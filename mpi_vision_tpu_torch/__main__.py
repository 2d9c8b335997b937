"""``python -m mpi_vision_tpu_torch`` — see cli.py."""

import sys

from mpi_vision_tpu_torch.cli import main

sys.exit(main())
