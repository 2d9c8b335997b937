"""Command-line tools of the port (``python -m mpi_vision_tpu_torch.tools.<name>``)."""
