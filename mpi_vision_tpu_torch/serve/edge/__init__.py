"""Pose-quantized edge render cache: view-cell frame reuse in front of
the render engine.

PyTorch counterpart of ``mpi_vision_tpu/serve/edge/``. Incoming poses
quantize onto a per-scene view-cell lattice (``lattice``); finished frames
live in a byte-budgeted LRU keyed by ``(scene_id, params_digest, cell)``
(``cache``); exact cell hits serve stored bytes, near-misses serve a
single-homography warp of the nearest cached frame (``warp``, on the
serving engine's device), and everything else renders for real and
populates the cell. ``serve/server.py`` wires the HTTP side — strong
ETags, ``If-None-Match`` -> 304, ``Cache-Control: max-age`` — and
``swap_scenes`` invalidates cached frames exactly like it invalidates
baked scenes.
"""

from mpi_vision_tpu_torch.serve.edge.cache import (
    CachedFrame,
    EdgeConfig,
    EdgeFrameCache,
)
from mpi_vision_tpu_torch.serve.edge.lattice import (
    pose_error,
    quantize_pose,
    rotation_vector,
)
from mpi_vision_tpu_torch.serve.edge.warp import warp_frame
