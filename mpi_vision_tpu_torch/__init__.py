"""mpi_vision_tpu_torch — the PyTorch and CUDA port of ``mpi_vision_tpu``.

The JAX package stays beside this one as the reference it is held to. This
package imports ``torch``, numpy and the standard library only; it mirrors
the JAX package's layout (``core``, ``kernels``, ``obs``, ``serve``,
``cli``) so each module's counterpart has the same name. So far it carries
the serving path: the core render math, the scene cache, engine,
micro-batching scheduler and HTTP service, and one hand-written CUDA
kernel (``kernels/csrc/render_fused.cu``) that replaces the JAX package's
three forward Pallas render kernels. Entry points run on the card unless
the caller asks for the CPU.
"""

from mpi_vision_tpu_torch.core.camera import inv_depths, intrinsics_matrix
from mpi_vision_tpu_torch.core.compose import over_composite
from mpi_vision_tpu_torch.core.render import (
    plane_homographies,
    render_mpi,
    render_views,
    warp_planes,
)
from mpi_vision_tpu_torch.core.sampling import Convention, bilinear_sample

__version__ = "0.1.0"
