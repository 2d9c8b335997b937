"""Back-to-front over-compositing of a warped MPI stack, one CUDA kernel.

PyTorch counterpart of ``mpi_vision_tpu/kernels/compose_pallas.py``, whose
Pallas kernel (``_composite_kernel``) composites a planar
``[B, P, 4, H, W]`` stack tile by tile in VMEM. Here one hand-written CUDA
kernel (``csrc/compose_over.cu``) composites the channels-last stack the
port's warp writes: one thread per pixel, the running composite in f32
registers, one 16-byte (f32) or 8-byte (bf16) load per plane and pixel.

  * ``plain_composite`` — the plain PyTorch version (the scan of
    ``core/compose.py``, accumulated in f32 and cast back to the input's
    type). CPU tensors run it; the chip smoke test holds the kernel to it.
  * ``over_composite_pallas`` — the public entry, in the JAX names:
    ``[P, ..., 4] -> [..., 3]``. CUDA tensors launch the kernel
    (``over_composite_pallas.launches`` counts launches), CPU tensors run
    ``plain_composite``, anything else raises. It goes through
    ``_OverComposite``, an autograd ``Function`` whose backward is the VJP
    of the plain scan recomputed from the saved input, as the JAX
    package's ``custom_vjp`` is (its backward is XLA, not a kernel).
  * ``over_composite_pallas_planar`` — the JAX planar layout
    ``[B, P, 4, H, W] -> [B, 3, H, W]``, a layout wrapper over the same
    kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from mpi_vision_tpu_torch.core import compose

KERNEL = "compose_over"
# The C entry point of csrc/compose_over.cu: planes, out, dtype code,
# planes, pixels, plane stride (elements), device index, stream.
_SIGNATURES = {"mpi_compose_over": (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    ctypes.c_int)}
# The kernel's dtype codes, and the bytes of one pixel's four channels (the
# alignment its vector load needs).
_DTYPES = {torch.float32: (0, 16), torch.bfloat16: (1, 8)}
# f32 operations per plane and pixel: 1 - alpha, then 3 x (mul, mul, add).
FLOPS_PER_SAMPLE = 10
# Serving's completion workers launch concurrently; the counters are
# read-modify-write.
_count_lock = threading.Lock()


def plain_composite(rgba: torch.Tensor) -> torch.Tensor:
  """The plain PyTorch version of the kernel: ``[P, ..., 4] -> [..., 3]``.

  ``core/compose.py``'s scan in f32 (bf16 input upcast), cast back to the
  input's type once at the end — the expression order and the single
  rounding the kernel reproduces.
  """
  with _count_lock:
    plain_composite.calls += 1
    kind = rgba.device.type
    plain_composite.by_device[kind] = \
        plain_composite.by_device.get(kind, 0) + 1
  out = compose.over_composite_scan(rgba.to(torch.float32))
  return out.to(rgba.dtype)


plain_composite.calls = 0
# The same runs by device type ("cpu": the CPU fallback or a CPU service;
# "cuda": a plain run on the card).
plain_composite.by_device = {"cpu": 0, "cuda": 0}


def _check(rgba: torch.Tensor) -> None:
  if rgba.dtype not in _DTYPES:
    raise TypeError(f"over_composite_pallas: rgba must be float32 or "
                    f"bfloat16, got {rgba.dtype}")
  if rgba.dim() < 2 or rgba.shape[-1] != 4:
    raise ValueError(f"expected [P, ..., 4] with a trailing RGBA axis of 4, "
                     f"got {tuple(rgba.shape)}")
  if rgba.numel() == 0:
    raise ValueError(f"empty composite: {tuple(rgba.shape)}")


def _launch(rgba: torch.Tensor) -> torch.Tensor:
  """The forward: the kernel for a CUDA tensor, the plain version for a CPU
  tensor, a raise for anything else (see ``over_composite_pallas``)."""
  if rgba.device.type == "cpu":
    return plain_composite(rgba)
  if rgba.device.type != "cuda":
    raise ValueError(f"over_composite_pallas: rgba must be on a CUDA device "
                     f"or the CPU, got {rgba.device}")
  num_planes = rgba.shape[0]
  lead = tuple(rgba.shape[1:-1])
  pixels = rgba[0].numel() // 4
  # The kernel reads [P, N, 4]: each plane's pixels contiguous, planes at
  # any stride (a plane subset of a larger stack is fine). Anything that
  # would need a copy to get there raises instead of copying in silence.
  inner = rgba[0]
  if not inner.is_contiguous():
    raise ValueError("over_composite_pallas: each plane's [..., 4] block "
                     "must be contiguous for the kernel")
  code, vec_bytes = _DTYPES[rgba.dtype]
  plane_stride = rgba.stride(0) if num_planes > 1 else 0
  if rgba.data_ptr() % vec_bytes or (plane_stride * rgba.element_size()
                                     ) % vec_bytes:
    raise ValueError(f"over_composite_pallas: every plane must start on a "
                     f"{vec_bytes}-byte boundary: the kernel reads a "
                     f"pixel's four channels in one load")
  dev = rgba.device
  out = torch.empty(lead + (3,), dtype=rgba.dtype, device=dev)
  from mpi_vision_tpu_torch.kernels import _build

  lib = _build.load(KERNEL, _SIGNATURES)
  err = lib.mpi_compose_over(
      rgba.data_ptr(), out.data_ptr(), code, num_planes, pixels,
      plane_stride, dev.index, torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError(f"compose_over kernel launch failed: CUDA error {err}")
  with _count_lock:
    over_composite_pallas.launches += 1
  return out


class _OverComposite(torch.autograd.Function):
  """The composite with its gradient: the counterpart of the JAX
  package's ``custom_vjp`` around its compose kernel. The forward keeps
  only the input; the backward is the VJP of ``over_composite_scan``,
  recomputed from it in plain torch (the JAX backward is the scan's XLA
  VJP too), in the input's type."""

  @staticmethod
  def forward(ctx, rgba):
    ctx.save_for_backward(rgba)
    return _launch(rgba)

  @staticmethod
  @torch.autograd.function.once_differentiable
  def backward(ctx, g):
    (rgba,) = ctx.saved_tensors
    with torch.enable_grad():
      x = rgba.detach().requires_grad_(True)
      (grad,) = torch.autograd.grad(compose.over_composite_scan(x), x, g)
    return grad


def over_composite_pallas(rgba: torch.Tensor) -> torch.Tensor:
  """Composite ``[P, ..., H, W, 4]`` back-to-front RGBA planes to
  ``[..., H, W, 3]``, differentiably.

  Plane 0 is the farthest and its alpha is ignored, as in
  ``core.compose.over_composite``. ``rgba`` is float32 or bfloat16; the
  result has its type, accumulated in f32 and rounded once.

  CUDA tensors launch the kernel on the current stream (no synchronise)
  and count the launch in ``over_composite_pallas.launches``; CPU tensors
  run ``plain_composite``. Anything else — another dtype or device, a
  plane whose ``[..., 4]`` block is not contiguous, a plane not on a
  16-byte (f32) or 8-byte (bf16) boundary, a missing ``nvcc``, a failed
  build or launch — raises.
  """
  _check(rgba)
  return _OverComposite.apply(rgba)


over_composite_pallas.launches = 0


def over_composite_pallas_planar(rgba: torch.Tensor) -> torch.Tensor:
  """Composite a planar ``[B, P, 4, H, W]`` stack to ``[B, 3, H, W]``.

  The JAX package's kernel layout, moved to the kernel's channels-last
  ``[P, B, H, W, 4]`` (one copy) and back.
  """
  if rgba.dim() != 5 or rgba.shape[2] != 4:
    raise ValueError(f"expected [B, P, 4, H, W], got {tuple(rgba.shape)}")
  out = over_composite_pallas(rgba.permute(1, 0, 3, 4, 2).contiguous())
  return out.permute(0, 3, 1, 2)
