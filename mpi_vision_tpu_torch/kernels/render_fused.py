"""Fused homography warp + bilinear sample + over-composite, one CUDA kernel.

PyTorch counterpart of the forward half of
``mpi_vision_tpu/kernels/render_pallas.py``. There, three Pallas kernels
(``_separable_kernel``, ``_shared_kernel``, ``_banded_kernel``) cover the
poses whose bilinear taps fit a TPU lane gather's 128-lane windows, chosen
by eager planners, with an XLA gather fallback past the envelope. Here one
hand-written CUDA kernel (``csrc/render_fused.cu``) renders every pose:
a Hopper thread gathers from anywhere, so the port has no envelope, no
plan, and no fallback.

  * ``pixel_homographies`` — per-plane maps from target to source *pixels*
    (the convention's normalisation folded into the 3x3).
  * ``plain_render`` — the plain PyTorch version of the kernel, in the
    kernel's layout. ``render_mpi_fused`` runs it for CPU tensors, and the
    chip smoke test holds the kernel to it on the card.
  * ``reference_render`` / ``_reference_render_batch`` — the same function
    in the JAX package's planar layout, the counterparts of its oracle.
  * ``render_mpi_fused`` — the wrapper: launches the kernel for CUDA
    tensors (``render_mpi_fused.launches`` counts launches), runs
    ``plain_render`` for CPU tensors, and raises on anything else. It
    goes through ``_FusedRender``, an autograd ``Function`` whose backward
    is ``kernels/render_fused_bwd.py``.
  * ``render_to_host`` — forward only: the kernel writes a flight's frames
    straight into pinned host memory as it composites them, so no frames
    buffer and no copy exist on the card (``serve/engine.py``).
  * ``launch_shape`` / ``check_launch`` — the kernel's launch (a block
    renders one tile for a chunk of up to ``VIEW_CHUNK`` views of a shared
    scene, one pass over the scene per chunk) and the limits the wrapper
    raises on, as pure functions.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from mpi_vision_tpu_torch.core import geometry, render, sampling
from mpi_vision_tpu_torch.core.sampling import Convention

KERNEL = "render_fused"
# The C entry points of csrc/render_fused.cu, both: planes, homs, out
# (device memory for the first, pinned host memory for the second), views,
# planes, height, width, view stride (floats), device index, stream.
_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
          ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
          ctypes.c_int, ctypes.c_void_p], ctypes.c_int)
_SIGNATURES = {"mpi_render_fused": _ARGS, "mpi_render_to_host": _ARGS}
# f32 operations that warp + bilinear sample + composite need for one
# output pixel of one plane: homography 6 mul + 6 add + 2 div + the zero
# test (15); floor, fraction and 1 - fraction for x and y (6); 4 channels
# x (6 mul + 3 add) for the bilinear blend (36); composite 3 x 3 plus
# 1 - alpha (10). Each division counts once. The kernel also spends 8 on
# the sampler's (u + 0.5) / W * W - 0.5 round trip, the identity in exact
# arithmetic, only to round as the plain version does; the bound does not
# count them.
FLOPS_PER_SAMPLE = 15 + 6 + 36 + 10
# A block renders one 32 x 8 output tile for a chunk of up to VIEW_CHUNK
# views of one shared scene (one view when each view has its own scene).
TILE = (32, 8)
VIEW_CHUNK = 4
# The chunk's homographies are staged in shared memory, views x P x 9
# floats per block, and the write-through's tile beside them, views x 8 x 96
# floats; past 48 KiB the launch needs an opt-in attribute this kernel does
# not set. MAX_PLANES is the limit at a full chunk of device output.
SMEM_LIMIT = 48 * 1024
MAX_PLANES = SMEM_LIMIT // (VIEW_CHUNK * 9 * 4)
STAGE_BYTES = TILE[1] * TILE[0] * 3 * 4  # one view's staged tile
MAX_VIEWS = 65535  # gridDim.z
# Offsets inside one plane are 32-bit.
MAX_PLANE_PIXELS = 2**31 - 1
# The serving engine's completion workers launch concurrently; the launch
# and plain-version counters are read-modify-write.
_count_lock = threading.Lock()


def launch_shape(views: int, num_planes: int, height: int, width: int,
                 shared: bool, to_host: bool = False) -> dict:
  """The kernel's launch for ``views`` views of ``[P, H, W]`` planes, as
  ``csrc/render_fused.cu``'s entry points compute it: ``view_chunk`` views
  per block (``VIEW_CHUNK`` of a shared scene, one for one scene per view),
  ``grid`` (x tiles, y tiles, view chunks), ``block`` and the
  ``smem_bytes`` of the chunk's homographies, with the staged tile of the
  write-through (``to_host``)."""
  chunk = min(views, VIEW_CHUNK) if shared else 1
  return {"view_chunk": chunk,
          "grid": (-(-width // TILE[0]), -(-height // TILE[1]),
                   -(-views // chunk)),
          "block": TILE,
          "smem_bytes": chunk * (num_planes * 9 * 4
                                 + (STAGE_BYTES if to_host else 0))}


def check_launch(name: str, views: int, num_planes: int, height: int,
                 width: int, shared: bool, to_host: bool = False) -> dict:
  """``launch_shape``, or a ``ValueError`` naming what the kernel cannot
  take: too many planes for shared memory, too many view chunks for the
  grid, or a plane of 2^31 pixels or more."""
  shape = launch_shape(views, num_planes, height, width, shared, to_host)
  if shape["smem_bytes"] > SMEM_LIMIT:
    raise ValueError(
        f"{name}: {num_planes} planes x {shape['view_chunk']} views exceed "
        f"the kernel's shared-memory budget ({MAX_PLANES} planes at a full "
        f"chunk of {VIEW_CHUNK} views)")
  if shape["grid"][2] > MAX_VIEWS:
    raise ValueError(f"{name}: {views} views exceed the kernel's grid "
                     f"({MAX_VIEWS} chunks of {shape['view_chunk']})")
  if height * width > MAX_PLANE_PIXELS:
    raise ValueError(f"{name}: {height} x {width} pixels per plane exceed "
                     f"the kernel's 32-bit plane offsets")
  return shape


def pixel_homographies(
    tgt_pose: torch.Tensor,
    depths: torch.Tensor,
    intrinsics: torch.Tensor,
    height: int,
    width: int,
    convention: Convention = Convention.EXACT,
) -> torch.Tensor:
  """Per-plane 3x3 maps from target *pixel* coords to source *pixel* coords.

  Composes the plane-induced homographies (core/render.py) with the
  convention's (0,1) normalization and the sampler's ``c*size - 0.5`` pixel
  mapping. For ``EXACT`` the composition is the identity; for the
  reference conventions it is a diagonal rescale + shift.

  Returns ``[P, B, 3, 3]`` float32.
  """
  homs = render.plane_homographies(tgt_pose, depths, intrinsics)  # [P,B,3,3]
  if convention is Convention.EXACT:
    return homs.to(torch.float32)
  if convention is Convention.REF_HOMOGRAPHY:
    # c = (x/(H-1), y/(W-1)); px = c_x*W - 0.5, py = c_y*H - 0.5.
    post = np.array([
        [width / (height - 1), 0.0, -0.5],
        [0.0, height / (width - 1), -0.5],
        [0.0, 0.0, 1.0],
    ], dtype=np.float32)
  elif convention is Convention.REF_PROJECTION:
    # c = ((x+0.5)/H, (y+0.5)/W); px = c_x*W - 0.5, py = c_y*H - 0.5.
    post = np.array([
        [width / height, 0.0, 0.5 * width / height - 0.5],
        [0.0, height / width, 0.5 * height / width - 0.5],
        [0.0, 0.0, 1.0],
    ], dtype=np.float32)
  else:
    raise ValueError(f"unknown convention: {convention!r}")
  post = torch.from_numpy(post).to(homs.device)
  return geometry.matmul_small(post, homs.to(torch.float32))


def is_separable(homs, atol: float = 1e-6) -> bool:
  """Whether pixel homographies are axis-aligned (h01 = h10 = h20 = h21 = 0).

  The TPU kernels render such poses through their separable tier; the
  CUDA kernel takes every pose alike, and the chip smoke test uses this
  to show that its pose classes cover both kinds.
  """
  h = np.asarray(torch.as_tensor(homs).detach().cpu()).reshape(-1, 9)
  return bool(np.all(np.abs(h[:, [1, 3, 6, 7]]) <= atol * np.abs(h[:, 8:9])))


def pixel_grid(height: int, width: int, device=None):
  """The target pixel grid ``[H, W, 3]`` (x, y, 1) and the sampler's
  ``(W, H)`` scale, as ``plain_render`` and the backward's plain versions
  use them."""
  grid = geometry.homogeneous_grid(height, width, device=device).permute(1, 2, 0)
  scale = torch.tensor([width, height], dtype=torch.float32, device=device)
  return grid, scale


def sample_coords(homs: torch.Tensor, grid: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
  """Normalised (0, 1) sampler coords of every target pixel under
  ``homs [..., 3, 3]``: ``[..., H, W, 2]``. The sampler maps them back by
  ``px = c * W - 0.5`` — the round trip the kernels evaluate too."""
  xy = geometry.from_homogeneous(geometry.apply_homography(grid, homs))
  return (xy + 0.5) / scale


def plain_render(planes: torch.Tensor, homs: torch.Tensor) -> torch.Tensor:
  """The plain PyTorch version of the kernel, in the kernel's layout.

  Args:
    planes: ``[P, H, W, 4]`` (one scene shared by every view) or
      ``[V, P, H, W, 4]`` RGBA planes, back-to-front.
    homs: ``[V, P, 3, 3]`` target-pixel -> source-pixel homographies.

  Returns:
    ``[V, H, W, 3]``. One plane at a time, so no warped-plane stack is
    held; each output element is the same f32 expression the kernel
    evaluates, in the same order.
  """
  with _count_lock:
    plain_render.calls += 1
    kind = planes.device.type
    plain_render.by_device[kind] = plain_render.by_device.get(kind, 0) + 1
  shared = planes.dim() == 4
  num_planes, h, w = planes.shape[-4], planes.shape[-3], planes.shape[-2]
  grid, scale = pixel_grid(h, w, planes.device)
  out = None
  for p in range(num_planes):
    plane = planes[p] if shared else planes[:, p]
    rgba = sampling.bilinear_sample(
        plane, sample_coords(homs[:, p], grid, scale))  # [V, H, W, 4]
    if out is None:
      out = rgba[..., :3]  # farthest plane: alpha ignored
    else:
      rgb, alpha = rgba[..., :3], rgba[..., 3:]
      out = rgb * alpha + out * (1.0 - alpha)
  return out


plain_render.calls = 0
# The same runs by device type: on a card's serving path a "cpu" run is a
# CPU-fallback render, a "cuda" one a plain run on the card (comparisons,
# the d homs backward) — which the port forbids on the served path.
plain_render.by_device = {"cpu": 0, "cuda": 0}


def reference_render(planes: torch.Tensor, homs: torch.Tensor) -> torch.Tensor:
  """``plain_render`` in the JAX package's planar layout.

  ``planes`` ``[P, 4, H, W]``, ``homs`` ``[P, 3, 3]`` -> ``[3, H, W]``.
  """
  out = plain_render(planes.permute(0, 2, 3, 1), homs[None])
  return out[0].permute(2, 0, 1)


def _reference_render_batch(planes: torch.Tensor,
                            homs: torch.Tensor) -> torch.Tensor:
  """Batched ``reference_render``: ``[B, P, 4, H, W]`` x ``[B, P, 3, 3]`` ->
  ``[B, 3, H, W]``."""
  return plain_render(planes.permute(0, 1, 3, 4, 2), homs).permute(0, 3, 1, 2)


def _check_float32(name: str, tensors: dict[str, torch.Tensor]) -> None:
  for key, t in tensors.items():
    if t.dtype != torch.float32:
      raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")


def _cuda_ready(name: str, tensors: dict[str, torch.Tensor],
                aligned: str) -> torch.device:
  """Device of ``tensors`` for a launch of kernel ``name``, or raise: one
  CUDA device, contiguous, and ``tensors[aligned]`` (read as float4) on a
  16-byte boundary. Every wrapper in this package checks with it."""
  devices = {t.device for t in tensors.values()}
  if len(devices) != 1 or next(iter(devices)).type != "cuda":
    raise ValueError(f"{name}: {', '.join(tensors)} must all be on one CUDA "
                     f"device, or all on the CPU; got "
                     f"{sorted(map(str, devices))}")
  for key, t in tensors.items():
    if not t.is_contiguous():
      raise ValueError(f"{name}: {key} must be contiguous for the kernel")
  if tensors[aligned].data_ptr() % 16:
    raise ValueError(f"{name}: {aligned} must start on a 16-byte boundary: "
                     "the kernel reads it as float4")
  return next(iter(devices))


def _check(planes: torch.Tensor, homs: torch.Tensor,
           name: str = "render_mpi_fused") -> tuple[int, int]:
  """Validate shapes and types; returns ``(views, planes)``."""
  _check_float32(name, {"planes": planes, "homs": homs})
  if planes.dim() not in (4, 5) or planes.shape[-1] != 4:
    raise ValueError(
        f"planes must be [P, H, W, 4] or [V, P, H, W, 4], got "
        f"{tuple(planes.shape)}")
  if homs.dim() != 4 or homs.shape[-2:] != (3, 3):
    raise ValueError(f"homs must be [V, P, 3, 3], got {tuple(homs.shape)}")
  views, num_planes = homs.shape[0], homs.shape[1]
  if planes.shape[-4] != num_planes:
    raise ValueError(f"planes hold {planes.shape[-4]} planes but homs "
                     f"{num_planes}")
  if planes.dim() == 5 and planes.shape[0] != views:
    raise ValueError(f"planes hold {planes.shape[0]} views but homs {views}")
  if views < 1 or num_planes < 1 or planes.shape[-3] < 1 or planes.shape[-2] < 1:
    raise ValueError("empty render: views, planes, H and W must be >= 1")
  return views, num_planes


def _run_kernel(name: str, planes: torch.Tensor, homs: torch.Tensor,
                views: int, num_planes: int,
                host: torch.Tensor | None = None) -> torch.Tensor:
  """One launch of the kernel on the current stream of the planes' card,
  for wrapper ``name`` (the errors it raises name it): the device-output
  instance into a new device buffer, or, given pinned ``host``, the
  write-through instance into it (``render_to_host``). Returns the buffer
  written; counts the launch."""
  dev = _cuda_ready(name, {"planes": planes, "homs": homs}, "planes")
  height, width = planes.shape[-3], planes.shape[-2]
  to_host = host is not None
  check_launch(name, views, num_planes, height, width, planes.dim() == 4,
               to_host=to_host)
  out = host if to_host else torch.empty((views, height, width, 3),
                                         dtype=torch.float32, device=dev)
  view_stride = 0 if planes.dim() == 4 else num_planes * height * width * 4
  from mpi_vision_tpu_torch.kernels import _build

  lib = _build.load(KERNEL, _SIGNATURES)
  entry = lib.mpi_render_to_host if to_host else lib.mpi_render_fused
  err = entry(planes.data_ptr(), homs.data_ptr(), out.data_ptr(), views,
              num_planes, height, width, view_stride, dev.index,
              torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err}")
  with _count_lock:
    render_mpi_fused.launches += 1
    render_to_host.launches += int(to_host)
  return out


def _launch(planes: torch.Tensor, homs: torch.Tensor) -> torch.Tensor:
  """The forward: the kernel for CUDA tensors, the plain version for CPU
  tensors, a raise for anything else (see ``render_mpi_fused``)."""
  views, num_planes = _check(planes, homs)
  if planes.device.type == "cpu" and homs.device.type == "cpu":
    return plain_render(planes, homs)
  return _run_kernel("render_mpi_fused", planes, homs, views, num_planes)


def render_to_host(planes: torch.Tensor, homs: torch.Tensor,
                   host: torch.Tensor) -> None:
  """Render a flight straight into host memory. Forward only.

  ``planes`` and ``homs`` are ``render_mpi_fused``'s; ``host`` is a
  contiguous float32 ``[V, H, W, 3]`` CPU tensor. For CUDA planes it has to
  be pinned: one launch of the kernel's write-through instance on the
  current stream stores each composite into ``host`` through its device
  mapping, so the frames cross the host link while the kernel renders and
  no frames buffer or copy exists on the card. Nothing is synchronised:
  ``host`` holds the frames once the stream has passed the launch, and
  PyTorch's pinned allocator does not see the writes, so the caller keeps
  ``host`` until then. The launch counts in ``render_to_host.launches`` and
  in ``render_mpi_fused.launches``. The pixels are the device-output
  launch's, to the bit.

  CPU planes and homographies write ``plain_render`` into ``host``. Any
  other buffer, and anything ``render_mpi_fused`` refuses, raises.
  """
  views, num_planes = _check(planes, homs, "render_to_host")
  height, width = planes.shape[-3], planes.shape[-2]
  _check_float32("render_to_host", {"host": host})
  if tuple(host.shape) != (views, height, width, 3):
    raise ValueError(f"render_to_host: host must be [{views}, {height}, "
                     f"{width}, 3], got {tuple(host.shape)}")
  if host.device.type != "cpu" or not host.is_contiguous():
    raise ValueError("render_to_host: host must be a contiguous CPU tensor")
  if planes.device.type == "cpu" and homs.device.type == "cpu":
    host.copy_(plain_render(planes, homs))
    return
  if not host.is_pinned():
    raise ValueError("render_to_host: the kernel writes only pinned host "
                     "memory")
  _run_kernel("render_to_host", planes, homs, views, num_planes, host)


render_to_host.launches = 0


class _FusedRender(torch.autograd.Function):
  """The render with its gradient: the counterpart of the JAX package's
  ``jax.custom_vjp`` around its fused kernels (``render_pallas.py``
  ``_make_fused``/``_make_shared``).

  The forward keeps only ``planes`` and ``homs``; the backward recomputes
  the warp rather than storing a warped stack, as the JAX backward does.
  ``d planes`` comes from ``render_fused_bwd.backward_planes`` (its two
  CUDA kernels on the card, their plain versions on the CPU). ``d homs`` is
  plain torch, the autograd of ``plain_render``, and is computed only when
  asked for: training poses are data, so the training path never takes it.
  """

  @staticmethod
  def forward(ctx, planes, homs):
    ctx.save_for_backward(planes, homs)
    return _launch(planes, homs)

  @staticmethod
  @torch.autograd.function.once_differentiable
  def backward(ctx, g):
    planes, homs = ctx.saved_tensors
    g = g.contiguous()
    dplanes = dhoms = None
    if ctx.needs_input_grad[0]:
      from mpi_vision_tpu_torch.kernels import render_fused_bwd

      dplanes = render_fused_bwd.backward_planes(planes, homs, g)
    if ctx.needs_input_grad[1]:
      with torch.enable_grad():
        h = homs.detach().requires_grad_(True)
        (dhoms,) = torch.autograd.grad(plain_render(planes.detach(), h), h, g)
    return dplanes, dhoms


def render_mpi_fused(planes: torch.Tensor, homs: torch.Tensor) -> torch.Tensor:
  """Render views of an MPI in one CUDA kernel launch, differentiably.

  Args:
    planes: ``[P, H, W, 4]`` float32 RGBA planes, back-to-front, shared by
      every view (the kernel reads them with a view stride of 0), or
      ``[V, P, H, W, 4]`` with one scene per view. Channels-last, unlike
      the JAX kernels' planar ``[P, 4, H, W]``: one bilinear tap is one
      16-byte load. Contiguous.
    homs: ``[V, P, 3, 3]`` float32 target-pixel -> source-pixel
      homographies (``pixel_homographies(...).transpose(0, 1)``),
      contiguous.

  Returns:
    ``[V, H, W, 3]`` float32, with a gradient to ``planes`` (and to
    ``homs`` when it requires one) through ``_FusedRender``.

  CUDA tensors launch the kernel on the current stream (no synchronise)
  and count the launch in ``render_mpi_fused.launches``; CPU tensors run
  ``plain_render``. Anything else — mixed devices, other dtypes, shapes,
  non-contiguous or misaligned (not 16-byte) planes on the card, a missing
  ``nvcc``, a failed build or launch — raises. The backward follows the
  same rule (``kernels/render_fused_bwd.py``).
  """
  _check(planes, homs)
  return _FusedRender.apply(planes, homs)


render_mpi_fused.launches = 0
