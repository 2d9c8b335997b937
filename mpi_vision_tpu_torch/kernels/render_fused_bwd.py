"""Gradient of the fused render with respect to the planes: two CUDA kernels.

PyTorch counterpart of ``mpi_vision_tpu/kernels/render_pallas_bwd.py``.
There, ``backward_planes`` runs a re-warp kernel (``_warp_sep_kernel`` /
``_warp_shr_kernel``), the XLA composite VJP, and a warp-transpose kernel
(``_adjoint_sep_kernel`` / ``_adjoint_shr_kernel``), each tier behind a
planner with an XLA fallback. Here two hand-written CUDA kernels
(``csrc/render_fused_bwd.cu``) compute the same

    d planes = warp^T( composite_vjp( warp(planes), g ) )

for every pose, with no plan and no fallback:

  * kernel A, ``rewarp_composite_vjp`` — re-warps every plane exactly as
    the forward kernel samples it and runs the over-composite's VJP in the
    same thread, giving ``dwarped [V, P, H, W, 4]``;
  * kernel B, ``adjoint_warp`` — the warp transpose in gather form: each
    source pixel sums, in a fixed order, the target pixels whose forward
    sample point reaches it (no atomics: the gradient is deterministic).

Beside each kernel is its plain version (``plain_rewarp_composite_vjp``,
``plain_adjoint_warp``): explicit torch in the kernel's order of
operations, so on the card kernel and plain version agree to the bit. The
wrappers run the plain version for CPU tensors and launch the kernel for
CUDA tensors, or raise; ``.launches`` counts launches, ``.calls`` plain
runs. ``backward_planes`` chains the two; ``kernels/render_fused.py`` calls
it from the render's autograd ``Function``.
"""

from __future__ import annotations

import ctypes

import torch

from mpi_vision_tpu_torch.core import sampling
from mpi_vision_tpu_torch.kernels import render_fused
from mpi_vision_tpu_torch.kernels.render_fused import (
    _check_float32,
    _count_lock,
    _cuda_ready,
)

KERNEL = "render_fused_bwd"
# The C entry points of csrc/render_fused_bwd.cu (pointers, counts, the
# view stride in floats or the shared flag, device index, stream).
_SIGNATURES = {
    "mpi_rewarp_composite_vjp": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "mpi_adjoint_warp": (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
}
# f32 operations kernel A needs per target pixel and plane of one view: the
# forward sample and composite (render_fused.FLOPS_PER_SAMPLE, 67) and the
# VJP: rgb - below (3), d rgb (3), d alpha (3 mul + 2 add), 1 - alpha and
# g * (1 - alpha) (4).
FLOPS_A = render_fused.FLOPS_PER_SAMPLE + 15
# f32 operations kernel B needs per target sample it transposes (each
# target pixel, plane and view, counted once however many candidates the
# kernel evaluates): the homography (15), floor and fractions (6), the four
# tap weights (4) and 4 taps x 4 channels x (mul + add) (32).
FLOPS_B = 15 + 6 + 4 + 32
MAX_PLANES = render_fused.MAX_PLANES
# Kernel B stages every view's forward map (9 floats) and inverse (9
# doubles) of its plane in shared memory; past 48 KiB the launch needs an
# opt-in attribute it does not set.
MAX_SHARED_VIEWS = (48 * 1024) // (9 * (4 + 8))


def _library():
  from mpi_vision_tpu_torch.kernels import _build

  return _build.load(KERNEL, _SIGNATURES)


# ---------------------------------------------------------------------------
# Kernel A: re-warp + over-composite VJP.


def _check_a(planes, homs, g):
  _check_float32("rewarp_composite_vjp", {"g": g})
  views, num_planes = render_fused._check(planes, homs,
                                          "rewarp_composite_vjp")
  h, w = planes.shape[-3], planes.shape[-2]
  if tuple(g.shape) != (views, h, w, 3):
    raise ValueError(f"g must be [V, H, W, 3] = {(views, h, w, 3)}, got "
                     f"{tuple(g.shape)}")
  return views, num_planes, h, w


def plain_rewarp_composite_vjp(planes: torch.Tensor, homs: torch.Tensor,
                               g: torch.Tensor) -> torch.Tensor:
  """The plain version of kernel A.

  Args:
    planes: ``[P, H, W, 4]`` (one scene shared by every view) or
      ``[V, P, H, W, 4]``, back-to-front.
    homs: ``[V, P, 3, 3]`` target-pixel -> source-pixel homographies.
    g: ``[V, H, W, 3]`` gradient of the rendered views.

  Returns:
    ``dwarped [V, P, H, W, 4]``: the gradient of each warped plane's RGBA.
    The forward pass parks ``(rgb - below, alpha)`` per plane in the output,
    as the kernel does, and the reverse pass overwrites it.
  """
  with _count_lock:
    plain_rewarp_composite_vjp.calls += 1
  views, num_planes, h, w = _check_a(planes, homs, g)
  shared = planes.dim() == 4
  grid, scale = render_fused.pixel_grid(h, w, planes.device)
  out = torch.empty((views, num_planes, h, w, 4), dtype=torch.float32,
                    device=planes.device)
  below = None
  for p in range(num_planes):
    rgba = sampling.bilinear_sample(
        planes[p] if shared else planes[:, p],
        render_fused.sample_coords(homs[:, p], grid, scale))
    rgb, alpha = rgba[..., :3], rgba[..., 3:]
    if below is None:  # farthest plane: alpha ignored
      below = rgb
      continue
    out[:, p, ..., :3] = rgb - below
    out[:, p, ..., 3:] = alpha
    below = rgb * alpha + below * (1.0 - alpha)
  for p in range(num_planes - 1, 0, -1):
    diff = out[:, p, ..., :3]
    alpha = out[:, p, ..., 3:].clone()
    dalpha = (g[..., 0:1] * diff[..., 0:1] + g[..., 1:2] * diff[..., 1:2]
              + g[..., 2:3] * diff[..., 2:3])
    out[:, p, ..., :3] = g * alpha
    out[:, p, ..., 3:] = dalpha
    g = g * (1.0 - alpha)
  out[:, 0, ..., :3] = g
  out[:, 0, ..., 3:] = 0.0
  return out


plain_rewarp_composite_vjp.calls = 0


def rewarp_composite_vjp(planes: torch.Tensor, homs: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
  """Kernel A: ``dwarped [V, P, H, W, 4]`` (see the plain version).

  CUDA tensors launch the kernel on the current stream (no synchronise)
  and count ``rewarp_composite_vjp.launches``; CPU tensors run the plain
  version. Mixed devices, other dtypes, non-contiguous or misaligned
  tensors on the card, a missing ``nvcc``, a failed build or launch raise.
  """
  views, num_planes, h, w = _check_a(planes, homs, g)
  if all(t.device.type == "cpu" for t in (planes, homs, g)):
    return plain_rewarp_composite_vjp(planes, homs, g)
  dev = _cuda_ready("rewarp_composite_vjp",
                    {"planes": planes, "homs": homs, "g": g}, "planes")
  if num_planes > MAX_PLANES:
    raise ValueError(f"{num_planes} planes exceed the kernel's {MAX_PLANES}")
  if views > render_fused.MAX_VIEWS:
    raise ValueError(f"{views} views exceed the kernel's "
                     f"{render_fused.MAX_VIEWS}")
  out = torch.empty((views, num_planes, h, w, 4), dtype=torch.float32,
                    device=dev)
  view_stride = 0 if planes.dim() == 4 else num_planes * h * w * 4
  err = _library().mpi_rewarp_composite_vjp(
      planes.data_ptr(), homs.data_ptr(), g.data_ptr(), out.data_ptr(),
      views, num_planes, h, w, view_stride, dev.index,
      torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError(f"rewarp_composite_vjp kernel launch failed: CUDA "
                       f"error {err}")
  with _count_lock:
    rewarp_composite_vjp.launches += 1
  return out


rewarp_composite_vjp.launches = 0


# ---------------------------------------------------------------------------
# Kernel B: the warp transpose in gather form.


def _inverse3x3(hom: torch.Tensor) -> torch.Tensor:
  """Inverse of ``[3, 3]`` in float64, adjugate over determinant, as the
  kernel computes it (non-finite for a singular map)."""
  m = hom.to(torch.float64).reshape(9)
  m0, m1, m2, m3, m4, m5, m6, m7, m8 = m.unbind()
  c00 = m4 * m8 - m5 * m7
  c01 = m5 * m6 - m3 * m8
  c02 = m3 * m7 - m4 * m6
  det = m0 * c00 + m1 * c01 + m2 * c02
  return torch.stack([
      c00, m2 * m7 - m1 * m8, m1 * m5 - m2 * m4,
      c01, m0 * m8 - m2 * m6, m2 * m3 - m0 * m5,
      c02, m1 * m6 - m0 * m7, m0 * m4 - m1 * m3]) / det


def candidate_boxes(hom: torch.Tensor, height: int, width: int):
  """Per source pixel, the target pixels that can sample it.

  The box ``(x +- 1, y +- 1)`` around every source pixel, its corners
  mapped through the inverse of ``hom [3, 3]`` in float64, the bounding
  box widened to floor/ceil and clamped to the image; the whole image where
  the inverse denominator is not one-signed over the box (the plane
  crosses the camera's plane there) or anything is non-finite; empty
  (``lo > hi``) where the box maps outside the image. Returns
  ``(i_lo, i_hi, j_lo, j_hi, whole)``, each ``[H * W]`` over source pixels
  in row-major order — the kernel's ``candidate_box``.
  """
  hi = _inverse3x3(hom)
  dev = hom.device
  ys, xs = torch.meshgrid(
      torch.arange(height, dtype=torch.float64, device=dev),
      torch.arange(width, dtype=torch.float64, device=dev), indexing="ij")
  xs, ys = xs.reshape(-1), ys.reshape(-1)
  jc, ic, pos, neg = [], [], True, True
  for dx in (-1.0, 1.0):
    for dy in (-1.0, 1.0):
      cx, cy = xs + dx, ys + dy
      e = hi[6] * cx + hi[7] * cy + hi[8]
      tol = 1e-7 * ((hi[6] * cx).abs() + (hi[7] * cy).abs() + hi[8].abs())
      pos = pos & (e > tol)
      neg = neg & (e < -tol)
      jc.append((hi[0] * cx + hi[1] * cy + hi[2]) / e)
      ic.append((hi[3] * cx + hi[4] * cy + hi[5]) / e)
  jc, ic = torch.stack(jc), torch.stack(ic)
  jmin, jmax = jc.min(0).values, jc.max(0).values
  imin, imax = ic.min(0).values, ic.max(0).values
  finite = (torch.isfinite(jmin) & torch.isfinite(jmax)
            & torch.isfinite(imin) & torch.isfinite(imax))
  whole = ~(pos | neg) | ~finite
  empty = ~whole & ((jmax < 0) | (jmin > width - 1) | (imax < 0)
                    | (imin > height - 1))

  def bound(v, lo_or_hi, size, fill):
    v = torch.where(whole, fill, lo_or_hi(v).clamp(0, size - 1))
    return v.to(torch.int64)

  i_lo = bound(imin, torch.floor, height, 0.0)
  i_hi = bound(imax, torch.ceil, height, height - 1.0)
  j_lo = bound(jmin, torch.floor, width, 0.0)
  j_hi = bound(jmax, torch.ceil, width, width - 1.0)
  i_lo = torch.where(empty, 1, i_lo)
  i_hi = torch.where(empty, 0, i_hi)
  return i_lo, i_hi, j_lo, j_hi, whole


def _check_b(dwarped, homs):
  _check_float32("adjoint_warp", {"dwarped": dwarped, "homs": homs})
  if dwarped.dim() != 5 or dwarped.shape[-1] != 4:
    raise ValueError(f"dwarped must be [V, P, H, W, 4], got "
                     f"{tuple(dwarped.shape)}")
  if homs.dim() != 4 or tuple(homs.shape) != (*dwarped.shape[:2], 3, 3):
    raise ValueError(f"homs must be [V, P, 3, 3] = "
                     f"{(*dwarped.shape[:2], 3, 3)}, got {tuple(homs.shape)}")
  return dwarped.shape[:4]


def _transpose_into(acc, pix, boxes, tmap, dw, xs, ys, width):
  """Sum, for the source pixels ``pix``, every candidate target pixel of
  their boxes in row-major order, as the kernel's loop does; non-hits add
  nothing. ``tmap`` is the forward map of every target pixel."""
  i_lo, i_hi, j_lo, j_hi = (b[pix] for b in boxes)
  px, py, x0f, y0f, x0, y0, reach = tmap
  x, y = xs[pix], ys[pix]
  sums = acc[pix]
  for di in range(int((i_hi - i_lo).max()) + 1):
    ti = i_lo + di
    row_ok = ti <= i_hi
    for dj in range(int((j_hi - j_lo).max()) + 1):
      tj = j_lo + dj
      t = ti.clamp(max=int(i_hi.max())) * width + tj.clamp(max=width - 1)
      tx0, ty0 = x0[t], y0[t]
      hit = (row_ok & (tj <= j_hi) & reach[t]
             & ((tx0 == x) | (tx0 + 1 == x)) & ((ty0 == y) | (ty0 + 1 == y)))
      wx = px[t] - x0f[t]
      wy = py[t] - y0f[t]
      kx = torch.where(tx0 == x, 1.0 - wx, wx)
      ky = torch.where(ty0 == y, 1.0 - wy, wy)
      kk = (ky * kx)[:, None]
      sums = torch.where(hit[:, None], sums + dw[t] * kk, sums)
  acc[pix] = sums


def plain_adjoint_warp(dwarped: torch.Tensor, homs: torch.Tensor,
                       shared: bool) -> torch.Tensor:
  """The plain version of kernel B: the warp transpose in gather form.

  Args:
    dwarped: ``[V, P, H, W, 4]`` gradient of each view's warped planes.
    homs: ``[V, P, 3, 3]`` the forward's target -> source pixel maps.
    shared: the views share one scene (sum into ``[P, H, W, 4]``);
      otherwise each view's scene gets its own (``[V, P, H, W, 4]``).

  Each source pixel sums, over views, then candidate rows, then columns
  (``candidate_boxes``), ``dwarped * (k_y * k_x)`` of every target pixel
  whose forward sample point — the forward's own f32 expression and reach
  guard — has it among its four bilinear taps, ``k`` the tap's weight.
  Source pixels are handled in groups of similar box size, each group
  looping over its largest box.
  """
  with _count_lock:
    plain_adjoint_warp.calls += 1
  views, num_planes, h, w = _check_b(dwarped, homs)
  dev = dwarped.device
  out = torch.zeros((1 if shared else views, num_planes, h * w, 4),
                    dtype=torch.float32, device=dev)
  grid, scale = render_fused.pixel_grid(h, w, dev)
  ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                          torch.arange(w, device=dev), indexing="ij")
  xs, ys = xs.reshape(-1), ys.reshape(-1)
  for p in range(num_planes):
    for v in range(views):
      coords = render_fused.sample_coords(homs[v, p], grid, scale)
      # The sampler's pixel coords (sampling.bilinear_sample) and the
      # forward kernel's reach guard.
      px = (coords[..., 0] * w - 0.5).reshape(-1)
      py = (coords[..., 1] * h - 0.5).reshape(-1)
      reach = (px >= -1.0) & (px < w) & (py >= -1.0) & (py < h)
      x0f = torch.where(reach, torch.floor(px), -2.0)
      y0f = torch.where(reach, torch.floor(py), -2.0)
      tmap = (px, py, x0f, y0f, x0f.to(torch.int64), y0f.to(torch.int64),
              reach)
      *boxes, _ = candidate_boxes(homs[v, p], h, w)
      rows = boxes[1] - boxes[0] + 1
      cols = boxes[3] - boxes[2] + 1
      live = (rows > 0) & (cols > 0)
      # Group by the box's power-of-two size, so that a few wide boxes do
      # not set the loop length for every pixel.
      key = (torch.ceil(torch.log2(rows.clamp(min=1).double())) * 64
             + torch.ceil(torch.log2(cols.clamp(min=1).double())))
      acc = out[0 if shared else v, p]
      dw = dwarped[v, p].reshape(-1, 4)
      for k in torch.unique(key[live]).tolist():
        pix = torch.nonzero(live & (key == k)).reshape(-1)
        _transpose_into(acc, pix, boxes, tmap, dw, xs, ys, w)
  out = out.reshape(out.shape[0], num_planes, h, w, 4)
  return out[0] if shared else out


plain_adjoint_warp.calls = 0


def adjoint_warp(dwarped: torch.Tensor, homs: torch.Tensor,
                 shared: bool) -> torch.Tensor:
  """Kernel B: ``d planes`` ``[P, H, W, 4]`` (``shared``) or
  ``[V, P, H, W, 4]`` (see the plain version).

  CUDA tensors launch the kernel on the current stream and count
  ``adjoint_warp.launches``; CPU tensors run the plain version; anything
  else raises, as ``rewarp_composite_vjp`` does.
  """
  views, num_planes, h, w = _check_b(dwarped, homs)
  if dwarped.device.type == "cpu" and homs.device.type == "cpu":
    return plain_adjoint_warp(dwarped, homs, shared)
  dev = _cuda_ready("adjoint_warp", {"dwarped": dwarped, "homs": homs},
                    "dwarped")
  if shared and views > MAX_SHARED_VIEWS:
    raise ValueError(f"{views} views of one scene exceed the kernel's "
                     f"{MAX_SHARED_VIEWS}")
  scenes = 1 if shared else views
  if scenes * num_planes > render_fused.MAX_VIEWS:
    raise ValueError(f"{scenes} scenes x {num_planes} planes exceed the "
                     f"kernel's grid ({render_fused.MAX_VIEWS})")
  out = torch.empty((scenes, num_planes, h, w, 4), dtype=torch.float32,
                    device=dev)
  err = _library().mpi_adjoint_warp(
      dwarped.data_ptr(), homs.data_ptr(), out.data_ptr(), views, num_planes,
      h, w, int(shared), dev.index, torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError(f"adjoint_warp kernel launch failed: CUDA error {err}")
  with _count_lock:
    adjoint_warp.launches += 1
  return out[0] if shared else out


adjoint_warp.launches = 0


def backward_planes(planes: torch.Tensor, homs: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
  """``d loss / d planes`` for ``g = d loss / d render``: kernel A, then
  kernel B (their plain versions for CPU tensors). ``planes`` ``[P, H, W,
  4]`` shared by the views (the gradient sums over them) or ``[V, P, H, W,
  4]``; returns the same shape."""
  dwarped = rewarp_composite_vjp(planes, homs, g)
  return adjoint_warp(dwarped, homs, shared=planes.dim() == 4)


def sign_changing_planes(homs: torch.Tensor, height: int, width: int) -> int:
  """How many ``[..., 3, 3]`` maps have an inverse whose denominator is not
  one-signed over the image's corners: planes that cross the camera's
  plane, where the JAX backward falls back to XLA (its ``den_ok``) and
  kernel B scans the whole image for the source pixels near the crossing."""
  count = 0
  for hom in homs.reshape(-1, 3, 3):
    hi = _inverse3x3(hom)
    e = torch.stack([hi[6] * cx + hi[7] * cy + hi[8]
                     for cx in (0.0, width - 1.0)
                     for cy in (0.0, height - 1.0)])
    count += int(not (bool((e > 0).all()) or bool((e < 0).all())))
  return count
