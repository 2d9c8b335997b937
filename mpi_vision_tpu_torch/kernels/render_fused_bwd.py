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
    the forward kernel samples it and runs the over-composite's VJP per
    pixel, giving ``dwarped [V, P, H, W, 4]``. The plane count picks where
    each plane's forward record waits for the reverse pass: in registers,
    in shared memory, or (past ``SMEM_PLANES``) in dwarped itself;
    ``rewarp_launch_shape`` mirrors the choice;
  * kernel B, ``adjoint_warp`` — the warp transpose in gather form: each
    source pixel sums, in a fixed order, the target pixels whose forward
    sample point reaches it (no atomics: the gradient is deterministic).
    One block takes a source tile, stages the tile's preimage once per
    view and finds each pixel's contributors in it; ``tile_boxes``,
    ``tile_chunks`` and ``tile_scan`` are the plain mirror of that logic,
    which the CPU tests hold by brute force.

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
import functools

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
# view stride in floats or the shared flag, device index, stream), and
# kernel A's launch at a shape (counts, ten fields out).
_SIGNATURES = {
    "mpi_rewarp_launch_shape": (
        [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.POINTER(ctypes.c_longlong)], None),
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
# Kernel A stages one view's P x 9 homographies in shared memory; its
# global path takes them without the opt-in past 48 KiB.
MAX_PLANES = render_fused.SMEM_LIMIT // (9 * 4)
# Kernel A's paths, chosen by the plane count in the .cu (rewarp_launch;
# these mirror its constants): up to REG_PLANES the records live in
# registers (one thread per pixel, a kernel per bucket of REG_BUCKET
# planes), up to SMEM_PLANES in shared memory (a block of SHARED_THREADS
# stages a tile's samples, [plane][pixel] float4, and turns them into
# records in place), past that in dwarped (the global path, blocks of
# TILE_A_GLOBAL, one view per grid z). The first two take (view, TILE_A
# tile) items, the views of a tile adjacent, from a 1-D grid.
TILE_A = (32, 2)
TILE_A_GLOBAL = (32, 8)
REG_PLANES = 16
REG_BUCKET = 4
SMEM_PLANES = 64
SHARED_THREADS = 256
GRID_X_MAX = 2**31 - 1
# The C side's path codes, in order.
REWARP_PATHS = ("registers", "shared", "global")
# The shared path's opt-in, one value for every plane count: the slots and
# maps of SMEM_PLANES planes.
SMEM_OPT_IN = SMEM_PLANES * (TILE_A[0] * TILE_A[1] * 16 + 9 * 4)
# Kernel B: one block per TILE_B source tile of one plane, one thread per
# column and ROWS_PER_THREAD rows. Its preimage is staged in chunks of up to
# CHUNK targets and MAX_SEGS row segments, rows wider than SEG_MAX cut into
# equal segments; NO_TAP marks a target out of reach (a reachable tap
# origin is >= -1).
TILE_B = (64, 16)
ROWS_PER_THREAD = 4
CHUNK = 1536
MAX_SEGS = 32
SEG_MAX = 240
NO_TAP = -2


def adjoint_launch_shape(views: int, num_planes: int, height: int,
                         width: int, shared: bool) -> dict:
  """Kernel B's launch, as ``csrc/render_fused_bwd.cu`` computes it:
  ``grid`` (x tiles, y tiles, scenes x planes), ``block`` and the dynamic
  ``smem_bytes`` of one staged chunk (dwarped float4 and the sample point
  float2 per target; per segment its y0 range and a byte span per tile
  column)."""
  scenes = 1 if shared else views
  return {"grid": (-(-width // TILE_B[0]), -(-height // TILE_B[1]),
                   scenes * num_planes),
          "block": (TILE_B[0], TILE_B[1] // ROWS_PER_THREAD),
          "smem_bytes": CHUNK * (16 + 8) + MAX_SEGS * (8 + 2 * TILE_B[0])}


def check_adjoint_launch(views: int, num_planes: int, height: int,
                         width: int, shared: bool) -> dict:
  """``adjoint_launch_shape``, or a ``ValueError`` naming what kernel B
  cannot take: more scenes x planes than the grid's z, or a plane of 2^31
  pixels or more (32-bit offsets)."""
  shape = adjoint_launch_shape(views, num_planes, height, width, shared)
  if shape["grid"][2] > render_fused.MAX_VIEWS:
    raise ValueError(f"{shape['grid'][2]} scenes x planes exceed kernel B's "
                     f"grid ({render_fused.MAX_VIEWS})")
  if height * width > render_fused.MAX_PLANE_PIXELS:
    raise ValueError(f"{height} x {width} pixels per plane exceed kernel "
                     "B's 32-bit plane offsets")
  return shape


def rewarp_launch_shape(views: int, num_planes: int, height: int,
                        width: int) -> dict:
  """Kernel A's launch, as ``csrc/render_fused_bwd.cu`` chooses it (its
  mirror: ``kernel_rewarp_launch_shape`` asks the built kernel, and the
  wrapper holds the two equal before it launches). The ``path``
  (``registers``, ``shared`` or ``global``), the register ``bucket``
  (planes unrolled; None off the registers path), ``block``, ``grid``, the
  (view, tile) ``items`` the 1-D grid walks (None on the global path) and
  the dynamic ``smem_bytes``: the shared path's sample slots and maps, the
  global path's maps (the registers path holds its bucket's maps in static
  shared memory)."""
  homs = num_planes * 9 * 4
  if num_planes > SMEM_PLANES:
    return {"path": "global", "bucket": None, "block": (*TILE_A_GLOBAL, 1),
            "grid": (-(-width // TILE_A_GLOBAL[0]),
                     -(-height // TILE_A_GLOBAL[1]), views),
            "items": None, "smem_bytes": homs}
  pixels = TILE_A[0] * TILE_A[1]
  items = -(-width // TILE_A[0]) * -(-height // TILE_A[1]) * views
  shape = {"grid": (min(items, GRID_X_MAX), 1, 1), "items": items}
  if num_planes > REG_PLANES:
    return {"path": "shared", "bucket": None,
            "block": (SHARED_THREADS, 1, 1),
            "smem_bytes": num_planes * pixels * 16 + homs, **shape}
  return {"path": "registers",
          "bucket": -(-num_planes // REG_BUCKET) * REG_BUCKET,
          "block": (pixels, 1, 1), "smem_bytes": 0, **shape}


def check_rewarp_launch(views: int, num_planes: int, height: int,
                        width: int) -> dict:
  """``rewarp_launch_shape``, or a ``ValueError`` naming what kernel A
  cannot take: more planes than ``MAX_PLANES``, more views than the global
  path's grid, or a plane of 2^31 pixels or more (32-bit offsets)."""
  if num_planes > MAX_PLANES:
    raise ValueError(f"{num_planes} planes exceed the kernel's {MAX_PLANES}")
  if views > render_fused.MAX_VIEWS:
    raise ValueError(f"{views} views exceed the kernel's "
                     f"{render_fused.MAX_VIEWS}")
  if height * width > render_fused.MAX_PLANE_PIXELS:
    raise ValueError(f"{height} x {width} pixels per plane exceed the "
                     "kernel's 32-bit plane offsets")
  return rewarp_launch_shape(views, num_planes, height, width)


def _library():
  from mpi_vision_tpu_torch.kernels import _build

  return _build.load(KERNEL, _SIGNATURES)


@functools.lru_cache(maxsize=None)
def kernel_rewarp_launch_shape(views: int, num_planes: int, height: int,
                               width: int) -> dict:
  """Kernel A's launch as the built kernel makes it, with the keys of
  ``rewarp_launch_shape``. Builds and loads the library (needs ``nvcc``)."""
  out = (ctypes.c_longlong * 10)()
  _library().mpi_rewarp_launch_shape(views, num_planes, height, width, out)
  path, bucket, bx, by, bz, gx, gy, gz, items, smem = out
  return {"path": REWARP_PATHS[path], "bucket": bucket or None,
          "block": (bx, by, bz), "grid": (gx, gy, gz),
          "items": items or None, "smem_bytes": smem}


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
    as the kernel's global path does (its other paths keep these records
    on chip), and the reverse pass overwrites it.
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

  CUDA tensors launch the kernel of the path ``check_rewarp_launch`` names
  on the current stream (no synchronise) and count
  ``rewarp_composite_vjp.launches``; CPU tensors run the plain version.
  Mixed devices, other dtypes, non-contiguous or misaligned tensors on the
  card, a missing ``nvcc``, a failed build, a kernel whose launch is not
  ``check_rewarp_launch``'s, a failed shared-memory opt-in or launch
  raise.
  """
  views, num_planes, h, w = _check_a(planes, homs, g)
  if all(t.device.type == "cpu" for t in (planes, homs, g)):
    return plain_rewarp_composite_vjp(planes, homs, g)
  dev = _cuda_ready("rewarp_composite_vjp",
                    {"planes": planes, "homs": homs, "g": g}, "planes")
  shape = check_rewarp_launch(views, num_planes, h, w)
  launched = kernel_rewarp_launch_shape(views, num_planes, h, w)
  if launched != shape:
    raise RuntimeError(f"rewarp_launch_shape {shape} is not the kernel's "
                       f"launch {launched}")
  out = torch.empty((views, num_planes, h, w, 4), dtype=torch.float32,
                    device=dev)
  view_stride = 0 if planes.dim() == 4 else num_planes * h * w * 4
  err = _library().mpi_rewarp_composite_vjp(
      planes.data_ptr(), homs.data_ptr(), g.data_ptr(), out.data_ptr(),
      views, num_planes, h, w, view_stride, dev.index,
      torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError(f"rewarp_composite_vjp kernel launch failed: CUDA "
                       f"error {err} (the shared-memory opt-in or the "
                       "launch)")
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


def preimage_boxes(hom: torch.Tensor, cx_lo, cx_hi, cy_lo, cy_hi,
                   height: int, width: int):
  """Target pixels that can sample the source boxes whose corners are
  ``(cx_lo | cx_hi, cy_lo | cy_hi)`` (float64 tensors, one entry per box).

  The corners mapped through the inverse of ``hom [3, 3]`` in float64, the
  bounding box widened to floor/ceil and clamped to the image; the whole
  image where the inverse denominator is not one-signed over the corners
  (the plane crosses the camera's plane there) or anything is non-finite;
  empty (``lo > hi``) where the box maps outside the image. Returns
  ``(i_lo, i_hi, j_lo, j_hi, whole)`` per box — the kernel's
  ``preimage_box``.
  """
  hi = _inverse3x3(hom)
  jc, ic, pos, neg = [], [], True, True
  for cy in (cy_lo, cy_hi):
    for cx in (cx_lo, cx_hi):
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
  j_lo = torch.where(empty, 1, j_lo)
  j_hi = torch.where(empty, 0, j_hi)
  return i_lo, i_hi, j_lo, j_hi, whole


def candidate_boxes(hom: torch.Tensor, height: int, width: int):
  """Per source pixel, the target pixels that can sample it: the
  ``preimage_boxes`` of the box ``(x +- 1, y +- 1)``, each ``[H * W]`` over
  source pixels in row-major order. ``plain_adjoint_warp`` scans them."""
  ys, xs = torch.meshgrid(
      torch.arange(height, dtype=torch.float64, device=hom.device),
      torch.arange(width, dtype=torch.float64, device=hom.device),
      indexing="ij")
  xs, ys = xs.reshape(-1), ys.reshape(-1)
  return preimage_boxes(hom, xs - 1.0, xs + 1.0, ys - 1.0, ys + 1.0,
                        height, width)


def tile_boxes(hom: torch.Tensor, height: int, width: int):
  """Kernel B's per-tile preimages: the ``preimage_boxes`` of each
  ``TILE_B`` source tile's corners +- 1 (clipped to the image), each
  ``[tiles_y * tiles_x]`` in row-major tile order."""
  tx, ty = TILE_B
  ys, xs = torch.meshgrid(
      torch.arange(0, height, ty, dtype=torch.float64, device=hom.device),
      torch.arange(0, width, tx, dtype=torch.float64, device=hom.device),
      indexing="ij")
  xs, ys = xs.reshape(-1), ys.reshape(-1)
  return preimage_boxes(hom, xs - 1.0, (xs + tx - 1).clamp(max=width - 1) + 1,
                        ys - 1.0, (ys + ty - 1).clamp(max=height - 1) + 1,
                        height, width)


def tile_chunks(box, chunk: int = CHUNK, max_segs: int = MAX_SEGS,
                seg_max: int = SEG_MAX) -> list[list[tuple[int, int, int]]]:
  """How kernel B stages one preimage ``box = (i_lo, i_hi, j_lo, j_hi)``:
  a list of chunks, each a list of row segments ``(i, j_begin, seg_w)`` in
  ascending ``(i, j)``. A row wider than ``seg_max`` is cut into equal
  segments; a chunk holds at most ``max_segs`` segments and ``chunk``
  staged targets (a segment's columns past ``j_hi`` are staged as out of
  reach)."""
  i_lo, i_hi, j_lo, j_hi = (int(b) for b in box)
  box_w, rows = j_hi - j_lo + 1, i_hi - i_lo + 1
  if box_w <= 0 or rows <= 0:
    return []
  pieces = -(-box_w // seg_max)
  seg_w = -(-box_w // pieces)
  per_chunk = min(max_segs, chunk // seg_w)
  segs = [(i_lo + g // pieces, j_lo + (g % pieces) * seg_w, seg_w)
          for g in range(rows * pieces)]
  return [segs[k:k + per_chunk] for k in range(0, len(segs), per_chunk)]


def forward_taps(hom: torch.Tensor, height: int, width: int):
  """Every target pixel's forward sample under ``hom``, ``[H * W]`` each:
  the sampler's pixel coords ``px, py`` (``sampling.bilinear_sample``), the
  forward kernel's reach guard, and the tap origin ``x0f, y0f`` (float,
  ``NO_TAP`` out of reach, as kernel B stages it)."""
  grid, scale = render_fused.pixel_grid(height, width, hom.device)
  coords = render_fused.sample_coords(hom, grid, scale)
  px = (coords[..., 0] * width - 0.5).reshape(-1)
  py = (coords[..., 1] * height - 0.5).reshape(-1)
  reach = (px >= -1.0) & (px < width) & (py >= -1.0) & (py < height)
  x0f = torch.where(reach, torch.floor(px), float(NO_TAP))
  y0f = torch.where(reach, torch.floor(py), float(NO_TAP))
  return px, py, reach, x0f, y0f


def tile_scan(hom: torch.Tensor, height: int, width: int,
              chunk: int = CHUNK, max_segs: int = MAX_SEGS,
              seg_max: int = SEG_MAX) -> torch.Tensor:
  """The plain mirror of kernel B's tile, chunk and span logic: a
  ``[H * W, H * W]`` bool, source pixel by target pixel, of the targets each
  source pixel's thread scans (in ascending ``(i, j)``, the order of its
  sum). Per segment: the running max of the staged ``x0`` from the left,
  the running min from the right (out-of-reach targets excluded), the
  segment's ``y0`` range; a thread (column x, ``ROWS_PER_THREAD`` rows from
  y_a) skips segments whose range misses ``[y_a - 1, y_a +
  ROWS_PER_THREAD - 1]`` and scans ``[first pmax >= x - 1, first smin >
  x)`` for all its rows. Small images only: the result is dense."""
  *_, x0, y0 = (t.to(torch.int64) for t in forward_taps(hom, height, width))
  scanned = torch.zeros((height * width, height * width), dtype=torch.bool)
  tx, ty = TILE_B
  tiles_x = -(-width // tx)
  boxes = torch.stack(tile_boxes(hom, height, width)[:4], 1).tolist()
  for t, box in enumerate(boxes):
    ys0, xs0 = (t // tiles_x) * ty, (t % tiles_x) * tx
    ys = torch.arange(ys0, min(ys0 + ty, height))
    xs = torch.arange(xs0, min(xs0 + tx, width))
    for segs in tile_chunks(box, chunk, max_segs, seg_max):
      for i, j_begin, seg_w in segs:
        js = torch.arange(j_begin, j_begin + seg_w)
        inside = js <= box[3]
        tgt = i * width + js.clamp(max=width - 1)
        ok = inside & (x0[tgt] != NO_TAP)
        if not bool(ok.any()):
          continue
        sx = torch.where(ok, x0[tgt], -2**62)
        pmax = torch.cummax(sx, 0).values
        sx = torch.where(ok, x0[tgt], 2**62)
        smin = torch.cummin(sx.flip(0), 0).values.flip(0)
        yr = y0[tgt][ok]
        # A thread's rows y_a .. y_a + ROWS_PER_THREAD - 1 share its scan.
        firsts = ys[::ROWS_PER_THREAD]
        groups = firsts[(yr.max() >= firsts - 1)
                        & (yr.min() <= firsts + ROWS_PER_THREAD - 1)]
        rows_hit = [y for y_a in groups.tolist()
                    for y in range(y_a, min(y_a + ROWS_PER_THREAD, height))]
        lo = torch.searchsorted(pmax, xs - 1, right=False)
        hi = torch.searchsorted(smin, xs, right=True)
        for x, a, b in zip(xs.tolist(), lo.tolist(), hi.tolist()):
          cols = tgt[a:b][inside[a:b]]
          for y in rows_hit:
            scanned[y * width + x, cols] = True
  return scanned


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
  ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                          torch.arange(w, device=dev), indexing="ij")
  xs, ys = xs.reshape(-1), ys.reshape(-1)
  for p in range(num_planes):
    for v in range(views):
      px, py, reach, x0f, y0f = forward_taps(homs[v, p], h, w)
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
  check_adjoint_launch(views, num_planes, h, w, shared)
  out = torch.empty((1 if shared else views, num_planes, h, w, 4),
                    dtype=torch.float32, device=dev)
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
