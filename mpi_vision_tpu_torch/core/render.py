"""MPI rendering: plane-induced homography warps + over-compositing.

PyTorch counterpart of ``mpi_vision_tpu/core/render.py``. A render is three
stages:

  1. the P plane homographies, as elementwise 3x3 products
     (``plane_homographies``);
  2. the target grid mapped through every homography (``warp_coordinates``);
  3. either a loop that warps a plane and composites it at once (never
     holding the [P, B, H, W, 4] warped stack — 'fused'), a batched warp +
     composite ('scan'/'assoc', see core/compose.py), a warp into the
     stack plane by plane and the hand-written CUDA compose kernel over it
     ('pallas', kernels/compose_over.py), or the hand-written CUDA kernel
     that does all three per output pixel ('fused_pallas', the JAX name of
     the fused kernel path; kernels/render_fused.py).

Layouts: MPIs enter as ``[B, H, W, P, 4]`` (the reference layout) or
planes-leading ``[P, B, H, W, 4]``.

The stages carry ``debug.named_scope`` ranges (``render/homographies``,
``render/warp``, ``render/composite``; the fused kernel's launch is
``render/warp_composite``), as the JAX package's ``jax.named_scope``s, so
profiles and Nsight timelines name them; the ranges add no synchronise.
"""

from __future__ import annotations

import torch

from mpi_vision_tpu_torch.core import compose, geometry, sampling
from mpi_vision_tpu_torch.core.sampling import Convention
from mpi_vision_tpu_torch.debug import named_scope

METHODS = ("fused_pallas", "pallas", "fused", "scan", "assoc")


def plane_homographies(
    tgt_pose: torch.Tensor,
    depths: torch.Tensor,
    intrinsics: torch.Tensor,
    tgt_intrinsics: torch.Tensor | None = None,
) -> torch.Tensor:
  """Inverse homographies (target pixels -> source pixels) for every MPI plane.

  Args:
    tgt_pose: ``[B, 4, 4]`` transform from the MPI (source/reference) camera
      frame to the target camera frame.
    depths: ``[P]`` plane depths, descending (far -> near).
    intrinsics: ``[B, 3, 3]`` source camera intrinsics.
    tgt_intrinsics: optional ``[B, 3, 3]`` target intrinsics (defaults to the
      source's).

  Returns:
    ``[P, B, 3, 3]``, with n_hat = [0, 0, 1] and a = -depth.
  """
  rot, t = geometry.pose_rt(tgt_pose)  # [B,3,3], [B,3,1]
  p = depths.shape[0]
  n_hat = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                       device=depths.device).expand(p, 1, 1, 3)
  a = -depths.reshape(p, 1, 1, 1)
  k_t = intrinsics if tgt_intrinsics is None else tgt_intrinsics
  return geometry.inverse_homography(
      intrinsics[None], k_t[None], rot[None], t[None], n_hat, a)


def warp_coordinates(
    homographies: torch.Tensor,
    height: int,
    width: int,
    convention: Convention = Convention.REF_HOMOGRAPHY,
    src_height: int | None = None,
    src_width: int | None = None,
) -> torch.Tensor:
  """Normalized (0, 1) source-sampling coords for a target grid.

  ``homographies``: ``[..., 3, 3]`` -> coords ``[..., H, W, 2]``.
  ``src_height``/``src_width`` decouple the sampled image's dims from the
  target grid's (cropped sources); the defaults keep target == source.
  """
  grid = geometry.homogeneous_grid(
      height, width, device=homographies.device).permute(1, 2, 0)  # [H,W,3]
  pts = geometry.apply_homography(grid, homographies)
  xy = geometry.from_homogeneous(pts)
  return sampling.normalize_pixel_coords(
      xy, height if src_height is None else src_height,
      width if src_width is None else src_width, convention)


def warp_planes(
    planes: torch.Tensor,
    tgt_pose: torch.Tensor,
    depths: torch.Tensor,
    intrinsics: torch.Tensor,
    convention: Convention = Convention.REF_HOMOGRAPHY,
) -> torch.Tensor:
  """Warp all MPI planes into the target view in one batched gather.

  ``planes``: ``[P, B, H, W, C]`` -> ``[P, B, H, W, C]``.
  """
  _, _, h, w, _ = planes.shape
  homs = plane_homographies(tgt_pose, depths, intrinsics)
  coords = warp_coordinates(homs, h, w, convention)  # [P, B, H, W, 2]
  return sampling.bilinear_sample(planes, coords)


def warp_stack(
    planes: torch.Tensor,
    homs: torch.Tensor,
    height: int,
    width: int,
    convention: Convention = Convention.REF_HOMOGRAPHY,
    src_window: tuple | None = None,
) -> torch.Tensor:
  """Every plane warped into the target grid: ``[P, B, H_t, W_t, C]``.

  ``planes [P, B, H_s, W_s, C]`` (the batch may be an ``expand`` of one
  scene), ``homs [P, B, 3, 3]``. The same values, bit for bit, as one
  batched ``bilinear_sample`` over ``warp_coordinates(homs, ...)`` — each
  element is the same elementwise chain — but the stack is filled one
  plane at a time, so the sampler's temporaries (int64 indices expanded
  over the channels, four gathered taps, the blends: roughly 150-200 bytes
  per target sample) exist for one plane, not for all P. At 1080p x 32
  planes that is the difference between ~1 GB and ~10 GB per view.
  ``src_window`` is ``render_mpi``'s.
  """
  num_planes, batch, h_s, w_s, chans = planes.shape
  if src_window is not None:
    h_s, w_s = src_window[2:]
  out = torch.empty((num_planes, batch, height, width, chans),
                    dtype=planes.dtype, device=planes.device)
  for p in range(num_planes):
    coords = warp_coordinates(homs[p], height, width, convention,
                              src_height=h_s, src_width=w_s)
    out[p] = sampling.bilinear_sample(planes[p], coords, window=src_window)
  return out


def render_views(
    rgba_layers: torch.Tensor,
    tgt_poses: torch.Tensor,
    depths: torch.Tensor,
    intrinsics: torch.Tensor,
    convention: Convention = Convention.REF_HOMOGRAPHY,
    method: str = "fused",
    tgt_intrinsics: torch.Tensor | None = None,
    out_hw: tuple[int, int] | None = None,
    src_window: tuple | None = None,
) -> torch.Tensor:
  """Render a batch of V target views of ONE scene.

  The batched-pose entry of the serving layer: one baked MPI, many poses —
  ``rgba_layers [H, W, P, 4]`` + ``tgt_poses [V, 4, 4]`` -> ``[V, H, W, 3]``.
  The MPI and intrinsics broadcast across the view axis as ``expand``
  views: the scene is never copied per view (the kernel reads one scene
  with a view stride of 0). A V-view batch is element-for-element the same
  computation as V single renders, which is what lets serving return
  bit-identical images whatever batch a request lands in.
  """
  v = tgt_poses.shape[0]
  planes = rgba_layers.unsqueeze(0).expand((v,) + tuple(rgba_layers.shape))
  k = intrinsics.unsqueeze(0).expand(v, 3, 3)
  k_t = (None if tgt_intrinsics is None else
         tgt_intrinsics.unsqueeze(0).expand(v, 3, 3))
  return render_mpi(planes, tgt_poses, depths, k, convention=convention,
                    method=method, tgt_intrinsics=k_t, out_hw=out_hw,
                    src_window=src_window)


def _kernel_homographies(tgt_pose: torch.Tensor, depths: torch.Tensor,
                         intrinsics: torch.Tensor, height: int, width: int,
                         convention: Convention) -> torch.Tensor:
  """The fused kernel's homographies for ``[V, 4, 4]`` poses and
  ``[V, 3, 3]`` intrinsics: ``[V, P, 3, 3]``, contiguous."""
  from mpi_vision_tpu_torch.kernels import render_fused
  with named_scope("render/homographies"):
    homs = render_fused.pixel_homographies(
        tgt_pose, depths, intrinsics, height, width, convention)  # [P,V,3,3]
    return homs.transpose(0, 1).contiguous()


def views_homographies(
    tgt_poses: torch.Tensor,
    depths: torch.Tensor,
    intrinsics: torch.Tensor,
    height: int,
    width: int,
    convention: Convention = Convention.REF_HOMOGRAPHY,
) -> torch.Tensor:
  """The homographies ``render_views(..., method="fused_pallas")`` hands
  the kernel for ``[V, 4, 4]`` poses of one ``height x width`` scene:
  ``[V, P, 3, 3]``, contiguous, computed as that call computes them. The
  serving engine launches the write-through kernel on them
  (``kernels/render_fused.render_to_host``)."""
  k = intrinsics.unsqueeze(0).expand(tgt_poses.shape[0], 3, 3)
  return _kernel_homographies(tgt_poses, depths, k, height, width,
                              convention)


def render_mpi(
    rgba_layers: torch.Tensor,
    tgt_pose: torch.Tensor,
    depths: torch.Tensor,
    intrinsics: torch.Tensor,
    convention: Convention = Convention.REF_HOMOGRAPHY,
    method: str = "fused",
    planes_leading: bool = False,
    tgt_intrinsics: torch.Tensor | None = None,
    out_hw: tuple[int, int] | None = None,
    src_window: tuple | None = None,
) -> torch.Tensor:
  """Render a novel view from an MPI. The reference's ``mpi_render_view_torch``.

  Args:
    rgba_layers: ``[B, H, W, P, 4]`` MPI (or ``[P, B, H, W, 4]`` when
      ``planes_leading``), planes ordered back-to-front (descending depth).
    tgt_pose: ``[B, 4, 4]`` source-cam -> target-cam transform.
    depths: ``[P]`` descending plane depths (see ``camera.inv_depths``).
    intrinsics: ``[B, 3, 3]``.
    convention: coordinate convention; REF_HOMOGRAPHY reproduces the
      reference exactly, EXACT is correct for non-square frames.
    method: 'fused_pallas' runs warp+sample+composite in the CUDA kernel of
      ``kernels/render_fused.py`` (its plain version for CPU tensors) —
      every pose, no envelope; 'fused' loops warp+composite per plane with
      no [P, ...] warped stack; 'scan'/'assoc' warp all planes then
      composite (see core/compose.py); 'pallas' warps into the stack one
      plane at a time, then composites it in the CUDA compose kernel
      (``kernels/compose_over.py``; its plain version for CPU tensors).
    tgt_intrinsics: optional ``[B, 3, 3]`` target intrinsics (every method
      but 'fused_pallas', as in the JAX package).
    out_hw: optional ``(H_t, W_t)`` rendered-frame dims when they differ
      from the MPI's (every method but 'fused_pallas').
    src_window: optional ``(y0, x0, H_full, W_full)``: the MPI is the window
      ``[y0:y0 + H, x0:x0 + W]`` of an ``H_full x W_full`` scene (a tile
      crop, serve/tiles.py), and ``intrinsics`` are the full scene's. Taps
      are computed in the full scene's pixel space and read from the window
      (zeros outside it): wherever every tap that lands on content falls
      inside the window, the frame is bit-identical to the full scene's.
      The frame defaults to ``H_full x W_full``. Every method but
      'fused_pallas'. (The JAX package folds the crop into corrected source
      intrinsics instead, which rounds a tap by up to ~1e-4 px at 1080p.)

  Returns:
    ``[B, H_t, W_t, 3]`` rendered view (``H_t, W_t`` default to the MPI's,
    or the full scene's with ``src_window``).
  """
  if method not in METHODS:
    raise ValueError(f"unknown render method {method!r}; one of {METHODS}")
  planes = rgba_layers if planes_leading else rgba_layers.movedim(3, 0)
  _, _, h, w, _ = planes.shape

  if method == "fused_pallas":
    if (tgt_intrinsics is not None or out_hw is not None
        or src_window is not None):
      raise ValueError(
          "method='fused_pallas' does not support tgt_intrinsics/out_hw/"
          "src_window (cropped sources); use 'pallas' or a plain method "
          "('fused'/'scan').")
    from mpi_vision_tpu_torch.kernels import render_fused
    homs = _kernel_homographies(tgt_pose, depths, intrinsics, h, w,
                                convention)               # [B, P, 3, 3]
    batched = planes.movedim(0, 1)                        # [B, P, H, W, 4]
    if batched.shape[0] == 1 or batched.stride(0) == 0:
      # One scene broadcast across the batch (render_views): hand the
      # kernel the scene once, with a view stride of 0. For a baked scene
      # this is its resident [P, H, W, 4] buffer, not a copy.
      batched = batched[0]
    with named_scope("render/warp_composite"):
      return render_fused.render_mpi_fused(batched.contiguous(), homs)

  if src_window is not None:
    src_window = tuple(int(v) for v in src_window)
    h, w = src_window[2:]
  th, tw = (h, w) if out_hw is None else (int(out_hw[0]), int(out_hw[1]))
  with named_scope("render/homographies"):
    homs = plane_homographies(tgt_pose, depths, intrinsics,
                              tgt_intrinsics=tgt_intrinsics)  # [P, B, 3, 3]

  if method == "pallas":
    with named_scope("render/warp"):
      warped = warp_stack(planes, homs, th, tw, convention, src_window)
    with named_scope("render/composite"):
      return compose.over_composite(warped, method="pallas")

  if method != "fused":
    with named_scope("render/warp"):
      coords = warp_coordinates(homs, th, tw, convention,
                                src_height=h, src_width=w)
      warped = sampling.bilinear_sample(planes, coords, window=src_window)
    with named_scope("render/composite"):
      return compose.over_composite(warped, method=method)

  def warp_one(plane, hom):
    coords = warp_coordinates(hom, th, tw, convention,
                              src_height=h, src_width=w)
    return sampling.bilinear_sample(plane, coords, window=src_window)

  with named_scope("render/warp_composite_scan"):
    # Farthest plane: alpha ignored.
    out = warp_one(planes[0], homs[0])[..., :3]
    for p in range(1, planes.shape[0]):
      rgba = warp_one(planes[p], homs[p])
      rgb, alpha = rgba[..., :3], rgba[..., 3:]
      out = rgb * alpha + out * (1.0 - alpha)
  return out
