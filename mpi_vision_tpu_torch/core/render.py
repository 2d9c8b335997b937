"""MPI rendering: plane-induced homography warps + over-compositing.

PyTorch counterpart of ``mpi_vision_tpu/core/render.py``. A render is three
stages:

  1. the P plane homographies, as elementwise 3x3 products
     (``plane_homographies``);
  2. the target grid mapped through every homography (``warp_coordinates``);
  3. either a loop that warps a plane and composites it at once (never
     holding the [P, B, H, W, 4] warped stack — 'fused'), a batched warp +
     composite ('scan'/'assoc', see core/compose.py), or the hand-written
     CUDA kernel that does all three per output pixel ('fused_pallas', the
     JAX name of the fused kernel path; kernels/render_fused.py).

Layouts: MPIs enter as ``[B, H, W, P, 4]`` (the reference layout) or
planes-leading ``[P, B, H, W, 4]``.
"""

from __future__ import annotations

import torch

from mpi_vision_tpu_torch.core import compose, geometry, sampling
from mpi_vision_tpu_torch.core.sampling import Convention

METHODS = ("fused_pallas", "fused", "scan", "assoc")


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


def render_views(
    rgba_layers: torch.Tensor,
    tgt_poses: torch.Tensor,
    depths: torch.Tensor,
    intrinsics: torch.Tensor,
    convention: Convention = Convention.REF_HOMOGRAPHY,
    method: str = "fused",
    tgt_intrinsics: torch.Tensor | None = None,
    out_hw: tuple[int, int] | None = None,
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
                    method=method, tgt_intrinsics=k_t, out_hw=out_hw)


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
      composite (see core/compose.py).
    tgt_intrinsics: optional ``[B, 3, 3]`` target intrinsics (plain methods
      only, as in the JAX package).
    out_hw: optional ``(H_t, W_t)`` rendered-frame dims when they differ
      from the MPI's (plain methods only).

  Returns:
    ``[B, H_t, W_t, 3]`` rendered view (``H_t, W_t`` default to the MPI's).
  """
  if method not in METHODS:
    raise ValueError(f"unknown render method {method!r}; one of {METHODS}")
  planes = rgba_layers if planes_leading else rgba_layers.movedim(3, 0)
  _, _, h, w, _ = planes.shape

  if method == "fused_pallas":
    if tgt_intrinsics is not None or out_hw is not None:
      raise ValueError(
          "method='fused_pallas' does not support tgt_intrinsics/out_hw "
          "(cropped sources); use a plain method ('fused'/'scan').")
    from mpi_vision_tpu_torch.kernels import render_fused
    homs = render_fused.pixel_homographies(
        tgt_pose, depths, intrinsics, h, w, convention)   # [P, B, 3, 3]
    batched = planes.movedim(0, 1)                        # [B, P, H, W, 4]
    if batched.shape[0] == 1 or batched.stride(0) == 0:
      # One scene broadcast across the batch (render_views): hand the
      # kernel the scene once, with a view stride of 0. For a baked scene
      # this is its resident [P, H, W, 4] buffer, not a copy.
      batched = batched[0]
    return render_fused.render_mpi_fused(
        batched.contiguous(), homs.transpose(0, 1).contiguous())

  th, tw = (h, w) if out_hw is None else (int(out_hw[0]), int(out_hw[1]))
  homs = plane_homographies(tgt_pose, depths, intrinsics,
                            tgt_intrinsics=tgt_intrinsics)  # [P, B, 3, 3]

  if method != "fused":
    coords = warp_coordinates(homs, th, tw, convention,
                              src_height=h, src_width=w)
    warped = sampling.bilinear_sample(planes, coords)
    return compose.over_composite(warped, method=method)

  def warp_one(plane, hom):
    coords = warp_coordinates(hom, th, tw, convention,
                              src_height=h, src_width=w)
    return sampling.bilinear_sample(plane, coords)

  # Farthest plane: alpha ignored.
  out = warp_one(planes[0], homs[0])[..., :3]
  for p in range(1, planes.shape[0]):
    rgba = warp_one(planes[p], homs[p])
    rgb, alpha = rgba[..., :3], rgba[..., 3:]
    out = rgb * alpha + out * (1.0 - alpha)
  return out
