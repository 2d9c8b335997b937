"""Plane-sweep volumes: depth-based projective inverse warping.

PyTorch counterpart of ``mpi_vision_tpu/core/sweep.py``: the reference
projection path (``pixel2cam`` -> ``cam2pixel`` -> bilinear sampler) with
all P depth hypotheses as one leading axis, no loop over planes. The small
matrix products are elementwise f32 sums (``geometry.matmul_small`` and
``_apply``), so no cuBLAS or TF32 path is taken on the card; the JAX side
runs them at ``Precision.HIGHEST``. The 4x4 pose inverses go through
``torch.linalg.inv``, where the JAX side uses ``jnp.linalg.inv``: the two
LU solves round differently by an ulp or so, which the tests bound.
"""

from __future__ import annotations

import torch

from mpi_vision_tpu_torch.core import geometry, sampling
from mpi_vision_tpu_torch.core.sampling import Convention


def _apply(mat: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
  """``einsum("...ij,...jhw->...ihw")`` as elementwise f32 sums, left to
  right over ``j``."""
  rows = []
  for i in range(mat.shape[-2]):
    row = mat[..., i, 0, None, None] * vecs[..., 0, :, :]
    for j in range(1, mat.shape[-1]):
      row = row + mat[..., i, j, None, None] * vecs[..., j, :, :]
    rows.append(row)
  return torch.stack(rows, dim=-3)


def pixel2cam(depth: torch.Tensor, pixel_coords: torch.Tensor,
              intrinsics: torch.Tensor, homogeneous: bool = True
              ) -> torch.Tensor:
  """Pixel frame -> camera frame: ``K^-1 p * depth``.

  ``depth``: ``[..., H, W]``; ``pixel_coords``: ``[..., 3, H, W]``;
  ``intrinsics``: ``[..., 3, 3]`` (leading dims broadcast). Returns
  ``[..., 3 (or 4), H, W]``.
  """
  cam = _apply(geometry.inverse_intrinsics(intrinsics), pixel_coords)
  cam = cam * depth[..., None, :, :]
  if homogeneous:
    cam = torch.cat([cam, torch.ones_like(cam[..., :1, :, :])], dim=-3)
  return cam


def cam2pixel(cam_coords: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
  """Camera frame -> pixel (x, y) via a 4x4 projection.

  ``cam_coords``: ``[..., 4, H, W]``; ``proj``: ``[..., 4, 4]``. Returns
  ``[..., H, W, 2]``; the +1e-10 z-guard is the reference's.
  """
  unnorm = _apply(proj, cam_coords)
  xy = unnorm[..., :2, :, :] / (unnorm[..., 2:3, :, :] + 1e-10)
  return xy.movedim(-3, -1)


def projective_inverse_warp(
    img: torch.Tensor,
    depth: torch.Tensor,
    pose: torch.Tensor,
    intrinsics: torch.Tensor,
    tgt_intrinsics: torch.Tensor | None = None,
    tgt_size: tuple[int, int] | None = None,
    convention: Convention = Convention.REF_PROJECTION,
    ret_coords: bool = False,
):
  """Inverse-warp a source image onto the target image plane at a depth map.

  Args:
    img: source image ``[B, H_s, W_s, C]``.
    depth: target-view depth map ``[..., B, H_t, W_t]`` (leading dims, e.g.
      depth hypotheses, broadcast through).
    pose: ``[B, 4, 4]`` target-cam -> source-cam transform.
    intrinsics: ``[B, 3, 3]`` source intrinsics.
    tgt_intrinsics: optional separate target intrinsics (default: source).
    tgt_size: optional (H_t, W_t); defaults to the depth map's.
    convention: REF_PROJECTION reproduces the reference; EXACT is the
      non-square-correct variant.
    ret_coords: also return the normalized sampling coords.

  Returns:
    ``[..., B, H_t, W_t, C]`` warped image (plus coords if requested).
  """
  b, h_s, w_s = img.shape[0], img.shape[1], img.shape[2]
  h_t, w_t = tgt_size if tgt_size is not None else depth.shape[-2:]
  k_t = intrinsics if tgt_intrinsics is None else tgt_intrinsics
  grid = geometry.homogeneous_grid(h_t, w_t, device=img.device).expand(
      b, 3, h_t, w_t)
  cam = pixel2cam(depth, grid, k_t)
  proj = geometry.matmul_small(geometry.intrinsics_to_4x4(intrinsics), pose)
  src_xy = cam2pixel(cam, proj)
  # Normalization uses the SOURCE image size (the gather target), as the
  # reference does.
  coords = sampling.normalize_pixel_coords(src_xy, h_s, w_s, convention)
  warped = sampling.bilinear_sample(img, coords)
  if ret_coords:
    return warped, coords
  return warped


def plane_sweep(
    img: torch.Tensor,
    depth_planes: torch.Tensor,
    pose: torch.Tensor,
    intrinsics: torch.Tensor,
    tgt_intrinsics: torch.Tensor | None = None,
    tgt_size: tuple[int, int] | None = None,
    convention: Convention = Convention.REF_PROJECTION,
    stacked: bool = False,
) -> torch.Tensor:
  """Plane-sweep volume: warp ``img`` at P constant-depth hypotheses.

  ``img``: ``[B, H, W, C]``; ``depth_planes``: ``[P]``. Returns
  ``[B, H, W, P*C]`` channel-concatenated plane-major (the reference
  layout), or ``[P, B, H, W, C]`` when ``stacked``.
  """
  b = img.shape[0]
  h_t, w_t = tgt_size if tgt_size is not None else img.shape[1:3]
  p = depth_planes.shape[0]
  depth_maps = depth_planes.reshape(p, 1, 1, 1).expand(p, b, h_t, w_t)
  volume = projective_inverse_warp(
      img, depth_maps, pose, intrinsics, tgt_intrinsics=tgt_intrinsics,
      tgt_size=(h_t, w_t), convention=convention)        # [P, B, H, W, C]
  if stacked:
    return volume
  return volume.movedim(0, 3).reshape(b, h_t, w_t, -1)


def plane_sweep_one(img: torch.Tensor, depth_planes: torch.Tensor,
                    pose: torch.Tensor, intrinsics: torch.Tensor,
                    **kwargs) -> torch.Tensor:
  """Unbatched wrapper: ``img [H, W, C]`` -> ``[1, H, W, P*C]`` (batch dim
  kept, as in the reference)."""
  return plane_sweep(img[None], depth_planes, pose[None], intrinsics[None],
                     **kwargs)


def projective_pixel_transform(
    depth: torch.Tensor,
    src_pixel_coords: torch.Tensor,
    src_pose: torch.Tensor,
    tgt_pose: torch.Tensor,
    src_intrinsics: torch.Tensor,
    tgt_intrinsics: torch.Tensor,
) -> torch.Tensor:
  """Project source-camera pixels into target-camera pixels.

  ``depth``: ``[B, H, W]`` (source view); ``src_pixel_coords``:
  ``[B, 3, H, W]``; poses are world-to-camera ``[B, 4, 4]``. Returns
  ``[B, H, W, 2]`` target pixel coords.
  """
  cam = pixel2cam(depth, src_pixel_coords, src_intrinsics)
  src_to_tgt = geometry.matmul_small(tgt_pose, torch.linalg.inv(src_pose))
  proj = geometry.matmul_small(geometry.intrinsics_to_4x4(tgt_intrinsics),
                               src_to_tgt)
  return cam2pixel(cam, proj)


def format_network_input(
    ref_image: torch.Tensor,
    src_images: torch.Tensor,
    ref_pose: torch.Tensor,
    src_poses: torch.Tensor,
    planes: torch.Tensor,
    intrinsics: torch.Tensor,
    **kwargs,
) -> torch.Tensor:
  """Multi-source network input: reference image ++ one PSV per source.

  Each source image is swept in the reference camera's frame (relative pose
  ``src_pose @ ref_pose^-1``) and the volumes are channel-concatenated
  after the reference image, in source order.

  Args:
    ref_image: ``[B, H, W, 3]``.
    src_images: ``[N, B, H, W, 3]``.
    ref_pose: ``[B, 4, 4]`` world-to-camera.
    src_poses: ``[N, B, 4, 4]`` world-to-camera.
    planes: ``[P]`` descending plane depths.
    intrinsics: ``[B, 3, 3]``.
    **kwargs: forwarded to ``plane_sweep`` (e.g. ``convention``).

  Returns:
    ``[B, H, W, 3 + 3*P*N]``.
  """
  rel = geometry.matmul_small(src_poses, torch.linalg.inv(ref_pose)[None])
  psvs = torch.stack([plane_sweep(img, planes, pose, intrinsics, **kwargs)
                      for img, pose in zip(src_images, rel)])
  n, b, h, w, _ = psvs.shape
  stacked = psvs.movedim(0, 3).reshape(b, h, w, -1)
  return torch.cat([ref_image, stacked], dim=-1)
