"""Projective geometry: homogeneous grids, plane-induced homographies, point transforms.

PyTorch counterpart of ``mpi_vision_tpu/core/geometry.py``. The JAX side
runs its 3x3 products at ``Precision.HIGHEST`` so no bf16 pass eats the f32
budget. Here every small matrix product is written out as elementwise
float32 multiply-adds (``matmul_small``) and the intrinsics inverse as a
back substitution (``inverse_intrinsics``), so no cuBLAS call, and hence
no TF32 path, is ever taken: the products stay true f32 on the card
whatever ``torch.backends.cuda.matmul.allow_tf32`` says. Elementwise arithmetic
also makes each matrix's result independent of the batch it is computed
in, which batched BLAS and LAPACK calls do not promise, and serving relies
on that for bit-identical frames whatever batch a request lands in.
"""

from __future__ import annotations

import torch

# Matches the reference's eps in divide_safe_torch.
SAFE_DIV_EPS = 1e-8


def matmul_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """``a @ b`` for small ``[..., n, k] x [..., k, m]`` matrices, batch-invariant.

  The sum over ``k`` runs left to right as separate elementwise multiplies
  and adds, so every entry is one fixed f32 expression.
  """
  out = a[..., :, 0:1] * b[..., 0:1, :]
  for j in range(1, a.shape[-1]):
    out = out + a[..., :, j:j + 1] * b[..., j:j + 1, :]
  return out


def inverse_intrinsics(k: torch.Tensor) -> torch.Tensor:
  """Inverse of upper-triangular ``[..., 3, 3]`` matrices (camera intrinsics).

  Back substitution against the identity with reciprocal diagonals: the
  operations, and so the roundings, of ``jnp.linalg.inv``'s triangular
  solve on such matrices, and a fixed elementwise expression per matrix
  (batch-invariant). Entries below the diagonal are taken to be zero.
  """
  a, b, c = k[..., 0, 0], k[..., 0, 1], k[..., 0, 2]
  e, f, i = k[..., 1, 1], k[..., 1, 2], k[..., 2, 2]
  ra, re, ri = 1.0 / a, 1.0 / e, 1.0 / i
  zero = torch.zeros_like(a)
  # Column j solves K x = e_j from the bottom row up.
  x12 = -(f * ri) * re
  cols = [
      (ra, zero, zero),
      (-(b * re) * ra, re, zero),
      ((-(b * x12) - c * ri) * ra, x12, ri),
  ]
  return torch.stack([torch.stack(col, -1) for col in cols], -1)


def homogeneous_grid(height: int, width: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
  """Homogeneous pixel grid ``[3, H, W]`` with rows (x, y, 1).

  x runs over [0, width-1] along the last axis, y over [0, height-1].
  """
  xs = torch.arange(width, dtype=dtype, device=device)
  ys = torch.arange(height, dtype=dtype, device=device)
  grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
  return torch.stack([grid_x, grid_y, torch.ones_like(grid_x)], dim=0)


def safe_divide(num: torch.Tensor, den: torch.Tensor,
                eps: float = SAFE_DIV_EPS) -> torch.Tensor:
  """Division that nudges exact zeros in ``den`` by ``eps``."""
  den = den.to(torch.float32)
  den = den + eps * (den == 0).to(torch.float32)
  return num.to(torch.float32) / den


def inverse_homography(
    k_s: torch.Tensor,
    k_t: torch.Tensor,
    rot: torch.Tensor,
    t: torch.Tensor,
    n_hat: torch.Tensor,
    a: torch.Tensor,
) -> torch.Tensor:
  """Plane-induced inverse homography mapping target pixels to source pixels.

  ``H = K_s (R^T + (R^T t n_hat R^T) / (a - n_hat R^T t)) K_t^{-1}``

  Args:
    k_s: source intrinsics, ``[..., 3, 3]``.
    k_t: target intrinsics, ``[..., 3, 3]``.
    rot: source-to-target rotation, ``[..., 3, 3]`` (p_t = R p_s + t).
    t: source-to-target translation, ``[..., 3, 1]``.
    n_hat: plane normal in the source frame, ``[..., 1, 3]``.
    a: plane displacement (n_hat . p_s + a = 0), ``[..., 1, 1]``.

  Returns:
    ``[..., 3, 3]`` inverse homographies.
  """
  rot_t = rot.transpose(-1, -2)
  k_t_inv = inverse_intrinsics(k_t)
  rot_t_t = matmul_small(rot_t, t)
  denom = a - matmul_small(n_hat, rot_t_t)
  numerator = matmul_small(matmul_small(rot_t_t, n_hat), rot_t)
  middle = rot_t + safe_divide(numerator, denom)
  return matmul_small(matmul_small(k_s, middle), k_t_inv)


def apply_homography(points: torch.Tensor,
                     homography: torch.Tensor) -> torch.Tensor:
  """Apply ``[..., 3, 3]`` homographies to ``[..., H, W, 3]`` points."""
  h = homography[..., None, None, :, :]  # [..., 1, 1, 3, 3]
  rows = []
  for i in range(3):
    row = h[..., i, 0] * points[..., 0]
    row = row + h[..., i, 1] * points[..., 1]
    rows.append(row + h[..., i, 2] * points[..., 2])
  return torch.stack(rows, dim=-1)


def from_homogeneous(points: torch.Tensor) -> torch.Tensor:
  """(u, v, w) -> (u/w, v/w) with a safe divide."""
  return safe_divide(points[..., :-1], points[..., -1:])


def pose_rt(pose: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  """Split ``[..., 4, 4]`` poses into rotation ``[..., 3, 3]`` and translation ``[..., 3, 1]``."""
  return pose[..., :3, :3], pose[..., :3, 3:]


def relative_pose(src_world_to_cam: torch.Tensor,
                  tgt_world_to_cam: torch.Tensor) -> torch.Tensor:
  """Transform taking points in the src camera frame to the tgt camera frame.

  ``rel = tgt_w2c @ inv(src_w2c)``.
  """
  return matmul_small(tgt_world_to_cam, torch.linalg.inv(src_world_to_cam))


def intrinsics_to_4x4(intrinsics: torch.Tensor) -> torch.Tensor:
  """Pad ``[..., 3, 3]`` intrinsics to ``[..., 4, 4]`` with a bottom-right identity."""
  k4 = intrinsics.new_zeros(intrinsics.shape[:-2] + (4, 4))
  k4[..., :3, :3] = intrinsics
  k4[..., 3, 3] = 1.0
  return k4
