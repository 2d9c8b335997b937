"""Plain reference of the MPI render, float64.

One target view of a multi-plane image, as the stereo-magnification paper
(Zhou et al., SIGGRAPH 2018) and the reference notebook define it:

  1. each plane at depth d (normal [0, 0, 1] in the source camera) induces
     the homography ``K (R^T + R^T t n R^T / (-d - n R^T t)) K^-1`` from
     target pixels to source pixels, for the pose ``[R | t]`` that takes
     source-camera points to the target camera;
  2. every target pixel samples its plane bilinearly, each of the four
     taps reading zero where it falls outside the image
     (``grid_sample(align_corners=False, padding_mode="zeros")``);
  3. the planes composite back to front with "over", the farthest plane's
     alpha ignored.

``convention`` says how a source position becomes a sampler pixel:
``"exact"`` keeps it (pixel centres at integers), ``"ref_homography"`` is
the notebook's ``x / (H - 1), y / (W - 1)`` normalisation, whose axis swap
is benign on square images. The homographies are NumPy float64, the
sampling and compositing PyTorch float64 on whatever device the planes
are; gradients flow to the planes.
"""

from __future__ import annotations

import numpy as np
import torch

CONVENTIONS = ("exact", "ref_homography")


def plane_homographies(pose, depths, k) -> np.ndarray:
  """``[P, 3, 3]`` float64 maps from target pixels to source pixels."""
  pose = np.asarray(pose, np.float64)
  k = np.asarray(k, np.float64)
  rt = pose[:3, :3].T
  rtt = rt @ pose[:3, 3:4]
  n = np.array([[0.0, 0.0, 1.0]])
  k_inv = np.linalg.inv(k)
  out = []
  for depth in np.asarray(depths, np.float64):
    middle = rt + (rtt @ n @ rt) / (-depth - (n @ rtt)[0, 0])
    out.append(k @ middle @ k_inv)
  return np.stack(out)


def sample_positions(hom: np.ndarray, height: int, width: int,
                     convention: str, device) -> tuple:
  """Sampler pixel coordinates ``(px, py)``, each ``[H, W]`` float64, of
  every target pixel under one homography."""
  if convention not in CONVENTIONS:
    raise ValueError(f"convention must be one of {CONVENTIONS}")
  h = torch.as_tensor(hom, dtype=torch.float64, device=device)
  ys, xs = torch.meshgrid(
      torch.arange(height, dtype=torch.float64, device=device),
      torch.arange(width, dtype=torch.float64, device=device), indexing="ij")
  u = h[0, 0] * xs + h[0, 1] * ys + h[0, 2]
  v = h[1, 0] * xs + h[1, 1] * ys + h[1, 2]
  w = h[2, 0] * xs + h[2, 1] * ys + h[2, 2]
  sx, sy = u / w, v / w
  if convention == "exact":
    return sx, sy
  return sx * width / (height - 1) - 0.5, sy * height / (width - 1) - 0.5


def bilinear(image: torch.Tensor, px: torch.Tensor,
             py: torch.Tensor) -> torch.Tensor:
  """``image [H, W, C]`` sampled at ``(px, py)``: ``[H', W', C]``; taps
  outside the image read zero."""
  height, width, chans = image.shape
  flat = image.reshape(height * width, chans)
  x0, y0 = torch.floor(px), torch.floor(py)
  wx, wy = (px - x0)[..., None], (py - y0)[..., None]
  x0, y0 = x0.long(), y0.long()

  def tap(ix, iy):
    inside = (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
    idx = (iy.clamp(0, height - 1) * width + ix.clamp(0, width - 1))
    return flat[idx.reshape(-1)].reshape(ix.shape + (chans,)) * inside[
        ..., None]

  top = tap(x0, y0) * (1 - wx) + tap(x0 + 1, y0) * wx
  bottom = tap(x0, y0 + 1) * (1 - wx) + tap(x0 + 1, y0 + 1) * wx
  return top * (1 - wy) + bottom * wy


def render(planes: torch.Tensor, pose, depths, k,
           convention: str = "exact") -> torch.Tensor:
  """One view: ``planes [P, H, W, 4]`` (back to front, any float dtype)
  under ``pose [4, 4]`` -> ``[H, W, 3]`` float64 on the planes' device."""
  num_planes, height, width, _ = planes.shape
  homs = plane_homographies(pose, depths, k)
  out = None
  for p in range(num_planes):
    px, py = sample_positions(homs[p], height, width, convention,
                              planes.device)
    rgba = bilinear(planes[p].to(torch.float64), px, py)
    if out is None:
      out = rgba[..., :3]
    else:
      alpha = rgba[..., 3:]
      out = rgba[..., :3] * alpha + out * (1 - alpha)
  return out
