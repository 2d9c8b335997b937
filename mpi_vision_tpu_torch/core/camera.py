"""Camera intrinsics, depth-plane spacing, and image pre/de-processing.

PyTorch counterpart of ``mpi_vision_tpu/core/camera.py``: intrinsics,
depth spacing and the image pre/de-processing the training path uses (the
crop and space-to-depth helpers are not ported yet).
"""

from __future__ import annotations

import torch


def intrinsics_matrix(fx, fy, cx, cy, dtype=torch.float32,
                      device=None) -> torch.Tensor:
  """3x3 K from scalars (or equal-shaped tensors, giving ``[..., 3, 3]``)."""
  fx, fy, cx, cy = (torch.as_tensor(v, dtype=dtype, device=device)
                    for v in (fx, fy, cx, cy))
  zero = torch.zeros_like(fx)
  one = torch.ones_like(fx)
  return torch.stack([
      torch.stack([fx, zero, cx], dim=-1),
      torch.stack([zero, fy, cy], dim=-1),
      torch.stack([zero, zero, one], dim=-1),
  ], dim=-2)


def scale_intrinsics(intrinsics: torch.Tensor, height, width) -> torch.Tensor:
  """Scale K elementwise by ``[[w, 1, w], [0, h, h], [0, 0, 1]]``."""
  scale = torch.tensor(
      [[width, 1.0, width], [0.0, height, height], [0.0, 0.0, 1.0]],
      dtype=intrinsics.dtype, device=intrinsics.device)
  return intrinsics * scale


def inv_depths(start_depth: float, end_depth: float, num_depths: int,
               device=None) -> torch.Tensor:
  """Depths uniform in inverse depth, endpoints included, descending (far first).

  Back-to-front compositing order.
  """
  fractions = (torch.arange(1, num_depths - 1, dtype=torch.float32,
                            device=device) / (num_depths - 1))
  inv_start = 1.0 / start_depth
  inv_end = 1.0 / end_depth
  interior = 1.0 / (inv_start + (inv_end - inv_start) * fractions)
  depths = torch.cat([
      torch.tensor([start_depth, end_depth], dtype=torch.float32,
                   device=device), interior])
  return torch.sort(depths, descending=True).values


def preprocess_image(image: torch.Tensor) -> torch.Tensor:
  """float [0, 1] -> [-1, 1]."""
  return image * 2.0 - 1.0


def deprocess_image(image: torch.Tensor) -> torch.Tensor:
  """[-1, 1] -> uint8 [0, 255] (truncating, as ``astype(uint8)``)."""
  return (((image + 1.0) / 2.0) * 255.0).to(torch.uint8)
