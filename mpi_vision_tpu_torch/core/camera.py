"""Camera intrinsics, depth-plane spacing, and image pre/de-processing.

PyTorch counterpart of ``mpi_vision_tpu/core/camera.py``: intrinsics,
depth spacing, the image pre/de-processing the training path uses, and
the reference's crop and space-to-depth helpers (NHWC, as in the JAX
package).
"""

from __future__ import annotations

import torch

from mpi_vision_tpu_torch.core import geometry, sampling


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


def space_to_depth(image: torch.Tensor, block_size: int) -> torch.Tensor:
  """``[..., H, W, C] -> [..., H/b, W/b, C*b*b]`` (NHWC).

  Output channel ``c*b*b + dy*b + dx`` — torch's unfold order, the
  reference ``SpaceToDepth`` module's — which makes it the exact inverse
  of ``depth_to_space`` (``PixelShuffle`` order).
  """
  b = block_size
  *lead, h, w, c = image.shape
  if h % b or w % b:
    raise ValueError(f"H, W must be divisible by block_size {b}; got {h}x{w}")
  x = image.reshape(*lead, h // b, b, w // b, b, c)
  n = len(lead)
  # (..., hb, dy, wb, dx, c) -> (..., hb, wb, c, dy, dx)
  x = x.permute(*range(n), n, n + 2, n + 4, n + 1, n + 3)
  return x.reshape(*lead, h // b, w // b, c * b * b)


def depth_to_space(image: torch.Tensor, block_size: int) -> torch.Tensor:
  """``[..., H, W, C*b*b] -> [..., H*b, W*b, C]`` (NHWC): input channel
  ``c*b*b + dy*b + dx`` goes to offset (dy, dx) of output channel c
  (``PixelShuffle`` order). Inverse of ``space_to_depth``."""
  b = block_size
  *lead, h, w, cbb = image.shape
  if cbb % (b * b):
    raise ValueError(f"channels {cbb} not divisible by block_size^2 {b * b}")
  c = cbb // (b * b)
  x = image.reshape(*lead, h, w, c, b, b)
  n = len(lead)
  # (..., h, w, c, dy, dx) -> (..., h, dy, w, dx, c)
  x = x.permute(*range(n), n, n + 3, n + 1, n + 4, n + 2)
  return x.reshape(*lead, h * b, w * b, c)


def crop_to_bounding_box(image: torch.Tensor, offset_y, offset_x,
                         height: int, width: int) -> torch.Tensor:
  """Differentiable crop through the bilinear sampler.

  Samples ``((x + offset_x + 0.5)/W_img, (y + offset_y + 0.5)/H_img)`` —
  the reference's (unswapped) crop convention. ``image``: ``[..., H, W,
  C]``; offsets may be fractional. Returns ``[..., height, width, C]``.
  """
  img_h, img_w = image.shape[-3], image.shape[-2]
  grid = geometry.homogeneous_grid(height, width, device=image.device)
  xy = grid[:2].movedim(0, -1)  # [h, w, 2] (x, y)
  offset = torch.stack([
      torch.as_tensor(offset_x, dtype=torch.float32, device=image.device)
      + 0.5,
      torch.as_tensor(offset_y, dtype=torch.float32, device=image.device)
      + 0.5])
  coords = (xy + offset) / torch.tensor([img_w, img_h], dtype=torch.float32,
                                        device=image.device)
  coords = coords.expand(image.shape[:-3] + coords.shape)
  return sampling.bilinear_sample(image, coords)


def crop_image_and_adjust_intrinsics(
    image: torch.Tensor, intrinsics: torch.Tensor,
    offset_y, offset_x, height: int, width: int,
) -> tuple[torch.Tensor, torch.Tensor]:
  """Crop images and shift/renormalize the (normalized) intrinsics to
  match: K to pixels, (cx, cy) minus the offset, back to the crop's
  normalized frame."""
  orig_h, orig_w = image.shape[-3], image.shape[-2]
  pixel_k = scale_intrinsics(intrinsics, orig_h, orig_w)
  shift = torch.zeros_like(pixel_k)
  shift[..., 0, 2] = torch.as_tensor(offset_x, dtype=pixel_k.dtype)
  shift[..., 1, 2] = torch.as_tensor(offset_y, dtype=pixel_k.dtype)
  cropped_k = scale_intrinsics(pixel_k - shift, 1.0 / height, 1.0 / width)
  cropped = crop_to_bounding_box(image, offset_y, offset_x, height, width)
  return cropped, cropped_k
