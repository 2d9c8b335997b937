"""Bilinear image sampling with exact ``torch.nn.functional.grid_sample`` parity.

PyTorch counterpart of ``mpi_vision_tpu/core/sampling.py``: the same
gather-based sampler, written as plain tensor code so that each output
element is a fixed sequence of elementwise float32 operations. That keeps
a view's pixels independent of how many views share the call (the serving
layer's bit-identical batching invariant), which a library sampler does
not promise.

Coordinate pipeline: callers produce coords in a (0, 1) "normalized"
space (x, y last-dim order); ``grid_sample(align_corners=False)`` maps a
normalized coord to the pixel index ``c * size - 0.5``.

The three coordinate conventions of the reference:
  * homography path: ``c = (x/(H-1), y/(W-1))`` — an x/height, y/width swap,
    benign for square images only;
  * projection path: ``c = ((x+0.5)/H, (y+0.5)/W)`` — the same swap;
  * crop path: ``c = ((x+0.5)/W, (y+0.5)/H)`` — unswapped.
EXACT is the convention that is right for non-square frames.
"""

from __future__ import annotations

import enum

import torch


class Convention(enum.Enum):
  """How raw pixel coordinates are normalized into the (0, 1) sampler space."""

  # x/(H-1), y/(W-1): reference homography/render path.
  REF_HOMOGRAPHY = "ref_homography"
  # (x+0.5)/H, (y+0.5)/W: reference projection/plane-sweep path.
  REF_PROJECTION = "ref_projection"
  # (x+0.5)/W, (y+0.5)/H: correct for non-square images; equals REF_PROJECTION
  # on square inputs.
  EXACT = "exact"


def normalize_pixel_coords(
    coords_xy: torch.Tensor,
    height: int,
    width: int,
    convention: Convention = Convention.REF_HOMOGRAPHY,
) -> torch.Tensor:
  """Map raw pixel (x, y) coords into the sampler's (0, 1) space per convention."""
  if convention is Convention.REF_HOMOGRAPHY:
    scale = [height - 1, width - 1]
    offset = None
  elif convention is Convention.REF_PROJECTION:
    scale, offset = [height, width], 0.5
  elif convention is Convention.EXACT:
    scale, offset = [width, height], 0.5
  else:
    raise ValueError(f"unknown convention: {convention!r}")
  scale = torch.tensor(scale, dtype=coords_xy.dtype, device=coords_xy.device)
  return (coords_xy if offset is None else coords_xy + offset) / scale


def bilinear_sample(image: torch.Tensor, coords: torch.Tensor,
                    window: tuple | None = None) -> torch.Tensor:
  """Bilinearly sample ``image`` at normalized (0, 1) coords, zeros outside.

  Reproduces ``grid_sample(align_corners=False, padding_mode='zeros')``
  fed with ``-1 + 2 * coords``, including its treatment of out-of-range
  corners: each of the four gathered neighbours is zeroed on its own when
  it falls outside the image.

  Args:
    image: ``[..., H_s, W_s, C]``.
    coords: ``[..., H_t, W_t, 2]`` with (x, y) in (0, 1) space; leading dims
      broadcast against the image's.
    window: optional ``(y0, x0, full_h, full_w)``: ``image`` is the window
      ``[y0:y0 + H_s, x0:x0 + W_s]`` of a ``full_h x full_w`` image and
      ``coords`` are normalized in the full image. Each tap is computed in
      the full image's pixel space and moved by the integer origin, an
      exact float subtraction, so a tap inside the window reads the pixel,
      with the weights, of the full image's sample; taps outside it read
      zeros.

  Returns:
    ``[..., H_t, W_t, C]`` sampled image. A broadcast image (an ``expand``
    of one scene across views) is gathered through its strides, never
    copied per view.
  """
  h_s, w_s, chans = image.shape[-3], image.shape[-2], image.shape[-1]
  full_h, full_w = (h_s, w_s) if window is None else window[2:]
  lead = torch.broadcast_shapes(image.shape[:-3], coords.shape[:-3])
  image = image.expand(lead + image.shape[-3:])
  coords = coords.to(torch.float32).expand(lead + coords.shape[-3:])
  # (0,1) space -> pixel index: c * size - 0.5 (align_corners=False).
  px = coords[..., 0] * full_w - 0.5
  py = coords[..., 1] * full_h - 0.5
  if window is not None:
    px = px - window[1]
    py = py - window[0]

  x0f = torch.floor(px)
  y0f = torch.floor(py)
  wx = (px - x0f)[..., None]
  wy = (py - y0f)[..., None]
  x0 = x0f.to(torch.int64)
  y0 = y0f.to(torch.int64)
  x1 = x0 + 1
  y1 = y0 + 1

  # H and W merge into one axis as a view (they are adjacent in every
  # layout this module is handed), so each lookup is one gather.
  flat = image.reshape(lead + (h_s * w_s, chans))
  n_t = x0.shape[len(lead):].numel()  # target points per leading index

  def gather(ix, iy):
    valid = (ix >= 0) & (ix < w_s) & (iy >= 0) & (iy < h_s)
    idx = iy.clamp(0, h_s - 1) * w_s + ix.clamp(0, w_s - 1)
    idx = idx.reshape(lead + (n_t, 1)).expand(lead + (n_t, chans))
    taken = torch.gather(flat, -2, idx).reshape(x0.shape + (chans,))
    return taken * valid[..., None].to(image.dtype)

  v00 = gather(x0, y0)
  v01 = gather(x1, y0)
  v10 = gather(x0, y1)
  v11 = gather(x1, y1)

  top = v00 * (1.0 - wx) + v01 * wx
  bot = v10 * (1.0 - wx) + v11 * wx
  return top * (1.0 - wy) + bot * wy
