"""Back-to-front alpha "over" compositing of MPI planes.

PyTorch counterpart of ``mpi_vision_tpu/core/compose.py``. Planes run back
(index 0) to front, and the first (farthest) plane's alpha is ignored
(treated as 1):

    out_0 = rgb_0
    out_i = rgb_i * a_i + out_{i-1} * (1 - a_i)

  * ``method='scan'``  — a loop over the plane axis.
  * ``method='assoc'`` — each plane is the affine map out -> rgb*a + (1-a)*out;
    affine maps compose associatively, so the planes reduce pairwise in
    log depth.
  * ``method='pallas'`` — the hand-written CUDA compose kernel
    (``kernels/compose_over.py``, the counterpart of the JAX package's
    Pallas ``kernels/compose_pallas.py``): CUDA tensors launch it, CPU
    tensors run its plain version, this module's scan.
"""

from __future__ import annotations

import torch


def _split(rgba: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
  return rgba[..., :3], rgba[..., 3:]


def over_composite_scan(rgba: torch.Tensor) -> torch.Tensor:
  """Loop over planes. ``rgba``: ``[P, ..., 4]`` back-to-front -> ``[..., 3]``."""
  out, _ = _split(rgba[0])  # farthest plane: alpha ignored
  for p in range(1, rgba.shape[0]):
    rgb, alpha = _split(rgba[p])
    out = rgb * alpha + out * (1.0 - alpha)
  return out


def plane_affine(rgba: torch.Tensor, first_opaque: bool = True
                 ) -> tuple[torch.Tensor, torch.Tensor]:
  """Planes as affine maps ``out -> B + A * out``: returns ``(A, B)`` each ``[P, ..., *]``.

  ``A = 1 - alpha`` (``[P, ..., 1]``), ``B = rgb * alpha`` (``[P, ..., 3]``).
  With ``first_opaque`` the farthest plane gets A=0, B=rgb — the reference's
  ignore-first-alpha behavior.
  """
  rgb, alpha = _split(rgba)
  coeff = 1.0 - alpha
  offset = rgb * alpha
  if first_opaque:
    coeff = torch.cat([torch.zeros_like(coeff[:1]), coeff[1:]])
    offset = torch.cat([rgb[:1], offset[1:]])
  return coeff, offset


def combine_affine(first, second):
  """Compose two batched affine maps, ``first`` applied before ``second``.

  ``(A1,B1) then (A2,B2)``: out -> B2 + A2*(B1 + A1*out) = (A1*A2, B1*A2 + B2).
  """
  a1, b1 = first
  a2, b2 = second
  return a1 * a2, b1 * a2 + b2


def over_composite_assoc(rgba: torch.Tensor) -> torch.Tensor:
  """Log-depth pairwise composite. Same contract as ``over_composite_scan``."""
  coeff, offset = plane_affine(rgba)
  while coeff.shape[0] > 1:
    n = coeff.shape[0] // 2 * 2
    a, b = combine_affine((coeff[0:n:2], offset[0:n:2]),
                          (coeff[1:n:2], offset[1:n:2]))
    coeff = torch.cat([a, coeff[n:]])
    offset = torch.cat([b, offset[n:]])
  # Farthest plane has A=0, so the composed offset IS the composite.
  return offset[0]


def over_composite(rgba: torch.Tensor, method: str = "scan") -> torch.Tensor:
  """Composite ``[P, ..., 4]`` back-to-front RGBA planes to ``[..., 3]`` RGB.

  ``method``: 'scan' (default), 'assoc', or 'pallas' (the CUDA kernel of
  ``kernels/compose_over.py``; float32 or bfloat16, ``[P, ..., 4]``).
  """
  if method == "scan":
    return over_composite_scan(rgba)
  if method == "assoc":
    return over_composite_assoc(rgba)
  if method == "pallas":
    from mpi_vision_tpu_torch.kernels import compose_over

    return compose_over.over_composite_pallas(rgba)
  raise ValueError(f"unknown composite method: {method!r}")
