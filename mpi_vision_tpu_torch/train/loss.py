"""Training and eval losses: the render sits inside the loss.

PyTorch counterpart of ``mpi_vision_tpu/train/loss.py``. The loss renders
a novel view through the full differentiable MPI pipeline and compares it
to the target photo, so the renderer's backward runs on every step.

  * ``render_novel_view`` — net output -> MPI -> relative pose -> rendered
    target view (notebook cell 12:38-42).
  * ``l2_render_loss`` — the reference's ``test_loss`` metric.
  * ``vgg_perceptual_loss`` — the training loss: the render, then
    ``perceptual_loss``: L1 on pixels plus L1 on four VGG16 feature blocks
    weighted ``1 / (1 + i)``, after ImageNet normalization and an optional
    bilinear resize (the reference's ``F.interpolate(align_corners=False,
    antialias=False)``, here as two small dense interpolation matrices
    applied as products: ``F.interpolate``'s bilinear backward adds with
    atomics on CUDA, a product's backward is another product, so the
    step stays deterministic at every size, as the bit-exact resume of
    ``train.loop.fit_resumable`` needs. ``jax.image.resize`` computes its
    resize the same way).

The render and the VGG features carry ``debug.named_scope`` ranges
(``loss/render``, ``loss/vgg``) where the JAX package has its
``jax.named_scope``s.

Batch dicts follow the reference dataset contract with NHWC images:
``tgt_img_cfw`` [B,4,4] world->target-cam, ``ref_img_wfc`` [B,4,4]
ref-cam->world, ``tgt_img``/``ref_img`` [B,H,W,3] in [-1,1], ``intrinsics``
[B,3,3], ``mpi_planes`` [P] descending, or batched [B,P], whose row 0 is
used as the reference does.
"""

from __future__ import annotations

from typing import Mapping

import torch

from mpi_vision_tpu_torch.core import geometry, render
from mpi_vision_tpu_torch.core.sampling import Convention
from mpi_vision_tpu_torch.debug import named_scope
from mpi_vision_tpu_torch.models.stereo_mag import mpi_from_net_output
from mpi_vision_tpu_torch.train import vgg as vgg_lib

Batch = Mapping[str, torch.Tensor]


def render_novel_view(mpi_pred: torch.Tensor, batch: Batch,
                      convention: Convention = Convention.REF_HOMOGRAPHY,
                      method: str = "fused") -> torch.Tensor:
  """Net output ``[B, H, W, 3 + 2P]`` -> rendered target view
  ``[B, H, W, 3]``. ``method="fused_pallas"`` renders through the CUDA
  kernel and its backward kernels (their plain versions on the CPU)."""
  rgba = mpi_from_net_output(mpi_pred, batch["ref_img"])     # [B,H,W,P,4]
  rel_pose = geometry.matmul_small(batch["tgt_img_cfw"], batch["ref_img_wfc"])
  planes = batch["mpi_planes"]
  if planes.dim() == 2:                # collated [B, P]: reference takes [0]
    planes = planes[0]
  return render.render_mpi(rgba, rel_pose, planes, batch["intrinsics"],
                           convention=convention, method=method)


def l2_render_loss(mpi_pred: torch.Tensor, batch: Batch,
                   convention: Convention = Convention.REF_HOMOGRAPHY,
                   method: str = "fused") -> torch.Tensor:
  """The reference's ``test_loss`` eval metric: MSE(rendered, target)."""
  out = render_novel_view(mpi_pred, batch, convention=convention,
                          method=method)
  return ((out - batch["tgt_img"]) ** 2).mean()


def resize_matrix(n_in: int, n_out: int,
                  device: "str | torch.device | None" = None
                  ) -> torch.Tensor:
  """``[n_out, n_in]`` f32 weights of a 1-D bilinear resize with
  half-pixel centres and no antialiasing (``F.interpolate(mode=
  "bilinear", align_corners=False)``'s taps): output ``i`` samples input
  ``max((i + 0.5) * n_in / n_out - 0.5, 0)`` between its two neighbours,
  the upper clamped to the edge."""
  src = ((torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out)
         - 0.5).clamp(min=0.0)
  lo = src.floor().long().clamp(max=n_in - 1)
  hi = (lo + 1).clamp(max=n_in - 1)
  frac = src - lo
  weights = torch.zeros(n_out, n_in, dtype=torch.float64)
  rows = torch.arange(n_out)
  weights.index_put_((rows, lo), 1.0 - frac, accumulate=True)
  weights.index_put_((rows, hi), frac, accumulate=True)
  return weights.to(device=device, dtype=torch.float32)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
  """NCHW ``x`` resized to ``size`` x ``size`` by the two products
  ``rows @ x @ cols^T`` of ``resize_matrix`` weights."""
  rows = resize_matrix(x.shape[-2], size, x.device)
  cols = resize_matrix(x.shape[-1], size, x.device)
  return rows @ x @ cols.T


def perceptual_loss(out: torch.Tensor, tgt: torch.Tensor,
                    vgg: vgg_lib.VGG16Features,
                    resize: int | None = 224) -> torch.Tensor:
  """The reference's perceptual loss between a rendered view and the
  target, both ``[B, H, W, 3]`` in [-1, 1]: pixel L1 + weighted VGG L1s."""
  x = vgg_lib.imagenet_normalize(out).permute(0, 3, 1, 2)
  y = vgg_lib.imagenet_normalize(tgt).permute(0, 3, 1, 2)
  if resize is not None and (x.shape[-2] != resize or x.shape[-1] != resize):
    x = resize_bilinear(x, resize)
    y = resize_bilinear(y, resize)
  loss = (x - y).abs().mean()                                 # cell 12:54
  with named_scope("loss/vgg"):
    feats_x, feats_y = vgg(x), vgg(y)
  for i, (fx, fy) in enumerate(zip(feats_x, feats_y)):
    loss = loss + (fx - fy).abs().mean() / (1.0 + i)          # cell 12:55-59
  return loss


def vgg_perceptual_loss(mpi_pred: torch.Tensor, batch: Batch,
                        vgg: vgg_lib.VGG16Features,
                        resize: int | None = 224,
                        convention: Convention = Convention.REF_HOMOGRAPHY,
                        method: str = "fused") -> torch.Tensor:
  """The reference training loss (cell 12): render, then
  ``perceptual_loss`` against the target."""
  with named_scope("loss/render"):
    out = render_novel_view(mpi_pred, batch, convention=convention,
                            method=method)
  return perceptual_loss(out, batch["tgt_img"], vgg, resize)
