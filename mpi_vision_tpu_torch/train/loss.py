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
    bilinear resize (``F.interpolate(align_corners=False,
    antialias=False)``, the reference's resize).

Batch dicts follow the reference dataset contract with NHWC images:
``tgt_img_cfw`` [B,4,4] world->target-cam, ``ref_img_wfc`` [B,4,4]
ref-cam->world, ``tgt_img``/``ref_img`` [B,H,W,3] in [-1,1], ``intrinsics``
[B,3,3], ``mpi_planes`` [P] descending, or batched [B,P], whose row 0 is
used as the reference does.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from mpi_vision_tpu_torch.core import geometry, render
from mpi_vision_tpu_torch.core.sampling import Convention
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


def perceptual_loss(out: torch.Tensor, tgt: torch.Tensor,
                    vgg: vgg_lib.VGG16Features,
                    resize: int | None = 224) -> torch.Tensor:
  """The reference's perceptual loss between a rendered view and the
  target, both ``[B, H, W, 3]`` in [-1, 1]: pixel L1 + weighted VGG L1s."""
  x = vgg_lib.imagenet_normalize(out).permute(0, 3, 1, 2)
  y = vgg_lib.imagenet_normalize(tgt).permute(0, 3, 1, 2)
  if resize is not None and (x.shape[-2] != resize or x.shape[-1] != resize):
    x = F.interpolate(x, (resize, resize), mode="bilinear",
                      align_corners=False, antialias=False)
    y = F.interpolate(y, (resize, resize), mode="bilinear",
                      align_corners=False, antialias=False)
  loss = (x - y).abs().mean()                                 # cell 12:54
  for i, (fx, fy) in enumerate(zip(vgg(x), vgg(y))):
    loss = loss + (fx - fy).abs().mean() / (1.0 + i)          # cell 12:55-59
  return loss


def vgg_perceptual_loss(mpi_pred: torch.Tensor, batch: Batch,
                        vgg: vgg_lib.VGG16Features,
                        resize: int | None = 224,
                        convention: Convention = Convention.REF_HOMOGRAPHY,
                        method: str = "fused") -> torch.Tensor:
  """The reference training loss (cell 12): render, then
  ``perceptual_loss`` against the target."""
  out = render_novel_view(mpi_pred, batch, convention=convention,
                          method=method)
  return perceptual_loss(out, batch["tgt_img"], vgg, resize)
