"""Dataclass configs with the reference's hyperparameters as the defaults.

PyTorch counterpart of ``mpi_vision_tpu/config.py``. ``TrainConfig()`` is
the reference run: 224 px images, 10 planes at depths 1 -> 100, batch 1,
Adam at lr 2e-4 for 20 epochs, VGG-perceptual loss with resize 224, the
U-Net with InstanceNorm. ``TrainConfig.scaled_480()`` is the larger
configuration the reference mentions (480 px, 33 planes).

The step is f32. PyTorch lets cuDNN run f32 convolutions in TF32 by
default; the trainer turns that off with ``TrainConfig.set_precision``.
Nothing here changes global state on import.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
  """The RealEstate10K-reduced pipeline (notebook cells 6/8)."""

  dataset_path: str = "."
  img_size: int = 224
  num_planes: int = 10
  depth_near: float = 1.0
  depth_far: float = 100.0
  min_dist: float = 16e3
  max_dist: float = 500e3
  batch_size: int = 1

  def make_dataset(self, is_valid: bool = False, rng=None, scenes=None,
                   device: "str | torch.device | None" = None):
    """A ``RealEstateDataset`` building its examples on ``device`` (default
    the card; raises without one unless ``"cpu"``); ``scenes`` reuses an
    already walked scene list."""
    from mpi_vision_tpu_torch.data.realestate import RealEstateDataset

    return RealEstateDataset(
        self.dataset_path, is_valid=is_valid, min_dist=self.min_dist,
        max_dist=self.max_dist, img_size=self.img_size,
        num_planes=self.num_planes,
        rng=rng if rng is not None else np.random.default_rng(),
        scenes=scenes, device=device)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
  """The reference training run (cells 14-16)."""

  data: DataConfig = DataConfig()
  learning_rate: float = 2e-4
  epochs: int = 20
  vgg_resize: int | None = 224
  norm: str | None = "instance"

  @classmethod
  def scaled_480(cls) -> "TrainConfig":
    """The cell-7 markdown's larger configuration: 480 px, 33 planes."""
    return cls(data=DataConfig(img_size=480, num_planes=33))

  def set_precision(self) -> None:
    """Make the step f32 through PyTorch's global switches: cuDNN TF32
    (on by default) and TF32 matmuls off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

  def make_train_state(self, seed: int = 0,
                       device: "str | torch.device | None" = None):
    """The U-Net and Adam on ``device`` (see ``train.loop``)."""
    from mpi_vision_tpu_torch.train.loop import create_train_state

    return create_train_state(
        seed, num_planes=self.data.num_planes,
        learning_rate=self.learning_rate, norm=self.norm, device=device)

  def model_meta(self) -> dict:
    """The manifest ``model`` block: what a checkpoint's arrays were
    trained as."""
    return {
        "num_planes": self.data.num_planes,
        "img_size": self.data.img_size,
        "norm": self.norm,
        "depth_near": self.data.depth_near,
        "depth_far": self.data.depth_far,
    }

  def make_vgg(self, device: "str | torch.device | None" = None):
    """The perceptual loss's VGG16 features on ``device``: the checkpoint
    ``MPI_VISION_VGG16_CKPT`` names, else fixed random features
    (``train.vgg.default_params``, which raises on a checkpoint it cannot
    read)."""
    from mpi_vision_tpu_torch.device import resolve_device
    from mpi_vision_tpu_torch.train.vgg import VGG16Features

    return VGG16Features().to(resolve_device(device))

  def make_train_step(self, vgg=None, method: str = "fused_pallas"):
    """The Adam step with the reference loss (``vgg=None``: the L2 metric
    loss), rendered by ``method``: ``"fused_pallas"`` through the CUDA
    kernels forward and backward, ``"fused"`` through the plain per-plane
    loop."""
    from mpi_vision_tpu_torch.train.loop import make_train_step

    return make_train_step(vgg, resize=self.vgg_resize, method=method)

  def make_eval_step(self, vgg=None, method: str = "fused_pallas"):
    """The loss-only step on the same loss surface as ``make_train_step``."""
    from mpi_vision_tpu_torch.train.loop import make_eval_step

    return make_eval_step(vgg, resize=self.vgg_resize, method=method)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
  """Novel-view rendering defaults (the 1080p x 32-plane north-star)."""

  num_planes: int = 32
  depth_near: float = 1.0
  depth_far: float = 100.0
  fov_deg: float = 60.0

  def depths(self, device=None) -> torch.Tensor:
    from mpi_vision_tpu_torch.core.camera import inv_depths

    return inv_depths(self.depth_near, self.depth_far, self.num_planes,
                      device=device)
