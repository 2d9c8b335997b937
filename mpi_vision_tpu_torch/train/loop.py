"""Training loop: the Adam train step and a minimal epoch driver.

PyTorch counterpart of the single-device part of
``mpi_vision_tpu/train/loop.py``. There the step is a pure jitted
``(state, batch) -> (state, metrics)``; here ``TrainState`` holds the model
and a ``torch.optim.Adam`` whose defaults are optax's (b1 0.9, b2 0.999,
eps 1e-8), and the step updates it in place and returns it, so callers
read the same shape of code.

  * ``make_loss_fn`` — VGG-perceptual loss (or L2) with the render inside;
    ``method="fused_pallas"`` renders through the CUDA kernels, forward and
    backward, ``"fused"`` through the plain per-plane loop.
  * ``make_train_step`` / ``make_eval_step`` / ``evaluate`` / ``fit``.

Not ported yet: the sharded steps, ``lr_find``, ``fit_resumable`` and the
checkpoint store.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping

import torch

from mpi_vision_tpu_torch.device import resolve_device
from mpi_vision_tpu_torch.models.stereo_mag import StereoMagnificationModel
from mpi_vision_tpu_torch.train import loss as loss_lib
from mpi_vision_tpu_torch.train import vgg as vgg_lib

Batch = Mapping[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
  """The model, its Adam state, and the count of optimizer steps taken."""

  model: StereoMagnificationModel
  optimizer: torch.optim.Adam
  step: int = 0


def create_train_state(seed: int = 0, num_planes: int = 10,
                       learning_rate: float = 2e-4,
                       norm: str | None = "instance",
                       device: "str | torch.device | None" = None
                       ) -> TrainState:
  """A fresh model (PyTorch's default init drawn under ``seed``, leaving
  the global generator as it was) and Adam at ``learning_rate``, on
  ``device`` (default the card; raises without one unless ``"cpu"``)."""
  device = resolve_device(device)
  with torch.random.fork_rng(devices=[]):
    torch.manual_seed(seed)
    model = StereoMagnificationModel(num_planes=num_planes, norm=norm)
  model.to(device)
  optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
  return TrainState(model=model, optimizer=optimizer)


def make_loss_fn(vgg: vgg_lib.VGG16Features | None,
                 resize: int | None = 224,
                 method: str = "fused") -> Callable[[torch.nn.Module, Batch],
                                                    torch.Tensor]:
  """``(model, batch) -> loss``: VGG-perceptual when ``vgg`` is given,
  else L2."""

  def loss_fn(model, batch):
    mpi_pred = model(batch["net_input"])
    if vgg is None:
      return loss_lib.l2_render_loss(mpi_pred, batch, method=method)
    return loss_lib.vgg_perceptual_loss(mpi_pred, batch, vgg, resize,
                                        method=method)

  return loss_fn


def make_train_step(vgg: vgg_lib.VGG16Features | None = None,
                    resize: int | None = 224, method: str = "fused"):
  """A ``(state, batch) -> (state, {"loss": tensor})`` Adam step. The loss
  stays a device tensor (no synchronise); ``state`` is updated in place."""
  loss_fn = make_loss_fn(vgg, resize, method)

  def step(state: TrainState, batch: Batch):
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(state.model, batch)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return state, {"loss": loss.detach()}

  return step


def make_eval_step(vgg: vgg_lib.VGG16Features | None = None,
                   resize: int | None = 224, method: str = "fused"):
  """A loss-only ``(state, batch) -> loss`` step on the same loss surface
  as ``make_train_step``, without gradients."""
  loss_fn = make_loss_fn(vgg, resize, method)

  def step(state: TrainState, batch: Batch) -> torch.Tensor:
    with torch.no_grad():
      return loss_fn(state.model, batch)

  return step


def evaluate(state: TrainState, batches: Iterable[Batch],
             eval_step=None) -> float:
  """Mean loss over ``batches`` (losses stay on the device during the loop;
  one fetch at the end)."""
  eval_step = eval_step or make_eval_step()
  losses = [eval_step(state, batch) for batch in batches]
  if not losses:
    raise ValueError("evaluate: no batches")
  return float(torch.stack(losses).mean())


def fit(state: TrainState, batches: Iterable[Batch], step=None):
  """Minimal epoch driver: returns ``(state, per-step losses)``. Losses stay
  on the device during the loop and are fetched once at the end."""
  step = step or make_train_step()
  losses = []
  for batch in batches:
    state, metrics = step(state, batch)
    losses.append(metrics["loss"])
  if not losses:
    return state, []
  return state, torch.stack(losses).cpu().tolist()
