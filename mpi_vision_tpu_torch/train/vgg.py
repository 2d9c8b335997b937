"""VGG16 feature extractor for the perceptual loss (``torch.nn``).

PyTorch counterpart of ``mpi_vision_tpu/train/vgg.py``. The reference's
``VGGPerceptualLoss`` slices ``torchvision.models.vgg16().features`` into
``[:4], [4:9], [9:16], [16:23]``: activations after relu1_2, relu2_2,
relu3_3 and relu4_3. ``VGG16Features`` is that slice as a plain
Sequential in torchvision's layer order, so a torchvision-format state dict
(``{i}.weight`` / ``{i}.bias``) loads into it as it is.

Weights: there is no ImageNet checkpoint in the repository. The default
(``default_params``) is deterministic He-style random features drawn from
a ``torch.Generator`` seeded with 0. They are NOT bitwise the JAX package's
``init_params(0)`` (flax draws from ``jax.random``); to run both loss stacks
with the same weights, carry the JAX params across with
``state_dict_from_jax_params``. Real ImageNet weights wait until a state
dict is in the repository.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

# torchvision vgg16.features up to relu4_3 (features[:23]); "M" = max pool.
_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512]
# Sequential indices of the four taps (the ReLU after conv 2, 4, 7, 10).
_TAP_INDICES = (3, 8, 15, 22)

# ImageNet normalization constants (notebook cell 12).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _conv_indices() -> list[int]:
  """Sequential indices of the ten convs (each conv is conv + ReLU, each
  "M" one pool)."""
  convs, i = [], 0
  for c in _CFG:
    if c == "M":
      i += 1
    else:
      convs.append(i)
      i += 2
  return convs


_CONV_INDICES = _conv_indices()


class VGG16Features(nn.Sequential):
  """``vgg16().features[:23]``: call on NCHW input, get the four taps
  (NCHW) as a list. Its parameters are frozen (no gradient), while the
  gradient still flows through to the input."""

  def __init__(self, state_dict: Mapping[str, torch.Tensor] | None = None):
    layers: list[nn.Module] = []
    cin = 3
    for c in _CFG:
      if c == "M":
        layers.append(nn.MaxPool2d(2, 2))
      else:
        layers += [nn.Conv2d(cin, c, 3, padding=1), nn.ReLU()]
        cin = c
    super().__init__(*layers)
    self.load_state_dict(default_params() if state_dict is None
                         else state_dict)
    self.requires_grad_(False)

  def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
    taps = []
    for i, layer in enumerate(self):
      x = layer(x)
      if i in _TAP_INDICES:
        taps.append(x)
        if i == _TAP_INDICES[-1]:
          break
    return taps


def init_params(seed: int = 0) -> dict[str, torch.Tensor]:
  """Deterministic He-style random features: weights normal with std
  ``sqrt(2 / fan_in)``, biases 0, drawn in order from a CPU
  ``torch.Generator(seed)``. Not bitwise the JAX package's ``init_params``.
  """
  gen = torch.Generator().manual_seed(seed)
  state, cin = {}, 3
  convs = iter(_CONV_INDICES)
  for c in _CFG:
    if c == "M":
      continue
    i = next(convs)
    std = (2.0 / (cin * 9)) ** 0.5
    state[f"{i}.weight"] = torch.randn((c, cin, 3, 3), generator=gen) * std
    state[f"{i}.bias"] = torch.zeros(c)
    cin = c
  return state


def default_params() -> dict[str, torch.Tensor]:
  """The training default: ``init_params(0)``."""
  return init_params(0)


def state_dict_from_jax_params(params: Mapping[str, Any]
                               ) -> dict[str, torch.Tensor]:
  """The JAX ``VGG16Features`` flax params (numpy arrays) as a
  torchvision-layout state dict: ``conv{k}.kernel`` ``(kh, kw, in, out)``
  -> ``{i}.weight`` ``[out, in, kh, kw]``, ``conv{k}.bias`` -> ``{i}.bias``,
  ``i`` the Sequential index of the k-th conv. The same layout the JAX
  package's ``state_dict_from_params`` writes."""
  tree = params.get("params", params)
  state = {}
  for k, i in enumerate(_CONV_INDICES):
    leaf = tree[f"conv{k}"]
    state[f"{i}.weight"] = torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(leaf["kernel"], np.float32), (3, 2, 0, 1))))
    state[f"{i}.bias"] = torch.from_numpy(np.array(leaf["bias"], np.float32))
  return state


def imagenet_normalize(img: torch.Tensor) -> torch.Tensor:
  """NHWC RGB -> ``(img - mean) / std``, exactly as the reference loss.

  The reference applies the ImageNet constants DIRECTLY to its [-1, 1]
  images (no [0, 1] rescale): a quirk, kept because the published loss
  curve depends on it.
  """
  mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
  std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
  return (img - mean) / std
