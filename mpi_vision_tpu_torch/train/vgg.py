"""VGG16 feature extractor for the perceptual loss (``torch.nn``).

PyTorch counterpart of ``mpi_vision_tpu/train/vgg.py``. The reference's
``VGGPerceptualLoss`` slices ``torchvision.models.vgg16().features`` into
``[:4], [4:9], [9:16], [16:23]``: activations after relu1_2, relu2_2,
relu3_3 and relu4_3. ``VGG16Features`` is that slice as a plain
Sequential in torchvision's layer order, so a torchvision-format state dict
(``{i}.weight`` / ``{i}.bias``) loads into it as it is.

Weights (``default_params``): the checkpoint that the
``MPI_VISION_VGG16_CKPT`` environment variable names, as the JAX package
reads it, else deterministic He-style random features drawn from a
``torch.Generator`` seeded with 0. The checkpoint is a directory holding
one ``mpi-ckpt-v1`` checkpoint (``ckpt/store.py``) written by
``save_params``; anything else the variable names raises, never falls
back to random features. The JAX package's ``save_params`` writes an orbax
directory, which the port cannot read: carry those params across with
``state_dict_from_jax_params`` and write them with ``save_params``. The
random features are NOT bitwise the JAX package's ``init_params(0)``
(flax draws from ``jax.random``). There is no ImageNet checkpoint in the
repository.
"""

from __future__ import annotations

import os
import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

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
  gradient still flows through to the input.

  ``dtype=torch.bfloat16`` (``train --bf16``) runs the convs in bf16 with
  their weights cast (the parameters stay f32) and returns the taps in
  f32, so the loss's L1 terms accumulate at full precision, as the JAX
  package's ``VGG16Features(dtype=...)`` does."""

  def __init__(self, state_dict: Mapping[str, torch.Tensor] | None = None,
               dtype: torch.dtype | None = None):
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
    self.dtype = dtype

  def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
    x = x.to(self.dtype or torch.float32)
    taps = []
    for i, layer in enumerate(self):
      if isinstance(layer, nn.Conv2d):
        x = F.conv2d(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype),
                     padding=layer.padding)
      else:
        x = layer(x)
      if i in _TAP_INDICES:
        taps.append(x.float())
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


# The environment variable naming the VGG weights to train against.
CKPT_ENV = "MPI_VISION_VGG16_CKPT"


def _param_names() -> list[str]:
  return [f"{i}.{leaf}" for i in _CONV_INDICES for leaf in ("weight", "bias")]


def save_params(path: str, state_dict: Mapping[str, torch.Tensor]) -> str:
  """Write a ``VGG16Features`` state dict (torchvision layout) to the
  directory ``path`` as one ``mpi-ckpt-v1`` checkpoint at step 0 — the
  form ``MPI_VISION_VGG16_CKPT`` names. Returns the checkpoint's dir.

  For real weights: on a machine with the torchvision zoo, write
  ``vgg16(weights="IMAGENET1K_V1").features[:23].state_dict()`` once, ship
  the directory and point the variable at it."""
  from mpi_vision_tpu_torch.ckpt.store import CheckpointStore

  missing = set(_param_names()) - set(state_dict)
  if missing:
    raise KeyError(f"VGG state dict lacks {sorted(missing)}")
  return CheckpointStore(path, keep=1).save(
      0, {k: state_dict[k] for k in _param_names()},
      meta={"model": "vgg16.features[:23]"})


def load_params(path: str) -> dict[str, torch.Tensor]:
  """The state dict ``save_params`` wrote to ``path``, hash-verified.

  Raises ``FileNotFoundError`` when ``path`` is not a directory and
  ``ValueError`` when it holds no readable checkpoint of these weights
  (an orbax directory from the JAX package's ``save_params`` is one such
  case), saying what it found and what it expects."""
  from mpi_vision_tpu_torch.ckpt.store import FORMAT, CheckpointStore

  expects = (f"a directory holding one {FORMAT} checkpoint "
             "(step_0000000000/arrays.npz + manifest.json) written by "
             "mpi_vision_tpu_torch.train.vgg.save_params")
  if not os.path.isdir(path):
    raise FileNotFoundError(
        f"VGG16 checkpoint {path!r} does not exist or is not a directory; "
        f"expected {expects}")
  found = sorted(os.listdir(path))
  if not any(re.match(r"^step_\d{10}$", name) for name in found):
    raise ValueError(
        f"VGG16 checkpoint {path!r} holds {found[:8]}, not a {FORMAT} "
        f"checkpoint; expected {expects} (an orbax directory from the JAX "
        "package's save_params cannot be read by the port: carry its "
        "params across with state_dict_from_jax_params and save_params)")
  template = dict.fromkeys(_param_names())
  try:
    restored = CheckpointStore(path).restore(template=template)
  except KeyError as e:
    raise ValueError(f"VGG16 checkpoint {path!r}: {e.args[0]}; expected "
                     f"{expects}") from None
  if restored is None:
    raise ValueError(
        f"VGG16 checkpoint {path!r} failed verification (moved to its "
        f"quarantine/); expected {expects}")
  return {k: torch.from_numpy(v)
          for k, v in restored.tree(template).items()}


def default_params() -> dict[str, torch.Tensor]:
  """The training default: the checkpoint ``MPI_VISION_VGG16_CKPT`` names
  (``load_params``, which raises on anything it cannot read), else
  ``init_params(0)``."""
  path = os.environ.get(CKPT_ENV, "")
  if path:
    return load_params(path)
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
