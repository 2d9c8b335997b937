"""Tiny per-plane RGBA predictor (DeepView-style direct MPI prediction).

PyTorch counterpart of ``mpi_vision_tpu/models/tiny_unet.py``, BASELINE
config 5's model: a small U-Net that predicts every plane's RGBA directly
from the plane-sweep volume. The PSV arrives plane-major ``[B, H, W, P,
C]``; planes fold into the batch axis so every plane runs through the same
shared-weight network in one batched convolution, and a few cross-plane
mixing convolutions at the 1/4-resolution bottleneck see the planes
stacked on channels, so planes can exchange occlusion evidence.

Layout: the convolutions run NCHW (cuDNN's layout); the module takes and
returns the JAX module's NHWC tensors. The two plane folds are ordered as
the JAX ``reshape``s order them — planes-major in the batch fold, and
channel ``plane * C + c`` in the bottleneck stack — so carried weights
give the same network.

Padding is flax's ``"SAME"``: a stride-2 3x3 convolution over an even size
pads 0 before and 1 after (torch's symmetric ``padding=1`` would sample a
different window), and a 4x4 stride-2 transpose convolution pads the
dilated input by 2 on both sides — torch's ``ConvTranspose2d(padding=1)``
— with the flax kernel flipped in space (flax's transpose convolution
does not flip it, torch's does).

Weights carry across with ``state_dict_from_jax_params``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


def _same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
  """flax/XLA ``"SAME"`` padding (before, after) of one spatial dim."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


class _Conv(nn.Conv2d):
  """A ``Conv2d`` evaluated with flax ``"SAME"`` padding."""

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    k, s = self.kernel_size[0], self.stride[0]
    ph = _same_pad(x.shape[-2], k, s)
    pw = _same_pad(x.shape[-1], k, s)
    return super().forward(F.pad(x, (pw[0], pw[1], ph[0], ph[1])))


def _conv_up(cin: int, cout: int) -> nn.ConvTranspose2d:
  """flax ``ConvTranspose((4, 4), strides=(2, 2))``: doubles H and W."""
  return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1)


class TinyPlaneUNet(nn.Module):
  """PSV ``[B, H, W, P, C]`` -> MPI ``[B, H, W, P, 4]``.

  RGB is tanh in [-1, 1] (image range), alpha sigmoid in (0, 1). H and W
  must be divisible by 4 (two stride-2 stages). ``num_planes`` and
  ``in_channels`` fix the bottleneck's plane stack (the flax module reads
  them off its input). f32 (the JAX module's ``dtype`` has no caller
  here).
  """

  def __init__(self, num_planes: int, in_channels: int = 6, width: int = 32,
               mix: int = 2):
    super().__init__()
    self.num_planes = num_planes
    w, p = width, num_planes
    self.enc0 = _Conv(in_channels, w, 3)
    self.enc1 = _Conv(w, w * 2, 3, stride=2)
    self.enc2 = _Conv(w * 2, w * 4, 3, stride=2)
    self.mix = nn.ModuleList(
        _Conv(p * w * 4 if i == 0 else w * 4 * 2, w * 4 * 2, 3)
        for i in range(mix))
    self.unmix = _Conv(w * 4 * 2 if mix else p * w * 4, p * w * 4, 1)
    self.dec1 = _conv_up(w * 4 * 2, w * 2)
    self.dec0 = _conv_up(w * 2 * 2, w)
    self.head = _Conv(w * 2, 4, 1)

  def forward(self, psv: torch.Tensor) -> torch.Tensor:
    b, h, w, p, c = psv.shape
    if p != self.num_planes:
      raise ValueError(f"built for {self.num_planes} planes, got {p}")
    # Planes fold into the batch, plane-major: [B*P, C, H, W].
    x = psv.permute(0, 3, 4, 1, 2).reshape(b * p, c, h, w)
    e0 = F.relu(self.enc0(x))
    e1 = F.relu(self.enc1(e0))
    e2 = F.relu(self.enc2(e1))
    # Cross-plane mixing at 1/4 resolution: channel plane * C + c.
    h4, w4 = e2.shape[-2:]
    m = e2.reshape(b, p * e2.shape[1], h4, w4)
    for conv in self.mix:
      m = F.relu(conv(m))
    m = self.unmix(m).reshape(b * p, -1, h4, w4)
    d1 = F.relu(self.dec1(torch.cat([m, e2], 1)))
    d0 = F.relu(self.dec0(torch.cat([d1, e1], 1)))
    out = self.head(torch.cat([d0, e0], 1))
    out = torch.cat([torch.tanh(out[:, :3]), torch.sigmoid(out[:, 3:])], 1)
    # [B*P, 4, H, W] -> [B, H, W, P, 4]
    return out.reshape(b, p, 4, h, w).permute(0, 3, 4, 1, 2)


def psv_from_net_input(net_input: torch.Tensor,
                       num_planes: int) -> torch.Tensor:
  """A stereo-mag net input ``[B, H, W, 3 + 3P]`` as the tiny model's
  plane-major input ``[B, H, W, P, 6]``: each plane's PSV RGB followed by
  the reference image's RGB."""
  b, h, w, _ = net_input.shape
  ref = net_input[..., :3]
  psv = net_input[..., 3:].reshape(b, h, w, num_planes, 3)
  return torch.cat([psv, ref[..., None, :].expand(psv.shape)], dim=-1)


def state_dict_from_jax_params(params: Mapping[str, Any]
                               ) -> dict[str, torch.Tensor]:
  """The JAX ``TinyPlaneUNet``'s flax params (numpy arrays) as this
  module's state dict.

  Conv kernels ``(kh, kw, in, out)`` -> ``[out, in, kh, kw]``; transpose
  conv kernels ``(kh, kw, in, out)`` -> ``[in, out, kh, kw]`` flipped in
  space (flax's transpose convolution correlates with the kernel as
  stored, torch's with it flipped). ``mix{i}`` map to ``mix.{i}``.
  ``params`` may be the tree or ``{"params": tree}``.
  """
  tree = params.get("params", params)
  state: dict[str, torch.Tensor] = {}
  for name, leaves in tree.items():
    kernel = np.asarray(leaves["kernel"], np.float32)
    if name.startswith("dec"):
      weight = np.transpose(kernel[::-1, ::-1], (2, 3, 0, 1))
    else:
      weight = np.transpose(kernel, (3, 2, 0, 1))
    key = f"mix.{name[3:]}" if name.startswith("mix") else name
    state[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(weight))
    state[f"{key}.bias"] = torch.from_numpy(
        np.array(leaves["bias"], np.float32))
  return state
