"""Stereo-magnification U-Net and MPI assembly (``torch.nn``).

PyTorch counterpart of ``mpi_vision_tpu/models/stereo_mag.py`` (the
reference notebook's cell 10): channel widths as multiples of
``ngf = 3 + 3P``, three stride-2 encoder stages, a three-conv dilation-2
bottleneck, three ks=4/s=2 transpose-conv decoder stages with skip concats
from cnv3_3 / cnv2_2 / cnv1_2, and a norm-free 1x1 Tanh head producing
``nout = 3 + 2P`` channels. Each block is conv -> [InstanceNorm2d(affine)]
-> activation. The convolutions run NCHW inside (cuDNN's layout); the
module takes and returns NHWC, the layout of the JAX batch dicts, so the
two packages' tensors compare directly.

Normalization: the reference passes fastai's ``InstanceNorm`` *callable*
as ``norm_type``, which fastai only matches against its enum, so the
notebook's trained network has no norm layers. ``norm=None`` reproduces
that; ``norm="instance"`` (the default) gives the paper's InstanceNorm.

Mixed precision (``dtype=torch.bfloat16``, ``train --bf16``): the JAX
package's flax ``dtype=`` layout, with explicit casts rather than
``torch.autocast`` (whose op lists decide casts differently): each conv
casts its input, weights and bias to bf16 and computes there; the
InstanceNorm statistics and affine are taken in f32 and cast back; the
parameters stay f32 and the network's output is cast to f32, so the render
and its kernels stay f32.

Weights carry across from the JAX package with
``state_dict_from_jax_params`` (the inverse of its
``params_from_torch_state``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


class ConvBlock(nn.Module):
  """conv -> [InstanceNorm2d] -> activation, torch padding semantics: ks=3
  convs pad by ``dilation``, the ks=4/s=2 transpose conv pads by 1 (doubling
  the spatial size exactly), the ks=1 head pads 0. ``dtype`` (None = f32)
  is the conv's computation dtype; the parameters stay f32."""

  def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
               dilation: int = 1, transpose: bool = False,
               norm: str | None = "instance", act: str | None = "relu",
               dtype: torch.dtype | None = None):
    super().__init__()
    self.dtype = dtype
    if transpose:
      self.conv = nn.ConvTranspose2d(cin, cout, kernel, stride=stride,
                                     padding=1)
    else:
      self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                            padding=dilation * (kernel - 1) // 2,
                            dilation=dilation)
    if norm == "instance":
      self.norm = nn.InstanceNorm2d(cout, affine=True)
    elif norm is None:
      self.norm = None
    else:
      raise ValueError(f"unknown norm: {norm!r}")
    acts = {"relu": nn.ReLU(), "tanh": nn.Tanh(), None: None}
    if act not in acts:
      raise ValueError(f"unknown act: {act!r}")
    self.act = acts[act]

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dt = self.dtype or torch.float32
    x = self._conv_cast(x.to(dt))
    if self.norm is not None:
      # Statistics and affine in f32, as flax's norm layers take them.
      x = self.norm(x.float()).to(dt)
    if self.act is not None:
      x = self.act(x)
    return x

  def _conv_cast(self, x: torch.Tensor) -> torch.Tensor:
    """The conv with its weights and bias cast to ``x``'s dtype."""
    conv = self.conv
    w, b = conv.weight.to(x.dtype), conv.bias.to(x.dtype)
    if isinstance(conv, nn.ConvTranspose2d):
      return F.conv_transpose2d(x, w, b, stride=conv.stride,
                                padding=conv.padding)
    return F.conv2d(x, w, b, stride=conv.stride, padding=conv.padding,
                    dilation=conv.dilation)


class StereoMagnificationModel(nn.Module):
  """U-Net predicting MPI blend weights, alphas and a background image.

  Input ``[B, H, W, 3 + 3P]`` (reference image ++ P-plane PSV of the source
  image, NHWC), output ``[B, H, W, 3 + 2P]`` in (-1, 1): P blend-weight
  channels, P alpha channels, 3 background-RGB channels. H and W must be
  divisible by 8. ``dtype=torch.bfloat16`` runs every conv in bf16 (see the
  module docstring); the output is f32 either way.
  """

  def __init__(self, num_planes: int = 10, norm: str | None = "instance",
               dtype: torch.dtype | None = None):
    super().__init__()
    ngf = 3 + num_planes * 3
    nout = 3 + num_planes * 2
    self.num_planes = num_planes
    self.dtype = dtype
    n = norm
    self.cnv1_1 = ConvBlock(ngf, ngf, norm=n, dtype=dtype)
    self.cnv1_2 = ConvBlock(ngf, ngf * 2, stride=2, norm=n, dtype=dtype)
    self.cnv2_1 = ConvBlock(ngf * 2, ngf * 2, norm=n, dtype=dtype)
    self.cnv2_2 = ConvBlock(ngf * 2, ngf * 4, stride=2, norm=n, dtype=dtype)
    self.cnv3_1 = ConvBlock(ngf * 4, ngf * 4, norm=n, dtype=dtype)
    self.cnv3_2 = ConvBlock(ngf * 4, ngf * 4, norm=n, dtype=dtype)
    self.cnv3_3 = ConvBlock(ngf * 4, ngf * 8, stride=2, norm=n, dtype=dtype)
    self.cnv4_1 = ConvBlock(ngf * 8, ngf * 8, dilation=2, norm=n, dtype=dtype)
    self.cnv4_2 = ConvBlock(ngf * 8, ngf * 8, dilation=2, norm=n, dtype=dtype)
    self.cnv4_3 = ConvBlock(ngf * 8, ngf * 8, dilation=2, norm=n, dtype=dtype)
    self.cnv5_1 = ConvBlock(ngf * 16, ngf * 4, kernel=4, stride=2,
                            transpose=True, norm=n, dtype=dtype)
    self.cnv5_2 = ConvBlock(ngf * 4, ngf * 4, norm=n, dtype=dtype)
    self.cnv5_3 = ConvBlock(ngf * 4, ngf * 4, norm=n, dtype=dtype)
    self.cnv6_1 = ConvBlock(ngf * 8, ngf * 2, kernel=4, stride=2,
                            transpose=True, norm=n, dtype=dtype)
    self.cnv6_2 = ConvBlock(ngf * 2, ngf * 2, norm=n, dtype=dtype)
    self.cnv7_1 = ConvBlock(ngf * 4, nout, kernel=4, stride=2,
                            transpose=True, norm=n, dtype=dtype)
    self.cnv7_2 = ConvBlock(nout, nout, norm=n, dtype=dtype)
    self.cnv8_1 = ConvBlock(nout, nout, kernel=1, norm=None, act="tanh",
                            dtype=dtype)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = x.permute(0, 3, 1, 2)
    c1_2 = self.cnv1_2(self.cnv1_1(x))
    c2_2 = self.cnv2_2(self.cnv2_1(c1_2))
    c3_3 = self.cnv3_3(self.cnv3_2(self.cnv3_1(c2_2)))
    c4_3 = self.cnv4_3(self.cnv4_2(self.cnv4_1(c3_3)))
    c5_3 = self.cnv5_3(self.cnv5_2(self.cnv5_1(torch.cat([c4_3, c3_3], 1))))
    c6_2 = self.cnv6_2(self.cnv6_1(torch.cat([c5_3, c2_2], 1)))
    c7_2 = self.cnv7_2(self.cnv7_1(torch.cat([c6_2, c1_2], 1)))
    return self.cnv8_1(c7_2).permute(0, 2, 3, 1).float()


def mpi_from_net_output(mpi_pred: torch.Tensor,
                        ref_img: torch.Tensor) -> torch.Tensor:
  """Assemble net output into an MPI ``[B, H, W, P, 4]``.

  Tanh outputs rescaled to (0, 1) give P blend weights and P alphas; the
  last 3 channels are a background RGB image; per-plane RGB =
  ``w * ref_img + (1 - w) * bg``.

  Args:
    mpi_pred: ``[B, H, W, 3 + 2P]`` network output in (-1, 1), NHWC.
    ref_img: ``[B, H, W, 3]`` the reference image (in [-1, 1]).
  """
  num_planes = (mpi_pred.shape[-1] - 3) // 2
  blend = (mpi_pred[..., :num_planes] + 1.0) / 2.0
  alphas = (mpi_pred[..., num_planes:2 * num_planes] + 1.0) / 2.0
  bg_rgb = mpi_pred[..., -3:]
  w = blend[..., None]
  rgb = w * ref_img[..., None, :] + (1.0 - w) * bg_rgb[..., None, :]
  return torch.cat([rgb, alphas[..., None]], dim=-1)


def state_dict_from_jax_params(params: Mapping[str, Any],
                               norm: str | None = "instance"
                               ) -> dict[str, torch.Tensor]:
  """The JAX model's flax params (numpy arrays) as this module's state dict.

  The inverse of the JAX package's ``params_from_torch_state``: conv
  kernels ``(kh, kw, in, out)`` -> ``[out, in, kh, kw]`` and transpose-conv
  kernels ``(kh, kw, out, in)`` -> ``[in, out, kh, kw]``, both by the
  permutation ``(3, 2, 0, 1)``; InstanceNorm ``scale``/``bias`` ->
  ``weight``/``bias``. ``params`` may be the tree or ``{"params": tree}``.
  """
  tree = params.get("params", params)
  state: dict[str, torch.Tensor] = {}
  for block, leaves in tree.items():
    conv = leaves["conv"]
    state[f"{block}.conv.weight"] = torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(conv["kernel"], np.float32), (3, 2, 0, 1))))
    state[f"{block}.conv.bias"] = torch.from_numpy(
        np.array(conv["bias"], np.float32))
    if norm == "instance" and "norm" in leaves:
      state[f"{block}.norm.weight"] = torch.from_numpy(
          np.array(leaves["norm"]["scale"], np.float32))
      state[f"{block}.norm.bias"] = torch.from_numpy(
          np.array(leaves["norm"]["bias"], np.float32))
  return state
