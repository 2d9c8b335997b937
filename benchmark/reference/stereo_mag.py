"""Plain reference of the stereo-magnification training step, float64.

The reference notebook's model and loss (cells 10-12) written out as plain
PyTorch functions over a dict of weights: the U-Net (conv -> InstanceNorm
-> ReLU blocks, three stride-2 stages, a dilation-2 bottleneck, three
transpose-conv stages with skip concats, a 1x1 Tanh head), the MPI
assembly from its output, the render into the target view
(``reference/render.py``), the VGG16 perceptual loss to relu4_3 and Adam.

Nothing here imports the measured program: the weights and the batches
are made by the benchmark (``benchmark/inputs.py``) and handed to both.
The weight names follow the layer names below (``<layer>.conv.weight``,
``<layer>.norm.weight``; VGG ``<index>.weight`` in torchvision's order),
which is the format the benchmark makes them in.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from benchmark.reference import render as ref_render

# name, cin and cout as (multiple of ngf or "nout"), kernel, stride,
# dilation, transpose, norm, activation. ngf = 3 + 3P, nout = 3 + 2P.
UNET_LAYERS = (
    ("cnv1_1", 1, 1, 3, 1, 1, False, True, "relu"),
    ("cnv1_2", 1, 2, 3, 2, 1, False, True, "relu"),
    ("cnv2_1", 2, 2, 3, 1, 1, False, True, "relu"),
    ("cnv2_2", 2, 4, 3, 2, 1, False, True, "relu"),
    ("cnv3_1", 4, 4, 3, 1, 1, False, True, "relu"),
    ("cnv3_2", 4, 4, 3, 1, 1, False, True, "relu"),
    ("cnv3_3", 4, 8, 3, 2, 1, False, True, "relu"),
    ("cnv4_1", 8, 8, 3, 1, 2, False, True, "relu"),
    ("cnv4_2", 8, 8, 3, 1, 2, False, True, "relu"),
    ("cnv4_3", 8, 8, 3, 1, 2, False, True, "relu"),
    ("cnv5_1", 16, 4, 4, 2, 1, True, True, "relu"),
    ("cnv5_2", 4, 4, 3, 1, 1, False, True, "relu"),
    ("cnv5_3", 4, 4, 3, 1, 1, False, True, "relu"),
    ("cnv6_1", 8, 2, 4, 2, 1, True, True, "relu"),
    ("cnv6_2", 2, 2, 3, 1, 1, False, True, "relu"),
    ("cnv7_1", 4, "nout", 4, 2, 1, True, True, "relu"),
    ("cnv7_2", "nout", "nout", 3, 1, 1, False, True, "relu"),
    ("cnv8_1", "nout", "nout", 1, 1, 1, False, False, "tanh"),
)

# torchvision vgg16().features up to relu4_3; "M" is a 2x2 max pool.
VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INSTANCE_NORM_EPS = 1e-5
ADAM = {"b1": 0.9, "b2": 0.999, "eps": 1e-8}


def unet_shapes(num_planes: int) -> list[dict]:
  """Every U-Net layer with its channel counts and kernel geometry."""
  ngf, nout = 3 + 3 * num_planes, 3 + 2 * num_planes
  out = []
  for name, cin, cout, k, s, d, tr, norm, act in UNET_LAYERS:
    cin = nout if cin == "nout" else cin * ngf
    cout = nout if cout == "nout" else cout * ngf
    out.append({"name": name, "cin": cin, "cout": cout, "kernel": k,
                "stride": s, "dilation": d, "transpose": tr, "norm": norm,
                "act": act})
  return out


def vgg_shapes() -> list[dict]:
  """The ten VGG convolutions with their torchvision indices; ``tap``
  marks the four whose ReLU output the loss reads, ``pool`` those followed
  by a max pool."""
  out, cin, index = [], 3, 0
  for i, c in enumerate(VGG_CFG):
    if c == "M":
      out[-1]["pool"] = True
      index += 1
      continue
    out.append({"index": index, "cin": cin, "cout": c, "pool": False})
    cin, index = c, index + 2
  for layer_no in (1, 3, 6, 9):
    out[layer_no]["tap"] = True
  return out


def _block(params: dict, layer: dict, x: torch.Tensor) -> torch.Tensor:
  name = layer["name"]
  w, b = params[f"{name}.conv.weight"], params[f"{name}.conv.bias"]
  if layer["transpose"]:
    x = F.conv_transpose2d(x, w, b, stride=layer["stride"], padding=1)
  else:
    x = F.conv2d(x, w, b, stride=layer["stride"],
                 padding=layer["dilation"] * (layer["kernel"] - 1) // 2,
                 dilation=layer["dilation"])
  if layer["norm"]:
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    x = (x - mean) / torch.sqrt(var + INSTANCE_NORM_EPS)
    x = (x * params[f"{name}.norm.weight"][None, :, None, None]
         + params[f"{name}.norm.bias"][None, :, None, None])
  return torch.relu(x) if layer["act"] == "relu" else torch.tanh(x)


def unet_forward(params: dict, net_input: torch.Tensor,
                 num_planes: int) -> torch.Tensor:
  """``[B, H, W, 3 + 3P]`` -> ``[B, H, W, 3 + 2P]`` (NHWC in and out)."""
  layers = {layer["name"]: layer for layer in unet_shapes(num_planes)}

  def run(names, x):
    for n in names:
      x = _block(params, layers[n], x)
    return x

  x = net_input.permute(0, 3, 1, 2)
  c1 = run(["cnv1_1", "cnv1_2"], x)
  c2 = run(["cnv2_1", "cnv2_2"], c1)
  c3 = run(["cnv3_1", "cnv3_2", "cnv3_3"], c2)
  c4 = run(["cnv4_1", "cnv4_2", "cnv4_3"], c3)
  c5 = run(["cnv5_1", "cnv5_2", "cnv5_3"], torch.cat([c4, c3], 1))
  c6 = run(["cnv6_1", "cnv6_2"], torch.cat([c5, c2], 1))
  c7 = run(["cnv7_1", "cnv7_2"], torch.cat([c6, c1], 1))
  return run(["cnv8_1"], c7).permute(0, 2, 3, 1)


def mpi_from_net_output(pred: torch.Tensor, ref_img: torch.Tensor
                        ) -> torch.Tensor:
  """Net output in (-1, 1) -> MPI ``[B, H, W, P, 4]``: P blend weights, P
  alphas and a background image; plane RGB = w * ref + (1 - w) * bg."""
  p = (pred.shape[-1] - 3) // 2
  w = ((pred[..., :p] + 1.0) / 2.0)[..., None]
  alpha = ((pred[..., p:2 * p] + 1.0) / 2.0)[..., None]
  bg = pred[..., -3:]
  rgb = w * ref_img[..., None, :] + (1.0 - w) * bg[..., None, :]
  return torch.cat([rgb, alpha], dim=-1)


def vgg_features(params: dict, x: torch.Tensor) -> list[torch.Tensor]:
  """NCHW -> the relu1_2, relu2_2, relu3_3 and relu4_3 activations."""
  taps = []
  for layer in vgg_shapes():
    i = layer["index"]
    x = torch.relu(F.conv2d(x, params[f"{i}.weight"], params[f"{i}.bias"],
                            padding=1))
    if layer.get("tap"):
      taps.append(x)
      if len(taps) == 4:
        break
    if layer["pool"]:
      x = F.max_pool2d(x, 2, 2)
  return taps


def resize_weights(n_in: int, n_out: int, like: torch.Tensor) -> torch.Tensor:
  """``[n_out, n_in]`` bilinear resize weights, half-pixel centres, no
  antialiasing, edge-clamped (``F.interpolate(align_corners=False)``)."""
  w = torch.zeros(n_out, n_in, dtype=like.dtype, device=like.device)
  for i in range(n_out):
    src = max((i + 0.5) * n_in / n_out - 0.5, 0.0)
    lo = min(int(src), n_in - 1)
    hi = min(lo + 1, n_in - 1)
    frac = src - lo
    w[i, lo] += 1.0 - frac
    w[i, hi] += frac
  return w


def perceptual_loss(out: torch.Tensor, tgt: torch.Tensor, vgg_params: dict,
                    resize: int | None) -> torch.Tensor:
  """Pixel L1 plus the four VGG L1s weighted 1 / (1 + i), after the
  ImageNet constants are applied to the [-1, 1] images as the notebook
  does (cell 12)."""
  mean = torch.tensor(IMAGENET_MEAN, dtype=out.dtype, device=out.device)
  std = torch.tensor(IMAGENET_STD, dtype=out.dtype, device=out.device)
  x = ((out - mean) / std).permute(0, 3, 1, 2)
  y = ((tgt - mean) / std).permute(0, 3, 1, 2)
  if resize is not None and tuple(x.shape[-2:]) != (resize, resize):
    rows = resize_weights(x.shape[-2], resize, x)
    cols = resize_weights(x.shape[-1], resize, x)
    x, y = rows @ x @ cols.T, rows @ y @ cols.T
  loss = (x - y).abs().mean()
  for i, (fx, fy) in enumerate(zip(vgg_features(vgg_params, x),
                                   vgg_features(vgg_params, y))):
    loss = loss + (fx - fy).abs().mean() / (1.0 + i)
  return loss


def step_loss(params: dict, vgg_params: dict, batch: dict, num_planes: int,
              resize: int | None, convention: str) -> torch.Tensor:
  """The training loss of one batch: U-Net, MPI, render, perceptual loss."""
  pred = unet_forward(params, batch["net_input"], num_planes)
  mpi = mpi_from_net_output(pred, batch["ref_img"])
  rel = batch["tgt_img_cfw"] @ batch["ref_img_wfc"]
  depths = batch["mpi_planes"]
  frames = []
  for b in range(mpi.shape[0]):
    planes = mpi[b].permute(2, 0, 1, 3)              # [P, H, W, 4]
    frames.append(ref_render.render(
        planes, rel[b].detach().cpu().numpy(), depths.detach().cpu().numpy(),
        batch["intrinsics"][b].detach().cpu().numpy(), convention))
  return perceptual_loss(torch.stack(frames), batch["tgt_img"], vgg_params,
                         resize)


def train(params: dict, vgg_params: dict, batches: list, num_planes: int,
          lr: float, resize: int | None, convention: str) -> dict:
  """Plain Adam steps, one a batch, from ``params`` (float64 tensors).

  Returns each step's loss, the first step's gradient by leaf, and the
  parameters after the last step."""
  params = {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items()}
  m = {k: torch.zeros_like(v) for k, v in params.items()}
  v2 = {k: torch.zeros_like(v) for k, v in params.items()}
  losses, first_grad = [], None
  for t, batch in enumerate(batches, start=1):
    loss = step_loss(params, vgg_params, batch, num_planes, resize,
                     convention)
    grads = torch.autograd.grad(loss, list(params.values()))
    losses.append(float(loss.detach()))
    with torch.no_grad():
      if first_grad is None:
        first_grad = {k: g.clone() for k, g in zip(params, grads)}
      for (k, p), g in zip(params.items(), grads):
        m[k] = ADAM["b1"] * m[k] + (1.0 - ADAM["b1"]) * g
        v2[k] = ADAM["b2"] * v2[k] + (1.0 - ADAM["b2"]) * g * g
        m_hat = m[k] / (1.0 - ADAM["b1"] ** t)
        v_hat = v2[k] / (1.0 - ADAM["b2"] ** t)
        p -= lr * m_hat / (torch.sqrt(v_hat) + ADAM["eps"])
  return {"losses": losses, "first_grad": first_grad,
          "params": {k: v.detach() for k, v in params.items()}}
