"""Inputs the benchmark makes from ``--seed`` and hands to the program and to
the reference alike: scenes, poses, depths, intrinsics, weights, batches.

Large tensors are drawn on the device from a ``torch.Generator`` in a few
large calls; small ones (poses, schedules) with NumPy on the host. The
same seed gives the same inputs, and every seed gives the same sizes.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
from torch.nn import functional as F

from benchmark.reference import stereo_mag


def sub_seed(seed: int, *tags) -> int:
  """A 63-bit seed for one input stream, from ``--seed`` and a tag."""
  words = [int(seed) % 2**64] + [zlib.crc32(str(t).encode()) for t in tags]
  return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
             % 2**63)


def generator(seed: int, device, *tags) -> torch.Generator:
  return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def inv_depths(near: float, far: float, planes: int) -> np.ndarray:
  """``[P]`` float32 depths uniform in inverse depth, far first."""
  inv = np.linspace(1.0 / near, 1.0 / far, planes)
  return np.sort(1.0 / inv)[::-1].astype(np.float32)


def intrinsics(height: int, width: int, focal_over_width: float) -> np.ndarray:
  """``[3, 3]`` float32 pinhole intrinsics, principal point at the centre."""
  f = focal_over_width * width
  return np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]],
                  np.float32)


def poses(seed: int, count: int, yaw_deg: float, trans: float,
          separable_share: float, tag: str = "poses") -> np.ndarray:
  """``[N, 4, 4]`` float32 source-to-target poses: translation uniform in
  +-``trans`` on each axis; a yaw uniform in +-``yaw_deg`` on all but a
  ``separable_share`` of them (evenly interleaved), which stay pure
  translations and so give axis-aligned (separable) homographies."""
  rng = np.random.default_rng(sub_seed(seed, tag))
  yaw = np.radians(rng.uniform(-yaw_deg, yaw_deg, count))
  t = rng.uniform(-trans, trans, (count, 3))
  keep = np.ones(count, bool)
  if separable_share > 0:
    keep[::max(int(round(1 / separable_share)), 1)] = False
  yaw = np.where(keep, yaw, 0.0)
  out = np.tile(np.eye(4), (count, 1, 1))
  c, s = np.cos(yaw), np.sin(yaw)
  out[:, 0, 0], out[:, 0, 2], out[:, 2, 0], out[:, 2, 2] = c, s, -s, c
  out[:, :3, 3] = t
  return out.astype(np.float32)


def smooth_field(gen: torch.Generator, channels: int, height: int, width: int,
                 scale_px: int, device) -> torch.Tensor:
  """``[channels, H, W]`` float32 in [0, 1]: uniform noise on a grid of
  ``scale_px`` pixels, bilinearly upsampled (photo-like smoothness)."""
  low = torch.rand((1, channels, -(-height // scale_px) + 1,
                    -(-width // scale_px) + 1), generator=gen, device=device)
  return F.interpolate(low, size=(height, width), mode="bilinear",
                       align_corners=False)[0]


def scene(seed: int, index: int, height: int, width: int, planes: int,
          scale_px: int, device) -> torch.Tensor:
  """One MPI, ``[P, 4, H, W]`` float32 on ``device``: smooth RGB and
  alpha in [0, 1], a third of the alpha zero."""
  field = smooth_field(generator(seed, device, "scene", index), planes * 4,
                       height, width, scale_px, device).view(planes, 4,
                                                             height, width)
  field[:, 3] = (field[:, 3] * 1.5 - 0.5).clamp_(0.0, 1.0)
  return field


def scene_hwp4(planes_p4hw: torch.Tensor) -> np.ndarray:
  """The host ``[H, W, P, 4]`` array the serving API registers."""
  return planes_p4hw.permute(2, 3, 0, 1).contiguous().cpu().numpy()


def unet_weights(seed: int, num_planes: int, device) -> dict:
  """U-Net weights in PyTorch's default initialisation: convolution
  weights and biases uniform in +-1/sqrt(fan_in) (fan_in from dim 1 of
  the weight, as torch computes it for both kinds of convolution),
  InstanceNorm scale 1 and shift 0. One draw for all of them."""
  shapes = []
  for layer in stereo_mag.unet_shapes(num_planes):
    k = layer["kernel"]
    w = ((layer["cin"], layer["cout"], k, k) if layer["transpose"]
         else (layer["cout"], layer["cin"], k, k))
    bound = 1.0 / (w[1] * k * k) ** 0.5
    shapes += [(f"{layer['name']}.conv.weight", w, bound),
               (f"{layer['name']}.conv.bias", (layer["cout"],), bound)]
  total = sum(int(np.prod(s)) for _, s, _ in shapes)
  flat = torch.rand(total, generator=generator(seed, device, "unet"),
                    device=device) * 2 - 1
  out, at = {}, 0
  for name, shape, bound in shapes:
    n = int(np.prod(shape))
    out[name] = (flat[at:at + n] * bound).view(shape)
    at += n
  for layer in stereo_mag.unet_shapes(num_planes):
    if layer["norm"]:
      out[f"{layer['name']}.norm.weight"] = torch.ones(layer["cout"],
                                                       device=device)
      out[f"{layer['name']}.norm.bias"] = torch.zeros(layer["cout"],
                                                      device=device)
  return out


def vgg_weights(seed: int, device) -> dict:
  """VGG16 features to relu4_3: He-normal weights (std sqrt(2 / fan_in)),
  zero biases, in torchvision's layout. No ImageNet weights exist in the
  repository; the convolution shapes are the published ones."""
  layers = stereo_mag.vgg_shapes()
  total = sum(l["cout"] * l["cin"] * 9 for l in layers)
  flat = torch.randn(total, generator=generator(seed, device, "vgg"),
                     device=device)
  out, at = {}, 0
  for l in layers:
    n = l["cout"] * l["cin"] * 9
    std = (2.0 / (l["cin"] * 9)) ** 0.5
    out[f"{l['index']}.weight"] = (flat[at:at + n] * std).view(
        l["cout"], l["cin"], 3, 3)
    out[f"{l['index']}.bias"] = torch.zeros(l["cout"], device=device)
    at += n
  return out


def train_batches(seed: int, count: int, img: int, num_planes: int,
                  near: float, far: float, focal_over_width: float,
                  yaw_deg: float, trans: float, scale_px: int,
                  device) -> list[dict]:
  """``count`` distinct batches of one example, in the training batch
  format: NHWC images in [-1, 1], a net input of the reference image and
  a smooth 3P-channel plane sweep, poses within the serving ranges, the
  configuration's depths and intrinsics. All images in one draw."""
  chans = 3 + 3 * num_planes + 3
  field = smooth_field(generator(seed, device, "batches"), count * chans,
                       img, img, scale_px, device)
  field = (field * 2 - 1).view(count, chans, img, img).permute(0, 2, 3, 1)
  pose = torch.from_numpy(poses(seed, count, yaw_deg, trans, 0.0,
                                tag="train_poses")).to(device)
  depths = torch.from_numpy(inv_depths(near, far, num_planes)).to(device)
  k = torch.from_numpy(intrinsics(img, img, focal_over_width)).to(device)
  eye = torch.eye(4, device=device)
  out = []
  for i in range(count):
    net_input = field[i:i + 1, ..., :3 + 3 * num_planes].contiguous()
    out.append({
        "net_input": net_input,
        "ref_img": net_input[..., :3].contiguous(),
        "tgt_img": field[i:i + 1, ..., 3 + 3 * num_planes:].contiguous(),
        "ref_img_wfc": eye[None].clone(),
        "tgt_img_cfw": pose[i:i + 1].contiguous(),
        "intrinsics": k[None].clone(),
        "mpi_planes": depths,
    })
  return out
