"""Reference-name compatibility surface, on the card.

PyTorch counterpart of ``mpi_vision_tpu/compat.py``: the reference's
helpers (the star-import surface of ``mpi_vision.utils``) under their
original names and signatures, so notebook-style code ports by changing an
import — ``from mpi_vision_tpu_torch.compat import *`` — and runs on the
card. This package IS the torch backend: ``backend`` stays a keyword for
the call sites, accepts ``"torch"`` (the default) and raises
``ValueError`` for anything else; the JAX backend lives in the JAX package
(``mpi_vision_tpu.compat``).

Every function takes ``device=None`` (the card, ``"cuda"``; with no card
it raises unless the caller passes ``"cpu"``), moves numpy or host inputs
to that device explicitly (float64 arrives as float32, as ``jnp.asarray``
makes it) and returns tensors there. On the card ``mpi_render_view_torch``
renders through ``core.render.render_mpi(method="fused_pallas")`` — the
``render_fused`` CUDA kernel, which folds the REF_HOMOGRAPHY convention
into its 3x3 — and ``over_composite`` through the ``compose_over`` CUDA
kernel (``kernels/compose_over.py``); on the CPU both wrappers run their
plain versions.

Reference quirks, treated as the JAX surface treats them:

  * Q1 (``bilinear_wrapper_torch`` returns NCHW, contradicting its own
    docstring): not reproduced — the output is NHWC.
  * Q2/Q3 (swapped x/y normalization scales): reproduced through the
    ``Convention.REF_HOMOGRAPHY`` / ``REF_PROJECTION`` conventions inside
    the respective pipelines.
  * Q4 (``format_network_input_torch``'s stray ``self``): dropped; call
    without the leading ``None``.

Layouts follow the reference call sites: images NHWC, MPIs ``[B, H, W, P,
4]``, plane-major stacks ``[P, B, H, W, C]``; ``SpaceToDepth`` /
``DepthToSpace`` are ``nn.Module``s on NCHW, like the torch modules they
mirror. The JAX package's ``shard_map`` version shim is JAX-only and has
no counterpart here.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from mpi_vision_tpu_torch.core import (
    camera,
    geometry,
    render,
    sampling,
    sweep,
)
from mpi_vision_tpu_torch.core.sampling import Convention
from mpi_vision_tpu_torch.data.realestate import (  # noqa: F401  (host-side)
    open_image,
    parse_camera_lines,
    read_file_lines,
)
from mpi_vision_tpu_torch.device import resolve_device

BACKEND = "torch"


def _check_backend(backend: str) -> None:
  if backend != BACKEND:
    raise ValueError(
        f"backend must be 'torch' here, got {backend!r}: "
        "mpi_vision_tpu_torch.compat is the torch backend; the JAX backend "
        "is the JAX package's mpi_vision_tpu.compat")


def _dev(backend: str, device) -> torch.device:
  _check_backend(backend)
  return resolve_device(device)


def _t(x, device: torch.device) -> torch.Tensor:
  """``x`` as a tensor on ``device``; float64 becomes float32."""
  t = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
  if t.dtype == torch.float64:
    t = t.to(torch.float32)
  return t.to(device)


def _stack(xs, device: torch.device) -> torch.Tensor:
  """A list/tuple of arrays stacked on a new leading axis, or ``xs``."""
  if isinstance(xs, (list, tuple)):
    return torch.stack([_t(x, device) for x in xs])
  return _t(xs, device)


# --- geometry -----------------------------------------------------------


def meshgrid_abs_torch(batch: int, height: int, width: int,
                       backend: str = BACKEND, device=None):
  """Homogeneous pixel grid ``[B, 3, H, W]`` (utils.py:18-33)."""
  grid = geometry.homogeneous_grid(height, width,
                                   device=_dev(backend, device))
  return grid.expand((batch,) + tuple(grid.shape))


def divide_safe_torch(num, den, backend: str = BACKEND, device=None):
  """Division with the reference's eps-where-zero guard (utils.py:35-39)."""
  dev = _dev(backend, device)
  return geometry.safe_divide(_t(num, dev), _t(den, dev))


def inv_homography_torch(k_s, k_t, rot, t, n_hat, a, backend: str = BACKEND,
                         device=None):
  """Plane-induced inverse homography ``[..., 3, 3]`` (utils.py:44-67)."""
  dev = _dev(backend, device)
  return geometry.inverse_homography(
      *(_t(x, dev) for x in (k_s, k_t, rot, t, n_hat, a)))


def inv_depths(start_depth, end_depth, num_depths, backend: str = BACKEND,
               device=None):
  """Inverse-depth-uniform plane depths, descending (utils.py:297-318)."""
  return camera.inv_depths(start_depth, end_depth, num_depths,
                           device=_dev(backend, device))


def make_intrinsics_matrix(fx, fy, cx, cy, backend: str = BACKEND,
                           device=None):
  """3x3 K from scalars (utils.py:576-581)."""
  return camera.intrinsics_matrix(fx, fy, cx, cy,
                                  device=_dev(backend, device))


def scale_intrinsics(intrinsics, height, width, backend: str = BACKEND,
                     device=None):
  """Elementwise intrinsics rescale (utils.py:535-546)."""
  return camera.scale_intrinsics(_t(intrinsics, _dev(backend, device)),
                                 height, width)


def preprocess_image_torch(image, backend: str = BACKEND, device=None):
  """[0, 1] -> [-1, 1] (utils.py:334-342)."""
  return camera.preprocess_image(_t(image, _dev(backend, device)))


def deprocess_image_torch(image, backend: str = BACKEND, device=None):
  """[-1, 1] -> uint8 [0, 255] (utils.py:344-352)."""
  return camera.deprocess_image(_t(image, _dev(backend, device)))


# --- sampling & rendering (homography path) -----------------------------


def resampler_wrapper_torch(imgs, coords, backend: str = BACKEND,
                            device=None):
  """Bilinear sample NHWC images at (0, 1)-space (x, y) coords with zeros
  padding (utils.py:395-407)."""
  dev = _dev(backend, device)
  return sampling.bilinear_sample(_t(imgs, dev), _t(coords, dev))


def bilinear_wrapper_torch(imgs, coords, backend: str = BACKEND,
                           device=None):
  """The same sampler as ``resampler_wrapper_torch`` — quirk Q1 (the NCHW
  output leak, utils.py:131-133) deliberately not reproduced."""
  return resampler_wrapper_torch(imgs, coords, backend, device)


def over_composite(rgbas, backend: str = BACKEND, device=None):
  """Back-to-front over-composite of the reference's LIST of ``[B, H, W,
  4]`` planes or a stacked ``[P, B, H, W, 4]`` (utils.py:136-157); the
  farthest plane's alpha is ignored. On the card: the ``compose_over``
  CUDA kernel; on the CPU its plain version."""
  from mpi_vision_tpu_torch.kernels import compose_over

  stack = _stack(rgbas, _dev(backend, device))
  if stack.dtype not in (torch.float32, torch.bfloat16):
    stack = stack.to(torch.float32)
  return compose_over.over_composite_pallas(stack.contiguous())


def projective_forward_homography_torch(src_images, intrinsics, pose, depths,
                                        backend: str = BACKEND, device=None):
  """Warp all MPI planes into the target view: ``[P, B, H, W, C]`` in and
  out (utils.py:237-265; n_hat = [0, 0, 1], a = -depth)."""
  dev = _dev(backend, device)
  return render.warp_planes(_t(src_images, dev), _t(pose, dev),
                            _t(depths, dev), _t(intrinsics, dev))


def mpi_render_view_torch(rgba_layers, tgt_pose, planes, intrinsics,
                          backend: str = BACKEND, device=None):
  """Render a novel view from an MPI ``[B, H, W, P, 4]`` -> ``[B, H, W, 3]``
  (utils.py:267-294), through the ``render_fused`` CUDA kernel on the card
  (its plain version on the CPU)."""
  dev = _dev(backend, device)
  return render.render_mpi(
      _t(rgba_layers, dev), _t(tgt_pose, dev), _t(planes, dev),
      _t(intrinsics, dev), method="fused_pallas")


# --- projection path (plane sweep) --------------------------------------


def pixel2cam_torch(depth, pixel_coords, intrinsics, backend: str = BACKEND,
                    device=None):
  """Pixels -> homogeneous camera frame ``[B, 4, H, W]`` (utils.py:356-375)."""
  dev = _dev(backend, device)
  return sweep.pixel2cam(_t(depth, dev), _t(pixel_coords, dev),
                         _t(intrinsics, dev))


def cam2pixel_torch(cam_coords, proj, backend: str = BACKEND, device=None):
  """Camera frame -> pixel (x, y) ``[B, H, W, 2]`` (utils.py:377-393)."""
  dev = _dev(backend, device)
  return sweep.cam2pixel(_t(cam_coords, dev), _t(proj, dev))


def projective_inverse_warp_torch(img, depth, pose, intrinsics,
                                  backend: str = BACKEND, device=None):
  """Depth-based inverse warp (utils.py:409-450, convention Q3)."""
  dev = _dev(backend, device)
  return sweep.projective_inverse_warp(
      *(_t(x, dev) for x in (img, depth, pose, intrinsics)))


def plane_sweep_torch(img, depth_planes, pose, intrinsics,
                      backend: str = BACKEND, device=None):
  """PSV ``[B, H, W, 3P]`` (utils.py:452-471)."""
  dev = _dev(backend, device)
  return sweep.plane_sweep(
      *(_t(x, dev) for x in (img, depth_planes, pose, intrinsics)))


def plane_sweep_torch_one(img, depth_planes, pose, intrinsics,
                          backend: str = BACKEND, device=None):
  """Unbatched PSV variant (utils.py:513-533)."""
  dev = _dev(backend, device)
  return sweep.plane_sweep_one(
      *(_t(x, dev) for x in (img, depth_planes, pose, intrinsics)))


def format_network_input_torch(ref_image, src_images, ref_pose, psv_src_poses,
                               planes, intrinsics, backend: str = BACKEND,
                               device=None):
  """Reference image ++ one PSV per source (utils.py:473-498, minus the
  stray ``self`` — quirk Q4). ``src_images``: list or ``[N, B, H, W, 3]``."""
  dev = _dev(backend, device)
  return sweep.format_network_input(
      _t(ref_image, dev), _stack(src_images, dev), _t(ref_pose, dev),
      _stack(psv_src_poses, dev), _t(planes, dev), _t(intrinsics, dev))


# --- pixel-shuffle modules (utils.py:803-820) ---------------------------


class SpaceToDepth(nn.Module):
  """NCHW ``[B, C, H, W] -> [B, C*b*b, H/b, W/b]``, torch unfold channel
  order — the reference module's contract (utils.py:803-817); the NHWC op
  of ``core.camera`` under a layout move, autograd intact."""

  def __init__(self, block_size: int):
    super().__init__()
    self.block_size = block_size

  def forward(self, x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
      x = torch.as_tensor(np.asarray(x))
    return camera.space_to_depth(x.movedim(1, -1),
                                 self.block_size).movedim(-1, 1)


class DepthToSpace(nn.Module):
  """NCHW ``[B, C*b*b, H, W] -> [B, C, H*b, W*b]`` (``PixelShuffle``
  order, utils.py:820)."""

  def __init__(self, block_size: int):
    super().__init__()
    self.block_size = block_size

  def forward(self, x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
      x = torch.as_tensor(np.asarray(x))
    return camera.depth_to_space(x.movedim(1, -1),
                                 self.block_size).movedim(-1, 1)


def resize_with_intrinsics_torch(path, intrinsics, height, width,
                                 backend: str = BACKEND, device=None):
  """Open + resize with the intrinsics rescaled (utils.py:549-572); the
  decode is host PIL, the results are moved to ``device``."""
  from mpi_vision_tpu_torch.data.realestate import resize_with_intrinsics

  dev = _dev(backend, device)
  k = intrinsics.detach().cpu().numpy() \
      if isinstance(intrinsics, torch.Tensor) else intrinsics
  image, k = resize_with_intrinsics(path, np.asarray(k), height, width)
  return _t(image, dev), _t(k, dev)


# --- remaining star-import tail ------------------------------------------
# Everything below completes the reference's module surface name-for-name
# (utils.py:7-16, 41-101, 160-233, 507-511, 601-687, 725-799).


def list_folders(path):
  """Immediate subdirectory paths (utils.py:7-9, dup :320-322); sorted for
  determinism (the reference exposes os.scandir order)."""
  return sorted(e.path for e in os.scandir(path) if e.is_dir())


def list_files(path):
  """Immediate file paths (utils.py:11-13); sorted for determinism."""
  return sorted(e.path for e in os.scandir(path) if e.is_file())


def flatten(lists):
  """Concatenate a list of lists (utils.py:15-16)."""
  return [x for sub in lists for x in sub]


def transpose_torch(rot, backend: str = BACKEND, device=None):
  """Transpose the last two dims (utils.py:41-42)."""
  return _t(rot, _dev(backend, device)).transpose(-2, -1)


def transform_points_torch(points, hom, backend: str = BACKEND, device=None):
  """Apply ``[..., 3, 3]`` homographies to ``[..., H, W, 3]`` points
  (utils.py:69-88)."""
  dev = _dev(backend, device)
  return geometry.apply_homography(_t(points, dev), _t(hom, dev))


def normalize_homogeneous_torch(points, backend: str = BACKEND, device=None):
  """(u, v, w) -> (u/w, v/w) with the safe divide (utils.py:90-101)."""
  return geometry.from_homogeneous(_t(points, _dev(backend, device)))


def transform_plane_imgs_torch(imgs, pixel_coords_trg, k_s, k_t, rot, t,
                               n_hat, a, backend: str = BACKEND,
                               device=None):
  """Per-plane homography warp (utils.py:160-195): inverse homography,
  point transform, Q2-convention normalization, bilinear sample.

  ``imgs``: ``[..., H_s, W_s, C]`` NHWC (Q1's channel-first output leak is
  not reproduced); ``pixel_coords_trg``: ``[..., H_t, W_t, 3]`` (u, v, 1).
  Leading dims broadcast (``planar_transform_torch`` relies on this).
  """
  dev = _dev(backend, device)
  pix = _t(pixel_coords_trg, dev)
  h_t, w_t = pix.shape[-3:-1]
  hom = geometry.inverse_homography(
      *(_t(x, dev) for x in (k_s, k_t, rot, t, n_hat, a)))
  pts = geometry.apply_homography(pix, hom)
  coords = sampling.normalize_pixel_coords(
      geometry.from_homogeneous(pts), h_t, w_t, Convention.REF_HOMOGRAPHY)
  return sampling.bilinear_sample(_t(imgs, dev), coords)


def planar_transform_torch(imgs, pixel_coords_trg, k_s, k_t, rot, t, n_hat,
                           a, backend: str = BACKEND, device=None):
  """All-planes batched warp (utils.py:198-233): ``imgs`` ``[L, B, H, W,
  C]``, per-batch cameras, per-plane ``n_hat [L, B, 1, 3]`` / ``a [L, B,
  1, 1]``; one broadcast ``transform_plane_imgs_torch`` call."""
  dev = _dev(backend, device)
  return transform_plane_imgs_torch(imgs, _t(pixel_coords_trg, dev)[None],
                                    k_s, k_t, rot, t, n_hat, a, backend, dev)


def show_torch_image(image):
  """Display a CHW [0, 255]-range image (utils.py:507-511). Import-guarded:
  matplotlib may be absent."""
  import matplotlib.pyplot as plt

  if isinstance(image, torch.Tensor):
    image = image.detach().cpu().numpy()
  arr = np.asarray(image, np.float32) / 255.0
  plt.imshow(np.clip(np.moveaxis(arr, 0, -1), 0.0, 1.0))


def crop_to_bounding_box_torch(image, offset_y, offset_x, height, width,
                               backend: str = BACKEND, device=None):
  """Differentiable crop via the bilinear sampler (utils.py:601-620)."""
  return camera.crop_to_bounding_box(_t(image, _dev(backend, device)),
                                     offset_y, offset_x, height, width)


def crop_image_and_adjust_intrinsics_torch(image, intrinsics, offset_y,
                                           offset_x, height, width,
                                           backend: str = BACKEND,
                                           device=None):
  """Crop + shift/renormalize normalized intrinsics (utils.py:622-651)."""
  dev = _dev(backend, device)
  return camera.crop_image_and_adjust_intrinsics(
      _t(image, dev), _t(intrinsics, dev), offset_y, offset_x, height,
      width)


def projective_pixel_transform(depth, src_pixel_coords, src_pose, tgt_pose,
                               src_intrinsics, tgt_intrinsics,
                               backend: str = BACKEND, device=None):
  """Source-camera pixels -> target-camera pixels (utils.py:653-687)."""
  dev = _dev(backend, device)
  return sweep.projective_pixel_transform(
      *(_t(x, dev) for x in (depth, src_pixel_coords, src_pose, tgt_pose,
                             src_intrinsics, tgt_intrinsics)))


def projective_inverse_warp_torch2(img, depth, pose, src_intrinsics,
                                   tgt_intrinsics, tgt_height, tgt_width,
                                   ret_flows: bool = False,
                                   backend: str = BACKEND, device=None):
  """Generalized inverse warp: separate src/tgt intrinsics + target size
  (utils.py:725-769). ``ret_flows`` also returns the raw source-pixel
  (x, y) flows, as the reference does."""
  dev = _dev(backend, device)
  img = _t(img, dev)
  out = sweep.projective_inverse_warp(
      img, _t(depth, dev), _t(pose, dev), _t(src_intrinsics, dev),
      tgt_intrinsics=_t(tgt_intrinsics, dev),
      tgt_size=(tgt_height, tgt_width), ret_coords=ret_flows)
  if not ret_flows:
    return out
  # sweep returns sampler-space (0, 1) coords; un-apply the Q3
  # normalization ((xy + 0.5) / [h_s, w_s]) to get raw source pixels.
  warped, coords = out
  h_s, w_s = img.shape[-3], img.shape[-2]
  scale = torch.tensor([float(h_s), float(w_s)], dtype=coords.dtype,
                       device=dev)
  return warped, coords * scale - 0.5


def plane_sweep_torch_one2(img, depth_planes, pose, src_intrinsics,
                           tgt_intrinsics, tgt_height, tgt_width,
                           backend: str = BACKEND, device=None):
  """Unbatched PSV with separate src/tgt intrinsics and target size
  (utils.py:771-799). ``img``: ``[H, W, C]`` -> ``[1, H_t, W_t, C*P]``."""
  dev = _dev(backend, device)
  return sweep.plane_sweep_one(
      _t(img, dev), _t(depth_planes, dev), _t(pose, dev),
      _t(src_intrinsics, dev), tgt_intrinsics=_t(tgt_intrinsics, dev),
      tgt_size=(tgt_height, tgt_width))
