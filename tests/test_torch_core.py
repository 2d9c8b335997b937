"""The port's core math (``mpi_vision_tpu_torch.core``) against the JAX package.

The same inputs, made from a seed with numpy, go through each JAX function
and its PyTorch counterpart. Tolerance: atol 1e-5 — both sides evaluate
the same f32 formulas, and differ only where XLA contracts a multiply-add
the port rounds twice (a few ulps of a pixel coordinate). Renders use
smooth seeded scenes so those ulps stay far below the tolerance; a
convention, half-pixel or compositing-order error moves them by orders
of magnitude more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_vision_tpu.core import camera as jcamera
from mpi_vision_tpu.core import compose as jcompose
from mpi_vision_tpu.core import geometry as jgeometry
from mpi_vision_tpu.core import render as jrender
from mpi_vision_tpu.core import sampling as jsampling
from mpi_vision_tpu_torch.core import camera as tcamera
from mpi_vision_tpu_torch.core import compose as tcompose
from mpi_vision_tpu_torch.core import geometry as tgeometry
from mpi_vision_tpu_torch.core import render as trender
from mpi_vision_tpu_torch.core import sampling as tsampling

ATOL = 1e-5
CONVENTIONS = [c.name for c in jsampling.Convention]
SHAPES = [(32, 32), (24, 48)]  # square and non-square


def _t(a):
  return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, atol=ATOL):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                             rtol=0)


def smooth_mpi(rng, b, h, w, p):
  """``[B, H, W, P, 4]`` in [0, 1]: one low-frequency sinusoid per channel."""
  yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                       indexing="ij")
  out = np.empty((b, h, w, p, 4), np.float32)
  for bi, pi, c in np.ndindex(b, p, 4):
    fx, fy = rng.uniform(0.5, 2.0, 2)
    out[bi, :, :, pi, c] = 0.5 + 0.5 * np.sin(
        np.pi * (fx * xx + fy * yy) + rng.uniform(0, 2 * np.pi))
  return out


def pose(tx=0.04, ty=0.02, tz=0.03, rx=0.006, ry=-0.008):
  out = np.eye(4, dtype=np.float32)
  cx, sx = np.cos(rx), np.sin(rx)
  cy, sy = np.cos(ry), np.sin(ry)
  rot_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float32)
  rot_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
  out[:3, :3] = rot_y @ rot_x
  out[:3, 3] = [tx, ty, tz]
  return out


def intrinsics(h, w):
  return np.array([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2], [0, 0, 1]],
                  np.float32)


# --- camera ------------------------------------------------------------------


@pytest.mark.parametrize("num", [2, 5, 32])
def test_inv_depths(num):
  np.testing.assert_array_equal(
      tcamera.inv_depths(1.0, 100.0, num).numpy(),
      np.asarray(jcamera.inv_depths(1.0, 100.0, num)))


def test_intrinsics_matrix():
  _close(tcamera.intrinsics_matrix(100.0, 90.0, 64.0, 32.0),
         jcamera.intrinsics_matrix(100.0, 90.0, 64.0, 32.0), atol=0)
  k = intrinsics(24, 48)
  _close(tcamera.scale_intrinsics(_t(k), 0.5, 2.0),
         jcamera.scale_intrinsics(jnp.asarray(k), 0.5, 2.0), atol=0)


# --- geometry ----------------------------------------------------------------


@pytest.mark.parametrize("h,w", SHAPES)
def test_homogeneous_grid(h, w):
  """The port's grid holds exact integers (as the reference's
  ``torch.linspace`` does); ``jnp.linspace`` rounds ``i/(W-1)*(W-1)``."""
  grid = tgeometry.homogeneous_grid(h, w)
  _close(grid, jgeometry.homogeneous_grid(h, w))
  np.testing.assert_array_equal(grid[0, 0].numpy(), np.arange(w))


def test_safe_divide_nudges_exact_zeros():
  num = np.array([1.0, -2.0, 3.0, 0.5], np.float32)
  den = np.array([0.0, 4.0, -0.0, 1e-9], np.float32)
  _close(tgeometry.safe_divide(_t(num), _t(den)),
         jgeometry.safe_divide(jnp.asarray(num), jnp.asarray(den)), atol=0)


def _random_geometry(rng, n):
  angles = rng.uniform(-0.2, 0.2, (n, 3))
  rots = []
  for ax, ay, az in angles:
    rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    rz = np.array([[np.cos(az), -np.sin(az), 0],
                   [np.sin(az), np.cos(az), 0], [0, 0, 1]])
    rots.append(rz @ ry @ rx)
  rot = np.asarray(rots, np.float32)
  t = rng.uniform(-0.1, 0.1, (n, 3, 1)).astype(np.float32)
  k = np.stack([intrinsics(24, 48)] * n)
  k[:, 0, 2] += rng.uniform(-2, 2, n).astype(np.float32)
  n_hat = np.broadcast_to(np.array([0.0, 0.0, 1.0], np.float32),
                          (n, 1, 3)).copy()
  a = -rng.uniform(1.0, 50.0, (n, 1, 1)).astype(np.float32)
  return k, rot, t, n_hat, a


def test_inverse_homography(rng):
  k, rot, t, n_hat, a = _random_geometry(rng, 6)
  got = tgeometry.inverse_homography(_t(k), _t(k), _t(rot), _t(t), _t(n_hat),
                                     _t(a))
  want = jgeometry.inverse_homography(*map(jnp.asarray,
                                           (k, k, rot, t, n_hat, a)))
  _close(got, want)


def test_inverse_intrinsics_matches_jnp_inv(rng):
  k = np.stack([intrinsics(h, w) for h, w in ((24, 48), (1080, 1920))])
  k[:, 0, 1] = rng.uniform(-1, 1, 2).astype(np.float32)  # skew
  got = tgeometry.inverse_intrinsics(_t(k)).numpy()
  np.testing.assert_allclose(got, np.asarray(jnp.linalg.inv(jnp.asarray(k))),
                             rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("h,w", SHAPES)
def test_apply_homography_and_from_homogeneous(rng, h, w):
  homs = rng.normal(size=(2, 3, 3)).astype(np.float32)
  homs[:, 2, 2] += 3.0
  grid = np.moveaxis(np.asarray(jgeometry.homogeneous_grid(h, w)), 0, -1)
  jpts = jgeometry.apply_homography(jnp.asarray(grid), jnp.asarray(homs))
  tpts = tgeometry.apply_homography(_t(grid), _t(homs))
  np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), rtol=1e-6,
                             atol=ATOL)
  _close(tgeometry.from_homogeneous(tpts),
         jgeometry.from_homogeneous(jpts))


def test_pose_rt_relative_pose_intrinsics_4x4(rng):
  a = np.stack([pose(0.1, 0.0, 0.2, 0.1, -0.1), pose(0.0, 0.3, 0.1, 0.0, 0.2)])
  b = np.stack([pose(-0.1, 0.1, 0.0, 0.05, 0.0), pose(0.2, 0.0, -0.1, 0.1, 0.1)])
  rot, t = tgeometry.pose_rt(_t(a))
  jrot, jt = jgeometry.pose_rt(jnp.asarray(a))
  _close(rot, jrot, atol=0)
  _close(t, jt, atol=0)
  _close(tgeometry.relative_pose(_t(a), _t(b)),
         jgeometry.relative_pose(jnp.asarray(a), jnp.asarray(b)))
  k = intrinsics(24, 48)[None]
  _close(tgeometry.intrinsics_to_4x4(_t(k)),
         jgeometry.intrinsics_to_4x4(jnp.asarray(k)), atol=0)


# --- sampling ----------------------------------------------------------------


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("h,w", SHAPES)
def test_normalize_pixel_coords(rng, convention, h, w):
  xy = rng.uniform(-5, 60, (h, w, 2)).astype(np.float32)
  _close(tsampling.normalize_pixel_coords(
      _t(xy), h, w, tsampling.Convention[convention]),
         jsampling.normalize_pixel_coords(
             jnp.asarray(xy), h, w, jsampling.Convention[convention]))


@pytest.mark.parametrize("h,w", SHAPES)
def test_bilinear_sample_zeros_padding(rng, h, w):
  """Coords reach past every edge: each tap is zeroed on its own."""
  image = rng.uniform(0, 1, (2, h, w, 4)).astype(np.float32)
  coords = rng.uniform(-0.2, 1.2, (2, h, w, 2)).astype(np.float32)
  got = tsampling.bilinear_sample(_t(image), _t(coords))
  _close(got, jsampling.bilinear_sample(jnp.asarray(image),
                                        jnp.asarray(coords)))
  assert (got == 0).all(-1).any(), "expected pixels fully off the image"


def test_bilinear_sample_broadcasts_image_without_copy(rng):
  """One image against a batch of coords: the image broadcasts."""
  image = rng.uniform(0, 1, (24, 48, 4)).astype(np.float32)
  coords = rng.uniform(0, 1, (3, 24, 48, 2)).astype(np.float32)
  _close(tsampling.bilinear_sample(_t(image), _t(coords)),
         jsampling.bilinear_sample(jnp.asarray(image), jnp.asarray(coords)))


# --- compose -----------------------------------------------------------------


@pytest.mark.parametrize("p", [1, 2, 5, 8])
def test_over_composite_scan_and_assoc(rng, p):
  rgba = rng.uniform(0, 1, (p, 2, 8, 12, 4)).astype(np.float32)
  want = jcompose.over_composite_scan(jnp.asarray(rgba))
  _close(tcompose.over_composite(_t(rgba), "scan"), want)
  _close(tcompose.over_composite(_t(rgba), "assoc"),
         jcompose.over_composite_assoc(jnp.asarray(rgba)))
  _close(tcompose.over_composite_assoc(_t(rgba)), want)


def test_plane_affine_and_combine_affine(rng):
  rgba = rng.uniform(0, 1, (4, 6, 4)).astype(np.float32)
  for first_opaque in (True, False):
    got = tcompose.plane_affine(_t(rgba), first_opaque)
    want = jcompose.plane_affine(jnp.asarray(rgba), first_opaque)
    for g, w in zip(got, want):
      _close(g, w, atol=0)
  a, b = tcompose.plane_affine(_t(rgba))
  ja, jb = jcompose.plane_affine(jnp.asarray(rgba))
  got = tcompose.combine_affine((a[0], b[0]), (a[1], b[1]))
  want = jcompose.combine_affine((ja[0], jb[0]), (ja[1], jb[1]))
  for g, w in zip(got, want):
    _close(g, w)


def test_over_composite_pallas_names_the_unported_kernel(rng):
  """'pallas' is the CUDA compose kernel (kernels/compose_over.py); on CPU
  tensors its plain version, equal to the JAX dispatcher's 'pallas'."""
  rgba = rng.uniform(0, 1, (2, 4, 4, 4)).astype(np.float32)
  got = tcompose.over_composite(_t(rgba), "pallas")
  assert got.shape == (4, 4, 3)
  _close(got, jcompose.over_composite(jnp.asarray(rgba), method="pallas"),
         atol=1e-6)
  assert torch.equal(got, tcompose.over_composite(_t(rgba), "scan"))
  with pytest.raises(ValueError, match="unknown composite method"):
    tcompose.over_composite(torch.zeros(2, 4, 4, 4), "bogus")


# --- render ------------------------------------------------------------------


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("h,w", SHAPES)
def test_plane_homographies_and_warp_coordinates(convention, h, w):
  depths = np.asarray(jcamera.inv_depths(1.0, 100.0, 4))
  poses = np.stack([pose(), pose(-0.03, 0.01, -0.02, -0.01, 0.015)])
  k = np.stack([intrinsics(h, w)] * 2)
  jhoms = jrender.plane_homographies(jnp.asarray(poses), jnp.asarray(depths),
                                     jnp.asarray(k))
  thoms = trender.plane_homographies(_t(poses), _t(depths), _t(k))
  _close(thoms, jhoms)
  conv_t = tsampling.Convention[convention]
  conv_j = jsampling.Convention[convention]
  _close(trender.warp_coordinates(thoms, h, w, conv_t),
         jrender.warp_coordinates(jhoms, h, w, conv_j))


@pytest.mark.parametrize("method", ["scan", "assoc", "fused"])
@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("h,w", SHAPES)
def test_render_mpi_plain_methods(rng, method, convention, h, w):
  p = 4
  mpi = smooth_mpi(rng, 2, h, w, p)
  poses = np.stack([pose(), pose(0.05, -0.02, -0.03, 0.01, 0.02)])
  depths = np.asarray(jcamera.inv_depths(1.0, 100.0, p))
  k = np.stack([intrinsics(h, w)] * 2)
  want = jrender.render_mpi(jnp.asarray(mpi), jnp.asarray(poses),
                            jnp.asarray(depths), jnp.asarray(k),
                            convention=jsampling.Convention[convention],
                            method=method)
  got = trender.render_mpi(_t(mpi), _t(poses), _t(depths), _t(k),
                           convention=tsampling.Convention[convention],
                           method=method)
  assert got.shape == (2, h, w, 3)
  _close(got, want)


def test_warp_planes_and_render_views(rng):
  h, w, p = 24, 48, 3
  mpi = smooth_mpi(rng, 1, h, w, p)[0]          # [H, W, P, 4]
  poses = np.stack([pose(), pose(0.02, 0.0, 0.01, 0.0, 0.01)])
  depths = np.asarray(jcamera.inv_depths(1.0, 100.0, p))
  k = intrinsics(h, w)
  conv = "EXACT"
  want = jrender.render_views(jnp.asarray(mpi), jnp.asarray(poses),
                              jnp.asarray(depths), jnp.asarray(k),
                              convention=jsampling.Convention[conv])
  got = trender.render_views(_t(mpi), _t(poses), _t(depths), _t(k),
                             convention=tsampling.Convention[conv])
  _close(got, want)
  planes = np.broadcast_to(np.moveaxis(mpi, 2, 0)[:, None],
                           (p, 2, h, w, 4)).copy()
  _close(trender.warp_planes(_t(planes), _t(poses), _t(depths),
                             _t(np.stack([k, k])),
                             tsampling.Convention[conv]),
         jrender.warp_planes(jnp.asarray(planes), jnp.asarray(poses),
                             jnp.asarray(depths), jnp.asarray(np.stack([k, k])),
                             jsampling.Convention[conv]))


def test_render_mpi_cropped_target(rng):
  """``tgt_intrinsics``/``out_hw`` on a plain method, as in the JAX package."""
  h, w, p = 24, 32, 3
  mpi = smooth_mpi(rng, 1, h, w, p)
  depths = np.asarray(jcamera.inv_depths(1.0, 100.0, p))
  k = intrinsics(h, w)[None]
  k_t = intrinsics(30, 40)[None]
  args = (mpi, pose()[None], depths, k)
  want = jrender.render_mpi(*map(jnp.asarray, args), method="scan",
                            tgt_intrinsics=jnp.asarray(k_t), out_hw=(30, 40))
  got = trender.render_mpi(*map(_t, args), method="scan",
                           tgt_intrinsics=_t(k_t), out_hw=(30, 40))
  assert got.shape == (1, 30, 40, 3)
  _close(got, want)
  with pytest.raises(ValueError, match="fused_pallas"):
    trender.render_mpi(*map(_t, args), method="fused_pallas",
                       tgt_intrinsics=_t(k_t), out_hw=(30, 40))
  got_pallas = trender.render_mpi(*map(_t, args), method="pallas",
                                  tgt_intrinsics=_t(k_t), out_hw=(30, 40))
  assert torch.equal(got_pallas, got)
  with pytest.raises(ValueError, match="unknown render method"):
    trender.render_mpi(*map(_t, args), method="bogus")
