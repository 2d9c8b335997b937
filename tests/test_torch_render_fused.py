"""The port's fused-render module against the JAX package's Pallas path.

``mpi_vision_tpu_torch.kernels.render_fused`` on CPU tensors runs the
kernel's plain version; the JAX side runs its Pallas kernels in interpret
mode, as ``tests/test_render_pallas.py`` does. The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py``.

Tolerances: atol 1e-5 where both sides evaluate the same f32 formulas
(``pixel_homographies``, ``reference_render``); atol 1e-4 against the
Pallas kernels, the tolerance the JAX package holds them to; 2e-3 against
``render_mpi(method="scan")`` under the reference conventions, which fold
their rescale into the 3x3 and so move a tap by up to ~1e-3 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_vision_tpu.core import render as jrender
from mpi_vision_tpu.core.camera import inv_depths as jinv_depths
from mpi_vision_tpu.core.sampling import Convention as JConvention
from mpi_vision_tpu.kernels import render_pallas as rp
from mpi_vision_tpu_torch.core import render as trender
from mpi_vision_tpu_torch.core.sampling import Convention as TConvention
from mpi_vision_tpu_torch.kernels import render_fused as rf

TRANSLATION = dict(tx=0.06, ty=-0.03, tz=-0.04)
ROTATION = dict(tx=0.04, ty=0.02, tz=0.03, rx=0.006, ry=-0.008)
# ~29 degrees of yaw: past the TPU kernels' banded tier, which falls back
# to XLA there; the CUDA kernel has no envelope.
PAST_BANDED = dict(tx=0.05, ry=0.5)
CONVENTIONS = [c.name for c in JConvention]


def _t(a):
  return torch.from_numpy(np.array(a, np.float32))


def _pose(tx=0.0, ty=0.0, tz=0.0, rx=0.0, ry=0.0):
  pose = np.eye(4, dtype=np.float32)
  cx, sx = np.cos(rx), np.sin(rx)
  cy, sy = np.cos(ry), np.sin(ry)
  rot_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float32)
  rot_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
  pose[:3, :3] = rot_y @ rot_x
  pose[:3, 3] = [tx, ty, tz]
  return pose[None]


def _intrinsics(h, w):
  return np.array([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2], [0, 0, 1]],
                  np.float32)[None]


def _smooth_planes(rng, p, h, w):
  """``[P, 4, H, W]`` low-frequency planes in [0, 1]."""
  yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                       indexing="ij")
  out = np.empty((p, 4, h, w), np.float32)
  for pi, c in np.ndindex(p, 4):
    fx, fy = rng.uniform(0.5, 2.0, 2)
    out[pi, c] = 0.5 + 0.5 * np.sin(np.pi * (fx * xx + fy * yy)
                                    + rng.uniform(0, 2 * np.pi))
  return out


def _homs(pose_kw, p, h, w, convention="EXACT"):
  """Pixel homographies from the JAX package: ``[P, 3, 3]`` numpy."""
  depths = jinv_depths(1.0, 100.0, p)
  return np.asarray(rp.pixel_homographies(
      jnp.asarray(_pose(**pose_kw)), depths, jnp.asarray(_intrinsics(h, w)),
      h, w, JConvention[convention]))[:, 0]


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("pose_kw", [TRANSLATION, ROTATION, PAST_BANDED])
@pytest.mark.parametrize("h,w", [(24, 40), (32, 256)])
def test_pixel_homographies(convention, pose_kw, h, w):
  p = 5
  depths = np.asarray(jinv_depths(1.0, 100.0, p))
  args = (_pose(**pose_kw), depths, _intrinsics(h, w))
  want = rp.pixel_homographies(*map(jnp.asarray, args), h, w,
                               JConvention[convention])
  got = rf.pixel_homographies(*map(_t, args), h, w, TConvention[convention])
  assert got.shape == (p, 1, 3, 3)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_is_separable_matches():
  for pose_kw in (TRANSLATION, ROTATION):
    homs = _homs(pose_kw, 3, 32, 256)
    assert rf.is_separable(_t(homs)) == rp.is_separable(homs)
  assert rf.is_separable(_t(_homs(TRANSLATION, 3, 32, 256)))


@pytest.mark.parametrize("pose_kw", [TRANSLATION, ROTATION, PAST_BANDED])
def test_reference_render(rng, pose_kw):
  p, h, w = 4, 24, 40
  planes = _smooth_planes(rng, p, h, w)
  homs = _homs(pose_kw, p, h, w)
  want = rp.reference_render(jnp.asarray(planes), jnp.asarray(homs))
  got = rf.reference_render(_t(planes), _t(homs))
  assert got.shape == (3, h, w)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_reference_render_batch(rng):
  p, h, w = 3, 24, 40
  planes = np.stack([_smooth_planes(rng, p, h, w) for _ in range(2)])
  homs = np.stack([_homs(TRANSLATION, p, h, w), _homs(ROTATION, p, h, w)])
  want = rp._reference_render_batch(jnp.asarray(planes), jnp.asarray(homs))
  got = rf._reference_render_batch(_t(planes), _t(homs))
  assert got.shape == (2, 3, h, w)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("pose_kw,separable", [(TRANSLATION, True),
                                               (ROTATION, False)])
def test_render_mpi_fused_vs_pallas_interpret(rng, pose_kw, separable):
  """CPU wrapper (plain version) vs the JAX Pallas kernels in interpret
  mode, at the shapes and tolerance of the JAX package's own test."""
  p, h, w = 5, 32, 256
  planes = rng.uniform(0, 1, (p, 4, h, w)).astype(np.float32)
  homs = _homs(pose_kw, p, h, w)
  want = rp.render_mpi_fused(jnp.asarray(planes), jnp.asarray(homs),
                             separable)                      # [3, H, W]
  launches = rf.render_mpi_fused.launches
  got = rf.render_mpi_fused(_t(planes).permute(0, 2, 3, 1).contiguous(),
                            _t(homs)[None])                  # [1, H, W, 3]
  assert rf.render_mpi_fused.launches == launches  # CPU: no kernel launch
  np.testing.assert_allclose(got[0].permute(2, 0, 1).numpy(),
                             np.asarray(want), atol=1e-4, rtol=0)


def test_pose_past_banded_envelope(rng):
  """Every pose renders through one path; past the TPU tiers' envelope
  the JAX side's answer is its XLA reference."""
  p, h, w = 5, 32, 256
  planes = rng.uniform(0, 1, (p, 4, h, w)).astype(np.float32)
  homs = _homs(PAST_BANDED, p, h, w)
  want = rp.reference_render(jnp.asarray(planes), jnp.asarray(homs))
  got = rf.render_mpi_fused(_t(planes).permute(0, 2, 3, 1).contiguous(),
                            _t(homs)[None])
  out = got[0].permute(2, 0, 1).numpy()
  np.testing.assert_allclose(out, np.asarray(want), atol=1e-4, rtol=0)
  assert (out == 0).all(0).any() and (out != 0).any(0).any()


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("h,w", [(32, 32), (24, 48)])
def test_render_mpi_fused_pallas_vs_jax_scan(rng, convention, h, w):
  p = 4
  mpi = rng.uniform(0, 1, (2, h, w, p, 4)).astype(np.float32)
  poses = np.concatenate([_pose(**ROTATION), _pose(**TRANSLATION)])
  depths = np.asarray(jinv_depths(1.0, 100.0, p))
  k = np.concatenate([_intrinsics(h, w)] * 2)
  want = jrender.render_mpi(
      jnp.asarray(mpi), jnp.asarray(poses), jnp.asarray(depths),
      jnp.asarray(k), convention=JConvention[convention], method="scan")
  got = trender.render_mpi(_t(mpi), _t(poses), _t(depths), _t(k),
                           convention=TConvention[convention],
                           method="fused_pallas")
  atol = 1e-4 if convention == "EXACT" else 2e-3
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("method", ["fused_pallas", "fused", "scan"])
def test_batched_views_bit_identical_to_single(rng, method):
  """A view's pixels do not depend on the batch it is rendered in."""
  h, w, p = 24, 40, 4
  mpi = _t(rng.uniform(0, 1, (h, w, p, 4)))
  poses = np.concatenate([
      _pose(**ROTATION), _pose(**TRANSLATION), _pose(**PAST_BANDED),
      _pose(0.01, 0.02, -0.05, 0.02, 0.03), _pose(-0.02, 0.0, 0.01)])
  depths = _t(jinv_depths(1.0, 100.0, p))
  k = _t(_intrinsics(h, w)[0])
  batch = trender.render_views(mpi, _t(poses), depths, k,
                               convention=TConvention.EXACT, method=method)
  for i in range(len(poses)):
    one = trender.render_views(mpi, _t(poses[i:i + 1]), depths, k,
                               convention=TConvention.EXACT, method=method)
    assert torch.equal(batch[i], one[0]), f"view {i} changed with the batch"


def test_wrapper_shared_scene_equals_per_view_scenes(rng):
  """A [P, H, W, 4] scene shared by V views (view stride 0) renders what
  V explicit copies do."""
  p, h, w = 3, 16, 24
  planes = _t(rng.uniform(0, 1, (p, h, w, 4)))
  homs = _t(np.stack([_homs(ROTATION, p, h, w), _homs(TRANSLATION, p, h, w)]))
  shared = rf.render_mpi_fused(planes, homs)
  copies = rf.render_mpi_fused(planes.expand(2, p, h, w, 4).contiguous(), homs)
  assert shared.shape == (2, h, w, 3)
  assert torch.equal(shared, copies)


def test_wrapper_rejects_what_the_kernel_does_not_take():
  planes = torch.zeros(3, 8, 8, 4)
  homs = torch.zeros(1, 3, 3, 3)
  with pytest.raises(TypeError, match="float32"):
    rf.render_mpi_fused(planes.double(), homs)
  with pytest.raises(ValueError, match="planes must be"):
    rf.render_mpi_fused(torch.zeros(3, 8, 8, 3), homs)
  with pytest.raises(ValueError, match="homs must be"):
    rf.render_mpi_fused(planes, torch.zeros(3, 3, 3))
  with pytest.raises(ValueError, match="planes but homs"):
    rf.render_mpi_fused(torch.zeros(2, 8, 8, 4), homs)
  with pytest.raises(ValueError, match="views but homs"):
    rf.render_mpi_fused(torch.zeros(2, 3, 8, 8, 4), homs)
  # Not on the CPU and not on CUDA: raises, never falls back.
  with pytest.raises(ValueError, match="CUDA device"):
    rf.render_mpi_fused(planes.to("meta"), homs.to("meta"))


def test_launch_shape():
  """The kernel's view chunks, grid and shared memory, and the limits the
  wrapper raises on."""
  fwd = rf.launch_shape(8, 32, 1080, 1920, shared=True)
  assert fwd == {"view_chunk": 4, "grid": (60, 135, 2), "block": (32, 8),
                 "smem_bytes": 4 * 32 * 36}
  assert rf.launch_shape(9, 32, 1080, 1920, True)["grid"][2] == 3
  assert rf.launch_shape(16, 32, 1080, 1920, True)["grid"][2] == 4
  assert rf.launch_shape(3, 32, 1080, 1920, True)["view_chunk"] == 3
  assert rf.launch_shape(3, 10, 224, 224, False)["view_chunk"] == 1
  assert rf.launch_shape(1, 32, 8, 8, True)["smem_bytes"] == 32 * 36
  rf.check_launch("t", 8, rf.MAX_PLANES, 8, 8, True)
  with pytest.raises(ValueError, match="shared-memory budget"):
    rf.check_launch("t", 8, rf.MAX_PLANES + 1, 8, 8, True)
  rf.check_launch("t", 1, rf.MAX_PLANES + 1, 8, 8, True)  # a chunk of one
  with pytest.raises(ValueError, match="grid"):
    rf.check_launch("t", rf.MAX_VIEWS + 1, 4, 8, 8, False)
  with pytest.raises(ValueError, match="32-bit"):
    rf.check_launch("t", 1, 4, 46341, 46341, True)


def test_plain_version_runs_only_for_cpu_tensors(rng):
  calls = rf.plain_render.calls
  rf.render_mpi_fused(torch.zeros(2, 8, 8, 4), torch.zeros(1, 2, 3, 3))
  assert rf.plain_render.calls == calls + 1
