"""The port's device mesh (``parallel/mesh.py``) against the JAX package's.

The JAX side runs on the suite's 8-device virtual CPU mesh, exactly as
``tests/test_parallel.py`` runs it; the port's meshes are ``["cpu"] * 8``
laid out as ``(8,)``, ``(2, 4)`` and ``(4, 2)`` — a device may repeat, and
one process runs every shard. The same seeded numpy inputs go through
both, at ``test_parallel.py``'s tolerances: 1e-5 for sharded renders and
composites, 1e-6 for the one-opaque-plane composite. Sharding must not
change a frame: the sharded ``fused_pallas`` render equals the unsharded
one to the bit (each shard is one call of the kernel's wrapper; on the
CPU its plain version).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_vision_tpu.core.camera import inv_depths as jinv_depths
from mpi_vision_tpu.parallel import mesh as jmesh
from mpi_vision_tpu_torch.core import compose, render
from mpi_vision_tpu_torch.kernels import render_fused as rf
from mpi_vision_tpu_torch.parallel import mesh as pmesh

H, W, P = 16, 16, 4
CPU8 = ["cpu"] * 8


def _jit(fn, **static):
  """``fn`` under ``jax.jit`` with ``static`` bound: eager JAX compiles
  every primitive of a ``shard_map`` body per shape."""
  return jax.jit(lambda *args: fn(*args, **static))


def _pose(tx, ry=0.0):
  pose = np.eye(4, dtype=np.float32)
  c, s = np.cos(ry), np.sin(ry)
  pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
  pose[0, 3] = tx
  return pose


@pytest.fixture
def scene(rng):
  mpi = rng.uniform(0, 1, (H, W, P, 4)).astype(np.float32)
  depths = np.asarray(jinv_depths(1.0, 100.0, P))
  k = np.array([[0.5 * W, 0, W / 2], [0, 0.5 * W, H / 2], [0, 0, 1]],
               np.float32)
  return mpi, depths, k


def _t(a):
  return torch.from_numpy(np.array(a, np.float32))


def _j(a):
  return jnp.asarray(a)


def test_make_mesh_shapes():
  m = pmesh.make_mesh(devices=CPU8)
  assert m.shape == {"data": 8} == dict(jmesh.make_mesh().shape)
  m2 = pmesh.make_mesh(("data", "planes"), shape=(2, 4), devices=CPU8)
  jm2 = jmesh.make_mesh(("data", "planes"), shape=(2, 4))
  assert m2.shape == {"data": 2, "planes": 4} == dict(jm2.shape)
  assert m2.devices.shape == jm2.devices.shape == (2, 4)
  assert m2.axis_names == jm2.axis_names
  # A repeated device is one distinct device; positions stay positions.
  assert m2.distinct_devices == [torch.device("cpu")]
  assert m2.axis_devices("planes") == [torch.device("cpu")] * 4
  assert pmesh.make_mesh(("planes",), devices=CPU8[:2]).shape == {"planes": 2}
  with pytest.raises(ValueError):
    pmesh.make_mesh(shape=(3, 3), devices=CPU8)


def test_make_mesh_without_a_card_raises(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    pmesh.make_mesh()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    pmesh.make_mesh(devices=["cuda"])
  assert pmesh.make_mesh(devices=["cpu"]).shape == {"data": 1}


def test_render_views_sharded_matches_jax(scene):
  mpi, depths, k = scene
  poses = np.stack([_pose(0.01 * i) for i in range(16)])
  got = pmesh.render_views_sharded(_t(mpi), _t(poses), _t(depths), _t(k),
                                   pmesh.make_mesh(devices=CPU8))
  want = _jit(jmesh.render_views_sharded, mesh=jmesh.make_mesh())(
      _j(mpi), _j(poses), _j(depths), _j(k))
  assert got.shape == (16, H, W, 3)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("method", ["fused_pallas", "fused", "pallas"])
def test_sharded_render_equals_unsharded_to_the_bit(scene, method):
  mpi, depths, k = (_t(a) for a in scene)
  poses = _t(np.stack([_pose(0.02 * i - 0.05, 0.01 * i) for i in range(8)]))
  calls = rf.plain_render.calls
  launches = rf.render_mpi_fused.launches
  got = pmesh.render_views_sharded(mpi, poses, depths, k,
                                   pmesh.make_mesh(devices=CPU8),
                                   method=method)
  if method == "fused_pallas":
    # One wrapper call per shard; CPU tensors run its plain version and
    # launch nothing.
    assert rf.plain_render.calls - calls == 8
    assert rf.render_mpi_fused.launches == launches
  want = render.render_views(mpi, poses, depths, k, method=method)
  assert torch.equal(got, want)
  again = pmesh.render_views_sharded(mpi, poses, depths, k,
                                     pmesh.make_mesh(devices=CPU8),
                                     method=method)
  assert torch.equal(got, again)


def test_sharded_tile_crop_equals_the_full_render(scene):
  """``src_window`` passes through: a crop holding every tap renders the
  full scene's frame, sharded or not."""
  mpi, depths, k = (_t(a) for a in scene)
  poses = _t(np.stack([_pose(0.002 * i) for i in range(4)]))
  crop = mpi[2:14, 1:15].contiguous()
  mesh = pmesh.make_mesh(devices=CPU8[:4])
  got = pmesh.render_views_sharded(crop, poses, depths, k, mesh,
                                   method="pallas", src_window=(2, 1, H, W))
  want = render.render_views(crop, poses, depths, k, method="pallas",
                             src_window=(2, 1, H, W))
  assert torch.equal(got, want)


def test_sharded_render_with_a_target_camera(scene):
  """``tgt_intrinsics``/``out_hw`` reach every shard, as in JAX."""
  mpi, depths, k = scene
  poses = np.stack([_pose(0.01 * i) for i in range(8)])
  k_t = k * np.array([[0.5], [0.5], [1.0]], np.float32)
  got = pmesh.render_views_sharded(
      _t(mpi), _t(poses), _t(depths), _t(k), pmesh.make_mesh(devices=CPU8),
      tgt_intrinsics=_t(k_t), out_hw=(H // 2, W // 2))
  jm = jmesh.make_mesh()
  want = jax.jit(lambda a, b, c, d, e: jmesh.render_views_sharded(
      a, b, c, d, jm, tgt_intrinsics=e, out_hw=(H // 2, W // 2)))(
          _j(mpi), _j(poses), _j(depths), _j(k), _j(k_t))
  assert got.shape == (8, H // 2, W // 2, 3)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_render_views_sharded_rejects_indivisible(scene):
  mpi, depths, k = scene
  poses = np.stack([_pose(0.01)] * 3)
  with pytest.raises(ValueError, match="not divisible"):
    jmesh.render_views_sharded(_j(mpi), _j(poses), _j(depths), _j(k),
                               jmesh.make_mesh())
  with pytest.raises(ValueError, match="not divisible"):
    pmesh.render_views_sharded(_t(mpi), _t(poses), _t(depths), _t(k),
                               pmesh.make_mesh(devices=CPU8))


@pytest.mark.parametrize("batch_dims", [(), (2,)])
def test_plane_sharded_composite_matches_jax(rng, batch_dims):
  p, h, w = 16, 8, 12
  rgba = rng.uniform(0, 1, (p,) + batch_dims + (h, w, 4)).astype(np.float32)
  got = pmesh.over_composite_planes_sharded(
      _t(rgba), pmesh.make_mesh(("planes",), devices=CPU8))
  want = _jit(jmesh.over_composite_planes_sharded,
              mesh=jmesh.make_mesh(("planes",)))(_j(rgba))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
  np.testing.assert_allclose(got.numpy(),
                             compose.over_composite(_t(rgba)).numpy(),
                             atol=1e-5)


def test_plane_sharded_composite_single_opaque_plane(rng):
  """The farthest plane's alpha is ignored by mesh position: the other
  shards on the same (repeated) device keep theirs."""
  p, h, w = 8, 8, 12
  rgba = rng.uniform(0, 1, (p, h, w, 4)).astype(np.float32)
  rgba[1:, ..., 3] = 0.0  # only the farthest plane visible
  got = pmesh.over_composite_planes_sharded(
      _t(rgba), pmesh.make_mesh(("planes",), devices=CPU8))
  want = _jit(jmesh.over_composite_planes_sharded,
              mesh=jmesh.make_mesh(("planes",)))(_j(rgba))
  np.testing.assert_allclose(got.numpy(), rgba[0, ..., :3], atol=1e-6)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_plane_sharded_composite_rejects_indivisible(rng):
  rgba = rng.uniform(0, 1, (6, 4, 4, 4)).astype(np.float32)
  with pytest.raises(ValueError, match="not divisible"):
    jmesh.over_composite_planes_sharded(_j(rgba), jmesh.make_mesh(("planes",)))
  with pytest.raises(ValueError, match="not divisible"):
    pmesh.over_composite_planes_sharded(
        _t(rgba), pmesh.make_mesh(("planes",), devices=CPU8))


@pytest.mark.parametrize("shape,views", [((2, 4), 4), ((4, 2), 8)])
def test_views_planes_sharded_matches_jax(scene, shape, views):
  mpi, depths, k = scene
  poses = np.stack([_pose(0.02 * i) for i in range(views)])
  axes = ("data", "planes")
  got = pmesh.render_views_planes_sharded(
      _t(mpi), _t(poses), _t(depths), _t(k),
      pmesh.make_mesh(axes, shape=shape, devices=CPU8))
  want = _jit(jmesh.render_views_planes_sharded,
              mesh=jmesh.make_mesh(axes, shape=shape))(
      _j(mpi), _j(poses), _j(depths), _j(k))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
  single = render.render_views(_t(mpi), _t(poses), _t(depths), _t(k))
  np.testing.assert_allclose(got.numpy(), single.numpy(), atol=1e-5)


def test_views_planes_sharded_on_a_mesh_laid_out_planes_first(scene):
  """The axes are found by name, whatever their order in the mesh."""
  mpi, depths, k = (_t(a) for a in scene)
  poses = _t(np.stack([_pose(0.02 * i) for i in range(4)]))
  got = pmesh.render_views_planes_sharded(
      mpi, poses, depths, k,
      pmesh.make_mesh(("planes", "data"), shape=(4, 2), devices=CPU8))
  want = pmesh.render_views_planes_sharded(
      mpi, poses, depths, k,
      pmesh.make_mesh(("data", "planes"), shape=(2, 4), devices=CPU8))
  assert torch.equal(got, want)


def test_views_planes_sharded_rejects_indivisible(scene):
  mpi, depths, k = scene
  mesh = pmesh.make_mesh(("data", "planes"), shape=(2, 4), devices=CPU8)
  with pytest.raises(ValueError, match="not divisible"):
    jmesh.render_views_planes_sharded(
        _j(mpi), jnp.zeros((3, 4, 4)), _j(depths), _j(k),
        jmesh.make_mesh(("data", "planes"), shape=(2, 4)))
  with pytest.raises(ValueError, match="not divisible"):
    pmesh.render_views_planes_sharded(_t(mpi), torch.zeros((3, 4, 4)),
                                      _t(depths), _t(k), mesh)


def _leaves(rng):
  return {
      "ref_img": rng.uniform(size=(8, 4, 4, 3)).astype(np.float32),
      "intrinsics": rng.uniform(size=(16, 3, 3)).astype(np.float32),
      "mpi_planes": rng.uniform(size=(8,)).astype(np.float32),
      "rows": rng.uniform(size=(8, 5)).astype(np.float32),
      "odd": rng.uniform(size=(3, 2)).astype(np.float32),
      "scalar": np.float32(2.0),
  }


def test_batch_spec_matches_jax_leaf_for_leaf(rng):
  leaves = _leaves(rng)
  for shape, devices in (((8,), CPU8), ((2, 4), CPU8), ((4,), CPU8[:4])):
    axes = ("data", "planes")[:len(shape)]
    m = pmesh.make_mesh(axes, shape=shape, devices=devices)
    jm = jmesh.make_mesh(axes, shape=shape,
                         devices=jmesh.jax.devices()[:len(devices)])
    for name, a in leaves.items():
      want = jmesh.batch_spec(_j(a), jm)
      got = pmesh.batch_spec(torch.as_tensor(a), m)
      assert tuple(got) == tuple(want), (shape, name)


def test_shard_batch_places_as_jax_does(rng):
  leaves = _leaves(rng)
  m = pmesh.make_mesh(devices=CPU8)
  sharded = pmesh.shard_batch(leaves, m)
  placed = jmesh.shard_batch({k: _j(v) for k, v in leaves.items()},
                             jmesh.make_mesh())
  for name, a in leaves.items():
    spec = sharded.specs[name]
    assert tuple(spec) == tuple(placed[name].sharding.spec), name
    pieces = [s[name] for s in sharded.shards]
    if spec:
      assert all(p.shape[0] == a.shape[0] // 8 for p in pieces)
    else:
      # Replicated on a repeated device: one shared copy, not eight.
      assert all(p is pieces[0] for p in pieces)
  for name, a in leaves.items():
    pieces = [s[name] for s in sharded.shards]
    whole = torch.cat(pieces) if sharded.specs[name] else pieces[0]
    np.testing.assert_array_equal(whole.numpy(), a)


def test_replicate_shares_copies_on_a_repeated_device():
  model = torch.nn.Linear(3, 2)
  tree = {"w": torch.ones(4), "m": model}
  rep = pmesh.replicate(tree, pmesh.make_mesh(devices=CPU8))
  assert list(rep.copies) == [torch.device("cpu")]
  assert rep.value["w"] is tree["w"] and rep.value["m"] is model
