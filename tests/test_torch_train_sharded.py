"""The port's data-parallel train steps against the JAX package's.

``train.loop.shard_train_step`` and ``shard_train_step_planned`` of both
packages take one step from the same weights (the JAX U-Net's, carried
across with ``models/stereo_mag.py``'s ``state_dict_from_jax_params``) on
the same seeded numpy batch of 8 at 32 px and 4 planes, ``norm=None``, the
L2 loss — ``tests/test_train.py``'s sharded cases. The JAX side runs on
the suite's 8-device CPU mesh, its planned step through the Pallas
kernels in interpret mode; the port's mesh is ``["cpu"] * 8``, its
planned step through the kernels' plain versions. Tolerances are
``test_train.py``'s: loss 1e-5, params 1e-5 (``shard_train_step``) and
1e-4 (the planned step). The sharded port step is also held to the port's
own single-device step, run twice to the bit, and given a mesh of two
distinct devices (``cpu`` and ``cpu:0``, one memory) so the replica, the
gradient gather and the refresh after Adam's step run as on two cards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_vision_tpu.core.camera import inv_depths as jinv_depths
from mpi_vision_tpu.models import stereo_mag as jmodel
from mpi_vision_tpu.parallel import mesh as jmesh
from mpi_vision_tpu.train import loop as jloop
from mpi_vision_tpu_torch.models import stereo_mag as tmodel
from mpi_vision_tpu_torch.parallel import mesh as pmesh
from mpi_vision_tpu_torch.train import loop as tloop

HW, P, B = 32, 4, 8
CPU8 = ["cpu"] * 8


def _batch(rng, pose, b=B):
  """``tests/test_train.py``'s batch, numpy."""
  k = np.array([[HW / 2, 0, HW / 2], [0, HW / 2, HW / 2], [0, 0, 1]],
               np.float32)
  return {
      "net_input": rng.uniform(-1, 1, (b, HW, HW, 3 + 3 * P)).astype(
          np.float32),
      "ref_img": rng.uniform(-1, 1, (b, HW, HW, 3)).astype(np.float32),
      "tgt_img": rng.uniform(-1, 1, (b, HW, HW, 3)).astype(np.float32),
      "tgt_img_cfw": np.stack([pose] * b),
      "ref_img_wfc": np.stack([np.eye(4, dtype=np.float32)] * b),
      "intrinsics": np.stack([k] * b),
      "mpi_planes": np.asarray(jinv_depths(1.0, 100.0, P)),
  }


def _translate():
  pose = np.eye(4, dtype=np.float32)
  pose[0, 3] = 0.04
  return pose


def _rot_pose(ry=0.006, tx=0.03):
  pose = np.eye(4, dtype=np.float32)
  c, s = np.cos(ry), np.sin(ry)
  pose[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
  pose[0, 3] = tx
  return pose


def _torch(batch):
  return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_state():
  """The port's seeded initial U-Net carried into a JAX train state (the
  JAX package's ``params_from_torch_state``; Adam at its default 2e-4):
  the same weights on both sides, without JAX's ``init`` trace."""
  port = tloop.create_train_state(num_planes=P, norm=None, device="cpu")
  net = jmodel.StereoMagnificationModel(num_planes=P, norm=None)
  params = jax.tree.map(jnp.asarray, jmodel.params_from_torch_state(
      port.model.state_dict(), None)["params"])
  tx = optax.adam(2e-4)
  return jloop.TrainState(step=0, apply_fn=net.apply, params=params, tx=tx,
                          opt_state=jax.jit(tx.init)(params))


def _port_state(jstate):
  """A port train state holding the JAX state's weights (carried back with
  ``state_dict_from_jax_params``), Adam at the JAX default LR."""
  state = tloop.create_train_state(num_planes=P, norm=None, device="cpu")
  state.model.load_state_dict(tmodel.state_dict_from_jax_params(
      jax.tree.map(np.asarray, jstate.params), None))
  return state


def _assert_params_close(state, jparams, atol):
  want = tmodel.state_dict_from_jax_params(jax.tree.map(np.asarray, jparams),
                                           None)
  for name, param in state.model.named_parameters():
    np.testing.assert_allclose(param.detach().numpy(), want[name].numpy(),
                               atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("planned,pose,atol", [
    (False, _translate(), 1e-5), (True, _rot_pose(), 1e-4)],
    ids=["shard_train_step", "shard_train_step_planned"])
def test_sharded_step_matches_jax(rng, jax_state, planned, pose, atol):
  batch = _batch(rng, pose)
  jm = jmesh.make_mesh()
  make_j = (jloop.shard_train_step_planned if planned
            else jloop.shard_train_step)
  js, jmetrics = make_j(jm, vgg_params=None)(
      jmesh.replicate(jax_state, jm),
      jmesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, jm))

  mesh = pmesh.make_mesh(devices=CPU8)
  make_t = (tloop.shard_train_step_planned if planned
            else tloop.shard_train_step)
  rep, metrics = make_t(mesh, vgg=None)(
      pmesh.replicate(_port_state(jax_state), mesh),
      pmesh.shard_batch(_torch(batch), mesh))
  assert isinstance(rep, pmesh.Replicated) and rep.value.step == 1
  assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= 1e-5
  _assert_params_close(rep.value, js.params, atol)


def test_sharded_step_matches_the_single_device_step(rng, jax_state):
  batch = _torch(_batch(rng, _rot_pose(), b=4))
  single = _port_state(jax_state)
  _, m1 = tloop.make_train_step(method="fused_pallas")(single, batch)
  mesh = pmesh.make_mesh(devices=CPU8[:4])
  sharded, m2 = tloop.shard_train_step_planned(mesh)(
      _port_state(jax_state), batch)
  assert isinstance(sharded, tloop.TrainState) and sharded.step == 1
  assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-5
  want = dict(single.model.named_parameters())
  for name, param in sharded.model.named_parameters():
    np.testing.assert_allclose(param.detach().numpy(),
                               want[name].detach().numpy(), atol=1e-5,
                               rtol=0, err_msg=name)


def _three_steps(jax_state, batch, devices):
  mesh = pmesh.make_mesh(devices=devices)
  step = tloop.shard_train_step_planned(mesh)
  rep = pmesh.replicate(_port_state(jax_state), mesh)
  sharded = pmesh.shard_batch(batch, mesh)
  losses = []
  for _ in range(3):
    rep, metrics = step(rep, sharded)
    losses.append(metrics["loss"])
  return rep, torch.stack(losses)


def test_two_sharded_runs_are_bit_identical(rng, jax_state):
  batch = _torch(_batch(rng, _rot_pose(), b=2))
  rep_a, losses_a = _three_steps(jax_state, batch, CPU8[:2])
  rep_b, losses_b = _three_steps(jax_state, batch, CPU8[:2])
  assert torch.equal(losses_a, losses_b)
  for a, b in zip(rep_a.value.model.parameters(),
                  rep_b.value.model.parameters()):
    assert torch.equal(a, b)


def test_distinct_devices_replicate_gather_and_refresh(rng, jax_state):
  """``cpu`` and ``cpu:0`` are two mesh devices sharing one memory: the
  second gets a parameter-only replica (no Adam state), its gradients
  come back to the master, and after the step the replica equals the
  master. The result equals the same mesh on one repeated device."""
  batch = _torch(_batch(rng, _rot_pose(), b=2))
  two = ["cpu", "cpu:0"]
  mesh = pmesh.make_mesh(devices=two)
  rep = pmesh.replicate(_port_state(jax_state), mesh)
  replica = rep.on(torch.device("cpu", 0))
  assert replica.optimizer is None
  assert replica.model is not rep.value.model
  rep_d, losses_d = _three_steps(jax_state, batch, two)
  rep_s, losses_s = _three_steps(jax_state, batch, ["cpu", "cpu"])
  assert torch.equal(losses_d, losses_s)
  master = rep_d.value.model
  other = rep_d.on(torch.device("cpu", 0))
  assert other.step == rep_d.value.step == 3
  for a, b, c in zip(master.parameters(), other.model.parameters(),
                     rep_s.value.model.parameters()):
    assert torch.equal(a, b) and torch.equal(a, c)


def test_indivisible_batch_raises(rng, jax_state):
  batch = _torch(_batch(rng, _translate(), b=3))
  mesh = pmesh.make_mesh(devices=CPU8)
  step = tloop.shard_train_step(mesh)
  with pytest.raises(ValueError, match="not divisible"):
    step(_port_state(jax_state), batch)
  with pytest.raises(ValueError, match="not divisible"):
    step(pmesh.replicate(_port_state(jax_state), mesh),
         pmesh.shard_batch(batch, mesh))
  jm = jmesh.make_mesh()
  with pytest.raises(ValueError, match="not divisible"):
    jloop.shard_train_step_planned(jm, vgg_params=None)(
        jmesh.replicate(jax_state, jm),
        jmesh.shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                          jm))


def test_replicate_refuses_a_state_off_the_first_device(jax_state):
  mesh = pmesh.make_mesh(devices=["cpu:0", "cpu"])
  with pytest.raises(ValueError, match="first device"):
    pmesh.replicate(_port_state(jax_state), mesh)
