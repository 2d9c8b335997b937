"""The port's tiny per-plane RGBA U-Net (BASELINE config 5) against JAX's.

Weights carried from ``TinyPlaneUNet.init`` with
``state_dict_from_jax_params`` give the port's ``nn.Module`` the JAX
module's forward (within 1e-5, the core tolerance); one step's gradients
through the L2 render loss — the port renders through
``method="fused_pallas"``, whose CPU route is the CUDA kernels' plain
versions forward and backward — agree with ``jax.grad`` within 1e-3 of
each tensor's largest entry (the stereo-mag step's bound); three Adam
steps at config 5's 1e-3 give the same losses within 1e-4.

The JAX side is shared: one module-scoped ``init`` per mix, and one
jitted Adam step of the render loss (its loss and gradients, and optax's
update) serves the gradient case and all three Adam steps (eager JAX
compiles each primitive of the render, its VJP and optax's per-leaf update
apart, which made those two cases the file's slowest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_vision_tpu.core import render as jrender
from mpi_vision_tpu.core.camera import inv_depths
from mpi_vision_tpu.models import tiny_unet as jtu
from mpi_vision_tpu_torch.core import render as trender
from mpi_vision_tpu_torch.kernels import render_fused, render_fused_bwd
from mpi_vision_tpu_torch.models import tiny_unet as ttu

HW, P, WIDTH = 16, 4, 8


def _inputs(seed=0, b=1):
  rng = np.random.default_rng(seed)
  net_input = rng.uniform(-1, 1, (b, HW, HW, 3 + 3 * P)).astype(np.float32)
  tgt = rng.uniform(-1, 1, (b, HW, HW, 3)).astype(np.float32)
  pose = np.eye(4, dtype=np.float32)[None].repeat(b, 0)
  pose[:, 0, 3] = 0.03
  pose[:, 2, 3] = -0.02
  depths = np.asarray(inv_depths(1.0, 100.0, P), np.float32)
  k = np.array([[HW / 2, 0, HW / 2], [0, HW / 2, HW / 2], [0, 0, 1]],
               np.float32)[None].repeat(b, 0)
  return net_input, tgt, pose, depths, k


@pytest.fixture(scope="module")
def jax_models():
  """``mix -> (jmodel, params)``, each initialised once."""
  cache = {}

  def get(mix):
    if mix not in cache:
      net_input = _inputs(0)[0]
      jmodel = jtu.TinyPlaneUNet(width=WIDTH, mix=mix)
      params = jmodel.init(jax.random.PRNGKey(0),
                           jtu.psv_from_net_input(jnp.asarray(net_input), P))
      cache[mix] = (jmodel, params)
    return cache[mix]

  return get


def _pair(jax_models, mix=2):
  """The JAX module and its params, and a fresh port module carrying
  them (the port's is rebuilt each time: the cases train it)."""
  jmodel, params = jax_models(mix)
  tmodel = ttu.TinyPlaneUNet(P, width=WIDTH, mix=mix)
  tmodel.load_state_dict(ttu.state_dict_from_jax_params(
      jax.tree_util.tree_map(np.asarray, params)), strict=True)
  return jmodel, params, tmodel


def test_psv_from_net_input_equals_jax():
  net_input = _inputs(1, b=2)[0]
  got = ttu.psv_from_net_input(torch.from_numpy(net_input), P)
  want = jtu.psv_from_net_input(jnp.asarray(net_input), P)
  assert got.shape == (2, HW, HW, P, 6)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mix", [2, 1, 0])
def test_forward_with_carried_weights_matches_jax(jax_models, mix):
  jmodel, params, tmodel = _pair(jax_models, mix)
  net_input = _inputs(2, b=2)[0]
  psv = jtu.psv_from_net_input(jnp.asarray(net_input), P)
  want = np.asarray(jmodel.apply(params, psv))
  with torch.no_grad():
    got = tmodel(torch.from_numpy(np.array(psv))).numpy()
  assert got.shape == (2, HW, HW, P, 4)
  np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
  assert (got[..., 3] >= 0).all() and (got[..., 3] <= 1).all()


def test_odd_bottleneck_and_same_padding():
  """12 x 20 pixels: the 1/4-res bottleneck is 3 x 5, so the stride-2
  convolutions see odd sizes too (flax SAME padding, not torch's)."""
  rng = np.random.default_rng(3)
  psv = rng.uniform(-1, 1, (1, 12, 20, 3, 6)).astype(np.float32)
  jmodel = jtu.TinyPlaneUNet(width=4, mix=1)
  params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(psv))
  tmodel = ttu.TinyPlaneUNet(3, width=4, mix=1)
  tmodel.load_state_dict(ttu.state_dict_from_jax_params(
      jax.tree_util.tree_map(np.asarray, params)))
  with torch.no_grad():
    got = tmodel(torch.from_numpy(psv)).numpy()
  np.testing.assert_allclose(got, np.asarray(jmodel.apply(params, psv)),
                             atol=1e-5, rtol=0)
  with pytest.raises(ValueError, match="planes"):
    tmodel(torch.zeros(1, 12, 20, 4, 6))


@pytest.fixture(scope="module")
def jax_adam_step(jax_models):
  """One jitted optax Adam step (1e-3) of the L2 render loss of the mix-2
  module at ``_inputs()``: ``(params, opt_state) -> (loss, grads,
  new_params, new_opt_state)``; with optax's ``init`` and the psv."""
  jmodel, _ = jax_models(2)
  net_input, tgt, pose, depths, k = _inputs()
  psv = jtu.psv_from_net_input(jnp.asarray(net_input), P)

  def loss_fn(p):
    mpi = jmodel.apply(p, psv)
    out = jrender.render_mpi(mpi, jnp.asarray(pose), jnp.asarray(depths),
                             jnp.asarray(k))
    return jnp.mean((out - jnp.asarray(tgt)) ** 2)

  tx = optax.adam(1e-3)

  def step(params, opt_state):
    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = tx.update(grads, opt_state)
    return loss, grads, optax.apply_updates(params, updates), opt_state

  return jax.jit(step), tx.init, psv


def _torch_loss(tmodel, psv, tgt, pose, depths, k):
  mpi = tmodel(psv)
  out = trender.render_mpi(mpi, pose, depths, k, method="fused_pallas")
  return torch.mean((out - tgt) ** 2)


def test_render_loss_gradients_match_jax(jax_models, jax_adam_step):
  _, params, tmodel = _pair(jax_models)
  _, tgt, pose, depths, k = _inputs()
  step, opt_init, psv = jax_adam_step
  jloss, jgrads, _, _ = step(params, opt_init(params))
  calls = (render_fused.plain_render.calls,
           render_fused_bwd.plain_rewarp_composite_vjp.calls,
           render_fused_bwd.plain_adjoint_warp.calls)
  tloss = _torch_loss(tmodel, torch.from_numpy(np.array(psv)),
                      *(torch.from_numpy(x) for x in (tgt, pose, depths, k)))
  tloss.backward()
  # The forward and both backward kernels' plain versions ran once each.
  assert (render_fused.plain_render.calls,
          render_fused_bwd.plain_rewarp_composite_vjp.calls,
          render_fused_bwd.plain_adjoint_warp.calls) == tuple(
              c + 1 for c in calls)
  np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
  want = ttu.state_dict_from_jax_params(
      jax.tree_util.tree_map(np.asarray, jgrads))
  got = {name: p.grad for name, p in tmodel.named_parameters()}
  assert set(got) == set(want)
  for name, ref in want.items():
    assert float(ref.abs().max()) > 0, name
    np.testing.assert_allclose(got[name].numpy(), ref.numpy(),
                               atol=1e-3 * float(ref.abs().max()), rtol=0,
                               err_msg=name)


def test_three_adam_steps_match_optax(jax_models, jax_adam_step):
  _, params, tmodel = _pair(jax_models)
  _, tgt, pose, depths, k = _inputs()
  step, opt_init, psv = jax_adam_step
  opt_state = opt_init(params)
  jlosses = []
  for _ in range(3):
    loss, _, params, opt_state = step(params, opt_state)
    jlosses.append(float(loss))
  opt = torch.optim.Adam(tmodel.parameters(), lr=1e-3, betas=(0.9, 0.999),
                         eps=1e-8)
  targs = [torch.from_numpy(x) for x in (tgt, pose, depths, k)]
  tpsv = torch.from_numpy(np.array(psv))
  tlosses = []
  for _ in range(3):
    opt.zero_grad()
    loss = _torch_loss(tmodel, tpsv, *targs)
    loss.backward()
    opt.step()
    tlosses.append(loss.item())
  np.testing.assert_allclose(tlosses, jlosses, atol=1e-4, rtol=0)
  assert tlosses[-1] < tlosses[0]
