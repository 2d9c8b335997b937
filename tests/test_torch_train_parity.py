"""Training-trajectory parity: the port against the JAX package.

The counterpart of ``bench/train_parity.py`` (which holds the JAX package
against its torch mirror): the full loss path (U-Net with InstanceNorm ->
MPI -> render -> VGG-perceptual loss -> Adam at the reference lr 2e-4,
no resize) from the same JAX weights carried across, over the same numpy
batches from the procedural dataset, JAX's ``make_train_step`` against the
port's (rendered through ``method="fused_pallas"``: its plain versions on
the CPU). Held to that script's own assertions: the first losses agree
within 1e-3 relative, each of the first 10 within 2%, the mean within
10%, and both runs learn. 20 steps at 32 px x 4 planes run in tier-1; the
script's 200 steps at 64 px x 5 planes are the ``slow`` case (its artifact,
``artifacts/train_parity.json``, reads a 0.33% mean and 1.1% max relative
difference between JAX and the torch mirror).
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_vision_tpu.data import realestate as jdata
from mpi_vision_tpu.models import stereo_mag as jmodel
from mpi_vision_tpu.train import loop as jloop
from mpi_vision_tpu.train import vgg as jvgg
from mpi_vision_tpu_torch.models import stereo_mag as tmodel
from mpi_vision_tpu_torch.train import loop as tloop
from mpi_vision_tpu_torch.train import vgg as tvgg

LR = 2e-4


def _batches(steps: int, img_size: int, num_planes: int) -> list[dict]:
  """``bench/train_parity.py``'s batches: 4 procedural scenes, cycled."""
  with tempfile.TemporaryDirectory(prefix="mpi_parity_") as root:
    jdata.synthesize_dataset(root, num_scenes=4, frames=4,
                             img_size=img_size, seed=0)
    ds = jdata.RealEstateDataset(root, img_size=img_size,
                                 num_planes=num_planes,
                                 rng=np.random.default_rng(7))
    batches, order = [], np.random.default_rng(11)
    while len(batches) < steps:
      for batch in jdata.iterate_batches(ds, batch_size=1, rng=order):
        batches.append({k: np.array(v) for k, v in batch.items()})
        if len(batches) >= steps:
          break
  return batches


def _trajectories(steps: int, img_size: int, num_planes: int):
  batches = _batches(steps, img_size, num_planes)
  net = jmodel.StereoMagnificationModel(num_planes=num_planes)
  params = jax.jit(net.init)(
      jax.random.key(0),
      jnp.zeros((1, img_size, img_size, 3 + 3 * num_planes)))["params"]
  vgg_params = jvgg.init_params(0)
  jstate = jloop.TrainState.create(apply_fn=net.apply, params=params,
                                   tx=optax.adam(LR))
  jstep = jloop.make_train_step(vgg_params, resize=None)
  jlosses = []
  for batch in batches:
    jstate, metrics = jstep(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    jlosses.append(metrics["loss"])
  jlosses = [float(v) for v in jax.device_get(jlosses)]

  state = tloop.create_train_state(num_planes=num_planes, learning_rate=LR,
                                   device="cpu")
  state.model.load_state_dict(tmodel.state_dict_from_jax_params(
      jax.tree.map(np.asarray, params), "instance"))
  vgg = tvgg.VGG16Features(tvgg.state_dict_from_jax_params(
      jax.tree.map(np.asarray, vgg_params)))
  tstep = tloop.make_train_step(vgg, resize=None, method="fused_pallas")
  tlosses = []
  for batch in batches:
    state, metrics = tstep(state, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    tlosses.append(metrics["loss"])
  tlosses = [float(v) for v in tlosses]
  return np.asarray(jlosses), np.asarray(tlosses)


@pytest.mark.parametrize("steps,img_size,num_planes", [
    (20, 32, 4),
    pytest.param(200, 64, 5, marks=pytest.mark.slow),
])
def test_trajectory_tracks_jax(steps, img_size, num_planes):
  jl, tl = _trajectories(steps, img_size, num_planes)
  rel = np.abs(jl - tl) / np.maximum(np.abs(jl), 1e-6)
  assert np.isfinite(tl).all()
  assert rel[0] < 1e-3, rel[0]
  assert rel[:10].max() < 0.02, rel[:10]
  assert rel.mean() < 0.10, rel.mean()
  assert jl[-1] < jl[0] and tl[-1] < tl[0], (jl[[0, -1]], tl[[0, -1]])
