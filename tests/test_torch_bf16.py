"""``--bf16`` in the port against the JAX package's bf16 compute.

``TrainConfig(compute_dtype="bfloat16")`` runs the U-Net's and the VGG
loss's convs in bf16 with f32 parameters, f32 norm statistics and an f32
output, as the JAX package's flax ``dtype=`` does. The same seeded inputs
and the same weights (carried across with ``state_dict_from_jax_params``)
go through both packages.

Tolerances are the JAX package's own for bf16 against f32: the U-Net's
output at mean < 2e-2 and max < 0.2 (``tests/test_models.py``,
``TestBF16Compute``: bf16's 8-bit mantissa compounds through ~20 layers),
the VGG-perceptual loss at 5% relative (``tests/test_train.py``,
``test_vgg_bf16_loss_tracks_f32``). bf16 roundings differ between XLA's and
PyTorch's CPU convolutions, so the port's bf16 is held to JAX's bf16 at
those same bounds, and, over five seeds, at tighter ones that a bf16
InstanceNorm does not meet.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_vision_tpu import config as jconfig
from mpi_vision_tpu.models import stereo_mag as jmodel
from mpi_vision_tpu.train import vgg as jvgg
from mpi_vision_tpu_torch import cli
from mpi_vision_tpu_torch import config as tconfig
from mpi_vision_tpu_torch.models import stereo_mag as tmodel
from mpi_vision_tpu_torch.train import loss as tloss
from mpi_vision_tpu_torch.train import vgg as tvgg

P, HW = 4, 32


def _within_bf16_bound(got, want):
  d = np.abs(np.asarray(got) - np.asarray(want))
  assert d.mean() < 2e-2 and d.max() < 0.2, (d.mean(), d.max())


@pytest.fixture(scope="module", params=[None, "instance"])
def unet_pair(request):
  """JAX params at init (numpy), an input, and both packages' bf16 and
  f32 outputs on them."""
  norm = request.param
  rng = np.random.default_rng(0)
  x = rng.uniform(-1, 1, (1, HW, HW, 3 + 3 * P)).astype(np.float32)
  m32 = jmodel.StereoMagnificationModel(num_planes=P, norm=norm)
  mbf = jmodel.StereoMagnificationModel(num_planes=P, norm=norm,
                                        dtype=jnp.bfloat16)
  params = jax.tree.map(np.asarray, jax.jit(m32.init)(
      jax.random.PRNGKey(0), jnp.asarray(x))["params"])
  out = {"jax_bf16": np.asarray(jax.jit(mbf.apply)({"params": params},
                                                   jnp.asarray(x)))}
  for name, dtype in (("port_bf16", torch.bfloat16), ("port_f32", None)):
    model = tmodel.StereoMagnificationModel(num_planes=P, norm=norm,
                                            dtype=dtype)
    model.load_state_dict(tmodel.state_dict_from_jax_params(params, norm))
    with torch.no_grad():
      out[name] = model(torch.from_numpy(x))
  return norm, params, x, out


def test_bf16_unet_tracks_jax_bf16_and_port_f32(unet_pair):
  _, _, _, out = unet_pair
  assert out["port_bf16"].dtype == torch.float32      # output cast back
  assert out["port_bf16"].shape == (1, HW, HW, 3 + 2 * P)
  _within_bf16_bound(out["port_bf16"].numpy(), out["jax_bf16"])
  _within_bf16_bound(out["port_bf16"].numpy(), out["port_f32"].numpy())
  # bf16 really ran: the output is not the f32 network's.
  assert not torch.equal(out["port_bf16"], out["port_f32"])


# The tighter bounds below, at about 2.5x the readings on five seeds
# (PERF.md): with InstanceNorm, mean |port - JAX| averaged over the seeds
# 1.9e-3 and the median of the per-seed max 3.1e-3; without norms, 1.2e-4
# and 1.6e-3. Norm statistics taken in bf16 read 1.09e-2 and 0.097.
SEEDS = range(5)
TIGHT_MEAN, TIGHT_MEDIAN_MAX = 5e-3, 1e-2


@pytest.mark.parametrize("norm", [None, "instance"])
def test_bf16_unet_tracks_jax_bf16_closely_over_seeds(norm):
  """JAX's bound is loose enough to pass a wrong cast layout; over five
  seeds the port's bf16 stays several times closer to JAX's bf16 than
  either a bf16 InstanceNorm or the f32 network comes."""
  m32 = jmodel.StereoMagnificationModel(num_planes=P, norm=norm)
  mbf = jmodel.StereoMagnificationModel(num_planes=P, norm=norm,
                                        dtype=jnp.bfloat16)
  init, apply_bf = jax.jit(m32.init), jax.jit(mbf.apply)
  means, maxes = [], []
  for seed in SEEDS:
    x = np.random.default_rng(seed).uniform(
        -1, 1, (1, HW, HW, 3 + 3 * P)).astype(np.float32)
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed),
                                           jnp.asarray(x))["params"])
    want = np.asarray(apply_bf({"params": params}, jnp.asarray(x)))
    model = tmodel.StereoMagnificationModel(num_planes=P, norm=norm,
                                            dtype=torch.bfloat16)
    model.load_state_dict(tmodel.state_dict_from_jax_params(params, norm))
    with torch.no_grad():
      d = np.abs(model(torch.from_numpy(x)).numpy() - want)
    means.append(float(d.mean()))
    maxes.append(float(d.max()))
  print(f"bf16 U-Net vs JAX bf16, norm {norm}, seeds {list(SEEDS)}: mean "
        f"{means}, max {maxes}")
  assert np.mean(means) < TIGHT_MEAN, means
  assert np.median(maxes) < TIGHT_MEDIAN_MAX, maxes


def test_bf16_unet_params_stay_f32_and_match_the_f32_tree(unet_pair):
  norm = unet_pair[0]
  mbf = tmodel.StereoMagnificationModel(num_planes=P, norm=norm,
                                        dtype=torch.bfloat16)
  m32 = tmodel.StereoMagnificationModel(num_planes=P, norm=norm)
  assert mbf.state_dict().keys() == m32.state_dict().keys()
  assert all(v.dtype == torch.float32 for v in mbf.state_dict().values())


def test_bf16_unet_gradients_finite_nonzero_f32(unet_pair):
  norm, params, x, _ = unet_pair
  model = tmodel.StereoMagnificationModel(num_planes=P, norm=norm,
                                          dtype=torch.bfloat16)
  model.load_state_dict(tmodel.state_dict_from_jax_params(params, norm))
  (model(torch.from_numpy(x)) ** 2).sum().backward()
  grads = [p.grad for p in model.parameters()]
  assert all(g is not None and g.dtype == torch.float32 for g in grads)
  assert all(bool(torch.isfinite(g).all()) for g in grads)
  assert any(float(g.abs().max()) > 0 for g in grads)


def test_bf16_vgg_loss_tracks_jax_bf16_and_f32():
  rng = np.random.default_rng(1)
  out = rng.uniform(-1, 1, (1, HW, HW, 3)).astype(np.float32)
  tgt = rng.uniform(-1, 1, (1, HW, HW, 3)).astype(np.float32)
  params = jvgg.init_params(0)
  want_bf = float(jax.jit(lambda a, b: _jax_perceptual(a, b, params))(
      jnp.asarray(out), jnp.asarray(tgt)))
  state = tvgg.state_dict_from_jax_params(jax.tree.map(np.asarray, params))
  got = {}
  for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
    net = tvgg.VGG16Features(state, dtype=dtype)
    taps = net(torch.from_numpy(out).permute(0, 3, 1, 2))
    assert all(t.dtype == torch.float32 for t in taps)
    got[name] = float(tloss.perceptual_loss(
        torch.from_numpy(out), torch.from_numpy(tgt), net, resize=None))
  assert np.isfinite(got["bf16"]) and got["bf16"] != got["f32"]
  assert abs(got["bf16"] - want_bf) / abs(want_bf) < 0.05, (got, want_bf)
  assert abs(got["bf16"] - got["f32"]) / abs(got["f32"]) < 0.05, got


def _jax_perceptual(out, tgt, params):
  """The JAX loss's perceptual half (``vgg_perceptual_loss`` after its
  render), on a given rendered view."""
  x, y = jvgg.imagenet_normalize(out), jvgg.imagenet_normalize(tgt)
  net = jvgg.VGG16Features(dtype=jnp.bfloat16)
  loss = jnp.mean(jnp.abs(x - y))
  for i, (fx, fy) in enumerate(zip(net.apply(params, x),
                                   net.apply(params, y))):
    loss = loss + jnp.mean(jnp.abs(fx - fy)) / (1.0 + i)
  return loss


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_model_meta_equals_jax(compute_dtype):
  jcfg = jconfig.TrainConfig(compute_dtype=compute_dtype)
  tcfg = tconfig.TrainConfig(compute_dtype=compute_dtype)
  assert tcfg.model_meta() == jcfg.model_meta()
  assert tcfg.torch_dtype == (None if compute_dtype is None
                              else torch.bfloat16)
  state = tcfg.make_train_state(0, "cpu")
  assert state.model.dtype == tcfg.torch_dtype
  assert tcfg.make_vgg("cpu").dtype == tcfg.torch_dtype


def test_dtype_of_rejects_a_non_float_name():
  assert tconfig.dtype_of("bfloat16") is torch.bfloat16
  with pytest.raises(ValueError, match="floating"):
    tconfig.dtype_of("int8")
  with pytest.raises(ValueError, match="floating"):
    tconfig.dtype_of("bf16")


def test_train_cli_bf16_step_on_the_cpu(tmp_path):
  ckpt = tmp_path / "ckpt"
  summary = cli.cmd_train(cli.build_parser().parse_args([
      "train", "--synthetic", "--synthetic-scenes", "1", "--img-size",
      str(HW), "--num-planes", str(P), "--epochs", "1", "--no-valid",
      "--vgg-resize", "0", "--device", "cpu", "--bf16",
      "--dataset", str(tmp_path / "data"), "--ckpt", str(ckpt)]))
  assert summary["steps"] == 1 and summary["nonfinite_losses"] == 0
  newest = sorted(p for p in os.listdir(ckpt) if p.startswith("step_"))[-1]
  manifest = json.loads((ckpt / newest / "manifest.json").read_text())
  assert manifest["meta"]["model"]["compute_dtype"] == "bfloat16"
  model_dtypes = {entry["dtype"] for key, entry in manifest["arrays"].items()
                  if key.startswith("['model']")}
  assert model_dtypes == {"float32"}
