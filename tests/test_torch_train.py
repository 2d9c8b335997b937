"""The port's training slice against the JAX package's.

Each module of ``mpi_vision_tpu_torch`` on the training path (sweep,
U-Net, VGG features, losses, the Adam step, the data pipeline, config and
the ``train`` CLI) is fed the same seeded numpy inputs, and the same
weights carried across from JAX, as its JAX counterpart.

Tolerances: 1e-5 where both sides evaluate the same f32 formulas (the
plane sweep, ``net_input``; the 4x4 pose inverses differ by an ulp between
``torch.linalg.inv`` and ``jnp.linalg.inv``); 1e-4 for network and VGG
activations (convolutions sum in other orders) and for the loss values,
the threshold of ``tests/test_train.py``; gradients of every U-Net
parameter at 1e-3 of that parameter's largest gradient (f32 sums in other
orders through 18 convolutions and the loss's absolute-value terms); Adam
against optax at rtol 1e-5 (the two update formulas round differently).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_vision_tpu import config as jconfig
from mpi_vision_tpu.core import sweep as jsweep
from mpi_vision_tpu.core.camera import inv_depths as jinv_depths
from mpi_vision_tpu.data import realestate as jdata
from mpi_vision_tpu.models import stereo_mag as jmodel
from mpi_vision_tpu.train import loss as jloss
from mpi_vision_tpu.train import vgg as jvgg
from mpi_vision_tpu_torch import config as tconfig
from mpi_vision_tpu_torch.core import sweep as tsweep
from mpi_vision_tpu_torch.data import realestate as tdata
from mpi_vision_tpu_torch.kernels import render_fused as rf
from mpi_vision_tpu_torch.kernels import render_fused_bwd as rb
from mpi_vision_tpu_torch.models import stereo_mag as tmodel
from mpi_vision_tpu_torch.train import loop as tloop
from mpi_vision_tpu_torch.train import loss as tloss
from mpi_vision_tpu_torch.train import vgg as tvgg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
  return torch.from_numpy(np.array(a, np.float32))


def _pose(tx=0.0, tz=0.0, ry=0.0):
  pose = np.eye(4, dtype=np.float32)
  c, s = np.cos(ry), np.sin(ry)
  pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
  pose[0, 3], pose[2, 3] = tx, tz
  return pose


def _k(hw):
  return np.array([[hw / 2, 0, hw / 2], [0, hw / 2, hw / 2], [0, 0, 1]],
                  np.float32)


def _batch(rng, hw=32, p=4, pose=None):
  """A batch with the reference dataset contract, numpy."""
  return {
      "net_input": rng.uniform(-1, 1, (1, hw, hw, 3 + 3 * p)).astype(
          np.float32),
      "ref_img": rng.uniform(-1, 1, (1, hw, hw, 3)).astype(np.float32),
      "tgt_img": rng.uniform(-1, 1, (1, hw, hw, 3)).astype(np.float32),
      "tgt_img_cfw": (_pose(0.04, 0.01, 0.02) if pose is None else pose)[None],
      "ref_img_wfc": np.eye(4, dtype=np.float32)[None],
      "intrinsics": _k(hw)[None],
      "mpi_planes": np.asarray(jinv_depths(1.0, 100.0, p)),
  }


def _jax(batch):
  return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
  return {k: _t(v) for k, v in batch.items()}


def _jax_unet(p, hw, norm, rng):
  """JAX U-Net params (numpy) with random norm affines, so that carrying
  them across is tested too."""
  net = jmodel.StereoMagnificationModel(num_planes=p, norm=norm)
  params = jax.jit(net.init)(jax.random.key(0),
                             jnp.zeros((1, hw, hw, 3 + 3 * p)))["params"]
  params = jax.tree.map(np.asarray, params)
  for leaves in params.values():
    if "norm" in leaves:
      c = leaves["norm"]["scale"].shape
      leaves["norm"] = {
          "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
          "bias": rng.uniform(-0.2, 0.2, c).astype(np.float32)}
  return net, params


def _port_unet(p, params, norm):
  model = tmodel.StereoMagnificationModel(num_planes=p, norm=norm)
  model.load_state_dict(tmodel.state_dict_from_jax_params(params, norm))
  return model


@pytest.fixture(scope="module")
def vgg_pair():
  """The JAX VGG features at ``init_params(0)`` and the port's, carried."""
  params = jvgg.init_params(0)
  return params, tvgg.VGG16Features(tvgg.state_dict_from_jax_params(
      jax.tree.map(np.asarray, params)))


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
  root = tmp_path_factory.mktemp("re10k_torch")
  return tdata.synthesize_dataset(str(root), num_scenes=3, frames=4,
                                  img_size=32)


# -- core/sweep --------------------------------------------------------------


@pytest.mark.parametrize("convention", ["REF_PROJECTION", "EXACT"])
def test_plane_sweep_one(rng, convention):
  from mpi_vision_tpu.core.sampling import Convention as JC
  from mpi_vision_tpu_torch.core.sampling import Convention as TC

  hw, p = 32, 4
  img = rng.uniform(-1, 1, (hw, hw, 3)).astype(np.float32)
  pose, depths = _pose(0.1, -0.05, 0.05), np.asarray(jinv_depths(1, 100, p))
  want = jax.jit(jsweep.plane_sweep_one, static_argnames="convention")(
      jnp.asarray(img), jnp.asarray(depths), jnp.asarray(pose),
      jnp.asarray(_k(hw)), convention=JC[convention])
  got = tsweep.plane_sweep_one(_t(img), _t(depths), _t(pose), _t(_k(hw)),
                               convention=TC[convention])
  assert got.shape == (1, hw, hw, 3 * p)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                             rtol=0)


def test_format_network_input(rng):
  hw, p = 32, 4
  ref = rng.uniform(-1, 1, (1, hw, hw, 3)).astype(np.float32)
  srcs = rng.uniform(-1, 1, (2, 1, hw, hw, 3)).astype(np.float32)
  ref_pose = _pose(0.02, 0.01, 0.03)[None]
  src_poses = np.stack([_pose(-0.1, 0.0, -0.02)[None],
                        _pose(0.1, 0.05, 0.01)[None]])
  depths = np.asarray(jinv_depths(1, 100, p))
  args = (ref, srcs, ref_pose, src_poses, depths, _k(hw)[None])
  want = jax.jit(jsweep.format_network_input)(*map(jnp.asarray, args))
  got = tsweep.format_network_input(*map(_t, args))
  assert got.shape == (1, hw, hw, 3 + 3 * p * 2)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                             rtol=0)


def test_image_pre_and_deprocessing(rng):
  from mpi_vision_tpu.core import camera as jcamera
  from mpi_vision_tpu_torch.core import camera as tcamera

  img = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
  pre = tcamera.preprocess_image(_t(img))
  np.testing.assert_array_equal(
      pre.numpy(), np.asarray(jcamera.preprocess_image(jnp.asarray(img))))
  np.testing.assert_array_equal(
      tcamera.deprocess_image(pre).numpy(),
      np.asarray(jcamera.deprocess_image(jnp.asarray(pre.numpy()))))


# -- models/stereo_mag -------------------------------------------------------


@pytest.mark.parametrize("norm", ["instance", None])
def test_unet_forward_with_jax_weights(rng, norm):
  p, hw = 4, 32
  net, params = _jax_unet(p, hw, norm, rng)
  x = rng.uniform(-1, 1, (2, hw, hw, 3 + 3 * p)).astype(np.float32)
  want = jax.jit(net.apply)({"params": params}, jnp.asarray(x))
  with torch.no_grad():
    got = _port_unet(p, params, norm)(_t(x))
  assert got.shape == (2, hw, hw, 3 + 2 * p)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                             rtol=0)


def test_state_dict_covers_the_module():
  for norm in ("instance", None):
    net = jmodel.StereoMagnificationModel(num_planes=2, norm=norm)
    shapes = jax.eval_shape(net.init, jax.random.key(0),
                            jnp.zeros((1, 16, 16, 9)))["params"]
    params = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state = tmodel.state_dict_from_jax_params(params, norm)
    model = tmodel.StereoMagnificationModel(num_planes=2, norm=norm)
    assert set(state) == set(model.state_dict())
    assert all(state[k].shape == v.shape
               for k, v in model.state_dict().items())


def test_mpi_from_net_output_exact(rng):
  pred = rng.uniform(-1, 1, (2, 8, 8, 3 + 2 * 5)).astype(np.float32)
  ref = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
  want = np.asarray(jmodel.mpi_from_net_output(jnp.asarray(pred),
                                               jnp.asarray(ref)))
  got = tmodel.mpi_from_net_output(_t(pred), _t(ref)).numpy()
  assert got.shape == (2, 8, 8, 5, 4)
  np.testing.assert_array_equal(got, want)


# -- train/vgg and train/loss ------------------------------------------------


def test_vgg_taps(rng, vgg_pair):
  params, vgg = vgg_pair
  x = rng.uniform(-2, 2, (2, 32, 32, 3)).astype(np.float32)
  want = jvgg.VGG16Features().apply(params, jnp.asarray(x))
  with torch.no_grad():
    got = vgg(_t(x).permute(0, 3, 1, 2))
  assert len(got) == len(want) == 4
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                               atol=1e-4, rtol=0)


def test_vgg_default_is_deterministic_he_init():
  a, b = tvgg.default_params(), tvgg.init_params(0)
  assert all(torch.equal(a[k], b[k]) for k in a)
  w = a["0.weight"]
  assert w.shape == (64, 3, 3, 3)
  assert abs(float(w.std()) - (2.0 / 27) ** 0.5) < 0.05
  assert not any(p.requires_grad for p in tvgg.VGG16Features().parameters())


def test_imagenet_normalize_quirk():
  x = torch.zeros(1, 2, 2, 3)
  want = np.asarray(jvgg.imagenet_normalize(jnp.zeros((1, 2, 2, 3))))
  np.testing.assert_array_equal(tvgg.imagenet_normalize(x).numpy(), want)


@pytest.mark.parametrize("method", ["fused_pallas", "fused"])
def test_l2_render_loss(rng, method):
  batch = _batch(rng)
  pred = rng.uniform(-1, 1, (1, 32, 32, 11)).astype(np.float32)
  want = float(jax.jit(jloss.l2_render_loss)(jnp.asarray(pred), _jax(batch)))
  got = float(tloss.l2_render_loss(_t(pred), _torch(batch), method=method))
  assert abs(got - want) <= 1e-4, (got, want)


@pytest.mark.parametrize("resize", [None, 24])
def test_vgg_perceptual_loss(rng, vgg_pair, resize):
  params, vgg = vgg_pair
  batch = _batch(rng)
  pred = rng.uniform(-1, 1, (1, 32, 32, 11)).astype(np.float32)
  want = float(jax.jit(jloss.vgg_perceptual_loss, static_argnames="resize")(
      jnp.asarray(pred), _jax(batch), params, resize=resize))
  got = float(tloss.vgg_perceptual_loss(_t(pred), _torch(batch), vgg,
                                        resize=resize,
                                        method="fused_pallas"))
  assert abs(got - want) <= 1e-4, (got, want)


# -- train/loop --------------------------------------------------------------


@pytest.mark.parametrize("norm,hw", [(None, 32), ("instance", 64)])
def test_train_step_loss_and_gradients_match_jax(rng, vgg_pair, norm, hw):
  """One step's loss, and the gradient of every U-Net parameter, against
  ``jax.value_and_grad`` of the JAX loss (``method="fused"``), from the
  same weights; the port renders through the Function (its plain
  backward on the CPU). With InstanceNorm the bottleneck must hold more
  than a few pixels per channel (64 px in, 8 x 8 there): at 4 x 4 a
  near-constant channel's normalization amplifies f32 noise past any
  useful tolerance, on either side. A conv bias right ahead of an
  InstanceNorm has an exact gradient of 0: both sides must leave it at
  rounding noise."""
  params_vgg, vgg = vgg_pair
  p = 4
  net, params = _jax_unet(p, hw, norm, rng)
  batch = _batch(rng, hw, p)
  jb = _jax(batch)

  def jax_loss(prm):
    pred = net.apply({"params": prm}, jb["net_input"])
    return jloss.vgg_perceptual_loss(pred, jb, params_vgg, resize=24)

  want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(
      jax.tree.map(jnp.asarray, params))
  want = tmodel.state_dict_from_jax_params(
      jax.tree.map(np.asarray, want_grads), norm)

  model = _port_unet(p, params, norm)
  loss = tloop.make_loss_fn(vgg, resize=24, method="fused_pallas")(
      model, _torch(batch))
  calls = (rb.plain_rewarp_composite_vjp.calls, rb.plain_adjoint_warp.calls)
  loss.backward()
  assert (rb.plain_rewarp_composite_vjp.calls,
          rb.plain_adjoint_warp.calls) == (calls[0] + 1, calls[1] + 1)
  assert abs(float(loss.detach()) - float(want_loss)) <= 1e-4
  for name, param in model.named_parameters():
    got, ref = param.grad, want[name]
    block = name.split(".")[0]
    if norm == "instance" and name.endswith("conv.bias") and block != "cnv8_1":
      noise = 1e-5 * float(want[f"{block}.conv.weight"].abs().max())
      assert float(got.abs().max()) <= noise, name
      assert float(ref.abs().max()) <= noise, name
      continue
    np.testing.assert_allclose(got.numpy(), ref.numpy(),
                               atol=1e-3 * float(ref.abs().max()), rtol=0,
                               err_msg=name)


def test_adam_matches_optax(rng):
  """Three Adam steps on the same gradients: ``torch.optim.Adam`` as the
  train state builds it vs ``optax.adam`` (lr 2e-4, default betas/eps)."""
  w0 = rng.normal(size=(5, 7)).astype(np.float32)
  grads = [rng.normal(size=(5, 7)).astype(np.float32) for _ in range(3)]
  tx = optax.adam(2e-4)
  jw, opt_state = jnp.asarray(w0), tx.init(jnp.asarray(w0))
  for g in grads:
    updates, opt_state = tx.update(jnp.asarray(g), opt_state, jw)
    jw = optax.apply_updates(jw, updates)
  state = tloop.create_train_state(num_planes=1, device="cpu")
  tw = torch.nn.Parameter(_t(w0))
  opt = torch.optim.Adam([tw], **{k: v for k, v in
                                  state.optimizer.defaults.items()
                                  if k in ("lr", "betas", "eps")})
  for g in grads:
    tw.grad = _t(g)
    opt.step()
  np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), rtol=1e-5,
                             atol=1e-7)
  assert state.optimizer.defaults["lr"] == 2e-4
  assert state.optimizer.defaults["betas"] == (0.9, 0.999)
  assert state.optimizer.defaults["eps"] == 1e-8


def test_fit_and_evaluate_train_the_model(rng):
  batch = _torch(_batch(rng, 16, 2))
  state = tloop.create_train_state(seed=1, num_planes=2, learning_rate=1e-3,
                                   device="cpu")
  eval_step = tloop.make_eval_step(method="fused_pallas")
  before = tloop.evaluate(state, [batch], eval_step)
  state, losses = tloop.fit(state, [batch] * 4,
                            tloop.make_train_step(method="fused_pallas"))
  assert state.step == 4 and len(losses) == 4
  assert all(np.isfinite(losses))
  assert tloop.evaluate(state, [batch], eval_step) < before


# -- data/realestate ---------------------------------------------------------


def test_synthesize_dataset_writes_the_same_files(tmp_path, dataset_root):
  jroot = jdata.synthesize_dataset(str(tmp_path), num_scenes=3, frames=4,
                                   img_size=32)
  for dirpath, _, files in os.walk(jroot):
    for name in files:
      path = os.path.join(dirpath, name)
      rel = os.path.relpath(path, jroot)
      with open(path, "rb") as a, open(os.path.join(dataset_root, rel),
                                       "rb") as b:
        assert a.read() == b.read(), rel


@pytest.mark.parametrize("skip", [0, 1])
def test_batch_stream_matches_jax(dataset_root, skip):
  """``iterate_batches`` over the train split (random triplets and
  shuffle from one seed) yields JAX's stream, ``skip`` included."""

  def stream(mod, **kw):
    ds = mod.RealEstateDataset(dataset_root, img_size=32, num_planes=4,
                               rng=np.random.default_rng(7), **kw)
    return list(mod.iterate_batches(ds, batch_size=1,
                                    rng=np.random.default_rng(8), skip=skip))

  want, got = stream(jdata), stream(tdata, device="cpu")
  assert len(got) == len(want) == 3 - skip
  for g, w in zip(got, want):
    assert set(g) == set(w)
    np.testing.assert_allclose(g["net_input"].numpy(),
                               np.asarray(w["net_input"]), atol=1e-5, rtol=0)
    for key in set(g) - {"net_input"}:
      np.testing.assert_allclose(g[key].numpy(), np.asarray(w[key]),
                                 atol=1e-6, rtol=0, err_msg=key)


def test_skip_equals_iterating_past(dataset_root):
  def stream(skip):
    ds = tdata.RealEstateDataset(dataset_root, img_size=32, num_planes=4,
                                 rng=np.random.default_rng(3), device="cpu")
    return list(tdata.iterate_batches(ds, rng=np.random.default_rng(4),
                                      skip=skip))

  full, skipped = stream(0), stream(2)
  assert len(skipped) == 1
  assert all(torch.equal(skipped[0][k], full[2][k]) for k in full[2])


def test_prefetch_preserves_order_and_raises():
  assert list(tdata.prefetch_batches(iter(range(5)))) == list(range(5))

  def bad():
    yield 1
    raise ValueError("boom")

  with pytest.raises(ValueError, match="boom"):
    list(tdata.prefetch_batches(bad()))


# -- config and the CLI ------------------------------------------------------


def test_train_config_is_the_reference_run():
  j, t = jconfig.TrainConfig(), tconfig.TrainConfig()
  for field in ("learning_rate", "epochs", "vgg_resize", "norm"):
    assert getattr(t, field) == getattr(j, field)
  for field in ("img_size", "num_planes", "depth_near", "depth_far",
                "min_dist", "max_dist", "batch_size"):
    assert getattr(t.data, field) == getattr(j.data, field)
  big = tconfig.TrainConfig.scaled_480().data
  assert (big.img_size, big.num_planes) == (480, 33)


def test_set_precision_is_explicit():
  before = torch.backends.cudnn.allow_tf32
  try:
    torch.backends.cudnn.allow_tf32 = True
    tconfig.TrainConfig().set_precision()
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
  finally:
    torch.backends.cudnn.allow_tf32 = before


def test_train_cli_on_the_cpu(tmp_path):
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  env["PYTHONPATH"] = ROOT
  proc = subprocess.run(
      [sys.executable, "-m", "mpi_vision_tpu_torch", "train", "--device",
       "cpu", "--synthetic", "--synthetic-scenes", "2", "--img-size", "32",
       "--num-planes", "4", "--epochs", "1", "--no-vgg-loss",
       "--dataset", str(tmp_path / "data")],
      cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
  assert proc.returncode == 0, proc.stderr[-3000:]
  summary = json.loads(proc.stdout.strip().splitlines()[-1])
  assert summary["command"] == "train" and summary["steps"] >= 1
  assert np.isfinite(summary["final_loss"])
  assert summary["device"] == "cpu"
  assert "render method fused_pallas" in proc.stderr


def test_train_cli_no_planned_render_runs_the_plain_loop(tmp_path, capsys,
                                                        monkeypatch):
  """``--no-planned-render`` trains through ``method="fused"``: neither the
  kernels nor the autograd Function's plain versions run."""
  from mpi_vision_tpu_torch import cli

  # The trainer's set_precision flips global switches: restore them after.
  monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                      torch.backends.cudnn.allow_tf32)
  monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                      torch.backends.cuda.matmul.allow_tf32)
  counters = (rf.render_mpi_fused, rb.rewarp_composite_vjp, rb.adjoint_warp)
  plains = (rf.plain_render, rb.plain_rewarp_composite_vjp,
            rb.plain_adjoint_warp)
  before = ([f.launches for f in counters], [f.calls for f in plains])
  assert cli.main(["train", "--device", "cpu", "--synthetic",
                   "--synthetic-scenes", "2", "--img-size", "16",
                   "--num-planes", "2", "--epochs", "1", "--no-vgg-loss",
                   "--no-planned-render", "--dataset",
                   str(tmp_path / "data")]) == 0
  out, err = capsys.readouterr()
  summary = json.loads(out.strip().splitlines()[-1])
  assert summary["steps"] >= 1 and np.isfinite(summary["final_loss"])
  assert "render method fused," in err
  assert ([f.launches for f in counters], [f.calls for f in plains]) == before


def test_render_counts_on_the_cpu_path(rng):
  """On CPU tensors the training render runs the plain versions and
  launches no kernel."""
  before = (rf.render_mpi_fused.launches, rb.rewarp_composite_vjp.launches,
            rb.adjoint_warp.launches)
  batch = _torch(_batch(rng, 16, 2))
  state = tloop.create_train_state(num_planes=2, device="cpu")
  tloop.make_train_step(method="fused_pallas")(state, batch)
  assert (rf.render_mpi_fused.launches, rb.rewarp_composite_vjp.launches,
          rb.adjoint_warp.launches) == before
