"""The port's checkpoint -> scenes bridge (``ckpt/export.py``) against the
JAX package's.

A JAX-layout training checkpoint (flax params under ``['params']``) and a
port-layout one (a state dict under ``['model']``, written by the port's
``train --ckpt``) are baked into servable scenes. On the JAX checkpoint
both packages bake from the same dataset (made by the JAX
``synthesize_dataset``, or each package's hermetic synthesis) and must give
the same scene ids letter for letter, the same digest and step; ``depths``
and ``intrinsics`` within 1e-6; ``rgba`` within 1e-4, the tolerance
``tests/test_torch_train.py::test_unet_forward_with_jax_weights`` holds the
U-Net to (the plane sweeps agree to 1e-5, then convolutions sum in other
orders).
"""

import hashlib
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_vision_tpu import config as jconfig
from mpi_vision_tpu.ckpt import CheckpointStore as JaxStore
from mpi_vision_tpu.ckpt import export as jexport
from mpi_vision_tpu.data import realestate as jdata
from mpi_vision_tpu.models import stereo_mag as jmodel
from mpi_vision_tpu_torch import cli
from mpi_vision_tpu_torch.ckpt import CheckpointStore
from mpi_vision_tpu_torch.ckpt import export as texport
from mpi_vision_tpu_torch.data import realestate as tdata
from mpi_vision_tpu_torch.models import stereo_mag as tmodel
from mpi_vision_tpu_torch.serve import RenderService
from mpi_vision_tpu_torch.train import loop as tloop

P, HW = 4, 32


@pytest.fixture(scope="module")
def jax_dataset(tmp_path_factory):
  root = tmp_path_factory.mktemp("export_data")
  return jdata.synthesize_dataset(str(root), num_scenes=2, frames=4,
                                  img_size=HW, seed=0)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
  """A JAX-layout checkpoint at step 7: the JAX U-Net's params (random
  norm affines, so those carry across too), an int32 ``step`` and the JAX
  config's ``model`` meta."""
  rng = np.random.default_rng(3)
  net = jmodel.StereoMagnificationModel(num_planes=P, norm="instance")
  params = jax.tree.map(np.asarray, jax.jit(net.init)(
      jax.random.key(0), jnp.zeros((1, HW, HW, 3 + 3 * P)))["params"])
  for leaves in params.values():
    if "norm" in leaves:
      c = leaves["norm"]["scale"].shape
      leaves["norm"] = {
          "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
          "bias": rng.uniform(-0.2, 0.2, c).astype(np.float32)}
  root = str(tmp_path_factory.mktemp("jax_ckpt"))
  meta = jconfig.TrainConfig(data=jconfig.DataConfig(
      img_size=HW, num_planes=P)).model_meta()
  JaxStore(root).save(7, {"params": params, "step": np.int32(7)},
                      meta={"model": meta})
  return root


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
  """The port's ``train --ckpt`` store: steps 0, 1 and 2."""
  root = tmp_path_factory.mktemp("port_ckpt")
  cli.cmd_train(cli.build_parser().parse_args([
      "train", "--synthetic", "--synthetic-scenes", "2", "--img-size",
      str(HW), "--num-planes", str(P), "--epochs", "1", "--no-valid",
      "--no-vgg-loss", "--device", "cpu", "--save-every", "1",
      "--dataset", str(root / "data"), "--ckpt", str(root / "ckpt")]))
  return str(root / "ckpt"), str(root / "data")


@pytest.mark.parametrize("stable_ids", [False, True])
@pytest.mark.parametrize("source", ["dataset", "hermetic"])
def test_jax_checkpoint_bakes_as_in_the_jax_package(jax_ckpt, jax_dataset,
                                                    source, stable_ids):
  dataset = jax_dataset if source == "dataset" else None
  want, want_info = jexport.scenes_from_checkpoint(
      jax_ckpt, dataset_path=dataset, scenes=2, stable_ids=stable_ids)
  got, got_info = texport.scenes_from_checkpoint(
      jax_ckpt, dataset_path=dataset, scenes=2, stable_ids=stable_ids,
      device="cpu")
  assert [s[0] for s in got] == [s[0] for s in want]
  assert got_info == want_info
  assert got_info["step"] == 7 and len(got) == 2
  for (_, rgba, depths, k), (_, jrgba, jdepths, jk) in zip(got, want):
    assert rgba.dtype == np.float32 and rgba.shape == (HW, HW, P, 4)
    np.testing.assert_allclose(depths, jdepths, atol=1e-6, rtol=0)
    np.testing.assert_allclose(k, jk, atol=1e-6, rtol=0)
    np.testing.assert_allclose(rgba, jrgba, atol=1e-4, rtol=0)


def test_port_checkpoint_bakes_with_stable_ids(port_ckpt):
  root, data = port_ckpt
  scenes, info = texport.scenes_from_checkpoint(
      root, dataset_path=data, scenes=2, stable_ids=True, device="cpu")
  assert [s[0] for s in scenes] == ["ckpt_000", "ckpt_001"]
  assert info["step"] == 2 and info["compute_dtype"] is None
  manifest = json.loads(open(os.path.join(
      root, "step_0000000002", "manifest.json")).read())
  # The digest runs over the ['model'] entries, as JAX's over ['params'].
  digest = hashlib.sha256()
  for key, entry in sorted(manifest["arrays"].items()):
    if key.startswith("['model']"):
      digest.update(key.encode())
      digest.update(entry["sha256"].encode())
  assert info["params_digest"] == digest.hexdigest()
  # The bake is the trained model's own forward, bit for bit.
  state = tloop.create_train_state(0, num_planes=P, device="cpu")
  tloop.restore_checkpoint(root, state)
  model, _, step = texport.restore_params(root, device="cpu")
  assert step == 2
  for name, value in state.model.state_dict().items():
    assert torch.equal(model.state_dict()[name], value), name
  example = tdata.RealEstateDataset(
      data, is_valid=True, img_size=HW, num_planes=P, device="cpu")[1]
  with torch.no_grad():
    pred = state.model(example["net_input"][None])
    want = tmodel.mpi_from_net_output(pred, example["ref_img"][None])
  np.testing.assert_array_equal(scenes[1][1], want[0].numpy())


def test_params_only_restore_reads_no_adam_key(port_ckpt, monkeypatch):
  read = []
  getitem = np.lib.npyio.NpzFile.__getitem__

  def spy(self, key):
    read.append(key)
    return getitem(self, key)

  monkeypatch.setattr(np.lib.npyio.NpzFile, "__getitem__", spy)
  texport.restore_params(port_ckpt[0], device="cpu")
  assert read and not any(k.startswith("['adam']") for k in read)
  assert any(k.startswith("['model']") for k in read)
  assert not any(k.startswith("['learning_rate']") for k in read)


def test_corrupt_newest_is_quarantined_and_the_one_before_served(
    port_ckpt, tmp_path):
  root = str(tmp_path / "ckpt")
  shutil.copytree(port_ckpt[0], root)
  # Flip one U-Net weight of step 2: its manifest hash no longer matches,
  # while the step scalar the peek reads still does.
  path = os.path.join(root, "step_0000000002", "arrays.npz")
  with np.load(path) as npz:
    arrays = {k: npz[k] for k in npz.files}
  key = "['model']['cnv4_1.conv.weight']"
  arrays[key] = arrays[key] + np.float32(1.0)
  with open(path, "wb") as fh:
    np.savez(fh, **arrays)
  logs = []
  scenes, info = texport.scenes_from_checkpoint(
      root, dataset_path=port_ckpt[1], scenes=1, log=logs.append,
      device="cpu")
  assert info["step"] == 1
  assert scenes[0][0].startswith(f"ckpt_1_{info['params_digest'][:8]}")
  assert os.listdir(os.path.join(root, "quarantine"))[0].startswith(
      "step_0000000002")
  assert any("quarantined step 2" in line for line in logs)
  assert CheckpointStore(root).steps() == [0, 1]


def test_missing_directory_raises_and_is_not_created(tmp_path):
  missing = tmp_path / "no_such_ckpt"
  with pytest.raises(FileNotFoundError,
                     match="checkpoint directory does not exist"):
    texport.restore_params(str(missing), device="cpu")
  with pytest.raises(FileNotFoundError,
                     match="checkpoint directory does not exist"):
    texport.scenes_from_checkpoint(str(missing), device="cpu")
  assert not missing.exists()
  with pytest.raises(FileNotFoundError, match="no restorable checkpoint"):
    texport.restore_params(str(tmp_path), device="cpu")


def test_baked_scenes_serve_through_render_service(port_ckpt):
  scenes, _ = texport.scenes_from_checkpoint(
      port_ckpt[0], dataset_path=port_ckpt[1], scenes=2, device="cpu")
  pose = np.eye(4, dtype=np.float32)
  pose[0, 3] = 0.02
  with RenderService(max_batch=2, max_wait_ms=0.5, resilience=None,
                     device="cpu") as svc:
    for sid, rgba, depths, k in scenes:
      svc.add_scene(sid, rgba, depths, k)
    for sid, *_ in scenes:
      img = svc.render(sid, pose)
      assert img.shape == (HW, HW, 3) and np.isfinite(img).all()
      np.testing.assert_array_equal(
          img, svc.engine.render_one(svc.cache.get(sid), pose))
    assert svc.cache.stats()["misses"] == 2


def test_bake_refuses_to_run_on_the_cpu_unasked(port_ckpt, monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    texport.restore_params(port_ckpt[0])
  with pytest.raises(RuntimeError, match="no CUDA device"):
    texport.scenes_from_checkpoint(port_ckpt[0], dataset_path=port_ckpt[1])
