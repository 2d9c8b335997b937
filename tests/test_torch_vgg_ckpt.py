"""``MPI_VISION_VGG16_CKPT`` in the port: honoured, or refused out loud.

The JAX package's ``train.vgg.default_params`` loads the checkpoint the
variable names. The port reads a directory written by its own
``train.vgg.save_params`` (one ``mpi-ckpt-v1`` checkpoint); with such a
directory holding the JAX weights (carried across by
``state_dict_from_jax_params``), the port's ``VGG16Features()`` taps equal
the JAX ``default_params()`` taps at the VGG tolerance of
``tests/test_torch_train.py`` (1e-4). Anything else the variable names —
a missing path, an orbax directory from the JAX ``save_params``, an empty
directory, a checkpoint of other arrays — raises; nothing falls back to
random features.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_vision_tpu.train import vgg as jvgg
from mpi_vision_tpu_torch import cli, config
from mpi_vision_tpu_torch.ckpt import CheckpointStore
from mpi_vision_tpu_torch.train import vgg as tvgg


@pytest.fixture(scope="module")
def jax_default():
  """JAX's ``default_params()`` with the variable unset, as numpy."""
  saved = os.environ.pop(tvgg.CKPT_ENV, None)
  try:
    return jax.tree.map(np.asarray, jvgg.default_params())
  finally:
    if saved is not None:
      os.environ[tvgg.CKPT_ENV] = saved


def test_env_checkpoint_taps_equal_jax(jax_default, tmp_path, monkeypatch,
                                       rng):
  path = str(tmp_path / "vgg")
  tvgg.save_params(path, tvgg.state_dict_from_jax_params(jax_default))
  monkeypatch.setenv(tvgg.CKPT_ENV, path)
  x = rng.uniform(-2, 2, (2, 32, 32, 3)).astype(np.float32)
  want = jvgg.VGG16Features().apply(jax_default, jnp.asarray(x))
  for vgg in (tvgg.VGG16Features(), config.TrainConfig().make_vgg("cpu")):
    with torch.no_grad():
      got = vgg(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
      np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                 np.asarray(w), atol=1e-4, rtol=0)
  # Loaded, not the port's own random default.
  loaded = tvgg.default_params()
  assert not torch.equal(loaded["0.weight"], tvgg.init_params(0)["0.weight"])
  assert torch.equal(tvgg.load_params(path)["21.bias"], loaded["21.bias"])


def test_unset_variable_keeps_the_random_default(monkeypatch):
  monkeypatch.delenv(tvgg.CKPT_ENV, raising=False)
  a, b = tvgg.default_params(), tvgg.init_params(0)
  assert all(torch.equal(a[k], b[k]) for k in b)


def _orbax(path, jax_default):
  jvgg.save_params(path, jax_default)


def _empty(path, jax_default):
  os.makedirs(path)


def _other_arrays(path, jax_default):
  CheckpointStore(path).save(0, {"w": np.zeros(3, np.float32)})


@pytest.mark.parametrize("make,error,match", [
    (None, FileNotFoundError, "does not exist"),
    (_orbax, ValueError, "orbax directory from the JAX package"),
    (_empty, ValueError, "not a mpi-ckpt-v1 checkpoint"),
    (_other_arrays, ValueError, "missing array"),
])
def test_unreadable_checkpoint_raises(jax_default, tmp_path, monkeypatch,
                                      make, error, match):
  path = str(tmp_path / "vgg")
  if make is not None:
    make(path, jax_default)
  monkeypatch.setenv(tvgg.CKPT_ENV, path)
  with pytest.raises(error, match=match):
    tvgg.VGG16Features()
  with pytest.raises(error, match=match):
    tvgg.default_params()


def test_train_cli_refuses_an_unreadable_checkpoint(tmp_path, monkeypatch):
  monkeypatch.setenv(tvgg.CKPT_ENV, str(tmp_path / "missing"))
  # The trainer flips PyTorch's global precision switches first.
  monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                      torch.backends.cudnn.allow_tf32)
  monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                      torch.backends.cuda.matmul.allow_tf32)
  with pytest.raises(FileNotFoundError, match="VGG16 checkpoint"):
    cli.main(["train", "--device", "cpu", "--synthetic",
              "--synthetic-scenes", "2", "--img-size", "16",
              "--num-planes", "2", "--epochs", "1",
              "--dataset", str(tmp_path / "data")])
