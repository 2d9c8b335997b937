"""The port's ``lr_find`` against JAX's, and the ``train`` CLI's sweep and
checkpoint flags.

``lr_find`` runs 12 steps at 16 px x 2 planes (``norm=None``, L2 loss)
from JAX weights carried across, over the same numpy batches, on both
sides. The swept ``lrs`` are equal exactly (both are
``np.geomspace``), the losses agree within 1e-4 (the tolerance of one
train step in ``tests/test_torch_train.py``), and the suggestion is the
same grid point. The CLI cases mirror ``tests/test_cli.py``'s
``test_train_lr_find``, ``test_train_ckpt_overwrite`` and
``test_ckpt_flags_without_ckpt_are_rejected``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from mpi_vision_tpu.train import loop as jloop
from mpi_vision_tpu_torch import cli
from mpi_vision_tpu_torch.models import stereo_mag as tmodel
from mpi_vision_tpu_torch.train import loop as tloop

HW, PLANES = 16, 2


def _batches():
  out = []
  for i in range(3):
    rng = np.random.default_rng([5, i])
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3] = 0.04
    k = np.array([[8, 0, 8], [0, 8, 8], [0, 0, 1]], np.float32)
    out.append({
        "net_input": rng.uniform(
            -1, 1, (1, HW, HW, 3 + 3 * PLANES)).astype(np.float32),
        "ref_img": rng.uniform(-1, 1, (1, HW, HW, 3)).astype(np.float32),
        "tgt_img": rng.uniform(-1, 1, (1, HW, HW, 3)).astype(np.float32),
        "tgt_img_cfw": pose[None],
        "ref_img_wfc": np.eye(4, dtype=np.float32)[None],
        "intrinsics": k[None],
        "mpi_planes": np.linspace(1.0, 0.01, PLANES, dtype=np.float32),
    })
  return out


@pytest.fixture(scope="module")
def sweeps():
  """Both packages' sweeps from the same weights, and the port's state
  before and after its sweep."""
  jstate = jloop.create_train_state(
      jax.random.PRNGKey(0), num_planes=PLANES, image_size=(HW, HW),
      norm=None, learning_rate=1e-3)
  batches = _batches()
  want = jloop.lr_find(jstate, batches, num_steps=12)
  state = tloop.create_train_state(num_planes=PLANES, learning_rate=1e-3,
                                   norm=None, device="cpu")
  state.model.load_state_dict(tmodel.state_dict_from_jax_params(
      jax.tree.map(np.asarray, jstate.params), None))
  before = {k: v.clone() for k, v in state.model.state_dict().items()}
  got = tloop.lr_find(
      state, [{k: torch.from_numpy(v) for k, v in b.items()}
              for b in batches], method="fused_pallas", num_steps=12)
  return want, got, state, before


def test_lr_find_sweeps_the_same_lrs(sweeps):
  want, got, _, _ = sweeps
  assert got["lrs"] == want["lrs"]
  lrs = np.asarray(got["lrs"])
  assert len(lrs) >= 2 and np.all(np.diff(lrs) > 0)
  assert lrs[0] == 1e-7 and lrs[-1] <= 10.0


def test_lr_find_losses_match_jax(sweeps):
  want, got, _, _ = sweeps
  assert len(got["losses"]) == len(want["losses"])
  np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-4,
                             rtol=0)
  np.testing.assert_allclose(got["smoothed"], want["smoothed"], atol=1e-4,
                             rtol=0)


def test_lr_find_suggests_the_same_grid_point(sweeps):
  want, got, _, _ = sweeps
  assert got["suggestion"] == want["suggestion"]
  assert got["suggestion"] in got["lrs"]
  assert got["suggestion"] < got["lrs"][-1]


def test_lr_find_leaves_the_state_untouched(sweeps):
  _, _, state, before = sweeps
  assert state.step == 0 and not state.optimizer.state
  assert tloop.current_learning_rate(state) == 1e-3
  after = state.model.state_dict()
  assert all(torch.equal(before[k], after[k]) for k in before)


def test_lr_find_needs_two_steps_and_a_batch():
  state = tloop.create_train_state(num_planes=PLANES, norm=None,
                                   device="cpu")
  with pytest.raises(ValueError, match="num_steps >= 2"):
    tloop.lr_find(state, [{}], num_steps=1)
  with pytest.raises(ValueError, match="at least one batch"):
    tloop.lr_find(state, [], num_steps=4)


# -- the CLI -----------------------------------------------------------------------


def _train(tmp_path, *extra):
  return ["train", "--device", "cpu", "--synthetic", "--synthetic-scenes",
          "2", "--img-size", "16", "--num-planes", "2", "--no-vgg-loss",
          "--dataset", str(tmp_path / "data"), *extra]


@pytest.fixture
def keep_cudnn_flags(monkeypatch):
  """The trainer sets PyTorch's global precision switches: restore them."""
  for mod, name in ((torch.backends.cudnn, "allow_tf32"),
                    (torch.backends.cuda.matmul, "allow_tf32"),
                    (torch.backends.cudnn, "deterministic"),
                    (torch.backends.cudnn, "benchmark")):
    monkeypatch.setattr(mod, name, getattr(mod, name))


def _summary(capsys):
  captured = capsys.readouterr()
  return json.loads(captured.out.strip().splitlines()[-1]), captured.err


def test_train_cli_lr_find(tmp_path, capsys, keep_cudnn_flags):
  assert cli.main(_train(tmp_path, "--epochs", "1", "--lr-find",
                         "--lr-find-steps", "12")) == 0
  out, err = _summary(capsys)
  assert out["steps"] == 2 and np.isfinite(out["final_loss"])
  assert 0 < out["lr_found"] <= 10.0
  assert "lr_find: suggestion" in err


def test_train_cli_ckpt_resume(tmp_path, capsys, keep_cudnn_flags):
  ckpt = str(tmp_path / "ckpt")
  assert cli.main(_train(tmp_path, "--epochs", "1", "--ckpt", ckpt,
                         "--save-every", "1")) == 0
  first, _ = _summary(capsys)
  assert first["ckpt"] == {"final_step": 2, "resumed_from": None,
                           "preempted": False, "saves": 3,
                           "nan_rollbacks": 0, "quarantined": 0}
  # Re-running over the same store starts fresh (its old saves cleared).
  assert cli.main(_train(tmp_path, "--epochs", "1", "--ckpt", ckpt)) == 0
  again, _ = _summary(capsys)
  assert again["ckpt"]["resumed_from"] is None
  assert cli.main(_train(tmp_path, "--epochs", "2", "--ckpt", ckpt,
                         "--resume", "--lr", "1e-3", "--async-save")) == 0
  resumed, err = _summary(capsys)
  assert resumed["ckpt"]["resumed_from"] == 2
  assert resumed["ckpt"]["final_step"] == 4 and resumed["steps"] == 2
  assert "--resume keeps the checkpointed optimizer state" in err


def test_train_cli_resume_over_an_empty_store_starts_fresh(
    tmp_path, capsys, keep_cudnn_flags):
  assert cli.main(_train(tmp_path, "--epochs", "1", "--ckpt",
                         str(tmp_path / "empty"), "--resume")) == 0
  out, err = _summary(capsys)
  assert out["ckpt"]["resumed_from"] is None and out["steps"] == 2
  assert "--resume keeps" not in err


@pytest.mark.parametrize("argv", [
    ["--resume"],
    ["--save-every", "5", "--keep", "2"],
    ["--no-nan-guard"],
    ["--async-save"],
    ["--stall-timeout-s", "5"],
    ["--inject-fault", "crash@step=1"],
])
def test_ckpt_flags_without_ckpt_are_rejected(argv):
  with pytest.raises(SystemExit, match=r"require\(s\) --ckpt"):
    cli.main(["train", "--synthetic", *argv])


@pytest.mark.parametrize("argv,match", [
    (["--inject-fault", "explode@step=1"], "expected KIND@WHEN"),
    (["--save-every", "-1"], "--save-every must be >= 0"),
    (["--keep", "0"], "--keep must be >= 1"),
])
def test_bad_ckpt_flags_are_refused(tmp_path, argv, match):
  with pytest.raises(SystemExit, match=match):
    cli.main(["train", "--synthetic", "--ckpt", str(tmp_path), *argv])
