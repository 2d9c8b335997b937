"""The port's crash-safe training loop (``train.loop.fit_resumable``).

At 16 px x 2 planes (``norm=None``, L2 loss, the render through
``method="fused_pallas"``: its plain versions on the CPU), the port's
counterparts of ``tests/test_ckpt.py``'s loop cases and of
``tests/test_train_resume.py``'s SIGKILL pin, which drives
``python -m mpi_vision_tpu_torch.tools.train_resume`` in subprocesses.
Resumed runs must equal uninterrupted ones to the bit (model, Adam state,
LR and step).

JAX parity: the same fault schedules through JAX's and the port's
``fit_resumable``, from JAX weights carried across and the same numpy
batches. The integer report fields are equal; each step's loss agrees
within 1e-4, the tolerance of one step in
``tests/test_torch_train.py::test_train_step_loss_and_gradients_match_jax``
(the trajectories do not drift apart past it over these 12 steps).
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from mpi_vision_tpu.ckpt import CheckpointStore as JaxCheckpointStore
from mpi_vision_tpu.ckpt import NanGuard as JaxNanGuard
from mpi_vision_tpu.ckpt import SimulatedCrash as JaxSimulatedCrash
from mpi_vision_tpu.ckpt import TrainFault as JaxTrainFault
from mpi_vision_tpu.ckpt import TrainFaultSource as JaxTrainFaultSource
from mpi_vision_tpu.train import loop as jloop
from mpi_vision_tpu_torch.ckpt import (
    BackgroundSaver,
    CheckpointStore,
    NanGuard,
    NonFiniteLossError,
    SimulatedCrash,
    StallWatchdog,
    TrainFault,
    TrainFaultSource,
)
from mpi_vision_tpu_torch.models import stereo_mag as tmodel
from mpi_vision_tpu_torch.train import loop as tloop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, PLANES, LR = 16, 2, 1e-3


def _np_batch(epoch: int, i: int) -> dict:
  rng = np.random.default_rng([11, epoch, i])
  pose = np.eye(4, dtype=np.float32)
  pose[0, 3] = 0.04
  k = np.array([[8, 0, 8], [0, 8, 8], [0, 0, 1]], np.float32)
  return {
      "net_input": rng.uniform(
          -1, 1, (1, HW, HW, 3 + 3 * PLANES)).astype(np.float32),
      "ref_img": rng.uniform(-1, 1, (1, HW, HW, 3)).astype(np.float32),
      "tgt_img": rng.uniform(-1, 1, (1, HW, HW, 3)).astype(np.float32),
      "tgt_img_cfw": np.stack([pose]),
      "ref_img_wfc": np.stack([np.eye(4, dtype=np.float32)]),
      "intrinsics": np.stack([k]),
      "mpi_planes": np.linspace(1.0, 0.01, PLANES, dtype=np.float32),
  }


def _epoch(e):
  return [{k: torch.from_numpy(v) for k, v in _np_batch(e, i).items()}
          for i in range(4)]


@pytest.fixture(scope="module")
def jax_init():
  """JAX's initial train state (mutable LR) and its params as numpy."""
  state = jloop.create_train_state(
      jax.random.PRNGKey(0), num_planes=PLANES, image_size=(HW, HW),
      norm=None, learning_rate=LR, mutable_lr=True)
  return state, jax.tree.map(np.asarray, state.params)


@pytest.fixture
def fresh(jax_init):
  """A new port train state holding the JAX initial weights (the loop
  updates a state in place, so every run takes its own)."""

  def make():
    state = tloop.create_train_state(num_planes=PLANES, learning_rate=LR,
                                     norm=None, device="cpu")
    state.model.load_state_dict(
        tmodel.state_dict_from_jax_params(jax_init[1], None))
    return state

  return make


STEP = tloop.make_train_step(None, method="fused_pallas")


def _fit(state, epochs, store, **kw):
  kw.setdefault("step", STEP)
  return tloop.fit_resumable(state, epochs, kw.pop("make_batches", _epoch),
                             store, **kw)


def _assert_states_equal(a, b):
  ta, tb = tloop.checkpoint_tree(a), tloop.checkpoint_tree(b)
  assert ta["step"] == tb["step"]
  assert ta["learning_rate"] == tb["learning_rate"]
  for name, t in ta["model"].items():
    assert torch.equal(t, tb["model"][name]), name
  for sa, sb in zip(ta["adam"], tb["adam"]):
    for key in sa:
      assert torch.equal(sa[key], sb[key]), key


@pytest.fixture
def clean(fresh, tmp_path):
  """The uninterrupted 3-epoch run (save every 2 steps)."""
  state, report = _fit(fresh(), 3, CheckpointStore(str(tmp_path / "clean")),
                       save_every=2, resume="never")
  assert report["final_step"] == 12 and len(report["losses"]) == 12
  return state, report


# -- the LR, the checkpoint tree and one checkpoint in a directory ------------


def test_learning_rate_lives_in_the_optimizer(fresh):
  state = fresh()
  assert tloop.current_learning_rate(state) == LR
  assert tloop.set_learning_rate(state, 5e-4) is state
  assert tloop.current_learning_rate(state) == 5e-4
  assert all(g["lr"] == 5e-4 for g in state.optimizer.param_groups)


def test_checkpoint_roundtrip_keeps_adams_step_dtype_and_device(
    fresh, tmp_path):
  state = fresh()
  STEP(state, _epoch(0)[0])
  path = str(tmp_path / "ckpt")
  tloop.save_checkpoint(path, state)
  with pytest.raises(FileExistsError):
    tloop.save_checkpoint(path, state)
  other = fresh()
  tloop.restore_checkpoint(path, other)
  _assert_states_equal(state, other)
  step_t = next(iter(other.optimizer.state.values()))["step"]
  assert step_t.dtype == torch.float32 and step_t.device.type == "cpu"
  assert float(step_t) == 1.0
  # Resumed from the restore, the next step equals the original's.
  batch = _epoch(0)[1]
  STEP(state, batch)
  STEP(other, batch)
  _assert_states_equal(state, other)
  tloop.save_checkpoint(path, state, overwrite=True)
  assert CheckpointStore(path).steps() == [2]


def test_load_checkpoint_tree_refuses_a_mismatched_state(fresh):
  tree = {k: v for k, v in tloop.checkpoint_tree(fresh()).items()}
  host = {"model": {k: v.numpy() for k, v in tree["model"].items()},
          "adam": [{k: v.numpy() for k, v in s.items()}
                   for s in tree["adam"]],
          "learning_rate": tree["learning_rate"], "step": tree["step"]}
  name = next(iter(host["model"]))
  host["model"][name] = host["model"][name][..., :1]
  with pytest.raises(ValueError, match="the state holds"):
    tloop.load_checkpoint_tree(fresh(), host)


# -- fit_resumable -------------------------------------------------------------


def test_soft_crash_then_resume_is_bit_exact(fresh, clean, tmp_path):
  faults = TrainFaultSource().at_step(7, TrainFault("crash"))
  store = CheckpointStore(str(tmp_path / "crash"),
                          fault_hook=faults.store_hook)
  with pytest.raises(SimulatedCrash):
    _fit(fresh(), 3, store, save_every=2, resume="never",
         fault_source=faults)
  resumed, report = _fit(fresh(), 3, CheckpointStore(str(tmp_path / "crash")),
                         save_every=2, resume="auto")
  assert report["resumed_from"] == 6 and report["final_step"] == 12
  assert report["losses"] == clean[1]["losses"][6:]
  _assert_states_equal(clean[0], resumed)


def test_corrupted_checkpoint_falls_back_and_stays_bit_exact(fresh, clean,
                                                             tmp_path):
  # Crash at step 7 AND corrupt the step-6 checkpoint (save index 3:
  # initial, step 2, step 4, step 6).
  faults = (TrainFaultSource()
            .at_step(7, TrainFault("crash"))
            .at_save(3, TrainFault("corrupt")))
  store_dir = str(tmp_path / "crash")
  with pytest.raises(SimulatedCrash):
    _fit(fresh(), 3, CheckpointStore(store_dir, fault_hook=faults.store_hook),
         save_every=2, resume="never", fault_source=faults)
  assert faults.injected["corrupt"] == 1
  resumed, report = _fit(fresh(), 3, CheckpointStore(store_dir),
                         save_every=2, resume="auto")
  assert report["quarantined"] == 1 and report["resumed_from"] == 4
  assert report["final_step"] == 12
  _assert_states_equal(clean[0], resumed)
  assert os.path.isdir(os.path.join(store_dir, "quarantine"))


def test_resume_must_raises_on_empty_store(fresh, tmp_path):
  with pytest.raises(FileNotFoundError, match="resume='must'"):
    _fit(fresh(), 1, CheckpointStore(str(tmp_path)), resume="must")


@pytest.mark.parametrize("nan_steps,lr", [((5,), LR * 0.5),
                                          ((5, 6), LR * 0.25)])
def test_nan_batch_rolls_back_and_cuts_lr(fresh, tmp_path, nan_steps, lr):
  """A NaN batch rolls back to the last checkpoint and halves the LR; a
  second NaN in the replay cuts from the already cut LR."""
  faults = TrainFaultSource()
  for s in nan_steps:
    faults.at_step(s, TrainFault("nan"))
  store = CheckpointStore(str(tmp_path))
  out, report = _fit(fresh(), 3, store, save_every=2, resume="never",
                     fault_source=faults,
                     nan_guard=NanGuard(lr_cut=0.5, max_rollbacks=3))
  assert faults.injected["nan"] == len(nan_steps)
  assert report["nan_rollbacks"] == len(nan_steps)
  assert report["final_step"] == 12 and len(report["losses"]) == 12
  assert all(np.isfinite(report["losses"]))
  assert tloop.current_learning_rate(out) == lr
  assert all(torch.isfinite(p).all() for p in out.model.parameters())
  # The cut rides in the checkpoint, as a float64 leaf and in the meta.
  restored = store.restore()
  assert restored.arrays["['learning_rate']"] == np.float64(lr)
  assert restored.meta["learning_rate"] == lr


def test_nan_without_guard_fails_fast(fresh, tmp_path):
  faults = TrainFaultSource().at_step(2, TrainFault("nan"))
  with pytest.raises(NonFiniteLossError):
    _fit(fresh(), 1, CheckpointStore(str(tmp_path)), resume="never",
         fault_source=faults)


def test_preempt_fault_saves_and_resume_completes(fresh, clean, tmp_path):
  faults = TrainFaultSource().at_step(6, TrainFault("preempt"))
  store_dir = str(tmp_path / "pre")
  _, report = _fit(fresh(), 3, CheckpointStore(store_dir), save_every=2,
                   resume="never", fault_source=faults)
  assert report["preempted"] and report["final_step"] == 6
  resumed, r2 = _fit(fresh(), 3, CheckpointStore(store_dir), save_every=2,
                     resume="auto")
  assert r2["resumed_from"] == 6 and not r2["preempted"]
  _assert_states_equal(clean[0], resumed)


def test_skip_ahead_resume_matches_replay_and_clean(fresh, clean, tmp_path):
  def crash_then_resume(root, make_batches):
    faults = TrainFaultSource().at_step(7, TrainFault("crash"))
    with pytest.raises(SimulatedCrash):
      _fit(fresh(), 3, CheckpointStore(str(root),
                                       fault_hook=faults.store_hook),
           make_batches=make_batches, save_every=2, resume="never",
           fault_source=faults)
    return _fit(fresh(), 3, CheckpointStore(str(root)),
                make_batches=make_batches, save_every=2, resume="auto")

  skip_calls = []

  def epoch_with_skip(e, skip=0):
    skip_calls.append((e, skip))
    return _epoch(e)[skip:]

  replayed, r_replay = crash_then_resume(tmp_path / "replay", _epoch)
  skipped, r_skip = crash_then_resume(tmp_path / "skip", epoch_with_skip)
  assert r_replay["resumed_from"] == r_skip["resumed_from"] == 6
  assert any(s > 0 for _, s in skip_calls)
  _assert_states_equal(clean[0], replayed)
  _assert_states_equal(clean[0], skipped)


def test_kwargs_only_callables_route_to_replay(fresh, tmp_path):
  calls = []

  def sneaky(e, **kwargs):
    calls.append(kwargs)
    return _epoch(e)

  faults = TrainFaultSource().at_step(5, TrainFault("preempt"))
  _fit(fresh(), 2, CheckpointStore(str(tmp_path)), make_batches=sneaky,
       resume="never", fault_source=faults)
  out, _ = _fit(fresh(), 2, CheckpointStore(str(tmp_path)),
                make_batches=sneaky, resume="auto")
  assert all(kw == {} for kw in calls)
  want, _ = _fit(fresh(), 2, CheckpointStore(str(tmp_path / "clean")),
                 resume="never")
  _assert_states_equal(want, out)


# The stall timeout, well below the hang and the slow host work.
STALL_S = 0.5


def test_hang_fault_trips_watchdog(fresh, tmp_path):
  fired = []
  faults = TrainFaultSource().at_step(
      2, TrainFault("hang", seconds=2 * STALL_S))
  dog = StallWatchdog(STALL_S, on_stall=fired.append).start(poll_s=0.01)
  _, report = _fit(fresh(), 1, CheckpointStore(str(tmp_path)),
                   resume="never", fault_source=faults, watchdog=dog)
  assert report["final_step"] == 4
  assert dog.stalls >= 1 and fired


def _instant_step(state, batch):
  """A step that takes no time: what is timed is the loop's host work."""
  state.step += 1
  return state, {"loss": torch.tensor(0.5)}


@pytest.mark.parametrize("slow", ["make_batches", "on_epoch"])
def test_slow_host_work_does_not_trip_watchdog(fresh, tmp_path, slow):
  """Building an epoch's batches and the per-epoch validation run between
  beats; longer than the stall timeout, they are not paged as hangs (the
  step is instant, so only they could outlast it)."""
  fired = []

  def slow_epoch(e):
    time.sleep(2 * STALL_S)
    return _epoch(e)

  kw = ({"make_batches": slow_epoch} if slow == "make_batches"
        else {"on_epoch": lambda *a: time.sleep(2 * STALL_S)})
  dog = StallWatchdog(STALL_S, on_stall=fired.append).start(poll_s=0.01)
  _, report = _fit(fresh(), 1, CheckpointStore(str(tmp_path)),
                   step=_instant_step, resume="never", watchdog=dog, **kw)
  assert report["final_step"] == 4
  assert dog.stalls == 0 and not fired


def test_fit_resumable_with_background_saver_is_bit_exact(fresh, tmp_path):
  sync, r_sync = _fit(fresh(), 2, CheckpointStore(str(tmp_path / "sync")),
                      save_every=2, resume="never")
  out, report = _fit(fresh(), 2,
                     BackgroundSaver(CheckpointStore(str(tmp_path / "bg"))),
                     save_every=2, resume="never")
  _assert_states_equal(sync, out)
  assert report["losses"] == r_sync["losses"]
  assert report["saves"] == r_sync["saves"]
  a = CheckpointStore(str(tmp_path / "sync")).restore()
  b = CheckpointStore(str(tmp_path / "bg")).restore()
  assert a.step == b.step == 8
  assert ({k: v["sha256"] for k, v in a.manifest["arrays"].items()}
          == {k: v["sha256"] for k, v in b.manifest["arrays"].items()})


# -- JAX parity ------------------------------------------------------------------


def _jax_epoch(e):
  return [_np_batch(e, i) for i in range(4)]


SCHEDULES = {
    # name: (step faults, save faults, crash-then-resume)
    "nan_rollbacks": ({5: "nan", 9: "nan"}, {}, False),
    "corrupt_then_crash": ({7: "crash"}, {3: "corrupt"}, True),
    "preempt": ({6: "preempt"}, {}, True),
}
INT_KEYS = ("final_step", "resumed_from", "preempted", "nan_rollbacks",
            "nan_rollback_steps", "saves", "quarantined")


def _run_schedule(pkg, name, init, root):
  """One schedule through one package's fit_resumable: the report of the
  run that finishes (the resume, for crash-then-resume schedules)."""
  step_faults, save_faults, resumes = SCHEDULES[name]
  if pkg == "jax":
    src_cls, fault_cls, store_cls = (JaxTrainFaultSource, JaxTrainFault,
                                     JaxCheckpointStore)
    fit, guard, crash = jloop.fit_resumable, JaxNanGuard, JaxSimulatedCrash
    make_batches, step = _jax_epoch, _JAX_STEP[0]
  else:
    src_cls, fault_cls, store_cls = (TrainFaultSource, TrainFault,
                                     CheckpointStore)
    fit, guard, crash = tloop.fit_resumable, NanGuard, SimulatedCrash
    make_batches, step = _epoch, STEP
  faults = src_cls()
  for s, kind in step_faults.items():
    faults.at_step(s, fault_cls(kind))
  for s, kind in save_faults.items():
    faults.at_save(s, fault_cls(kind))
  store = store_cls(root, fault_hook=faults.store_hook)
  kw = dict(step=step, save_every=2, nan_guard=guard())
  try:
    state, report = fit(init(), 3, make_batches, store, resume="never",
                        fault_source=faults, **kw)
  except crash:
    state, report = None, None
  if resumes:
    state, report = fit(init(), 3, make_batches, store_cls(root),
                        resume="auto", **kw)
  return state, report


_JAX_STEP = []


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_fit_resumable_matches_jax(jax_init, fresh, tmp_path, name):
  if not _JAX_STEP:
    _JAX_STEP.append(jloop.make_train_step(vgg_params=None))
  jstate, jreport = _run_schedule("jax", name, lambda: jax_init[0],
                                  str(tmp_path / "jax"))
  tstate, treport = _run_schedule("port", name, fresh, str(tmp_path / "port"))
  for key in INT_KEYS:
    assert treport[key] == jreport[key], key
  assert len(treport["losses"]) == len(jreport["losses"])
  np.testing.assert_allclose(treport["losses"], jreport["losses"], atol=1e-4,
                             rtol=0)
  assert tloop.current_learning_rate(tstate) == pytest.approx(
      jloop.current_learning_rate(jstate), rel=1e-6)


# -- the kill-and-resume pin, in subprocesses ------------------------------------


COMMON = ["--epochs", "3", "--batches", "4", "--save-every", "2", "--seed",
          "0", "--device", "cpu"]


def _spawn(*args):
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  env["PYTHONPATH"] = ROOT
  # One intra-op thread each: the concurrent runs would oversubscribe the
  # cores (every run of one test shares this environment, so digests
  # compare like with like).
  env["OMP_NUM_THREADS"] = "1"
  return subprocess.Popen(
      [sys.executable, "-m", "mpi_vision_tpu_torch.tools.train_resume",
       *COMMON, *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
      text=True, env=env, cwd=ROOT)


def _finish(proc, timeout=300):
  out, err = proc.communicate(timeout=timeout)
  return proc.returncode, out, err


def _json_line(out: str, err: str) -> dict:
  lines = [ln for ln in out.strip().splitlines() if ln.startswith("{")]
  assert lines, f"no JSON line:\nstdout={out!r}\nstderr={err[-2000:]}"
  return json.loads(lines[-1])


def test_sigkill_midepoch_resume_is_bit_exact(tmp_path):
  """SIGKILL at step 7 of 12 (mid-epoch), resume, compare digests — and
  the variant whose step-6 checkpoint is corrupted before the kill."""
  base_dir = str(tmp_path / "baseline")
  kill_dir = str(tmp_path / "killed")
  rot_dir = str(tmp_path / "killed_corrupt")
  baseline = _spawn("--dir", base_dir, "--fresh")
  killed = _spawn("--dir", kill_dir, "--fresh", "--crash-at", "7")
  rotted = _spawn("--dir", rot_dir, "--fresh", "--crash-at", "7",
                  "--corrupt-save", "3")
  rc_base, out_base, err_base = _finish(baseline)
  rc_kill, _, err_kill = _finish(killed)
  rc_rot, _, err_rot = _finish(rotted)
  assert rc_base == 0, err_base[-2000:]
  base = _json_line(out_base, err_base)
  assert base["value"] == 12 and base["digest"] and base["device"] == "cpu"
  assert rc_kill == -signal.SIGKILL, (rc_kill, err_kill[-2000:])
  assert rc_rot == -signal.SIGKILL, (rc_rot, err_rot[-2000:])
  assert any(n.startswith("step_") for n in os.listdir(kill_dir))

  res_kill = _spawn("--dir", kill_dir)
  res_rot = _spawn("--dir", rot_dir)
  rc1, out1, err1 = _finish(res_kill)
  rc2, out2, err2 = _finish(res_rot)
  assert rc1 == 0, err1[-2000:]
  assert rc2 == 0, err2[-2000:]
  resumed, rot = _json_line(out1, err1), _json_line(out2, err2)
  assert resumed["resumed_from"] == 6 and resumed["value"] == 12
  assert resumed["digest"] == base["digest"]
  assert rot["quarantined"] == 1 and rot["resumed_from"] == 4
  assert rot["digest"] == base["digest"]
  assert os.path.isdir(os.path.join(rot_dir, "quarantine"))


def test_train_resume_selftest_smoke():
  rc, out, err = _finish(_spawn("--selftest"))
  assert rc == 0, err[-2000:]
  res = _json_line(out, err)
  assert res["metric"] == "train_resume_selftest" and res["value"] == 1
  assert res["bit_exact"] is True and res["resumed_from"] == 6
