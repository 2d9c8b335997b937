"""The port's checkpoint store, guards and fault injection (``ckpt/``).

The port's counterparts of ``tests/test_ckpt.py``'s store, guard and fault
cases, on trees that mix torch tensors with numpy arrays, plus the format
pin across packages: a checkpoint the port's store writes is restored and
hash-verified by the JAX package's ``CheckpointStore``, and the reverse,
with equal arrays and meta. Everything is exact (the store moves bytes).
"""

import builtins
import errno
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from mpi_vision_tpu.ckpt import CheckpointStore as JaxCheckpointStore
from mpi_vision_tpu_torch.ckpt import (
    BackgroundSaver,
    CheckpointStore,
    CorruptCheckpointError,
    NanGuard,
    NonFiniteLossError,
    PreemptionGuard,
    SimulatedCrash,
    StallWatchdog,
    TrainFault,
    TrainFaultSource,
    flatten_arrays,
    unflatten_arrays,
)


def _tree(rng):
  return {
      "params": {"w": torch.from_numpy(
          rng.normal(size=(3, 4)).astype(np.float32)),
                 "b": rng.normal(size=(4,)).astype(np.float32)},
      "adam": [{"step": torch.tensor(3.0)}],
      "step": np.int64(7),
  }


def _host(tree):
  """The tree with every leaf as a numpy array."""
  if isinstance(tree, dict):
    return {k: _host(v) for k, v in tree.items()}
  if isinstance(tree, list):
    return [_host(v) for v in tree]
  return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _assert_equal(a, b):
  a, b = _host(a), _host(b)
  if isinstance(a, dict):
    assert set(a) == set(b)
    for k in a:
      _assert_equal(a[k], b[k])
  elif isinstance(a, list):
    assert len(a) == len(b)
    for x, y in zip(a, b):
      _assert_equal(x, y)
  else:
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# -- the store ----------------------------------------------------------------


def test_roundtrip_bit_exact_including_scalars(rng, tmp_path):
  store = CheckpointStore(str(tmp_path))
  tree = _tree(rng)
  store.save(7, tree, meta={"cursor": {"epoch": 1, "batch": 2}})
  restored = store.restore(template=tree)
  assert restored.step == 7
  assert restored.meta["cursor"] == {"epoch": 1, "batch": 2}
  out = restored.tree(tree)
  assert out["step"].shape == () and out["step"].dtype == np.int64
  assert out["adam"][0]["step"].shape == ()       # 0-d stays 0-d
  assert out["adam"][0]["step"].dtype == np.float32
  _assert_equal(tree, out)
  assert sorted(restored.arrays) == [
      "['adam'][0]['step']", "['params']['b']", "['params']['w']",
      "['step']"]


def test_partial_template_restores_subtree(rng, tmp_path):
  store = CheckpointStore(str(tmp_path))
  tree = _tree(rng)
  store.save(1, tree)
  restored = store.restore(template={"params": tree["params"]})
  # A params-only template reads and verifies only the params.
  assert sorted(restored.arrays) == ["['params']['b']", "['params']['w']"]
  _assert_equal(tree["params"], restored.tree({"params": tree["params"]})
                ["params"])


def test_missing_template_key_raises(rng, tmp_path):
  store = CheckpointStore(str(tmp_path))
  store.save(1, _tree(rng))
  with pytest.raises(KeyError, match="missing array"):
    store.restore(template={"nope": np.zeros(1)})


def test_gc_keeps_last_k(rng, tmp_path):
  store = CheckpointStore(str(tmp_path), keep=2)
  for s in range(5):
    store.save(s, _tree(rng))
  assert store.steps() == [3, 4]


def test_overwrite_same_step(rng, tmp_path):
  store = CheckpointStore(str(tmp_path))
  store.save(3, _tree(rng))
  tree2 = _tree(np.random.default_rng(99))
  store.save(3, tree2)
  _assert_equal(tree2, store.restore().tree(tree2))
  assert store.steps() == [3]


def _truncate_arrays(path):
  arrays = os.path.join(path, "arrays.npz")
  with open(arrays, "r+b") as fh:
    fh.truncate(os.path.getsize(arrays) // 2)


def _garble_arrays(path):
  arrays = os.path.join(path, "arrays.npz")
  with open(arrays, "r+b") as fh:
    fh.seek(os.path.getsize(arrays) // 2 - 8)
    fh.write(b"\xde\xad\xbe\xef" * 4)


def _edit_manifest(path, edit):
  mpath = os.path.join(path, "manifest.json")
  with open(mpath) as fh:
    manifest = json.load(fh)
  edit(manifest)
  with open(mpath, "w") as fh:
    json.dump(manifest, fh)


def _garble_manifest(path):
  with open(os.path.join(path, "manifest.json"), "w") as fh:
    fh.write("{not json")


def _drop_step(path):
  _edit_manifest(path, lambda m: m.update({"step#": m.pop("step")}))


def _mismatch_step(path):
  _edit_manifest(path, lambda m: m.update({"step": 20}))


def _mismatch_hash(path):
  def edit(m):
    m["arrays"][next(iter(m["arrays"]))]["sha256"] = "0" * 64
  _edit_manifest(path, edit)


@pytest.mark.parametrize("damage,reason", [
    (_truncate_arrays, "unreadable"),
    (_garble_arrays, ""),
    (_garble_manifest, "manifest unreadable"),
    (_drop_step, "step invalid"),
    (_mismatch_step, "manifest step 20 != directory step 2"),
    (_mismatch_hash, "hash mismatch"),
])
def test_damaged_checkpoint_quarantined_with_fallback(rng, tmp_path, damage,
                                                      reason):
  """Truncated, garbled, step-mangled and hash-mismatched checkpoints are
  quarantined and restore falls back to the last good one."""
  store = CheckpointStore(str(tmp_path))
  good_tree = _tree(rng)
  store.save(1, good_tree)
  store.save(2, _tree(np.random.default_rng(1)))
  damage(store._step_dir(2))
  events = []
  restored = store.restore(template=good_tree,
                           on_quarantine=lambda s, r: events.append((s, r)))
  assert restored.step == 1
  _assert_equal(good_tree, restored.tree(good_tree))
  assert store.quarantined == 1 and events[0][0] == 2
  assert reason in events[0][1]
  assert store.steps() == [1]
  assert len(os.listdir(os.path.join(str(tmp_path), "quarantine"))) == 1


def test_hash_mismatch_at_an_explicit_step_raises(rng, tmp_path):
  store = CheckpointStore(str(tmp_path))
  store.save(1, _tree(rng))
  _mismatch_hash(store._step_dir(1))
  with pytest.raises(CorruptCheckpointError, match="hash mismatch"):
    store.restore(step=1)
  assert store.quarantined == 1


def test_transient_read_error_does_not_quarantine(rng, tmp_path, monkeypatch):
  store = CheckpointStore(str(tmp_path))
  store.save(1, _tree(rng))
  real_open = builtins.open

  def flaky_open(file, *a, **kw):
    if str(file).endswith("manifest.json"):
      raise OSError(errno.EMFILE, "Too many open files", str(file))
    return real_open(file, *a, **kw)

  monkeypatch.setattr(builtins, "open", flaky_open)
  with pytest.raises(OSError) as ei:
    store.restore()
  monkeypatch.undo()
  assert ei.value.errno == errno.EMFILE
  assert store.quarantined == 0 and store.steps() == [1]
  assert store.restore().step == 1


def test_empty_store_restores_none(tmp_path):
  assert CheckpointStore(str(tmp_path)).restore() is None


def test_crash_before_rename_leaves_no_checkpoint(rng, tmp_path):
  faults = TrainFaultSource().at_save(
      1, TrainFault("crash", stage="pre_rename"))
  store = CheckpointStore(str(tmp_path), fault_hook=faults.store_hook)
  store.save(0, _tree(rng))
  with pytest.raises(SimulatedCrash):
    store.save(1, _tree(rng))
  fresh = CheckpointStore(str(tmp_path))
  assert fresh.steps() == [0]
  assert not [n for n in os.listdir(str(tmp_path)) if n.startswith(".tmp-")]
  assert fresh.restore().step == 0


def test_corrupt_write_fault_quarantines_on_restore(rng, tmp_path):
  faults = TrainFaultSource().at_save(1, TrainFault("corrupt"))
  store = CheckpointStore(str(tmp_path), fault_hook=faults.store_hook)
  store.save(0, _tree(rng))
  store.save(1, _tree(rng))
  assert faults.injected["corrupt"] == 1
  fresh = CheckpointStore(str(tmp_path))
  assert fresh.restore().step == 0 and fresh.quarantined == 1


def test_interrupted_same_step_replace_restores_aside(rng, tmp_path):
  store = CheckpointStore(str(tmp_path))
  tree = _tree(rng)
  store.save(3, tree)
  os.rename(store._step_dir(3),
            os.path.join(str(tmp_path),
                         f".old-step_0000000003-{os.getpid()}-1"))
  fresh = CheckpointStore(str(tmp_path))
  assert fresh.steps() == [3]
  _assert_equal(tree, fresh.restore(template=tree).tree(tree))


def test_clear_removes_published_keeps_quarantine(rng, tmp_path):
  store = CheckpointStore(str(tmp_path))
  store.save(1, _tree(rng))
  store.save(2, _tree(rng))
  store.quarantine(2, "evidence")
  assert store.clear() == [1]
  assert store.steps() == [] and store.restore() is None
  assert os.listdir(os.path.join(str(tmp_path), "quarantine"))


def test_flatten_copies_and_unflatten_inverts(rng):
  tree = _tree(rng)
  flat = flatten_arrays(tree)
  _assert_equal(tree, unflatten_arrays(flat, tree))
  before = flat["['params']['w']"].copy()
  tree["params"]["w"].add_(1.0)                 # in place, as Adam does
  tree["params"]["b"] += 1.0
  np.testing.assert_array_equal(flat["['params']['w']"], before)
  assert not np.shares_memory(flat["['params']['b']"], tree["params"]["b"])


# -- guards and faults ------------------------------------------------------


def test_nan_guard_budget():
  guard = NanGuard(max_rollbacks=2)
  guard.note_rollback(3, float("nan"))
  guard.note_rollback(5, float("inf"))
  with pytest.raises(NonFiniteLossError, match="exhausted"):
    guard.note_rollback(7, float("nan"))
  assert guard.rollbacks == 2


def test_watchdog_fires_once_per_episode():
  now = [0.0]
  fired = []
  dog = StallWatchdog(10.0, clock=lambda: now[0], on_stall=fired.append)
  assert not dog.check()
  now[0] = 5.0
  dog.beat()
  now[0] = 14.0
  assert not dog.check()
  now[0] = 16.0
  assert dog.check() and fired == [11.0]
  now[0] = 30.0
  assert not dog.check()
  dog.beat()
  now[0] = 50.0
  assert dog.check()
  assert dog.stalls == 2


def test_watchdog_suspended_holds_fire_past_timeout():
  now = [0.0]
  fired = []
  dog = StallWatchdog(10.0, clock=lambda: now[0], on_stall=fired.append)
  with dog.suspended():
    now[0] = 40.0
    assert not dog.check() and not fired
  assert not dog.check()
  now[0] = 51.0
  assert dog.check() and dog.stalls == 1


def test_watchdog_thread_start_stop():
  dog = StallWatchdog(0.01).start(poll_s=0.005)
  assert dog.running
  dog.stop()
  assert not dog.running


def test_preemption_guard_signal_roundtrip():
  guard = PreemptionGuard(signals=(signal.SIGTERM,))
  before = signal.getsignal(signal.SIGTERM)
  with guard:
    assert not guard.requested.is_set()
    signal.raise_signal(signal.SIGTERM)
    assert guard.requested.is_set()
  assert signal.getsignal(signal.SIGTERM) is before


def test_poison_batch_only_floats():
  batch = {"x": torch.ones(2, 2), "i": torch.arange(3),
           "n": np.ones(2, np.float32), "m": np.arange(2)}
  bad = TrainFaultSource.poison_batch(batch)
  assert torch.isnan(bad["x"]).all() and bad["x"].device == batch["x"].device
  assert bad["x"].dtype == torch.float32
  assert torch.equal(bad["i"], batch["i"])
  assert np.isnan(bad["n"]).all()
  np.testing.assert_array_equal(bad["m"], batch["m"])


# -- the background saver ---------------------------------------------------


def _hashes(restored):
  return {k: v["sha256"] for k, v in restored.manifest["arrays"].items()}


@pytest.mark.parametrize("mutate", [False, True])
def test_background_saver_publishes_byte_identical_checkpoint(
    rng, tmp_path, mutate):
  """The background save of a tree equals a foreground save of the same
  tree, also when its tensors are updated in place right after ``save``
  returns (the saver copies every leaf before it returns)."""
  tree = _tree(rng)
  sync = CheckpointStore(str(tmp_path / "sync"))
  sync.save(7, tree, meta={"cursor": {"epoch": 1, "batch": 2}})
  bg = BackgroundSaver(CheckpointStore(str(tmp_path / "bg")))
  gate = threading.Event()
  real = bg.store.save_arrays
  bg.store.save_arrays = lambda *a, **kw: (gate.wait(30), real(*a, **kw))[1]
  bg.save(7, tree, meta={"cursor": {"epoch": 1, "batch": 2}})
  if mutate:
    tree["params"]["w"].mul_(-3.0)
    tree["params"]["b"] *= -3.0
    tree["adam"][0]["step"].add_(1.0)
  gate.set()
  bg.flush()
  a, b = sync.restore(), bg.restore()
  assert b.step == 7 and b.meta == a.meta
  assert _hashes(a) == _hashes(b)
  with open(os.path.join(a.path, "arrays.npz"), "rb") as fa, \
      open(os.path.join(b.path, "arrays.npz"), "rb") as fb:
    assert fa.read() == fb.read()
  assert bg.saves == 1


def test_background_latest_step_counts_pending_save(rng, tmp_path):
  store = CheckpointStore(str(tmp_path))
  gate = threading.Event()
  real = store.save_arrays
  store.save_arrays = lambda *a, **kw: (gate.wait(30), real(*a, **kw))[1]
  bg = BackgroundSaver(store)
  bg.save(5, _tree(rng))
  assert bg.latest_step() == 5
  assert store.latest_step() is None
  gate.set()
  bg.flush()
  assert store.latest_step() == 5


def test_background_failed_save_surfaces_at_next_touch(rng, tmp_path):
  store = CheckpointStore(str(tmp_path))
  store.save_arrays = lambda *a, **kw: (_ for _ in ()).throw(
      RuntimeError("disk full"))
  bg = BackgroundSaver(store)
  bg.save(1, _tree(rng))
  with pytest.raises(RuntimeError, match="disk full"):
    bg.flush()
  bg.flush()


def test_background_reads_flush_first(rng, tmp_path):
  store = CheckpointStore(str(tmp_path))
  gate = threading.Event()
  real = store.save_arrays
  store.save_arrays = lambda *a, **kw: (gate.wait(30), real(*a, **kw))[1]
  bg = BackgroundSaver(store)
  tree = _tree(rng)
  bg.save(3, tree)
  timer = threading.Timer(0.1, gate.set)
  timer.start()
  restored = bg.restore(template=tree)
  timer.join(5)
  assert restored is not None and restored.step == 3


# -- one format across the two packages -------------------------------------


def test_port_checkpoint_reads_in_the_jax_store(rng, tmp_path):
  tree = _tree(rng)
  CheckpointStore(str(tmp_path)).save(
      4, tree, meta={"cursor": {"epoch": 0, "batch": 4}, "lr": 2e-4})
  template = _host(tree)
  restored = JaxCheckpointStore(str(tmp_path)).restore(template=template)
  assert restored.step == 4
  assert restored.meta == {"cursor": {"epoch": 0, "batch": 4}, "lr": 2e-4}
  out = restored.tree(template)
  assert isinstance(out["adam"], list)
  _assert_equal(tree, out)


def test_jax_checkpoint_reads_in_the_port_store(rng, tmp_path):
  tree = _host(_tree(rng))
  JaxCheckpointStore(str(tmp_path)).save(
      9, tree, meta={"cursor": {"epoch": 2, "batch": 1}})
  port = CheckpointStore(str(tmp_path))
  restored = port.restore(template=tree)
  assert restored.step == 9 and port.quarantined == 0
  assert restored.meta == {"cursor": {"epoch": 2, "batch": 1}}
  _assert_equal(tree, restored.tree(tree))
