"""Live checkpoint reload in the port: watcher semantics and zero-drop
scene swaps.

The counterpart of ``tests/serve/test_reload.py``, test for test, run
against ``mpi_vision_tpu_torch`` (``ckpt/watch.py`` is a copy of the JAX
module; ``RenderService.swap_scenes`` a port), on the CPU: a checkpoint
published while the service is under load swaps the scenes in place with
zero failed in-flight requests, and requests racing the swap serve either
the old bake or the new one, never an error. The watcher is pinned on a
fake store and against a real ``CheckpointStore``. One case more than the
JAX file: a tiled service re-bakes only the tiles a swap changed.
"""

import threading
import time

import numpy as np
import pytest

from mpi_vision_tpu_torch.ckpt import CheckpointStore, CheckpointWatcher
from mpi_vision_tpu_torch.serve import RenderService, synthetic_scene

H = W = 16
P = 4


def _pose(tx=0.0):
  pose = np.eye(4, dtype=np.float32)
  pose[0, 3] = tx
  return pose


def _service(**kw):
  return RenderService(max_batch=kw.pop("max_batch", 2), max_wait_ms=0.5,
                       resilience=None, device="cpu", **kw)


# --- watcher unit behavior (fake store) ----------------------------------


class FakeStore:
  def __init__(self, step=None):
    self.step = step
    self.boom = None

  def latest_step(self):
    if self.boom is not None:
      raise self.boom
    return self.step


def test_watcher_fires_once_per_new_step_and_ignores_stale():
  store = FakeStore(step=None)
  fired = []
  w = CheckpointWatcher(store, fired.append, poll_s=1.0)
  assert w.check_once() is None  # empty store: nothing to do
  store.step = 5
  assert w.check_once() == 5
  assert w.check_once() is None  # same step: fire-once
  store.step = 4
  assert w.check_once() is None  # regression (GC'd newest): stale, ignored
  store.step = 7
  assert w.check_once() == 7
  assert fired == [5, 7]
  assert w.snapshot()["reloads"] == 2


def test_watcher_initial_step_suppresses_the_startup_checkpoint():
  store = FakeStore(step=5)
  fired = []
  w = CheckpointWatcher(store, fired.append, initial_step=5)
  assert w.check_once() is None  # step 5 was the startup bake
  store.step = 6
  assert w.check_once() == 6
  assert fired == [6]


def test_watcher_failed_reload_is_retried_until_superseded():
  store = FakeStore(step=3)
  calls = []

  def flaky(step):
    calls.append(step)
    if len(calls) < 3:
      raise RuntimeError("bake failed")

  logs = []
  w = CheckpointWatcher(store, flaky, log=logs.append)
  assert w.check_once() is None  # fails; step 3 stays unseen
  assert w.check_once() is None  # retried next poll
  assert w.check_once() == 3     # third time lucky
  assert calls == [3, 3, 3]
  snap = w.snapshot()
  assert snap["reload_errors"] == 2 and snap["reloads"] == 1
  assert snap["last_error"] is None  # cleared by the success
  assert any("step 3 failed" in line for line in logs)


def test_watcher_store_errors_counted_not_fatal():
  store = FakeStore(step=1)
  w = CheckpointWatcher(store, lambda s: None)
  store.boom = OSError("transient NFS sadness")
  assert w.check_once() is None
  assert w.snapshot()["reload_errors"] == 1
  store.boom = None
  assert w.check_once() == 1  # recovered


def test_watcher_thread_polls_and_stops():
  store = FakeStore(step=None)
  fired = []
  with CheckpointWatcher(store, fired.append, poll_s=0.01).start() as w:
    store.step = 2
    deadline = time.monotonic() + 5.0
    while not fired and time.monotonic() < deadline:
      time.sleep(0.01)
  assert fired == [2]
  assert w.snapshot()["polls"] >= 1


def test_watcher_injected_sleep_paces_the_thread():
  store = FakeStore(step=None)
  slept = []
  w = CheckpointWatcher(store, lambda s: None, poll_s=3.0,
                        sleep=lambda s: (slept.append(s), time.sleep(0.001)))
  with w.start():
    deadline = time.monotonic() + 5.0
    while len(slept) < 2 and time.monotonic() < deadline:
      time.sleep(0.005)
  assert slept[:2] == [3.0, 3.0]


# --- zero-drop swap under load ------------------------------------------


def test_swap_scenes_invalidates_the_cache_and_changes_pixels():
  with _service() as svc:
    svc.add_scene("s", *synthetic_scene("s", H, W, P, seed=0))
    before = svc.render("s", _pose())
    assert svc.cache.stats()["misses"] == 1
    assert svc.swap_scenes(
        {"s": synthetic_scene("s", H, W, P, seed=99)}) == ["s"]
    after = svc.render("s", _pose())
    stats = svc.cache.stats()
    assert stats["invalidations"] == 1 and stats["misses"] == 2  # re-baked
    assert not np.array_equal(before, after)  # really the new data
    # And the new bake matches a service that NEVER saw the old data.
    with _service() as fresh:
      fresh.add_scene("s", *synthetic_scene("s", H, W, P, seed=99))
      np.testing.assert_array_equal(after, fresh.render("s", _pose()))


def test_ckpt_publish_swaps_scenes_with_zero_failed_inflight(tmp_path):
  """The acceptance pin: checkpoint publishes arrive while requests are
  in flight; every request succeeds (old scenes or new, never an error)
  and the pixels eventually serve the newest publish."""
  store = CheckpointStore(str(tmp_path))
  store.save(0, {"v": np.float32(0)})

  with _service(max_batch=4) as svc:
    scene_ids = ["ckpt_000", "ckpt_001"]
    for sid in scene_ids:
      svc.add_scene(sid, *synthetic_scene(sid, H, W, P, seed=0))

    def reload_step(step):
      # The CLI's reload in miniature: new scene data from the published
      # step, swapped in place under the SAME ids, prebaked.
      svc.swap_scenes({sid: synthetic_scene(sid, H, W, P, seed=step)
                       for sid in scene_ids}, prebake=True)

    watcher = CheckpointWatcher(store, reload_step, poll_s=1.0,
                                initial_step=0)
    stop = threading.Event()
    failures: list[BaseException] = []
    completed = [0]
    lock = threading.Lock()

    def hammer(widx):
      i = 0
      while not stop.is_set():
        sid = scene_ids[(widx + i) % len(scene_ids)]
        i += 1
        try:
          img = svc.render(sid, _pose(0.001 * (i % 7)), timeout=60)
          assert img.shape == (H, W, 3)
        except BaseException as e:  # noqa: BLE001 - ANY failure is the bug
          with lock:
            failures.append(e)
          return
        with lock:
          completed[0] += 1

    threads = [threading.Thread(target=hammer, args=(w,), daemon=True)
               for w in range(4)]
    for t in threads:
      t.start()
    deadline = time.monotonic() + 60.0
    for step in (1, 2, 3):
      # A real publish (atomic rename) lands mid-traffic...
      while completed[0] < step * 20 and time.monotonic() < deadline:
        time.sleep(0.005)
      store.save(step, {"v": np.float32(step)})
      assert watcher.check_once() == step  # ...and the watcher swaps it in.
    while completed[0] < 80 and time.monotonic() < deadline:
      time.sleep(0.005)
    stop.set()
    for t in threads:
      t.join(30)
      assert not t.is_alive()

    assert not failures, f"in-flight requests failed across swaps: " \
                         f"{failures[:3]}"
    assert completed[0] >= 80
    assert watcher.snapshot()["reloads"] == 3
    # The service now provably serves step 3's data.
    got = svc.render(scene_ids[0], _pose())
    with _service() as fresh:
      fresh.add_scene(scene_ids[0],
                      *synthetic_scene(scene_ids[0], H, W, P, seed=3))
      np.testing.assert_array_equal(got, fresh.render(scene_ids[0],
                                                      _pose()))


def test_swap_scenes_prebake_leaves_no_cold_first_request():
  with _service() as svc:
    svc.add_scene("s", *synthetic_scene("s", H, W, P, seed=0))
    svc.render("s", _pose())
    svc.swap_scenes({"s": synthetic_scene("s", H, W, P, seed=1)},
                    prebake=True)
    misses_after_swap = svc.cache.stats()["misses"]
    svc.render("s", _pose())  # must be a cache HIT on the new bake
    stats = svc.cache.stats()
    assert stats["misses"] == misses_after_swap
    assert stats["hits"] >= 1


@pytest.mark.parametrize("prebake", [False, True])
def test_a_bake_that_read_the_old_data_does_not_outlive_the_swap(
    monkeypatch, prebake):
  """A request misses the cache and its bake reads the old registry entry;
  the swap lands while that bake runs. The racing request may serve the
  old scene, but its bake must not enter the cache after the swap's
  invalidation (or over the swap's prebake): every later request serves
  the new data."""
  from mpi_vision_tpu_torch.serve import cache as cache_mod

  old = synthetic_scene("s", H, W, P, seed=0)
  new = synthetic_scene("s", H, W, P, seed=99)
  want = {}
  for name, scene in (("old", old), ("new", new)):
    with _service() as fresh:
      fresh.add_scene("s", *scene)
      want[name] = fresh.render("s", _pose())

  real_bake = cache_mod.bake_scene
  entered, release = threading.Event(), threading.Event()
  slow = [True]

  def slow_bake(*args, **kw):
    if slow[0]:          # the first bake: it already holds the old entry
      slow[0] = False
      entered.set()
      assert release.wait(30)
    return real_bake(*args, **kw)

  monkeypatch.setattr(cache_mod, "bake_scene", slow_bake)
  with _service() as svc:
    svc.add_scene("s", *old)
    raced = []
    racer = threading.Thread(
        target=lambda: raced.append(svc.render("s", _pose(), timeout=60)),
        daemon=True)
    racer.start()
    assert entered.wait(30)
    svc.swap_scenes({"s": new}, prebake=prebake)
    release.set()
    racer.join(60)
    assert not racer.is_alive()
    np.testing.assert_array_equal(raced[0], want["old"])
    for _ in range(2):
      np.testing.assert_array_equal(svc.render("s", _pose()), want["new"])


def test_tiled_swap_rebakes_only_the_changed_tiles():
  from mpi_vision_tpu_torch.kernels import compose_over

  rgba, depths, k = synthetic_scene("s", H, W, P, seed=0)
  with _service(tile=8) as svc:          # a 2 x 2 tile grid
    svc.add_scene("s", rgba, depths, k)
    svc.render("s", _pose())
    assert svc.stats()["tile_cache"]["misses"] == 4
    patched = rgba.copy()
    patched[8:, :8, :, :3] = 0.25        # one tile's colours change
    compose_over.plain_composite.calls = 0
    assert svc.swap_scenes({"s": (patched, depths, k)},
                           prebake=True) == ["s"]
    tiles = svc.stats()["tile_cache"]
    assert tiles["invalidations"] == 1 and tiles["misses"] == 5
    got = svc.render("s", _pose())
    assert svc.stats()["tile_cache"]["misses"] == 5  # prebaked: all hits
    assert compose_over.plain_composite.calls > 0    # the compose path ran
    with _service(tile=8) as fresh:
      fresh.add_scene("s", patched, depths, k)
      np.testing.assert_array_equal(got, fresh.render("s", _pose()))
    # A swap that changes nothing re-bakes nothing.
    svc.swap_scenes({"s": (patched, depths, k)}, prebake=True)
    assert svc.stats()["tile_cache"]["misses"] == 5
