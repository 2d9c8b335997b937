"""The port's host-side serving modules: histograms, tracing, resilience,
scheduler backpressure.

``obs/hist.py`` and ``serve/resilience.py`` are copies of the JAX
package's modules, so they are held to them exactly: the same inputs give
the same snapshots, classifications, breaker states and backoff schedules.
The rest pins behaviour of the port's service on the CPU.
"""

import random
import threading

import numpy as np
import pytest

from mpi_vision_tpu.obs import hist as jhist
from mpi_vision_tpu.serve import resilience as jres
from mpi_vision_tpu.serve.scheduler import MicroBatcher as JMicroBatcher
from mpi_vision_tpu_torch.obs import hist as thist
from mpi_vision_tpu_torch.obs.trace import Tracer
from mpi_vision_tpu_torch.serve import resilience as tres
from mpi_vision_tpu_torch.serve import (
    CircuitOpenError,
    MicroBatcher,
    QueueFullError,
    RenderEngine,
    RenderService,
    ResilienceConfig,
    TransientDeviceError,
    bake_scene,
    synthetic_scene,
)

H, W, P = 16, 24, 3


class _Clock:

  def __init__(self):
    self.t = 0.0

  def __call__(self):
    return self.t


def test_hist_matches_jax(rng):
  values = rng.lognormal(-4.0, 1.5, 400)
  ours, theirs = thist.NativeHistogram(), jhist.NativeHistogram()
  for i, v in enumerate(values):
    ours.record(float(v), exemplar=f"t{i}")
    theirs.record(float(v), exemplar=f"t{i}")
  ours.record(0.0)
  theirs.record(0.0)
  assert ours.snapshot() == theirs.snapshot()
  for q in (0.5, 0.9, 0.99):
    assert ours.quantile(q) == theirs.quantile(q)
  merged = thist.merge([ours.snapshot(), ours.snapshot()])
  assert merged.snapshot() == jhist.merge(
      [theirs.snapshot(), theirs.snapshot()]).snapshot()


@pytest.mark.parametrize("make", [
    lambda m: ValueError("UNAVAILABLE but bad input"),
    lambda m: RuntimeError("UNAVAILABLE: socket closed"),
    lambda m: RuntimeError("CUDA error: an illegal memory access"),
    lambda m: ConnectionResetError("peer"),
    lambda m: TimeoutError("slow"),
    lambda m: KeyError("scene"),
    lambda m: m.TransientDeviceError("card gone"),
    lambda m: m.DispatchTimeoutError("hung"),
    lambda m: m.CircuitOpenError(3.0),
])
def test_classify_error_matches_jax(make):
  assert tres.classify_error(make(tres)) == jres.classify_error(make(jres))


def test_circuit_breaker_matches_jax():
  clocks = _Clock(), _Clock()
  breakers = [m.CircuitBreaker(failure_threshold=2, reset_after_s=5.0,
                               clock=c) for m, c in zip((tres, jres), clocks)]
  script = ["fail", "ok", "fail", "fail", "allow", "tick6", "allow",
            "allow", "fail", "tick6", "allow", "ok", "allow"]
  for step in script:
    got = []
    for b, c in zip(breakers, clocks):
      if step == "fail":
        b.record_failure()
      elif step == "ok":
        b.record_success()
      elif step == "tick6":
        c.t += 6.0
      got.append((b.allow_primary() if step == "allow" else None,
                  b.snapshot(), b.would_allow(), b.retry_after_s()))
    assert got[0] == got[1], step


def test_retry_policy_matches_jax():
  ours, theirs = tres.RetryPolicy(), jres.RetryPolicy()
  r1, r2 = random.Random(7), random.Random(7)
  assert ([ours.backoff_s(a, r1) for a in range(1, 8)]
          == [theirs.backoff_s(a, r2) for a in range(1, 8)])


def test_executor_retries_transient_then_succeeds():
  sleeps = []
  ex = tres.ResilientExecutor(
      tres.ResilienceConfig(max_retries=2, watchdog_s=None),
      sleep=sleeps.append)
  calls = []

  def flaky():
    calls.append(1)
    if len(calls) < 3:
      raise TransientDeviceError("card hiccup")
    return "frame"

  assert ex.run(flaky) == "frame"
  assert len(calls) == 3 and len(sleeps) == 2
  assert ex.breaker.state == tres.CircuitBreaker.CLOSED

  def bad():
    calls.append(1)
    raise ValueError("malformed pose")

  calls.clear()
  with pytest.raises(ValueError):
    ex.run(bad)
  assert len(calls) == 1  # permanent: never retried


def test_executor_opens_breaker_and_fast_fails():
  ex = tres.ResilientExecutor(tres.ResilienceConfig(
      max_retries=0, breaker_threshold=1, breaker_reset_s=60.0,
      watchdog_s=None))

  def dead():
    raise TransientDeviceError("card gone")

  with pytest.raises(TransientDeviceError):
    ex.run(dead)
  with pytest.raises(CircuitOpenError):
    ex.check_fastfail()
  with pytest.raises(CircuitOpenError):
    ex.run(lambda: "never runs")


def test_watchdog_abandons_a_hung_call():
  release = threading.Event()
  with pytest.raises(tres.DispatchTimeoutError):
    tres.call_with_watchdog(lambda: release.wait(30), 0.05)
  release.set()
  assert tres.call_with_watchdog(lambda: 3, 1.0) == 3


class _DeadEngine(RenderEngine):
  """A CPU engine whose device is gone: every submit fails transiently."""

  def submit(self, scene, poses):
    raise TransientDeviceError("UNAVAILABLE: device lost")


def test_service_breaker_fast_fails_and_reports_degraded():
  svc = RenderService(
      engine=_DeadEngine(device="cpu"), max_wait_ms=0.0,
      resilience=ResilienceConfig(max_retries=0, breaker_threshold=1,
                                  breaker_reset_s=60.0, watchdog_s=None))
  try:
    svc.add_synthetic_scenes(1, height=H, width=W, planes=P)
    with pytest.raises(TransientDeviceError):
      svc.render("scene_000", np.eye(4, dtype=np.float32), timeout=30)
    with pytest.raises(CircuitOpenError):
      svc.render("scene_000", np.eye(4, dtype=np.float32), timeout=30)
    health = svc.healthz()
    assert health["status"] == "degraded"
    assert health["breaker"]["state"] == "open"
    stats = svc.stats()
    assert stats["errors"]["transient"] == 1
    assert stats["resilience"]["breaker_fastfails"] == 1
    assert stats["resilience"]["breaker_opens"] == 1
  finally:
    svc.close()


class _GatedEngine(RenderEngine):
  """A CPU engine whose submits wait for the test to open a gate."""

  def __init__(self):
    super().__init__(device="cpu")
    self.entered = threading.Event()
    self.gate = threading.Event()

  def submit(self, scene, poses):
    self.entered.set()
    assert self.gate.wait(30)
    return super().submit(scene, poses)


def test_scheduler_sheds_past_max_queue():
  engine = _GatedEngine()
  scene = bake_scene("s", *synthetic_scene("s", H, W, P), device="cpu")
  batcher = MicroBatcher(engine, lambda sid: scene, max_batch=1,
                         max_wait_ms=0.0, max_queue=1, max_inflight=1).start()
  try:
    pose = np.eye(4, dtype=np.float32)
    first = batcher.submit("s", pose)
    assert engine.entered.wait(30)      # the one flight holds the device
    second = batcher.submit("s", pose)  # queued behind it
    with pytest.raises(QueueFullError):
      batcher.submit("s", pose)
    assert batcher.rejected == 1
    engine.gate.set()
    a, b = first.result(30), second.result(30)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (H, W, 3)
  finally:
    engine.gate.set()
    batcher.stop()


def test_traced_render_records_the_span_tree():
  tracer = Tracer()
  svc = RenderService(device="cpu", tracer=tracer, max_wait_ms=0.0)
  try:
    svc.add_synthetic_scenes(1, height=H, width=W, planes=P)
    tr = tracer.start_trace("render", scene_id="scene_000")
    svc.render("scene_000", np.eye(4, dtype=np.float32), trace=tr)
    (record,) = tracer.find(tr.trace_id)
    names = {span["name"] for span in record["spans"]}
    assert {"queue_wait", "dispatch", "attempt", "bake", "h2d", "compute",
            "readback"} <= names
    assert record.get("error") is None
  finally:
    svc.close()


@pytest.mark.parametrize("prev,cur,window,cap", [
    (None, 0.0, 2, 16), (None, 0.01, 2, 16), (0.01, 0.005, 3, 16),
    (0.01, 0.0099, 3, 16), (0.01, 0.001, 16, 16)])
def test_adaptive_window_policy_matches_jax(prev, cur, window, cap):
  assert (MicroBatcher._next_window(prev, cur, window, cap, 0.05)
          == JMicroBatcher._next_window(prev, cur, window, cap, 0.05))


def test_service_auto_inflight_serves_and_reports():
  svc = RenderService(device="cpu", max_inflight="auto", max_inflight_cap=4,
                      max_wait_ms=0.0)
  try:
    svc.add_synthetic_scenes(1, height=H, width=W, planes=P)
    futs = [svc.render_async("scene_000", np.eye(4, dtype=np.float32))
            for _ in range(3)]
    frames = [f.result(30) for f in futs]
    assert all(np.array_equal(frames[0], f) for f in frames)
    pipeline = svc.stats()["pipeline"]
    assert pipeline["max_inflight"] >= 2
    assert pipeline["adaptive"] == {"settled": False, "cap": 4, "epochs": 0}
  finally:
    svc.close()
