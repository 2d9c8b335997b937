"""Fault injection and the CPU fallback route of the port's service.

``serve/faultinject.py`` is a copy of the JAX module: a seeded schedule
replays the same fault indices (dispatch and bake) as JAX's
``FaultyEngine``. The fallback cases are ported from
``tests/serve/test_resilience.py:383-430`` (breaker open -> CPU fallback,
``prebake_fallback``) with the port's contract on top: only transient
errors open the breaker, so a kernel that fails to build fails its
request with a 500 and never reaches the fallback; the half-open probe
goes back to the primary engine; ``swap_scenes`` invalidates the fallback
cache and emits ``scene_swap``. The primary here is a CPU engine wrapped
in ``FaultyEngine`` (the card's role), the fallback another CPU engine.
Frames: the fallback's equal the primary's bit for bit (the same plain
version on the same inputs), and the primary's within 1e-4 of the JAX
service's under ``Convention.EXACT`` (``tests/test_torch_serve.py``'s
bound).
"""

import json
import random
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from mpi_vision_tpu.core.sampling import Convention as JConvention
from mpi_vision_tpu.serve import RenderService as JRenderService
from mpi_vision_tpu.serve import faultinject as jfault
from mpi_vision_tpu_torch.core.sampling import Convention
from mpi_vision_tpu_torch.kernels import _build, render_fused
from mpi_vision_tpu_torch.serve import (
    CircuitOpenError,
    Fault,
    FaultyEngine,
    RenderEngine,
    RenderService,
    ResilienceConfig,
    TransientDeviceError,
    classify_error,
    make_http_server,
    synthetic_scene,
)
from mpi_vision_tpu_torch.serve import faultinject as tfault

H, W, P = 16, 24, 4


def _pose(tx=0.0):
  pose = np.eye(4, dtype=np.float32)
  pose[0, 3] = tx
  return pose


class _Inner:
  """A stand-in engine: counts what reaches it."""

  def __init__(self):
    self.calls = 0
    self.devices = ["cpu"]

  def render_batch(self, scene, poses):
    self.calls += 1
    return np.zeros((len(poses), 1, 1, 3), np.float32)


class _CardEngine(FaultyEngine):
  """A CPU engine that reports the card as its platform."""

  platform = "cuda"


def _replay(mod, seed):
  rng = random.Random(seed)
  plan = [rng.random() < 0.3 for _ in range(40)]
  bake_plan = [rng.random() < 0.5 for _ in range(10)]
  eng = mod.FaultyEngine(
      _Inner(), schedule=lambda i: mod.Fault("error") if plan[i] else None,
      bake_schedule=lambda i: (mod.Fault("error", transient=False)
                               if bake_plan[i] else None))
  eng.fail_next(2)
  eng.inject_bake(mod.Fault("error"))
  failed, baked = [], []
  for i in range(40):
    try:
      eng.render_batch(None, np.zeros((1, 4, 4), np.float32))
    except Exception as e:  # noqa: BLE001 - classified below
      failed.append((i, type(e).__name__, classify_error(e)))
  for i in range(10):
    try:
      eng.check_bake(f"s{i}")
    except Exception as e:  # noqa: BLE001
      baked.append((i, type(e).__name__, str(e)))
  return failed, baked, dict(eng.injected), eng.inner.calls


@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_schedule_replays_the_jax_fault_indices(seed):
  ours, theirs = _replay(tfault, seed), _replay(jfault, seed)
  assert ours == theirs
  assert ours[0][:2] == [(0, "TransientDeviceError", "transient"),
                         (1, "TransientDeviceError", "transient")]
  with pytest.raises(ValueError):
    tfault.Fault("melt")


def _service(cpu_fallback="on", scenes=1, engine=None, **resilience):
  cfg = dict(max_retries=2, backoff_base_s=0.01, breaker_threshold=1,
             breaker_reset_s=60.0, watchdog_s=60.0)
  cfg.update(resilience)
  eng = engine if engine is not None else FaultyEngine(
      RenderEngine(method="fused_pallas", convention=Convention.EXACT,
                   device="cpu"))
  svc = RenderService(engine=eng, resilience=ResilienceConfig(**cfg),
                      cpu_fallback=cpu_fallback, max_batch=4,
                      max_wait_ms=1.0)
  svc.add_synthetic_scenes(scenes, height=H, width=W, planes=P)
  return svc, eng


def test_breaker_open_routes_to_cpu_fallback():
  svc, eng = _service()
  jax_svc = JRenderService(max_batch=4, max_wait_ms=1.0, use_mesh=False,
                           convention=JConvention.EXACT)
  try:
    assert svc.fallback_engine is not None
    assert svc.fallback_engine.platform == "cpu"
    assert svc.fallback_engine.method == "fused_pallas"
    assert svc.fallback_engine.convention is Convention.EXACT
    jax_svc.add_synthetic_scenes(1, height=H, width=W, planes=P)
    pose = _pose(0.015)
    baseline = svc.render("scene_000", pose)
    np.testing.assert_allclose(baseline, jax_svc.render("scene_000", pose),
                               atol=1e-4, rtol=0)
    eng.schedule = lambda idx: Fault("error")  # primary hard down
    # threshold=1: the first failure opens the breaker; the retry inside
    # the SAME request degrades to the CPU fallback transparently.
    before = dict(render_fused.plain_render.by_device)
    out = svc.render("scene_000", pose)
    np.testing.assert_array_equal(out, baseline)
    assert svc.metrics.fallback_renders == 1
    assert svc.stats()["resilience"]["fallback_renders"] == 1
    assert (render_fused.plain_render.by_device["cpu"]
            - before["cpu"]) == 1
    health = svc.healthz()
    assert health["status"] == "degraded"
    assert "CPU fallback" in health["reason"]
    assert health["fallback_active"] is True
    # Submissions do NOT fast-fail while a fallback can serve them.
    np.testing.assert_array_equal(svc.render("scene_000", pose), baseline)
    assert svc.metrics.fallback_renders == 2
    kinds = [(e["old"], e["new"])
             for e in svc.events.snapshot(kind="breaker")["events"]]
    assert kinds == [("closed", "open")]
  finally:
    svc.close()
    jax_svc.close()


def test_prebake_fallback_serves_breaker_open_requests_warm():
  svc, eng = _service(scenes=3)
  try:
    warmed = svc.prebake_fallback(2)  # hottest-K = first two registered
    assert warmed == ["scene_000", "scene_001"]
    fb = svc._fallback_cache.stats()
    assert fb["scenes"] == 2 and fb["misses"] == 2
    eng.schedule = lambda idx: Fault("error")  # primary hard down
    out = svc.render("scene_000", _pose(0.01))  # degrades to fallback
    assert out.shape == (H, W, 3)
    assert svc.metrics.fallback_renders >= 1
    fb = svc._fallback_cache.stats()
    assert fb["hits"] >= 1 and fb["misses"] == 2  # WARM: no new bake
    # An un-prebaked scene still works — it just pays the cold bake.
    svc.render("scene_002", _pose(0.01))
    assert svc._fallback_cache.stats()["misses"] == 3
  finally:
    svc.close()


def test_prebake_fallback_without_fallback_engine_is_a_noop():
  svc, _ = _service(cpu_fallback="off")
  try:
    assert svc.fallback_engine is None and svc.prebake_fallback(2) == []
  finally:
    svc.close()


def test_cpu_fallback_modes():
  with pytest.raises(ValueError, match="requires resilience"):
    RenderService(device="cpu", resilience=None, cpu_fallback="on")
  with pytest.raises(ValueError, match="auto/on/off"):
    RenderService(device="cpu", cpu_fallback="maybe")
  # "auto" builds a fallback only when the primary is not the CPU.
  auto = RenderService(device="cpu", cpu_fallback="auto")
  try:
    assert auto.fallback_engine is None
    assert "fallback_active" in auto.healthz()
  finally:
    auto.close()
  # With a primary on the card, only an explicit "on" or "auto" builds
  # one: by default work never moves to the CPU.
  made = {}
  for mode in ("default", "off", "auto", "on"):
    eng = _CardEngine(RenderEngine(method="fused_pallas", device="cpu"))
    kw = {} if mode == "default" else {"cpu_fallback": mode}
    svc = RenderService(engine=eng, **kw)
    try:
      made[mode] = svc.fallback_engine is not None
    finally:
      svc.close()
  assert made == {"default": False, "off": False, "auto": True, "on": True}


def test_without_fallback_an_open_breaker_fast_fails():
  svc, eng = _service(cpu_fallback="off")
  try:
    eng.schedule = lambda idx: Fault("error")
    with pytest.raises(CircuitOpenError):
      svc.render("scene_000", _pose())
    with pytest.raises(CircuitOpenError):
      svc.render("scene_000", _pose())  # fast-fail at the door
    health = svc.healthz()
    assert health["status"] == "degraded"
    assert health["fallback_active"] is False
    assert "503" in health["reason"]
    assert svc.metrics.fallback_renders == 0
  finally:
    svc.close()


def test_half_open_probe_goes_to_the_primary_and_closes():
  svc, eng = _service(breaker_reset_s=0.3)
  try:
    baseline = svc.render("scene_000", _pose(0.02))
    eng.fail_next(1)  # one transient failure opens the breaker
    np.testing.assert_array_equal(svc.render("scene_000", _pose(0.02)),
                                  baseline)
    assert svc.metrics.fallback_renders == 1
    assert svc.healthz()["fallback_active"] is True
    time.sleep(0.4)
    dispatches = eng.dispatches
    np.testing.assert_array_equal(svc.render("scene_000", _pose(0.02)),
                                  baseline)
    assert eng.dispatches == dispatches + 1  # the probe rode the primary
    assert svc.metrics.fallback_renders == 1
    health = svc.healthz()
    assert health["status"] == "ok" and health["fallback_active"] is False
    kinds = [(e["old"], e["new"])
             for e in svc.events.snapshot(kind="breaker")["events"]]
    assert kinds == [("closed", "open"), ("open", "half_open"),
                     ("half_open", "closed")]
  finally:
    svc.close()


class _BuildFails(RenderEngine):
  """A card engine whose kernel does not build."""

  def submit(self, scene, poses):
    raise _build.KernelBuildError("CUDA kernel build failed:\nnvcc exit 1")


class _LaunchFails(RenderEngine):
  def submit(self, scene, poses):
    raise RuntimeError("CUDA kernel build failed")


@pytest.mark.parametrize("engine_cls", [_BuildFails, _LaunchFails])
def test_kernel_failure_fails_the_request_and_never_reaches_the_fallback(
    engine_cls):
  svc, _ = _service(engine=engine_cls(method="fused_pallas", device="cpu"),
                    breaker_threshold=1)
  httpd = make_http_server(svc, port=0)
  threading.Thread(target=httpd.serve_forever, daemon=True).start()
  base = f"http://127.0.0.1:{httpd.server_address[1]}"
  try:
    assert svc.fallback_engine is not None
    before = dict(render_fused.plain_render.by_device)
    body = json.dumps({"scene_id": "scene_000",
                       "pose": _pose().tolist()}).encode()
    for _ in range(3):
      with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(urllib.request.Request(
            base + "/render", data=body), timeout=60)
      assert err.value.code == 500
      assert "CUDA kernel build failed" in json.load(err.value)["error"]
    stats = svc.stats()
    assert stats["resilience"]["fallback_renders"] == 0
    assert stats["errors"]["permanent"] == 3
    assert stats["breaker"]["state"] == "closed"
    assert stats["resilience"]["retries"] == 0
    assert render_fused.plain_render.by_device == before
    assert svc.healthz()["fallback_active"] is False
  finally:
    httpd.shutdown()
    httpd.server_close()
    svc.close()


def test_kernel_build_errors_are_permanent():
  assert classify_error(_build.KernelBuildError("x unavailable")) \
      == "permanent"
  assert classify_error(TransientDeviceError("card gone")) == "transient"


def test_http_healthz_reads_degraded_with_fallback_active():
  svc, eng = _service()
  httpd = make_http_server(svc, port=0)
  threading.Thread(target=httpd.serve_forever, daemon=True).start()
  base = f"http://127.0.0.1:{httpd.server_address[1]}"
  try:
    eng.schedule = lambda idx: Fault("error")
    body = json.dumps({"scene_id": "scene_000",
                       "pose": _pose(0.01).tolist()}).encode()
    with urllib.request.urlopen(urllib.request.Request(
        base + "/render", data=body), timeout=60) as resp:
      assert resp.status == 200
    health = json.loads(urllib.request.urlopen(base + "/healthz",
                                               timeout=30).read())
    assert health["status"] == "degraded"
    assert health["fallback_active"] is True
    stats = json.loads(urllib.request.urlopen(base + "/stats",
                                              timeout=30).read())
    assert stats["resilience"]["fallback_renders"] == 1
    assert stats["fallback"]["engine"]["platform"] == "cpu"
    events = json.loads(urllib.request.urlopen(
        base + "/debug/events?kind=breaker&recent=5", timeout=30).read())
    assert [e["new"] for e in events["events"]] == ["open"]
    with pytest.raises(urllib.error.HTTPError) as err:
      urllib.request.urlopen(base + "/debug/events?recent=x", timeout=30)
    assert err.value.code == 400
  finally:
    httpd.shutdown()
    httpd.server_close()
    svc.close()


def test_hang_is_abandoned_and_a_bake_fault_is_retried():
  svc, eng = _service(cpu_fallback="off", breaker_threshold=5,
                      watchdog_s=0.5)
  try:
    baseline = svc.render("scene_000", _pose(0.01))
    eng.inject(Fault("hang", seconds=30.0))
    np.testing.assert_array_equal(svc.render("scene_000", _pose(0.01)),
                                  baseline)
    assert svc.metrics.watchdog_trips == 1
    assert svc.events.snapshot(kind="watchdog_trip")["events"][0][
        "fallback"] is False
    svc.add_scene("cold", *synthetic_scene("cold", H, W, P))
    eng.fail_next_bake(1)
    assert svc.render("cold", _pose()).shape == (H, W, 3)
    assert eng.injected["bake"] == 1 and svc.metrics.retries >= 2
  finally:
    eng.release.set()
    svc.close()


def test_swap_invalidates_the_fallback_cache_and_emits_scene_swap():
  svc, eng = _service()
  try:
    svc.prebake_fallback()
    eng.schedule = lambda idx: Fault("error")
    old = svc.render("scene_000", _pose(0.01))  # from the fallback
    new_data = synthetic_scene("scene_000", H, W, P, seed=9)
    assert svc.swap_scenes({"scene_000": new_data}) == ["scene_000"]
    assert svc._fallback_cache.get("scene_000") is None
    new = svc.render("scene_000", _pose(0.01))
    assert not np.array_equal(new, old)
    fresh = RenderService(device="cpu", convention=Convention.EXACT)
    try:
      fresh.add_scene("scene_000", *new_data)
      np.testing.assert_array_equal(new, fresh.render("scene_000",
                                                      _pose(0.01)))
    finally:
      fresh.close()
    swaps = svc.events.snapshot(kind="scene_swap")["events"]
    assert [(e["scenes"], e["prebake"]) for e in swaps] == [
        (["scene_000"], False)]
  finally:
    svc.close()
