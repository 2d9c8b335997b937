"""The port's SLO engine against the JAX package's.

``obs/slo.py`` is a copy of the JAX module (less its Prometheus
rendering, which waits for the port's ``/metrics``), over the native
histograms of ``obs/hist.py``. On a scripted fake-clock trace of good and
bad requests and latencies, the port's ``SloTracker`` gives JAX's
``snapshot()``, ``check()`` edges, alert callbacks, ``fast_burn()`` and
``verdict()``, exactly (a copy is held to equality). The service cases
pin the wiring: ``ServeMetrics`` feeds the tracker, ``/stats`` carries
the ``slo`` block, a firing alert reads ``degraded`` in ``/healthz`` and
lands in the event log.
"""

import numpy as np
import pytest

from mpi_vision_tpu.obs import hist as jhist
from mpi_vision_tpu.obs import slo as jslo
from mpi_vision_tpu_torch.obs import hist as thist
from mpi_vision_tpu_torch.obs import slo as tslo
from mpi_vision_tpu_torch.serve import RenderService

H = W = 16
P = 4


class _Clock:

  def __init__(self, t=1000.0):
    self.t = t

  def __call__(self):
    return self.t


CONFIGS = [
    dict(fast_window_s=10.0, slow_window_s=60.0, bucket_s=1.0,
         burn_threshold=10.0, min_requests=5),
    dict(fast_window_s=10.0, slow_window_s=40.0, bucket_s=1.0,
         burn_threshold=4.0, min_requests=3, latency_threshold_s=0.05,
         quantile=0.9, per_scene=True),
]


def _drive(mod, cfg, seed):
  """One scripted trace through ``mod``'s tracker; returns everything
  observable along the way."""
  clock = _Clock()
  edges = []
  tracker = mod.SloTracker(mod.SloConfig(**cfg), clock=clock,
                           on_alert=lambda n, f, d: edges.append((n, f, d)))
  rng = np.random.default_rng(seed)
  seen = []
  for step in range(160):
    clock.t += float(rng.choice([0.05, 0.3, 1.1]))
    phase = (step // 40) % 4          # healthy, outage, slow, recovered
    scene = f"scene_{step % 3}"
    if phase == 1 and rng.random() < 0.6:
      tracker.record_bad(int(rng.integers(1, 3)))
    else:
      lat = float(rng.lognormal(-4.0 if phase != 2 else -1.5, 0.5))
      tracker.record(ok=True, latency_s=lat, scene_id=scene,
                     trace_id=f"t{step}")
    if step % 9 == 0:
      seen.append(("check", tracker.check()))
    if step % 13 == 0:
      seen.append(("burn", tracker.fast_burn()))
      seen.append(("snap", tracker.snapshot()))
  snap = tracker.snapshot()
  seen.append(("firing", tracker.alerts_firing()))
  seen.append(("verdict", mod.verdict(snap)))
  tracker.reset()
  seen.append(("reset", tracker.snapshot()))
  return seen, edges, snap


@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
@pytest.mark.parametrize("seed", [0, 1])
def test_tracker_trace_equals_jax(cfg, seed):
  ours = _drive(tslo, CONFIGS[cfg], seed)
  theirs = _drive(jslo, CONFIGS[cfg], seed)
  assert ours[0] == theirs[0]
  assert ours[1] == theirs[1]
  assert ours[2] == theirs[2]
  fired = [e for e in ours[1] if e[1]]
  cleared = [e for e in ours[1] if not e[1]]
  assert fired and cleared  # the trace fires AND clears an alert


def test_config_validation_equals_jax():
  for bad in (dict(availability_target=1.0), dict(latency_threshold_s=0),
              dict(fast_window_s=10.0, slow_window_s=5.0),
              dict(burn_threshold=0), dict(quantile=1.5),
              dict(per_scene=True)):
    for mod in (tslo, jslo):
      with pytest.raises(ValueError):
        mod.SloConfig(**bad)
  assert tslo.burn_rate(3, 10, 0.99) == jslo.burn_rate(3, 10, 0.99)
  assert tslo.verdict(None) is None


def test_native_histograms_equal_jax(rng):
  """The SLO windows' quantiles come from ``obs/hist.py``: the same
  observations give JAX's snapshots, merges and quantiles."""
  values = rng.lognormal(-3.0, 1.0, 200)
  snaps = {}
  for name, mod in (("torch", thist), ("jax", jhist)):
    halves = []
    for part in (values[:120], values[120:]):
      h = mod.NativeHistogram()
      for i, v in enumerate(part):
        h.record(float(v), exemplar=f"t{i}")
      halves.append(h.snapshot())
    merged = mod.merge(halves)
    snaps[name] = (halves, merged.snapshot(),
                   [merged.quantile(q) for q in (0.5, 0.9, 0.99)],
                   [mod.quantile_of(halves[0], q) for q in (0.5, 0.99)],
                   mod.quantile_of(None, 0.5),
                   [mod.bucket_index(float(v)) for v in values[:20]],
                   [mod.bucket_bounds(i) for i in (-3, 0, 7)])
  assert snaps["torch"] == snaps["jax"]


def _pose():
  return np.eye(4, dtype=np.float32)


def test_service_feeds_the_tracker_and_reports_alerts():
  clock = _Clock()
  tracker = tslo.SloTracker(tslo.SloConfig(**CONFIGS[0]), clock=clock)
  svc = RenderService(device="cpu", max_batch=2, max_wait_ms=1.0,
                      slo=tracker)
  try:
    svc.add_synthetic_scenes(1, height=H, width=W, planes=P)
    for _ in range(6):
      svc.render("scene_000", _pose())
    snap = svc.stats()["slo"]
    assert snap["objectives"]["availability"]["fast"]["requests"] == 6
    assert snap["objectives"]["availability"]["fast"]["bad"] == 0
    assert svc.healthz()["status"] == "ok"
    assert svc.healthz()["slo_alerts_firing"] == []
    for _ in range(8):
      with pytest.raises(KeyError):
        svc.render("nope", _pose())
      svc.metrics.record_error("transient")  # an outage's failures
    health = svc.healthz()
    assert health["status"] == "degraded"
    assert health["slo_alerts_firing"] == ["availability"]
    assert "SLO alert firing: availability burning" in health["reason"]
    alerts = svc.events.snapshot(kind="slo_alert")["events"]
    assert [(e["slo"], e["firing"]) for e in alerts] == [
        ("availability", True)]
    clock.t += 11.0
    for _ in range(5):
      svc.render("scene_000", _pose())
    assert svc.healthz()["status"] == "ok"
    alerts = svc.events.snapshot(kind="slo_alert")["events"]
    assert [e["firing"] for e in alerts] == [True, False]
  finally:
    svc.close()


def test_slo_none_disables_the_block():
  svc = RenderService(device="cpu", slo=None)
  try:
    assert svc.slo is None and "slo" not in svc.stats()
    assert "slo_alerts_firing" not in svc.healthz()
  finally:
    svc.close()
