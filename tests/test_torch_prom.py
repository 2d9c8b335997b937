"""The port's Prometheus exposition against the JAX package's.

``obs/prom.py`` and ``obs/hist.py``'s exposition helpers are copies of the
JAX modules: the same ``stats`` dict through both ``serve_registry``s gives
the same text, letter for letter; the parser, the exemplar stripper, the
pool aggregator and the TTL cache (fake clock) agree; ``SloTracker``'s
``mpi_slo_*`` families are JAX's on one scripted trace. The port's
``RenderService`` on the CPU exposes at ``/metrics`` exactly the JAX
service's ``mpi_*`` family set for the same traffic, and its render
counters equal ``/stats``.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

from mpi_vision_tpu.obs import attrib as jattrib
from mpi_vision_tpu.obs import hist as jhist
from mpi_vision_tpu.obs import prom as jprom
from mpi_vision_tpu.obs import slo as jslo
from mpi_vision_tpu.obs.trace import Tracer as JTracer
from mpi_vision_tpu.serve import RenderService as JRenderService
from mpi_vision_tpu_torch.obs import attrib as tattrib
from mpi_vision_tpu_torch.obs import hist as thist
from mpi_vision_tpu_torch.obs import prom as tprom
from mpi_vision_tpu_torch.obs import slo as tslo
from mpi_vision_tpu_torch.obs.trace import Tracer
from mpi_vision_tpu_torch.serve import RenderService, make_http_server
from mpi_vision_tpu_torch.serve.metrics import (
    LATENCY_BUCKETS_S,
    ServeMetrics,
)

H = W = 16
P = 4


class _Clock:

  def __init__(self, t=100.0):
    self.t = t

  def __call__(self):
    return self.t


def _pose(i):
  pose = np.eye(4, dtype=np.float32)
  pose[0, 3] = 0.01 * i
  return pose


def _families(text: str) -> set:
  return {line.split()[2] for line in text.splitlines()
          if line.startswith("# TYPE ")}


@pytest.fixture(scope="module")
def served():
  """One port service and one JAX service after the same traffic (SLO with
  a quantile objective, attribution and tracing on): their stats and
  expositions."""
  out = {}
  for name, cls, kw, slo_mod, attrib_mod, tracer in (
      ("port", RenderService, {"device": "cpu"}, tslo, tattrib, Tracer()),
      ("jax", JRenderService, {"use_mesh": False}, jslo, jattrib,
       JTracer())):
    svc = cls(max_batch=2, max_wait_ms=1.0,
              slo=slo_mod.SloConfig(quantile=0.99),
              attrib=attrib_mod.AttribConfig(), tracer=tracer, **kw)
    try:
      svc.add_synthetic_scenes(2, height=H, width=W, planes=P, seed=1)
      for i in range(4):
        trace = svc.tracer.start_trace("render", scene_id=f"scene_00{i % 2}")
        svc.render_request(f"scene_00{i % 2}", _pose(i), trace=trace,
                           request_class="background" if i == 3 else None)
      out[name] = {"stats": svc.stats(), "text": svc.metrics_text(),
                   "hist": svc.metrics.latency_histogram()}
      if name == "port":
        httpd = make_http_server(svc, port=0)
        port = httpd.server_address[1]
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
          base = f"http://127.0.0.1:{port}"
          with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            out["http"] = (r.status, r.headers["Content-Type"],
                           r.read().decode())
          with urllib.request.urlopen(base + "/metrics?exemplars=1",
                                      timeout=30) as r:
            out["http_exemplars"] = r.read().decode()
          with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            out["http_stats"] = json.loads(r.read())
        finally:
          httpd.shutdown()
          httpd.server_close()
          thread.join(10)
    finally:
      svc.close()
  return out


def test_same_stats_dict_renders_identical_text(served):
  for name in ("port", "jax"):
    stats, hist = served[name]["stats"], served[name]["hist"]
    assert tprom.render_serve_metrics(stats, hist) == \
        jprom.render_serve_metrics(stats, hist), name
    assert tprom.render_serve_metrics(stats) == \
        jprom.render_serve_metrics(stats)


def test_service_metrics_family_set_equals_jax(served):
  port, jax = _families(served["port"]["text"]), \
      _families(served["jax"]["text"])
  assert port == jax
  assert all(f.startswith("mpi_") for f in port)
  for fam in ("mpi_serve_requests_total", "mpi_serve_request_latency_seconds",
              "mpi_serve_request_latency_nativehist", "mpi_slo_quantile",
              "mpi_obs_tsdb_samples_total", "mpi_serve_attrib_requests_total",
              "mpi_serve_breaker_state"):
    assert fam in port, fam


def test_metrics_render_counters_equal_stats(served):
  status, ctype, text = served["http"]
  assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
  samples = tprom.parse_metrics_text(text)
  stats = served["http_stats"]

  def value(family, sample=None, labels=()):
    return samples[family]["samples"][(sample or family, labels)]

  assert value("mpi_serve_requests_total") == stats["requests"] == 4
  assert value("mpi_serve_batches_total") == stats["batches"]
  for phase, secs in stats["device_phase_seconds"].items():
    assert value("mpi_serve_device_phase_seconds_total",
                 labels=(("phase", phase),)) == pytest.approx(secs,
                                                              abs=1e-3)
  count = value("mpi_serve_request_latency_seconds",
                "mpi_serve_request_latency_seconds_count")
  assert count == stats["requests"]
  # Exemplars only on request; the stripped text parses the same.
  assert " # {" not in text and " # {" in served["http_exemplars"]
  assert tprom.strip_exemplars(served["http_exemplars"]) == text
  assert jprom.parse_metrics_text(text) == samples


def test_parse_round_trip_and_aggregate_equal_jax(served):
  text = served["port"]["text"]
  parsed = tprom.parse_metrics_text(text)
  assert parsed == jprom.parse_metrics_text(text)
  texts = [text, served["jax"]["text"]]
  drop = tslo.NON_ADDITIVE_FAMILIES | thist.NON_ADDITIVE_FAMILIES
  collect_t, collect_j = {}, {}
  got = tprom.aggregate_metrics_texts(texts, drop=drop, collect=collect_t)
  want = jprom.aggregate_metrics_texts(
      texts, drop=jslo.NON_ADDITIVE_FAMILIES | jhist.NON_ADDITIVE_FAMILIES,
      collect=collect_j)
  assert got == want and collect_t == collect_j
  summed = tprom.parse_metrics_text(got)
  assert summed["mpi_serve_requests_total"]["samples"][
      ("mpi_serve_requests_total", ())] == 8
  assert "mpi_slo_quantile" not in summed


def test_latency_histogram_equals_jax_metrics():
  from mpi_vision_tpu.serve.metrics import ServeMetrics as JServeMetrics

  assert LATENCY_BUCKETS_S == \
      __import__("mpi_vision_tpu.serve.metrics",
                 fromlist=["x"]).LATENCY_BUCKETS_S
  rng = np.random.default_rng(4)
  ours, theirs = ServeMetrics(clock=_Clock()), JServeMetrics(clock=_Clock())
  for lat in rng.lognormal(-4, 2, 200):
    for m in (ours, theirs):
      m.record_request(float(lat), scene_id=f"s{int(lat * 100) % 3}",
                       trace_id="t")
  assert ours.latency_histogram() == theirs.latency_histogram()
  assert ours.attrib_reference() == theirs.attrib_reference()


def test_hist_exposition_helpers_equal_jax():
  rng = np.random.default_rng(5)
  snaps = []
  for mod in (thist, jhist):
    h = mod.NativeHistogram()
    for i, v in enumerate(rng.lognormal(-3, 1.5, 64)):
      h.record(float(v), exemplar=f"trace{i:02d}")
    h.record(0.0)
    snaps.append(h.snapshot())
    rng = np.random.default_rng(5)
  assert snaps[0] == snaps[1]
  assert [thist.q_label(q) for q in thist.QUANTILES] == \
      [jhist.q_label(q) for q in jhist.QUANTILES] == ["0.5", "0.9", "0.99"]
  texts = []
  for prom_mod, hist_mod in ((tprom, thist), (jprom, jhist)):
    reg = prom_mod.Registry()
    hist_mod.add_family(reg, "mpi_serve_phase_latency_nativehist", "help",
                        [({"phase": "compute"}, snaps[0]),
                         ({"phase": "h2d"}, None)])
    texts.append(reg.render())
  assert texts[0] == texts[1]
  samples = tprom.parse_metrics_text(texts[0])[
      "mpi_serve_phase_latency_nativehist"]["samples"]
  back = thist.snapshots_from_samples(samples)
  assert back == jhist.snapshots_from_samples(samples)
  got = back[(("phase", "compute"),)]
  assert got["count"] == snaps[0]["count"] == 65
  assert got["buckets"] == snaps[0]["buckets"]
  assert got["zero"] == 1


def test_exposition_cache_ttl_on_a_fake_clock():
  for mod in (tprom, jprom):
    clock, renders = _Clock(), []
    cache = mod.ExpositionCache(lambda: f"v{len(renders)}"
                                if not renders.append(1) else "",
                                ttl_s=0.25, clock=clock)
    assert cache.get() == "v1"
    clock.t += 0.1
    assert cache.get() == "v1" and cache.cache_hits == 1
    clock.t += 0.2
    assert cache.get() == "v2" and cache.renders == 2
    cache.invalidate()
    assert cache.get() == "v3"


def test_slo_registry_equals_jax():
  texts = []
  for mod in (tslo, jslo):
    clock = _Clock(1000.0)
    tracker = mod.SloTracker(mod.SloConfig(
        fast_window_s=10.0, slow_window_s=40.0, bucket_s=1.0,
        burn_threshold=4.0, min_requests=3, latency_threshold_s=0.05,
        quantile=0.9, per_scene=True), clock=clock)
    rng = np.random.default_rng(7)
    for step in range(60):
      clock.t += 0.5
      if 20 <= step < 30:
        tracker.record_bad()
      else:
        tracker.record(ok=True, latency_s=float(rng.uniform(0.01, 0.2)),
                       scene_id=f"scene_{step % 2}", trace_id=f"t{step}")
      tracker.check()
    texts.append(tracker.metrics_text())
  assert texts[0] == texts[1]
  assert "mpi_slo_quantile_latency_seconds" in texts[0]
  assert "mpi_slo_scene_alerts_firing" in texts[0]
