"""The port's flight recorder against the JAX package's.

``obs/tsdb.py``, ``obs/ship.py``, ``obs/attrib.py`` and ``obs/incident.py``
are copies of the JAX modules. Each is driven through the same scripted
fake-clock event sequence in both packages and must give the same
observable result: the tsdb ring's queries, compaction and stats; the
shipper's batches through a fake transport across a sink outage (retries,
the disk spool, the in-order drain, nothing lost); the attribution
ledger's cells, conservation and families; the incident recorder's
bundles, dedup latch, ring pruning and lifecycle tap. The service cases
pin the port's wiring on the CPU: ``/debug/tsdb``, ``/debug/attrib`` and
``/debug/incidents`` answer as the JAX service's routes do, 503 included
when the piece is off; an SLO alert edge captures one bundle that ships
through the spool; attribution cells sum to ``attrib_reference``; an
incident's profile capture and a concurrent ``/debug/profile`` never both
run (409). No real sleeps; every thread is closed by its fixture.
"""

import contextlib
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from mpi_vision_tpu.obs import attrib as jattrib
from mpi_vision_tpu.obs import incident as jincident
from mpi_vision_tpu.obs import prom as jprom
from mpi_vision_tpu.obs import ship as jship
from mpi_vision_tpu.obs import slo as jslo
from mpi_vision_tpu.obs import tsdb as jtsdb
from mpi_vision_tpu.serve import RenderService as JRenderService
from mpi_vision_tpu.serve import make_http_server as jmake_http_server
from mpi_vision_tpu.serve.resilience import RetryPolicy as JRetryPolicy
from mpi_vision_tpu_torch.obs import attrib as tattrib
from mpi_vision_tpu_torch.obs import incident as tincident
from mpi_vision_tpu_torch.obs import prom as tprom
from mpi_vision_tpu_torch.obs import ship as tship
from mpi_vision_tpu_torch.obs import slo as tslo
from mpi_vision_tpu_torch.obs import tsdb as ttsdb
from mpi_vision_tpu_torch.obs.profile import DeviceProfiler
from mpi_vision_tpu_torch.serve import RenderService, make_http_server
from mpi_vision_tpu_torch.serve.resilience import RetryPolicy

H = W = 16
P = 4
PORT_MODS = {"tsdb": ttsdb, "ship": tship, "attrib": tattrib,
             "incident": tincident, "prom": tprom, "slo": tslo,
             "retry": RetryPolicy}
JAX_MODS = {"tsdb": jtsdb, "ship": jship, "attrib": jattrib,
            "incident": jincident, "prom": jprom, "slo": jslo,
            "retry": JRetryPolicy}


class FakeClock:

  def __init__(self, t=1000.0):
    self.t = t

  def __call__(self):
    return self.t

  def advance(self, dt):
    self.t += dt
    return self.t


def _exposition(prom_mod, step: int) -> str:
  reg = prom_mod.Registry()
  reg.counter("mpi_serve_requests_total", "Requests.", 10 * step)
  g = reg.gauge("mpi_serve_queue_depth", "Queue.")
  g.sample(step % 3, {"scene": "a"})
  g.sample(step % 5, {"scene": "b"})
  reg.gauge("mpi_serve_cache_bytes", "Bytes.", 1000 + step)
  return reg.render()


def _tsdb_run(mods):
  clock = FakeClock()
  step = [0]
  rec = mods["tsdb"].TsdbRecorder(
      lambda: _exposition(mods["prom"], step[0]),
      mods["tsdb"].TsdbConfig(interval_s=1.0, max_points=12, max_series=3,
                              compact_after_s=4.0, compact_stride=2),
      clock=clock)
  touched = []
  for i in range(14):
    step[0] = i
    clock.advance(1.0)
    touched.append(rec.sample())
  fams = rec.families()
  return {
      "touched": touched, "families": fams,
      "query": {f: rec.query(f) for f in fams},
      "recent": rec.query("mpi_serve_queue_depth", recent_s=3.0, points=2),
      "since": rec.snapshot_since(1010.0),
      "stats": rec.stats(),
      "text": mods["tsdb"].registry(rec.stats()).render(),
      "empty_text": mods["tsdb"].registry(None).render(),
      "parse": mods["tsdb"].parse_query({"family": ["x"], "recent": ["2"],
                                         "points": ["3"]}),
  }


def test_tsdb_ring_equals_jax():
  got, want = _tsdb_run(PORT_MODS), _tsdb_run(JAX_MODS)
  assert got == want
  assert got["stats"]["dropped_series"] > 0      # max_series bounded it
  assert got["stats"]["compacted_points"] > 0    # compaction thinned it
  with pytest.raises(ValueError):
    ttsdb.parse_query({"recent": ["soon"]})


class FakeTransport:

  def __init__(self):
    self.down = False
    self.bodies = []

  def post(self, url, body, timeout):
    if self.down:
      raise OSError("sink down")
    self.bodies.append(json.loads(body))
    return 200


def _ship_run(mods, tmp_path):
  clock = FakeClock()
  transport = FakeTransport()
  rec = mods["tsdb"].TsdbRecorder(lambda: _exposition(mods["prom"], 1),
                                  mods["tsdb"].TsdbConfig(interval_s=1.0),
                                  clock=clock)
  shipper = mods["ship"].TelemetryShipper(
      mods["ship"].ShipConfig(
          url="http://sink/ingest", spool_dir=str(tmp_path / "spool"),
          retry=mods["retry"](max_retries=1, backoff_base_s=0.01)),
      tsdb=rec, transport=transport, clock=clock, sleep=lambda s: None)
  trail = []
  shipper.note_alert({"kind": "slo_alert", "slo": "latency_p99",
                      "firing": True})
  clock.advance(1.0)
  rec.sample()
  shipper.tick()
  transport.down = True
  for i in range(3):  # three batches spool during the outage
    shipper.note_alert({"kind": "slo_alert", "slo": f"s{i}",
                        "firing": i % 2 == 0})
    if i == 1:
      shipper.note_incident({"kind": "mpi_incident", "id": "incident-1"})
    clock.advance(1.0)
    rec.sample()
    shipper.tick()
    trail.append(dict(shipper.stats()))
  transport.down = False
  clock.advance(1.0)
  shipper.note_alert({"kind": "slo_alert", "slo": "after", "firing": False})
  shipper.tick()  # drains the spool oldest-first, then ships the new one
  stats = shipper.stats()
  for entry in [stats] + trail:
    entry.pop("spool_dir", None)
  return {"bodies": transport.bodies, "trail": trail, "stats": stats,
          "text": mods["ship"].registry(stats).render()}


def test_shipper_outage_spool_and_drain_equal_jax(tmp_path):
  got = _ship_run(PORT_MODS, tmp_path / "port")
  want = _ship_run(JAX_MODS, tmp_path / "jax")
  assert got == want
  stats = got["stats"]
  assert stats["spooled"] == 3 and stats["spool_files"] == 0
  assert stats["post_failures"] >= 6 and stats["retries"] >= 3
  # Every alert edge arrived once, in the order it was noted.
  slos = [edge["slo"] for body in got["bodies"] for item in body["items"]
          if item["kind"] == "slo_alert_edges" for edge in item["edges"]]
  assert slos == ["latency_p99", "s0", "s1", "s2", "after"]
  kinds = [item["kind"] for body in got["bodies"] for item in body["items"]]
  assert "incidents" in kinds and "tsdb" in kinds


def test_ship_sink_accepts_and_counts(tmp_path):
  for mod in (tship, jship):
    server, sink = mod.make_sink_server(str(tmp_path / mod.__name__),
                                        port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
      url = f"http://127.0.0.1:{server.server_address[1]}/ingest"
      status = mod.HttpPostTransport().post(url, b'{"kind": "x"}', 5.0)
      assert status == 200
      with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(urllib.request.Request(
            url, data=b"not json", method="POST"), timeout=5)
      stats = sink.stats()
      assert stats["received"] == 1 and stats["rejected"] == 1
    finally:
      server.shutdown()
      server.server_close()
      thread.join(10)


def _attrib_run(mods):
  rng = np.random.default_rng(11)
  ledger = mods["attrib"].AttribLedger(mods["attrib"].AttribConfig(
      scene_cap=3))
  ref = {"requests": 0, "device_phase_seconds": {
      "h2d": 0.0, "compute": 0.0, "readback": 0.0}}
  for i in range(60):
    scene = f"scene_{int(rng.integers(0, 5))}"
    cls = [None, "interactive", "prefetch", "background"][i % 4]
    level = int(rng.integers(0, 3))
    device = {p: float(rng.uniform(0, 0.01))
              for p in ("h2d", "compute", "readback")}
    edge = [None, "hit", "warp"][i % 3]
    ledger.record(scene, cls, level, device=None if edge else device,
                  queue_wait_s=float(rng.uniform(0, 0.05)), edge=edge)
    ref["requests"] += 1
    if not edge:
      for p, v in device.items():
        ref["device_phase_seconds"][p] += v
    ledger.record_bytes(scene, cls, level, nbytes=int(rng.integers(1, 1000)))
    if i % 5 == 0:
      ledger.record_tiles(scene, cls, level, tiles=int(rng.integers(1, 9)))
  snap = ledger.snapshot(top=4, reference=ref)
  return {"snap": snap, "full": ledger.snapshot(),
          "top": ledger.top_cells(3),
          "text": mods["attrib"].registry(ledger.snapshot()).render(),
          "merged": mods["attrib"].merge_snapshots(
              [ledger.snapshot(), ledger.snapshot()])}


def test_attribution_ledger_equals_jax():
  got, want = _attrib_run(PORT_MODS), _attrib_run(JAX_MODS)
  assert got == want
  assert got["snap"]["conservation"]["ok"]
  scenes = {cell["scene"] for cell in got["full"]["cells"]}
  assert "_other" in scenes and len(scenes) <= 4


def _incident_run(mods, tmp_path):
  clock = FakeClock()
  shipped = []
  rec = mods["incident"].IncidentRecorder(
      mods["incident"].IncidentConfig(dir=str(tmp_path), keep=2),
      collect=lambda job: {"slo": {"burn": 12.5}, "seen": job["alert"]},
      on_bundle=shipped.append, clock=clock, wall=clock)
  rec.note_alert("latency_p99", True, {"burn_rate": 12.5})
  rec.note_alert("latency_p99", True)          # deduplicated
  clock.advance(2.0)
  n1 = rec.drain()
  rec.note_alert("latency_p99", False)
  rec.note_alert("latency_p99", True, {"burn_rate": 20.0})
  rec.note_alert("availability", True)
  n2 = rec.drain()                             # prunes to keep=2
  tap = mods["incident"].LifecycleIncidentTap(rec)
  for line in ('{"kind": "backend_quarantined", "backend": "b1"}',
               '{"kind": "autoscale_up", "seq": 7}', "not json"):
    tap(line)
  n3 = rec.drain()
  listing = rec.list()
  bundles = [rec.get(entry["id"]) for entry in listing]
  stats = rec.stats()
  stats.pop("dir")
  with pytest.raises(KeyError):
    rec.get("incident-999999")
  return {"counts": (n1, n2, n3), "list": listing, "bundles": bundles,
          "shipped": [b["id"] for b in shipped], "stats": stats,
          "tap": (tap.taps, tap.errors),
          "text": mods["incident"].registry(rec.stats()).render()}


def test_incident_recorder_equals_jax(tmp_path):
  got = _incident_run(PORT_MODS, tmp_path / "port")
  want = _incident_run(JAX_MODS, tmp_path / "jax")
  assert got == want
  assert got["counts"] == (1, 2, 2)
  assert got["stats"]["suppressed"] == 1 and got["stats"]["pruned"] == 3
  assert [b["alert"]["alert"] for b in got["bundles"]] == [
      "autoscale_up:7", "quarantine:b1"]
  with pytest.raises(ValueError):
    tincident.IncidentConfig(dir=str(tmp_path), keep=0)


# --- the service wiring -----------------------------------------------------


def _pose(i):
  pose = np.eye(4, dtype=np.float32)
  pose[0, 3] = 0.01 * i
  return pose


def _get(base, path):
  try:
    with urllib.request.urlopen(base + path, timeout=30) as resp:
      return resp.status, json.loads(resp.read())
  except urllib.error.HTTPError as e:
    return e.code, json.loads(e.read())


@contextlib.contextmanager
def _serving(svc, make_server):
  httpd = make_server(svc, port=0)
  thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  thread.start()
  try:
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
  finally:
    httpd.shutdown()
    httpd.server_close()
    thread.join(10)
    svc.close()


def _recorder_service(mods, cls, kw, tmp_path, **extra):
  """A service with every recorder piece adopted un-started on a fake
  clock: tests drive ``sample()``, ``drain()`` and ``tick()``."""
  clock = FakeClock()
  holder = []
  tsdb = mods["tsdb"].TsdbRecorder(lambda: holder[0]._render_metrics_text(),
                                   mods["tsdb"].TsdbConfig(interval_s=1.0),
                                   clock=clock)
  transport = FakeTransport()
  shipper = mods["ship"].TelemetryShipper(
      mods["ship"].ShipConfig(url="http://sink/ingest",
                              spool_dir=str(tmp_path / "spool")),
      transport=transport, clock=clock, sleep=lambda s: None)
  incidents = mods["incident"].IncidentRecorder(
      mods["incident"].IncidentConfig(dir=str(tmp_path / "incidents"),
                                      **extra.pop("incident_kw", {})),
      clock=clock, wall=clock)
  slo = mods["slo"].SloTracker(mods["slo"].SloConfig(
      latency_threshold_s=1e-6, quantile=0.99, min_requests=3,
      fast_window_s=10.0, slow_window_s=40.0, bucket_s=1.0), clock=clock)
  svc = cls(max_batch=2, max_wait_ms=1.0, slo=slo, tsdb=tsdb, ship=shipper,
            attrib=mods["attrib"].AttribConfig(), incidents=incidents,
            metrics_ttl_s=0.0, **kw, **extra)
  holder.append(svc)
  svc.add_synthetic_scenes(2, height=H, width=W, planes=P, seed=3)
  return svc, clock, transport


def _drive(svc, clock, base):
  for i in range(4):
    svc.render_request(f"scene_00{i % 2}", _pose(i))
    clock.advance(0.5)
  svc.tsdb.sample()
  svc.slo.check()
  # Fire edges land from record() (burn-rate objectives) and from the
  # snapshot a /metrics render takes (the quantile objective).
  fired = sorted(svc.slo.alerts_firing())
  svc.incidents.drain()
  svc.shipper.tick()
  out = {"fired": fired}
  for path in ("/debug/tsdb", "/debug/tsdb?family=mpi_serve_requests_total",
               "/debug/tsdb?recent=x", "/debug/attrib?top=2",
               "/debug/attrib?top=x", "/debug/incidents",
               "/debug/incidents?id=incident-000001",
               "/debug/incidents?id=incident-000009"):
    out[path] = _get(base, path)
  return out


def test_recorder_routes_answer_as_the_jax_service(tmp_path):
  results = {}
  for name, mods, cls, make_server, kw in (
      ("port", PORT_MODS, RenderService, make_http_server,
       {"device": "cpu"}),
      ("jax", JAX_MODS, JRenderService, jmake_http_server,
       {"use_mesh": False})):
    svc, clock, transport = _recorder_service(mods, cls, kw,
                                              tmp_path / name)
    with _serving(svc, make_server) as base:
      results[name] = (_drive(svc, clock, base), transport.bodies,
                       svc.stats())
  (got, got_bodies, stats), (want, want_bodies, _) = \
      results["port"], results["jax"]
  assert got["fired"] == want["fired"] and got["fired"]
  for path, (status, body) in got.items():
    if path == "fired":
      continue
    assert status == want[path][0], path
    assert set(body) == set(want[path][1]), path
  assert got["/debug/tsdb?recent=x"][0] == 400
  assert got["/debug/attrib?top=x"][0] == 400
  assert got["/debug/incidents?id=incident-000009"][0] == 404
  # The attribution cells' device seconds sum to the metrics' unrounded
  # phase totals (the ledger's conservation), requests too.
  attrib = got["/debug/attrib?top=2"][1]
  assert attrib["conservation"]["ok"]
  assert attrib["conservation"]["request_delta"] == 0
  ref = attrib["conservation"]["reference_device_s"]
  assert attrib["conservation"]["ledger_device_s"] == pytest.approx(
      ref, abs=1e-6)
  # One bundle per fire edge, shipped through the spool.
  index = got["/debug/incidents"][1]
  assert len(index["incidents"]) == len(got["fired"])
  bundle = got["/debug/incidents?id=incident-000001"][1]
  for key in ("slo", "tsdb_window", "events", "attrib_top"):
    assert key in bundle, key
  kinds = [item["kind"] for body in got_bodies for item in body["items"]]
  assert kinds == [item["kind"] for body in want_bodies
                   for item in body["items"]]
  assert "incidents" in kinds and "slo_alert_edges" in kinds
  for block in ("tsdb", "ship", "attrib", "incidents"):
    assert block in stats, block


def test_recorder_routes_503_when_off():
  for cls, make_server, kw in (
      (RenderService, make_http_server, {"device": "cpu"}),
      (JRenderService, jmake_http_server, {"use_mesh": False})):
    svc = cls(max_batch=2, max_wait_ms=1.0, **kw)
    with _serving(svc, make_server) as base:
      for path in ("/debug/tsdb", "/debug/attrib", "/debug/incidents"):
        status, body = _get(base, path)
        assert status == 503 and "error" in body, (cls, path)
      with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
        assert resp.status == 200
      stats = _get(base, "/stats")[1]
      for block in ("tsdb", "ship", "attrib", "incidents", "alert_hook"):
        assert block not in stats


def test_incidents_require_slo_tracking(tmp_path):
  with pytest.raises(ValueError, match="SLO"):
    RenderService(device="cpu", slo=None,
                  incidents=tincident.IncidentConfig(dir=str(tmp_path)))


def test_incident_profile_and_debug_profile_never_both_run(tmp_path):
  """An incident's profile capture holds the service's DeviceProfiler: a
  concurrent ``GET /debug/profile`` gets 409; a capture already in flight
  leaves the bundle a ProfileBusyError instead of a profile."""
  seen = {}
  base_box = []

  def sleep(seconds):
    # Inside the incident's capture window: the HTTP endpoint is busy.
    try:
      urllib.request.urlopen(base_box[0] + "/debug/profile?seconds=0.1",
                             timeout=30)
    except urllib.error.HTTPError as e:
      seen["status"] = e.code
      seen["retry_after"] = e.headers.get("Retry-After")

  profiler = DeviceProfiler(str(tmp_path / "prof"),
                            trace_ctx=lambda d: contextlib.nullcontext(),
                            sleep=sleep)
  svc, clock, _ = _recorder_service(
      PORT_MODS, RenderService, {"device": "cpu", "profiler": profiler},
      tmp_path, incident_kw={"profile_seconds": 0.5})
  with _serving(svc, make_http_server) as base:
    base_box.append(base)
    for i in range(4):
      svc.render_request("scene_000", _pose(i))
      clock.advance(0.5)
    svc.slo.check()
    assert svc.slo.alerts_firing()
    captured = svc.incidents.drain()
    assert captured == len(svc.slo.alerts_firing())
    assert seen == {"status": 409, "retry_after": "1"}
    for n, entry in enumerate(reversed(svc.incidents.list()), 1):
      assert svc.incidents.get(entry["id"])["profile"]["capture"] == n
    # A capture in flight (held lock) when the next fire edge lands.
    with profiler._lock:
      svc.incidents.note_alert("manual", True, {"burn_rate": 9.0})
      svc.incidents.drain()
    newest = svc.incidents.get(svc.incidents.list()[0]["id"])
    assert newest["alert"]["alert"] == "manual"
    assert "ProfileBusyError" in newest["profile"]["error"]
