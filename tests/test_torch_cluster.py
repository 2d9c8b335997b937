"""The port's serve/cluster against the JAX package's: ring placement,
router failover, aggregated observability.

The fake-transport cases of ``tests/serve/test_cluster.py``, run against
the port's copy (``mpi_vision_tpu_torch/serve/cluster/``), cheapest first:

  * ``HashRing`` unit tests — placement determinism, replication,
    minimal movement on resize (re-placement after a pool resize is a
    pure function, not an accident of dict order).
  * ``Router`` tests over an injectable fake transport — per-backend
    breaker isolation, failover order, the 502-never-500 contract for
    malformed/truncated backend bodies, resurrection through the
    half-open probe, aggregated /healthz / /metrics — all deterministic
    (fake clocks, no sockets except the router's own front end).

Then the same scripted inputs through both packages: ring placements of
200 scene ids at several pool sizes and ``vnodes``, the ``RetryBudget``
token arithmetic, the router's try order, statuses and counters under one
fake transport and fake clock, and the ``/stats``, ``/healthz`` and
``/metrics`` shapes. The live cases (real backend processes) are in
``tests/test_torch_cluster_live.py``.
"""

import base64
import json
import threading
import urllib.request

import numpy as np
import pytest

from mpi_vision_tpu.obs import parse_metrics_text as jparse_metrics_text
from mpi_vision_tpu.serve import brownout as jbrownout
from mpi_vision_tpu.serve.cluster import HashRing as JHashRing
from mpi_vision_tpu.serve.cluster import Router as JRouter
from mpi_vision_tpu.serve.resilience import RetryBudget as JRetryBudget
from mpi_vision_tpu_torch.obs import Tracer, parse_metrics_text
from mpi_vision_tpu_torch.serve import brownout
from mpi_vision_tpu_torch.serve.cluster import (
    AllReplicasOpenError,
    HashRing,
    ReplicasExhaustedError,
    Router,
    make_router_http_server,
)
from mpi_vision_tpu_torch.serve.resilience import RetryBudget


# --- ring ----------------------------------------------------------------


SCENES_100 = [f"scene_{i:03d}" for i in range(100)]


def test_ring_placement_deterministic_and_order_free():
  a = HashRing(["x", "y", "z"], replication=2)
  b = HashRing(["z", "x", "y"], replication=2)  # insertion order differs
  for sid in SCENES_100:
    assert a.placement(sid) == b.placement(sid)
    assert len(a.placement(sid)) == 2
    assert len(set(a.placement(sid))) == 2  # replicas are distinct


def test_ring_replication_clamped_to_pool_size():
  ring = HashRing(["only"], replication=3)
  assert ring.placement("s") == ["only"]
  assert HashRing([], replication=2).placement("s") == []


def test_ring_spreads_scenes_across_backends():
  ring = HashRing(["a", "b", "c"], replication=1)
  primaries = {ring.primary(sid) for sid in SCENES_100}
  assert primaries == {"a", "b", "c"}  # nobody owns everything


def test_ring_resize_moves_only_scenes_touching_the_changed_backend():
  before = HashRing(["a", "b", "c"], replication=2)
  grown = HashRing(["a", "b", "c", "d"], replication=2)
  moved = 0
  for sid in SCENES_100:
    if "d" not in grown.placement(sid):
      # Consistent hashing: adding d only remaps scenes d now serves.
      assert grown.placement(sid) == before.placement(sid)
    else:
      moved += 1
  assert 0 < moved < len(SCENES_100)  # d took some load, not all of it
  # Removal is exactly the inverse: the survivor ring is bit-identical
  # to one built without the backend (re-placement is deterministic).
  shrunk = HashRing(["a", "b", "c", "d"], replication=2)
  shrunk.remove("d")
  for sid in SCENES_100:
    assert shrunk.placement(sid) == before.placement(sid)


# --- router over a fake transport ---------------------------------------


class FakeTransport:
  """address -> handler(method, path, body, headers) -> (status, headers,
  body); raising ConnectionError simulates a dead host. Records calls."""

  def __init__(self):
    self.handlers = {}
    self.calls = []

  def set(self, address, handler):
    self.handlers[address] = handler

  def request(self, method, url, body=None, headers=None, timeout=30.0):
    assert url.startswith("http://")
    address, _, path = url[len("http://"):].partition("/")
    self.calls.append((address, method, "/" + path))
    return self.handlers[address](method, "/" + path, body, headers or {})


def _good_render(scene_id, h=2, w=2, fill=0.5):
  img = np.full((h, w, 3), fill, np.float32)
  body = json.dumps({
      "scene_id": scene_id, "shape": [h, w, 3], "dtype": "<f4",
      "image_b64": base64.b64encode(img.tobytes()).decode(),
  }).encode()
  return 200, {"Content-Type": "application/json"}, body


def _dead(method, path, body, headers):
  raise ConnectionError("connection refused")


class FakeClock:
  def __init__(self, t=100.0):
    self.t = t

  def __call__(self):
    return self.t


def _two_backend_router(transport, clock=None, threshold=2, reset_s=10.0,
                        tracer=None):
  return Router({"a": "hostA:1", "b": "hostB:1"}, replication=2,
                breaker_threshold=threshold, breaker_reset_s=reset_s,
                transport=transport,
                clock=clock if clock is not None else FakeClock(),
                tracer=tracer)


def _scene_with_primary(router, primary):
  sid = next(s for s in SCENES_100 if router.placement(s)[0] == primary)
  body = json.dumps({"scene_id": sid, "pose": np.eye(4).tolist()}).encode()
  return sid, body


def test_router_forwards_to_primary_and_carries_traceparent():
  transport = FakeTransport()
  seen = {}

  def handler(method, path, body, headers):
    seen.update(headers)
    return _good_render("s")

  transport.set("hostA:1", handler)
  transport.set("hostB:1", handler)
  router = _two_backend_router(transport)
  sid, body = _scene_with_primary(router, "a")
  status, headers, _ = router.forward_render(sid, body, trace_id="ab" * 16)
  assert status == 200
  assert headers["X-Backend-Id"] == "a"
  assert len(transport.calls) == 1  # primary answered; no failover
  # Outbound W3C traceparent: version 00, OUR trace id, sampled.
  version, trace_id, span_id, flags = seen["traceparent"].split("-")
  assert (version, trace_id, flags) == ("00", "ab" * 16, "01")
  assert len(span_id) == 16


def test_router_fails_over_to_replica_when_primary_is_dead():
  transport = FakeTransport()
  transport.set("hostA:1", _dead)
  transport.set("hostB:1", lambda m, p, b, h: _good_render("s"))
  router = _two_backend_router(transport)
  sid, body = _scene_with_primary(router, "a")
  status, headers, _ = router.forward_render(sid, body)
  assert status == 200 and headers["X-Backend-Id"] == "b"
  snap = router.metrics.snapshot()
  assert snap["failovers"] == 1 and snap["forwards"] == {"b": 1}
  assert router.stats()["backend_info"]["a"]["breaker"][
      "consecutive_failures"] == 1


def test_router_4xx_passthrough_is_not_a_backend_failure():
  transport = FakeTransport()
  err = json.dumps({"error": "unknown scene"}).encode()
  transport.set("hostA:1", lambda m, p, b, h: (404, {}, err))
  transport.set("hostB:1", lambda m, p, b, h: (404, {}, err))
  router = _two_backend_router(transport)
  sid, body = _scene_with_primary(router, "a")
  status, headers, resp = router.forward_render(sid, body)
  assert status == 404 and resp == err
  assert len(transport.calls) == 1  # a 404 is an ANSWER: no failover
  assert router.stats()["backend_info"]["a"]["breaker"][
      "consecutive_failures"] == 0  # and the backend counts as healthy


@pytest.mark.parametrize("bad_response", [
    lambda: (200, {"Content-Type": "application/json"}, b"not json {"),
    lambda: (200, {"Content-Type": "application/json"},
             json.dumps({"scene_id": "s"}).encode()),  # missing keys
    lambda: _truncated_json(),
    lambda: (200, {"Content-Type": "application/octet-stream",
                   "X-Image-Shape": "2,2,3", "X-Image-Dtype": "<f4"},
             b"\x00" * 17),  # truncated binary: shape says 48 bytes
    lambda: (200, {"Content-Type": "application/octet-stream",
                   "X-Image-Shape": "nope", "X-Image-Dtype": "<f4"},
             b"\x00" * 48),
])
def test_router_rejects_garbage_200s_and_fails_over(bad_response):
  transport = FakeTransport()
  transport.set("hostA:1", lambda m, p, b, h: bad_response())
  transport.set("hostB:1", lambda m, p, b, h: _good_render("s"))
  router = _two_backend_router(transport)
  sid, body = _scene_with_primary(router, "a")
  status, headers, _ = router.forward_render(sid, body)
  assert status == 200 and headers["X-Backend-Id"] == "b"
  snap = router.metrics.snapshot()
  assert snap["bad_responses"] == 1 and snap["failovers"] == 1


def _truncated_json():
  full = json.dumps({
      "scene_id": "s", "shape": [2, 2, 3], "dtype": "<f4",
      "image_b64": base64.b64encode(b"\x00" * 48).decode()}).encode()
  return 200, {"Content-Type": "application/json"}, full[:-20]


def test_router_breaker_opens_and_isolates_only_the_bad_backend():
  transport = FakeTransport()
  transport.set("hostA:1", _dead)
  transport.set("hostB:1", lambda m, p, b, h: _good_render("s"))
  clock = FakeClock()
  router = _two_backend_router(transport, clock=clock, threshold=2)
  sid, body = _scene_with_primary(router, "a")
  for _ in range(2):  # two failed attempts open a's circuit
    status, _, _ = router.forward_render(sid, body)
    assert status == 200  # the replica still answers every time
  info = router.stats()["backend_info"]
  assert info["a"]["breaker"]["state"] == "open"
  assert info["b"]["breaker"]["state"] == "closed"  # isolation
  transport.calls.clear()
  status, headers, _ = router.forward_render(sid, body)
  assert status == 200 and headers["X-Backend-Id"] == "b"
  # The open breaker means the corpse is not even contacted.
  assert all(addr != "hostA:1" for addr, _, _ in transport.calls)


def test_router_resurrected_backend_recloses_via_half_open_probe():
  transport = FakeTransport()
  transport.set("hostA:1", _dead)
  transport.set("hostB:1", lambda m, p, b, h: _good_render("s"))
  clock = FakeClock()
  router = _two_backend_router(transport, clock=clock, threshold=2,
                               reset_s=10.0)
  sid, body = _scene_with_primary(router, "a")
  for _ in range(2):
    router.forward_render(sid, body)
  assert router.stats()["backend_info"]["a"]["breaker"]["state"] == "open"
  # The backend comes back; after the cooldown the NEXT request is the
  # half-open probe, and its success re-closes the circuit.
  transport.set("hostA:1", lambda m, p, b, h: _good_render("s"))
  clock.t += 10.1
  status, headers, _ = router.forward_render(sid, body)
  assert status == 200 and headers["X-Backend-Id"] == "a"
  assert router.stats()["backend_info"]["a"]["breaker"]["state"] == "closed"


def test_router_all_replicas_open_is_503_with_retry_after():
  transport = FakeTransport()
  transport.set("hostA:1", _dead)
  transport.set("hostB:1", _dead)
  clock = FakeClock()
  router = _two_backend_router(transport, clock=clock, threshold=1)
  sid, body = _scene_with_primary(router, "a")
  with pytest.raises(ReplicasExhaustedError):
    router.forward_render(sid, body)  # opens both breakers (threshold 1)
  with pytest.raises(AllReplicasOpenError) as err:
    router.forward_render(sid, body)
  assert 0 < err.value.retry_after_s <= 10.0
  assert router.metrics.snapshot()["breaker_fastfails"] == 1


# --- eject/readmit (the supervisor's administrative hooks) ---------------


def test_router_ejected_backend_is_skipped_without_an_attempt():
  transport = FakeTransport()
  transport.set("hostA:1", lambda m, p, b, h: _good_render("s"))
  transport.set("hostB:1", lambda m, p, b, h: _good_render("s"))
  router = _two_backend_router(transport)
  sid, body = _scene_with_primary(router, "a")
  router.eject("a", reason="rolling_restart")
  status, headers, _ = router.forward_render(sid, body)
  assert status == 200 and headers["X-Backend-Id"] == "b"
  # Planned downtime spends NOTHING: no attempt, no failover, no
  # breaker count against the ejected backend.
  assert all(addr != "hostA:1" for addr, _, _ in transport.calls)
  snap = router.metrics.snapshot()
  assert snap["failovers"] == 0
  info = router.stats()["backend_info"]
  assert info["a"]["breaker"]["consecutive_failures"] == 0
  assert info["a"]["ejected"] is True
  assert router.ejected() == ["a"]
  router.readmit("a")
  assert router.ejected() == []
  transport.calls.clear()
  status, headers, _ = router.forward_render(sid, body)
  assert status == 200 and headers["X-Backend-Id"] == "a"
  # Both edges land in the lifecycle log.
  kinds = router.events.snapshot()["by_kind"]
  assert kinds["backend_eject"] == 1 and kinds["backend_readmit"] == 1


def test_router_all_replicas_ejected_is_503_not_error():
  transport = FakeTransport()
  transport.set("hostA:1", lambda m, p, b, h: _good_render("s"))
  transport.set("hostB:1", lambda m, p, b, h: _good_render("s"))
  router = _two_backend_router(transport)
  sid, body = _scene_with_primary(router, "a")
  router.eject("a")
  router.eject("b")
  with pytest.raises(AllReplicasOpenError):
    router.forward_render(sid, body)
  assert router.metrics.snapshot()["breaker_fastfails"] == 1


# --- retry budget (failover amplification guard) -------------------------


def test_router_retry_budget_degrades_brownout_to_fast_503():
  from mpi_vision_tpu_torch.serve.cluster import RetryBudgetExhaustedError

  transport = FakeTransport()
  transport.set("hostA:1", _dead)
  transport.set("hostB:1", _dead)
  # Breakers never open (high threshold): the budget is the only guard.
  router = Router({"a": "hostA:1", "b": "hostB:1"}, replication=2,
                  breaker_threshold=1000, transport=transport,
                  clock=FakeClock(), retry_budget_ratio=0.1,
                  retry_budget_initial=2.0)
  sid, body = _scene_with_primary(router, "a")
  # 2 initial tokens cover the first two requests' failovers (each walk
  # = 1 primary attempt + 1 budgeted failover).
  for _ in range(2):
    with pytest.raises(ReplicasExhaustedError):
      router.forward_render(sid, body)
  # Bucket dry (2 withdrawn, deposits only 0.1/request): the walk now
  # stops after the primary attempt — fast 503, no amplification.
  calls_before = len(transport.calls)
  with pytest.raises(RetryBudgetExhaustedError):
    router.forward_render(sid, body)
  assert len(transport.calls) == calls_before + 1  # primary only
  snap = router.metrics.snapshot()
  assert snap["retry_budget_exhausted"] == 1
  budget = router.stats()["retry_budget"]
  assert budget["withdrawals"] == 2 and budget["refused"] == 1
  assert budget["tokens"] < 1.0


def test_router_retry_budget_refusal_releases_a_claimed_probe_slot():
  """A dry budget can interrupt the walk right after allow_primary()
  claimed a replica's half-open probe; the slot must be released or
  that breaker wedges in HALF_OPEN forever (nothing else feeds it)."""
  from mpi_vision_tpu_torch.serve.cluster import RetryBudgetExhaustedError

  transport = FakeTransport()
  transport.set("hostA:1", _dead)
  transport.set("hostB:1", _dead)
  clock = FakeClock()
  router = Router({"a": "hostA:1", "b": "hostB:1"}, replication=2,
                  breaker_threshold=1, breaker_reset_s=10.0,
                  transport=transport, clock=clock,
                  retry_budget_ratio=0.4, retry_budget_initial=1.0)
  sid, body = _scene_with_primary(router, "a")
  with pytest.raises(ReplicasExhaustedError):
    router.forward_render(sid, body)  # opens both breakers, spends the token
  clock.t += 10.1  # both cooldowns elapse: the next walk probes
  with pytest.raises(RetryBudgetExhaustedError):
    # a's probe fails (dead, re-opens a), b's allow_primary() claims ITS
    # probe slot, then the dry budget stops the walk before the attempt.
    router.forward_render(sid, body)
  # Deposits refilled the bucket past 1 token; b's next allow_primary()
  # must still probe — a leaked slot would keep it False forever (and a,
  # freshly re-opened, stays skipped: b IS the serving path).
  transport.set("hostB:1", lambda m, p, b, h: _good_render("s"))
  status, headers, _ = router.forward_render(sid, body)
  assert status == 200 and headers["X-Backend-Id"] == "b"
  assert router.stats()["backend_info"]["b"]["breaker"]["state"] == "closed"


def test_router_retry_budget_refills_from_good_traffic():
  transport = FakeTransport()
  transport.set("hostA:1", lambda m, p, b, h: _good_render("s"))
  transport.set("hostB:1", lambda m, p, b, h: _good_render("s"))
  router = Router({"a": "hostA:1", "b": "hostB:1"}, replication=2,
                  transport=transport, clock=FakeClock(),
                  retry_budget_ratio=0.5, retry_budget_initial=0.0)
  sid, body = _scene_with_primary(router, "a")
  for _ in range(4):  # 4 * 0.5 = 2 tokens earned
    assert router.forward_render(sid, body)[0] == 200
  transport.set("hostA:1", _dead)
  status, headers, _ = router.forward_render(sid, body)
  assert status == 200 and headers["X-Backend-Id"] == "b"  # budgeted


# --- load-aware replica choice -------------------------------------------


def _load_router(transport, clock):
  return Router({"a": "hostA:1", "b": "hostB:1"}, replication=2,
                transport=transport, clock=clock, load_aware=True,
                load_ttl_s=5.0, load_threshold=4)


def test_router_load_aware_demotes_deep_primary():
  transport = FakeTransport()
  transport.set("hostA:1", lambda m, p, b, h: _good_render("s"))
  transport.set("hostB:1", lambda m, p, b, h: _good_render("s"))
  clock = FakeClock()
  router = _load_router(transport, clock)
  sid, body = _scene_with_primary(router, "a")
  # No load data: placement order wins (cache locality).
  assert router.forward_render(sid, body)[1]["X-Backend-Id"] == "a"
  # Fresh depths show the primary 9 deep vs 0: demote it.
  router.note_backend_load("a", 9)
  router.note_backend_load("b", 0)
  status, headers, _ = router.forward_render(sid, body)
  assert status == 200 and headers["X-Backend-Id"] == "b"
  assert router.metrics.snapshot()["load_reroutes"] == 1
  # Below the threshold: the primary keeps its scene.
  router.note_backend_load("a", 3)
  assert router.forward_render(sid, body)[1]["X-Backend-Id"] == "a"


def test_router_cell_routing_spreads_and_counts_reroutes():
  """Tile-granular routing (serve/tiles.py x the edge lattice): with
  --route-cell on, requests place by their (scene, view-cell) ring key
  — a hot scene's cells spread over the pool, reroutes off the
  scene-level primary are counted, and a malformed pose falls back to
  the scene key instead of failing placement."""
  transport = FakeTransport()
  transport.set("hostA:1", lambda m, p, b, h: _good_render("s"))
  transport.set("hostB:1", lambda m, p, b, h: _good_render("s"))
  router = Router({"a": "hostA:1", "b": "hostB:1"}, replication=1,
                  route_cell=0.05, transport=transport, clock=FakeClock())
  sid = "hot"
  rng = np.random.default_rng(7)
  served = set()
  for _ in range(24):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = rng.uniform(-1.0, 1.0, 3).astype(np.float32)
    req = {"scene_id": sid, "pose": pose.tolist()}
    cell = router.request_cell(req)
    assert cell is not None
    status, headers, _ = router.forward_render(
        sid, json.dumps(req).encode(), cell=cell)
    assert status == 200
    served.add(headers["X-Backend-Id"])
  # One scene, replication 1: without cell keys ONE backend serves
  # everything; with them both backends took cells.
  assert served == {"a", "b"}
  snap = router.metrics.snapshot()
  assert snap["cell_routes"] == 24
  assert 0 < snap["cell_reroutes"] < 24
  # Same cell -> same placement (determinism the edge caches rely on).
  pose = np.eye(4, dtype=np.float32)
  req = {"scene_id": sid, "pose": pose.tolist()}
  assert (router.request_cell(req) == router.request_cell(req))
  # Malformed/missing poses ride the scene-level key (the backend owns
  # the 400; the router must not fail in placement math).
  assert router.request_cell({"scene_id": sid, "pose": "junk"}) is None
  assert router.request_cell({"scene_id": sid}) is None
  off = Router({"a": "hostA:1"}, transport=transport, clock=FakeClock())
  assert off.request_cell(req) is None  # routing off: scene-level key


def test_router_load_aware_ignores_stale_depths():
  transport = FakeTransport()
  transport.set("hostA:1", lambda m, p, b, h: _good_render("s"))
  transport.set("hostB:1", lambda m, p, b, h: _good_render("s"))
  clock = FakeClock()
  router = _load_router(transport, clock)
  sid, body = _scene_with_primary(router, "a")
  router.note_backend_load("a", 9)
  router.note_backend_load("b", 0)
  clock.t += 5.1  # past load_ttl_s: yesterday's hotspot is not today's
  assert router.forward_render(sid, body)[1]["X-Backend-Id"] == "a"
  assert router.metrics.snapshot()["load_reroutes"] == 0


def test_router_stats_fanout_feeds_the_load_table():
  transport = FakeTransport()

  def statsy(depth):
    def handler(method, path, body, headers):
      if path == "/stats":
        return 200, {}, json.dumps({"queue_depth": depth}).encode()
      return 200, {}, json.dumps({"status": "ok"}).encode()
    return handler

  transport.set("hostA:1", statsy(7))
  transport.set("hostB:1", statsy(1))
  clock = FakeClock()
  router = _load_router(transport, clock)
  router.stats()  # any stats scrape doubles as a load refresh
  with router._lock:
    depths = {b: d for b, (d, _) in router._load.items()}
  assert depths == {"a": 7.0, "b": 1.0}


# --- router-side client-perceived SLO ------------------------------------


def test_router_slo_counts_failures_the_backends_never_see():
  """Client-perceived availability: a 502 from an exhausted replica walk
  is a failure NO backend tracker recorded (the backends were dead) —
  the router's own SloTracker must count it, next to the successes."""
  transport = FakeTransport()
  transport.set("hostA:1", lambda m, p, b, h: _good_render("s"))
  transport.set("hostB:1", lambda m, p, b, h: _good_render("s"))
  router = _two_backend_router(transport)
  sid, body = _scene_with_primary(router, "a")
  for _ in range(8):
    router.forward_render(sid, body)
  transport.set("hostA:1", _dead)
  transport.set("hostB:1", _dead)
  for _ in range(3):
    # The first walk exhausts the replicas (502); the failures open both
    # breakers, so later walks fast-fail (503) — ALL are client-
    # perceived failures the backend trackers never saw.
    with pytest.raises((ReplicasExhaustedError, AllReplicasOpenError)):
      router.forward_render(sid, body)
  snap = router.slo.snapshot()
  slow = snap["objectives"]["availability"]["slow"]
  assert slow["requests"] == 11 and slow["bad"] == 3
  # Completed requests carry an end-to-end latency sample too.
  assert snap["objectives"]["latency"]["slow"]["requests"] == 8


def test_router_stats_slo_block_carries_the_router_stream():
  transport = FakeTransport()

  def minimal(method, path, body, headers):
    if path == "/render":
      return _good_render("s")
    return 200, {}, b"{}"

  transport.set("hostA:1", minimal)
  transport.set("hostB:1", minimal)
  router = _two_backend_router(transport)
  sid, body = _scene_with_primary(router, "a")
  router.forward_render(sid, body)
  slo = router.stats()["slo"]
  assert slo["router"]["objectives"]["availability"]["slow"]["requests"] == 1
  # The fleet summary distilled from the backends still sits beside it.
  assert "attainment" in slo and "backends_reporting" in slo


def test_router_forwards_if_none_match_and_edge_headers():
  """The router is a pure conditional-request conduit: the client's
  If-None-Match reaches the backend, and the backend's ETag /
  Cache-Control / X-Edge-Cache ride back through the HTTP front end's
  forwarded headers (a 304 is an answered status, not a failure)."""
  transport = FakeTransport()
  seen = {}

  def edge_backend(method, path, body, headers):
    seen.update(headers)
    if headers.get("If-None-Match") == '"tag123"':
      return 304, {"ETag": '"tag123"', "Cache-Control": "max-age=5",
                   "X-Edge-Cache": "revalidated"}, b""
    return _good_render("s")

  transport.set("hostA:1", edge_backend)
  transport.set("hostB:1", edge_backend)
  router = _two_backend_router(transport)
  sid, body = _scene_with_primary(router, "a")
  status, headers, resp_body = router.forward_render(
      sid, body, if_none_match='"tag123"')
  assert seen.get("If-None-Match") == '"tag123"'
  assert status == 304 and resp_body == b""
  assert headers["ETag"] == '"tag123"'
  # The 304 counted as a healthy answer: breaker closed, SLO good.
  assert router.breaker_state("a") == "closed"
  assert router.slo.snapshot()[
      "objectives"]["availability"]["slow"]["bad"] == 0


# --- concurrent fan-out (a slow backend must not stall the scrape) -------


def test_router_fan_out_probes_backends_concurrently():
  """Both backends block on one barrier that only releases when BOTH
  probes are in flight at once — a serial fan-out would deadlock the
  first probe until its timeout. Deterministic: no sleeps, no timing."""
  barrier = threading.Barrier(2, timeout=10.0)

  def blocking_backend(method, path, body, headers):
    barrier.wait()  # serial fan-out: BrokenBarrierError after 10 s
    return 200, {}, json.dumps({"status": "ok"}).encode()

  transport = FakeTransport()
  transport.set("hostA:1", blocking_backend)
  transport.set("hostB:1", blocking_backend)
  router = _two_backend_router(transport)
  health = router.healthz()
  assert health["backends"] == {"a": "ok", "b": "ok"}
  assert health["status"] == "ok"


# --- the router's own HTTP front end ------------------------------------


@pytest.fixture
def http_router():
  """A socketed router front end over fake backends: hostA answers
  garbage 200s, hostB is dead — the 502-never-500 worst case."""
  transport = FakeTransport()
  transport.set("hostA:1",
                lambda m, p, b, h: (200, {"Content-Type":
                                          "application/json"}, b"garbage"))
  transport.set("hostB:1", _dead)
  router = _two_backend_router(transport, tracer=Tracer())
  server = make_router_http_server(router)
  thread = threading.Thread(target=server.serve_forever, daemon=True)
  thread.start()
  base = f"http://127.0.0.1:{server.server_address[1]}"
  yield base, router, transport
  server.shutdown()


def _post(base, payload, raw=None):
  data = raw if raw is not None else json.dumps(payload).encode()
  req = urllib.request.Request(base + "/render", data=data,
                               headers={"Content-Type": "application/json"})
  try:
    with urllib.request.urlopen(req, timeout=30) as resp:
      return resp.status, dict(resp.headers.items()), resp.read()
  except urllib.error.HTTPError as e:
    with e:
      return e.code, dict(e.headers.items()), e.read()


def test_http_router_garbage_backends_answer_502_never_500(http_router):
  base, _, _ = http_router
  status, headers, body = _post(
      base, {"scene_id": "scene_000", "pose": np.eye(4).tolist()})
  assert status == 502
  payload = json.loads(body)
  assert "attempts" in payload and len(payload["attempts"]) >= 1
  assert headers.get("X-Trace-Id")


def test_http_router_rejects_malformed_requests_with_400(http_router):
  base, _, _ = http_router
  assert _post(base, None, raw=b"{nope")[0] == 400
  assert _post(base, {"scene_id": ["not", "a", "string"],
                      "pose": np.eye(4).tolist()})[0] == 400
  assert _post(base, ["not", "an", "object"])[0] == 400


def test_http_router_open_breakers_answer_503_with_retry_after(http_router):
  base, router, _ = http_router
  for _ in range(2):  # open both breakers (threshold 2, both backends bad)
    _post(base, {"scene_id": "scene_000", "pose": np.eye(4).tolist()})
  status, headers, _ = _post(
      base, {"scene_id": "scene_000", "pose": np.eye(4).tolist()})
  assert status == 503 and int(headers["Retry-After"]) >= 1


# --- aggregated observability over fakes --------------------------------


def _obs_backend(metrics_text, health_status="ok"):
  def handler(method, path, body, headers):
    if path == "/healthz":
      return 200, {}, json.dumps({"status": health_status}).encode()
    if path == "/stats":
      return 200, {}, json.dumps({"requests": 1}).encode()
    if path.startswith("/metrics"):  # the router scrapes ?exemplars=1
      return 200, {}, metrics_text.encode()
    return 404, {}, b"{}"
  return handler


_EXPO_A = """# HELP mpi_serve_requests_total Completed render requests.
# TYPE mpi_serve_requests_total counter
mpi_serve_requests_total 3
# HELP mpi_serve_errors_total Failed requests by class.
# TYPE mpi_serve_errors_total counter
mpi_serve_errors_total{class="transient"} 1
"""

_EXPO_B = """# HELP mpi_serve_requests_total Completed render requests.
# TYPE mpi_serve_requests_total counter
mpi_serve_requests_total 5
# HELP mpi_serve_errors_total Failed requests by class.
# TYPE mpi_serve_errors_total counter
mpi_serve_errors_total{class="transient"} 2
"""


def test_aggregated_healthz_degraded_not_unhealthy_with_one_dead():
  transport = FakeTransport()
  transport.set("hostA:1", _obs_backend(_EXPO_A))
  transport.set("hostB:1", _dead)
  router = _two_backend_router(transport)
  health = router.healthz()
  assert health["status"] == "degraded"  # NOT unhealthy: a is serving
  assert health["backends"] == {"a": "ok", "b": "unreachable"}
  assert health["backends_reachable"] == 1
  assert "replicas cover" in health["reason"]


def test_aggregated_healthz_unhealthy_only_when_nobody_answers():
  transport = FakeTransport()
  transport.set("hostA:1", _dead)
  transport.set("hostB:1", _dead)
  router = _two_backend_router(transport)
  assert router.healthz()["status"] == "unhealthy"
  ok = FakeTransport()
  ok.set("hostA:1", _obs_backend(_EXPO_A))
  ok.set("hostB:1", _obs_backend(_EXPO_B))
  assert _two_backend_router(ok).healthz()["status"] == "ok"


def test_aggregated_metrics_sums_backends_and_adds_cluster_families():
  transport = FakeTransport()
  transport.set("hostA:1", _obs_backend(_EXPO_A))
  transport.set("hostB:1", _obs_backend(_EXPO_B))
  router = _two_backend_router(transport)
  families = parse_metrics_text(router.metrics_text())
  assert families["mpi_serve_requests_total"]["samples"][
      ("mpi_serve_requests_total", ())] == 8  # 3 + 5
  assert families["mpi_serve_errors_total"]["samples"][
      ("mpi_serve_errors_total", (("class", "transient"),))] == 3
  assert families["mpi_cluster_backends"]["samples"][
      ("mpi_cluster_backends", ())] == 2
  up = families["mpi_cluster_backend_up"]["samples"]
  assert up[("mpi_cluster_backend_up", (("backend", "a"),))] == 1
  assert up[("mpi_cluster_backend_up", (("backend", "b"),))] == 1


def test_aggregated_metrics_cached_for_ttl_under_injectable_clock():
  clock = FakeClock()
  transport = FakeTransport()
  transport.set("hostA:1", _obs_backend(_EXPO_A))
  transport.set("hostB:1", _obs_backend(_EXPO_B))
  router = _two_backend_router(transport, clock=clock)
  first = router.metrics_text()
  fanouts = len(transport.calls)
  # Inside the TTL: the STALE string comes back with zero fan-out.
  transport.set("hostA:1", _obs_backend(_EXPO_B))
  clock.t += 0.24
  assert router.metrics_text() == first
  assert len(transport.calls) == fanouts
  # Past the TTL: one fresh fan-out, new numbers (5 + 5).
  clock.t += 0.02
  families = parse_metrics_text(router.metrics_text())
  assert families["mpi_serve_requests_total"]["samples"][
      ("mpi_serve_requests_total", ())] == 10
  assert len(transport.calls) > fanouts


# --- the same inputs through both packages -------------------------------


SCENES_200 = [f"scene_{i:03d}" for i in range(200)]


@pytest.mark.parametrize("n_backends,vnodes,replication", [
    (1, 64, 2), (2, 64, 2), (3, 64, 2), (5, 16, 3), (8, 128, 2), (4, 1, 1)])
def test_ring_placements_equal_jax(n_backends, vnodes, replication):
  ids = [f"b{i}" for i in range(n_backends)]
  port = HashRing(ids, vnodes=vnodes, replication=replication)
  ref = JHashRing(ids, vnodes=vnodes, replication=replication)
  for sid in SCENES_200:
    assert port.placement(sid) == ref.placement(sid), sid
    assert port.placement(sid, tile=(1, 2)) == ref.placement(
        sid, tile=(1, 2)), sid
  # A resize moves the same scenes in both packages.
  for ring in (port, ref):
    ring.add("grown")
    ring.remove("b0")
  for sid in SCENES_200:
    assert port.placement(sid) == ref.placement(sid), sid


def test_retry_budget_equals_jax_on_one_script():
  rng = np.random.default_rng(7)
  port = RetryBudget(ratio=0.25, initial=3.0, cap=5.0)
  ref = JRetryBudget(ratio=0.25, initial=3.0, cap=5.0)
  for op in rng.choice(["deposit", "withdraw"], size=200, p=[0.7, 0.3]):
    if op == "deposit":
      port.deposit()
      ref.deposit()
    else:
      assert port.try_withdraw() == ref.try_withdraw()
    assert port.snapshot() == ref.snapshot()
  assert port.snapshot()["refused"] > 0  # the script ran the bucket dry
  for bad in ({"ratio": 0.0}, {"initial": 5.0, "cap": 1.0},
              {"initial": -1.0}):
    with pytest.raises(ValueError):
      RetryBudget(**bad)
    with pytest.raises(ValueError):
      JRetryBudget(**bad)


class ScriptedTransport(FakeTransport):
  """Every backend follows one scripted mode per step: ``ok``, ``dead``
  (connection refused), ``garbage`` (a 200 that is not JSON), ``5xx``,
  or ``404`` (the backend answers: healthy)."""

  def __init__(self, modes):
    super().__init__()
    self.modes = modes  # address -> mode, mutated by the script
    for address in modes:
      self.set(address, self._handler(address))

  def _handler(self, address):
    def handler(method, path, body, headers):
      mode = self.modes[address]
      if mode == "dead":
        raise ConnectionError("connection refused")
      if path == "/healthz":
        return 200, {}, json.dumps({"status": "ok"}).encode()
      if path == "/stats":
        return 200, {}, json.dumps({"requests": 1,
                                    "queue_depth": 0}).encode()
      if path.startswith("/metrics"):
        return 200, {}, _EXPO_A.encode()
      if mode == "garbage":
        return 200, {"Content-Type": "application/json"}, b"garbage"
      if mode == "5xx":
        return 500, {}, json.dumps({"error": "boom"}).encode()
      if mode == "404":
        return 404, {}, json.dumps({"error": "unknown scene"}).encode()
      return _good_render(json.loads(body)["scene_id"])
    return handler


# (step, address, mode) edits applied before that step's request.
_SCRIPT_EDITS = {
    3: [("hostA:1", "dead")],
    6: [("hostB:1", "garbage")],
    9: [("hostC:1", "5xx")],
    12: [("hostB:1", "ok")],
    15: [("hostA:1", "ok"), ("hostC:1", "dead")],
    19: [("hostB:1", "404")],
    22: [("hostB:1", "dead"), ("hostA:1", "dead")],
    30: [("hostA:1", "ok"), ("hostB:1", "ok"), ("hostC:1", "ok")],
}


def _run_script(router_cls):
  clock = FakeClock()
  transport = ScriptedTransport(
      {"hostA:1": "ok", "hostB:1": "ok", "hostC:1": "ok"})
  router = router_cls({"a": "hostA:1", "b": "hostB:1", "c": "hostC:1"},
                      replication=3, breaker_threshold=2,
                      breaker_reset_s=1.0, retry_budget_initial=3.0,
                      transport=transport, clock=clock)
  log = []
  for step in range(40):
    for address, mode in _SCRIPT_EDITS.get(step, ()):
      transport.modes[address] = mode
    if step == 25:
      router.note_backend_load("b", 12)
    if step == 34:
      router.eject("c", reason="scripted")
    if step == 37:
      router.readmit("c")
    sid = SCENES_100[step % 7]
    body = json.dumps({"scene_id": sid, "pose": np.eye(4).tolist()}).encode()
    n_calls = len(transport.calls)
    try:
      status, headers, _ = router.forward_render(sid, body)
      outcome = (status, headers.get("X-Backend-Id"))
    except Exception as e:  # noqa: BLE001 - the class IS the outcome
      outcome = (type(e).__name__,)
    log.append((step, sid, outcome, transport.calls[n_calls:],
                {b: router.breaker_state(b) for b in "abc"}))
    clock.t += 0.3
  return router, log


def test_router_try_order_and_outcomes_equal_jax():
  port, port_log = _run_script(Router)
  ref, ref_log = _run_script(JRouter)
  assert port_log == ref_log
  outcomes = {entry[2][0] for entry in port_log}
  # The script walks every path: served, failed over, answered 404,
  # exhausted replicas, breaker fast-fails and a dry retry budget.
  assert {200, 404} <= outcomes
  assert outcomes & {"ReplicasExhaustedError", "AllReplicasOpenError",
                     "RetryBudgetExhaustedError"}
  assert port.metrics.snapshot() == ref.metrics.snapshot()
  assert port.retry_budget.snapshot() == ref.retry_budget.snapshot()
  assert port.metrics.snapshot()["failovers"] > 0


def _keys(tree):
  """The nested key structure of a JSON-like dict."""
  if isinstance(tree, dict):
    return {k: _keys(v) for k, v in tree.items()}
  return None


def _obs_pair(router_cls, clock):
  transport = FakeTransport()
  transport.set("hostA:1", _obs_backend(_EXPO_A))
  transport.set("hostB:1", _dead)
  return _two_backend_router(transport, clock=clock) if router_cls is Router \
      else JRouter({"a": "hostA:1", "b": "hostB:1"}, replication=2,
                   breaker_threshold=2, breaker_reset_s=10.0,
                   transport=transport, clock=clock)


def test_stats_healthz_and_metrics_shapes_equal_jax():
  port = _obs_pair(Router, FakeClock())
  ref = _obs_pair(JRouter, FakeClock())
  assert _keys(port.stats()) == _keys(ref.stats())
  assert port.healthz() == ref.healthz()
  port_fams = parse_metrics_text(port.metrics_text())
  ref_fams = jparse_metrics_text(ref.metrics_text())
  assert sorted(port_fams) == sorted(ref_fams)
  assert {f for f in port_fams if f.startswith("mpi_cluster_")}
  for name in port_fams:
    np.testing.assert_equal(port_fams[name]["samples"],
                            ref_fams[name]["samples"], err_msg=name)


def test_brownout_level_is_not_summed_across_the_fleet():
  """The router drops the families ``brownout.NON_ADDITIVE_FAMILIES``
  names from its aggregated ``/metrics`` (a pooled "level 5" from
  backends at L2 and L3 means nothing). The port's brownout module
  lacked the name until the router was copied; it now equals JAX's."""
  assert brownout.NON_ADDITIVE_FAMILIES == jbrownout.NON_ADDITIVE_FAMILIES
  level = ("# HELP mpi_serve_brownout_level Current brownout level.\n"
           "# TYPE mpi_serve_brownout_level gauge\n"
           "mpi_serve_brownout_level {}\n")
  transport = FakeTransport()
  transport.set("hostA:1", _obs_backend(_EXPO_A + level.format(2)))
  transport.set("hostB:1", _obs_backend(_EXPO_B + level.format(3)))
  families = parse_metrics_text(
      _two_backend_router(transport).metrics_text())
  assert "mpi_serve_brownout_level" not in families
  assert families["mpi_serve_requests_total"]["samples"][
      ("mpi_serve_requests_total", ())] == 8


def test_the_package_exports_the_jax_names():
  from mpi_vision_tpu.serve import cluster as jcluster
  from mpi_vision_tpu_torch.serve import cluster

  assert cluster.__all__ == jcluster.__all__
  for name in cluster.__all__:
    assert getattr(cluster, name).__name__ == getattr(jcluster, name).__name__
