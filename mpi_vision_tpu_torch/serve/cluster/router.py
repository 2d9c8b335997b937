"""Scene-sharded routing front end over a pool of serve backends.

A copy of ``mpi_vision_tpu/serve/cluster/router.py`` with its imports
rewritten: the router is host code and never touches the card; its
backends are the PyTorch package's ``serve`` processes, each rendering
on the card.

The multi-host serving tier (one process cannot carry heavy traffic
from many users). A ``Router`` owns a consistent-
hash ring (``ring.py``) placing every scene id on ``replication``
backends, forwards ``/render`` to the scene's primary, and fails over
down the replica list when a backend is unreachable, times out, or
answers garbage. Health is tracked **per backend** with one
``serve.resilience.CircuitBreaker`` each — a service's own breaker is
global to it, and this is the split across hosts: one bad
host must fast-fail *its* requests onto replicas without degrading the
fleet. A backend that comes back re-closes its own breaker through the
standard half-open probe (the next request after the cooldown IS the
probe).

Cross-host observability: every forwarded request carries an outbound
W3C ``traceparent`` header built from the router's trace id, and the
backends already honor inbound traceparent — so one trace id
resolves to a span tree on the router (``/debug/traces``) AND on the
backend that served it, stitching the distributed trace end-to-end.
Aggregated ``/stats``, ``/metrics``
(summed across the pool + ``mpi_cluster_*`` router families, memoized
~250 ms), and ``/healthz`` (degraded-not-unhealthy while replicas
cover for a dead backend) come from the same front end.

Transport is injectable: the default speaks HTTP via urllib; tests
inject deterministic fakes (malformed-JSON backends, truncated binary,
connection refusals) without sockets.
"""

from __future__ import annotations

import http.client
import json
import math
import re
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid

import functools
import numpy as np
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from mpi_vision_tpu_torch.obs import attrib as attrib_mod
from mpi_vision_tpu_torch.obs import prom
from mpi_vision_tpu_torch.obs import hist as hist_mod
from mpi_vision_tpu_torch.obs import tsdb as tsdb_mod
from mpi_vision_tpu_torch.obs.events import EventLog
from mpi_vision_tpu_torch.obs.slo import SloConfig, SloTracker
from mpi_vision_tpu_torch.obs.trace import NULL_TRACE, NULL_TRACER, Tracer
from mpi_vision_tpu_torch.serve import brownout as brownout_mod
from mpi_vision_tpu_torch.serve.assets import store as assets_mod
from mpi_vision_tpu_torch.serve.edge import lattice as edge_lattice
from mpi_vision_tpu_torch.serve.resilience import CircuitBreaker, RetryBudget
from mpi_vision_tpu_torch.serve.cluster.ring import HashRing
from mpi_vision_tpu_torch.serve.server import _MAX_BODY_BYTES, _inbound_trace_id


def new_trace_id_32() -> str:
  """A 32-hex W3C-sized trace id (the 16-hex in-process ids cannot ride
  a ``traceparent``, whose trace-id field is exactly 32 hex chars)."""
  return uuid.uuid4().hex


def new_span_id_16() -> str:
  return uuid.uuid4().hex[:16]


def make_traceparent(trace_id: str, span_id: str | None = None) -> str:
  """A version-00 W3C traceparent carrying ``trace_id`` (sampled flag
  set — the router only propagates ids it is itself recording)."""
  return f"00-{trace_id}-{span_id or new_span_id_16()}-01"


class AllReplicasOpenError(RuntimeError):
  """Every replica's breaker refused the request (HTTP 503)."""

  def __init__(self, scene_id: str, retry_after_s: float):
    self.retry_after_s = max(float(retry_after_s), 0.0)
    super().__init__(
        f"all replicas for scene {scene_id!r} have open circuits; "
        f"retry after {self.retry_after_s:.1f}s")


class ReplicasExhaustedError(RuntimeError):
  """Every replica was tried and failed (HTTP 502)."""

  def __init__(self, scene_id: str, attempts: list[str]):
    self.attempts = attempts
    super().__init__(
        f"all replicas failed for scene {scene_id!r}: " + "; ".join(attempts))


class RetryBudgetExhaustedError(RuntimeError):
  """The fleet-wide failover budget refused further attempts (HTTP 503).

  Fired mid-brownout: the primary attempt failed and the token bucket
  says the fleet is already retrying as much as it can afford — fail
  fast instead of amplifying offered load by another replica walk.
  """

  def __init__(self, scene_id: str, attempts: list[str]):
    self.attempts = attempts
    super().__init__(
        f"retry budget exhausted for scene {scene_id!r} after: "
        + "; ".join(attempts))


class HttpTransport:
  """The default router->backend transport (stdlib urllib, no deps).

  ``request`` returns ``(status, headers, body)`` for ANY HTTP response
  (4xx/5xx included — the router decides what a status means) and raises
  ``ConnectionError`` only when no HTTP conversation happened at all
  (refused, reset, DNS, timeout) — the signal that the *host*, not the
  request, is in trouble.
  """

  def request(self, method: str, url: str, body: bytes | None = None,
              headers: dict | None = None,
              timeout: float = 30.0) -> tuple[int, dict, bytes]:
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=dict(headers or {}))
    try:
      with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers.items()), resp.read()
    except urllib.error.HTTPError as e:
      # An HTTP-level error IS a response; read it fully so the router
      # can forward the backend's own error JSON.
      with e:
        return e.code, dict(e.headers.items()), e.read()
    except (urllib.error.URLError, ConnectionError, TimeoutError,
            OSError, http.client.HTTPException) as e:
      # HTTPException (BadStatusLine, IncompleteRead, ...) is NOT an
      # OSError: a half-dead backend writing a garbled status line or
      # truncating mid-read must look like a dead host (fail over,
      # breaker counts), not escape as an unclassified exception.
      raise ConnectionError(str(e.reason if isinstance(
          e, urllib.error.URLError) else e) or repr(e)) from e


class RouterMetrics:
  """Router-level counters (the backends keep their own ServeMetrics)."""

  def __init__(self, clock=time.monotonic):
    self._clock = clock
    self._lock = threading.Lock()
    self._t0 = clock()
    self.requests = 0
    self.forwards: dict[str, int] = {}
    self.failovers = 0
    self.bad_responses = 0
    self.replica_exhausted = 0
    self.breaker_fastfails = 0
    self.breaker_opens = 0
    self.bad_requests = 0
    self.restarts: dict[str, int] = {}
    self.quarantines: dict[str, int] = {}
    self.load_reroutes = 0
    self.retry_budget_exhausted = 0
    self.cell_routes = 0
    self.cell_reroutes = 0
    self.session_proxies = 0
    self.gossip_rounds = 0
    self.gossip_merges = 0
    self.gossip_conflicts = 0
    self.gossip_peer_failures = 0
    self.supervisor_lease_held = 0
    self.supervisor_takeovers = 0
    # Elastic-fleet decisions (serve/cluster/autoscale.py): executed
    # scale-ups/downs, aborted actuations (spawn/warm failure, stranded
    # scale-out), and decisions denied by the scaling budget.
    self.autoscale_ups = 0
    self.autoscale_downs = 0
    self.autoscale_aborts = 0
    self.autoscale_budget_denied = 0
    # Asset-tier routing (serve/assets/): manifest/viewer forwards,
    # digest-addressed asset forwards, fan-outs past a primary's 404
    # (any replica holding the digest may answer), fleet-wide misses.
    self.scene_manifest_forwards = 0
    self.scene_asset_forwards = 0
    self.scene_asset_fanouts = 0
    self.scene_asset_misses = 0
    self.scene_asset_revalidations = 0

  def record_request(self) -> None:
    with self._lock:
      self.requests += 1

  def record_forward(self, backend_id: str) -> None:
    with self._lock:
      self.forwards[backend_id] = self.forwards.get(backend_id, 0) + 1

  def record_failover(self) -> None:
    with self._lock:
      self.failovers += 1

  def record_bad_response(self) -> None:
    with self._lock:
      self.bad_responses += 1

  def record_replica_exhausted(self) -> None:
    with self._lock:
      self.replica_exhausted += 1

  def record_breaker_fastfail(self) -> None:
    with self._lock:
      self.breaker_fastfails += 1

  def record_breaker_open(self) -> None:
    with self._lock:
      self.breaker_opens += 1

  def record_bad_request(self) -> None:
    with self._lock:
      self.bad_requests += 1

  def record_restart(self, backend_id: str) -> None:
    """A supervisor respawned this backend — crash/wedge recovery, a
    rolling-restart step, or an operator readmit (one counter for every
    respawn; /debug/events says which kind each one was)."""
    with self._lock:
      self.restarts[backend_id] = self.restarts.get(backend_id, 0) + 1

  def record_quarantine(self, backend_id: str) -> None:
    """A supervisor gave up restarting this backend (crash loop)."""
    with self._lock:
      self.quarantines[backend_id] = self.quarantines.get(backend_id, 0) + 1

  def record_load_reroute(self) -> None:
    with self._lock:
      self.load_reroutes += 1

  def record_retry_budget_exhausted(self) -> None:
    with self._lock:
      self.retry_budget_exhausted += 1

  def record_gossip_round(self) -> None:
    with self._lock:
      self.gossip_rounds += 1

  def record_gossip_merge(self, merges: int, conflicts: int) -> None:
    with self._lock:
      self.gossip_merges += merges
      self.gossip_conflicts += conflicts

  def record_gossip_peer_failure(self) -> None:
    with self._lock:
      self.gossip_peer_failures += 1

  def record_lease_held(self, held: bool) -> None:
    """Whether THIS router currently holds the supervision lease."""
    with self._lock:
      self.supervisor_lease_held = 1 if held else 0

  def record_takeover(self) -> None:
    """This router adopted supervision from a dead/wedged peer."""
    with self._lock:
      self.supervisor_takeovers += 1

  def record_autoscale(self, kind: str) -> None:
    """One autoscale outcome: ``up``/``down`` (executed), ``abort``
    (actuation failed or a stranded scale-out was abandoned), or
    ``budget_denied`` (the per-window scaling budget refused a
    decision — the anti-thrash guard doing its job)."""
    with self._lock:
      if kind == "up":
        self.autoscale_ups += 1
      elif kind == "down":
        self.autoscale_downs += 1
      elif kind == "abort":
        self.autoscale_aborts += 1
      else:
        self.autoscale_budget_denied += 1

  def record_scene_get(self, kind: str) -> None:
    """One asset-tier GET routed (kind: "manifest" covers manifest AND
    viewer — both are scene-generation lookups; "asset" is a
    digest-addressed fetch)."""
    with self._lock:
      if kind == "asset":
        self.scene_asset_forwards += 1
      else:
        self.scene_manifest_forwards += 1

  def record_asset_fanout(self) -> None:
    """An asset walk continued past a backend's 404 (digest-addressed:
    any replica holding the bytes may answer)."""
    with self._lock:
      self.scene_asset_fanouts += 1

  def record_asset_miss(self) -> None:
    """Every reachable backend 404'd an asset digest."""
    with self._lock:
      self.scene_asset_misses += 1

  def record_asset_revalidated(self) -> None:
    """An asset GET answered 304 AT THE ROUTER: the client's
    If-None-Match named the digest's own strong ETag, and content
    addressing makes that proof of freshness — no backend contacted."""
    with self._lock:
      self.scene_asset_revalidations += 1

  def record_session_proxy(self) -> None:
    """One streaming session tunneled to a backend (POST /session)."""
    with self._lock:
      self.session_proxies += 1

  def record_cell_route(self, rerouted: bool) -> None:
    """One request placed by its ``(scene, view-cell)`` ring key;
    ``rerouted`` when that key's primary differs from the scene-level
    primary (the affinity actually moved the request)."""
    with self._lock:
      self.cell_routes += 1
      if rerouted:
        self.cell_reroutes += 1

  def snapshot(self) -> dict:
    with self._lock:
      return {
          "uptime_s": round(max(self._clock() - self._t0, 0.0), 3),
          "requests": self.requests,
          "forwards": dict(sorted(self.forwards.items())),
          "failovers": self.failovers,
          "bad_responses": self.bad_responses,
          "replica_exhausted": self.replica_exhausted,
          "breaker_fastfails": self.breaker_fastfails,
          "breaker_opens": self.breaker_opens,
          "bad_requests": self.bad_requests,
          "restarts": dict(sorted(self.restarts.items())),
          "quarantines": dict(sorted(self.quarantines.items())),
          "load_reroutes": self.load_reroutes,
          "retry_budget_exhausted": self.retry_budget_exhausted,
          "cell_routes": self.cell_routes,
          "cell_reroutes": self.cell_reroutes,
          "session_proxies": self.session_proxies,
          "gossip_rounds": self.gossip_rounds,
          "gossip_merges": self.gossip_merges,
          "gossip_conflicts": self.gossip_conflicts,
          "gossip_peer_failures": self.gossip_peer_failures,
          "supervisor_lease_held": self.supervisor_lease_held,
          "supervisor_takeovers": self.supervisor_takeovers,
          "autoscale": {
              "ups": self.autoscale_ups,
              "downs": self.autoscale_downs,
              "aborts": self.autoscale_aborts,
              "budget_denied": self.autoscale_budget_denied,
          },
          "scene_sync": {
              "manifest_forwards": self.scene_manifest_forwards,
              "asset_forwards": self.scene_asset_forwards,
              "asset_fanouts": self.scene_asset_fanouts,
              "asset_misses": self.scene_asset_misses,
              "asset_revalidations": self.scene_asset_revalidations,
          },
      }


class _Backend:
  """One pool member: address + its own breaker + contact bookkeeping.

  ``ejected`` is the administrative down-flag (supervisor quarantine or a
  planned rolling-restart step): the forward walk skips the backend
  without spending an attempt on it, which is what makes a PLANNED
  restart invisible to clients — no failed probe, no breaker transition,
  traffic just rides the replica list. The breaker handles UNPLANNED
  badness; eject handles known badness.
  """

  def __init__(self, backend_id: str, address: str, breaker: CircuitBreaker):
    self.backend_id = backend_id
    self.address = address  # host:port
    self.breaker = breaker
    self.ejected = False
    self.eject_reason: str | None = None

  @property
  def base_url(self) -> str:
    return f"http://{self.address}"

  def snapshot(self) -> dict:
    out = {
        "address": self.address,
        "breaker": self.breaker.snapshot(),
        "ejected": self.ejected,
    }
    if self.ejected and self.eject_reason:
      out["eject_reason"] = self.eject_reason
    return out


class Router:
  """Scene-sharded, health-aware request routing over serve backends.

  Args:
    backends: mapping ``backend_id -> "host:port"`` (or an iterable of
      addresses, ids auto-assigned ``b0..bN``).
    replication / vnodes: ring knobs (``ring.HashRing``).
    breaker_threshold / breaker_reset_s: per-backend circuit breaker
      (``serve.resilience.CircuitBreaker`` — consecutive transport-level
      failures open it; backend-*answered* errors like 404 never count).
    render_timeout_s: per-attempt forward timeout; a request tries at
      most ``replication`` attempts, so worst-case latency is bounded by
      ``replication * render_timeout_s``.
    health_timeout_s: per-backend budget for aggregated /healthz and
      /stats fan-outs (a dead backend must cost one short timeout, not
      hang the probe).
    metrics_ttl_s: aggregated-exposition cache TTL (scrape storms fan
      out to the pool once per window, not once per scrape).
    tracer: optional ``obs.Tracer``; router traces use 32-hex W3C trace
      ids so the SAME id appears in the backend's recorded trace.
    transport: injectable request transport (tests); default urllib.
    events: lifecycle event log (``obs.events.EventLog``; a private one
      is made if omitted) — per-backend breaker transitions, failovers,
      eject/readmit edges, served at ``/debug/events`` next to the
      backends'.
    retry_budget_ratio: failover tokens earned per routed request
      (``resilience.RetryBudget``); a brownout that drains the bucket
      degrades to fast 503s instead of R-fold retry amplification.
      <= 0 disables the budget (unbounded failover).
    load_aware: prefer a measurably less-loaded replica over the
      primary. Placement order still wins by default (cache locality);
      the primary is only demoted when fresh ``/stats`` queue depths
      (``note_backend_load`` / ``refresh_load``, stale after
      ``load_ttl_s``) show it at least ``load_threshold`` requests
      deeper than its best replica — safe because replicas render
      bit-identical pixels.
    tsdb: the router-side time-series ring (``obs.tsdb``): pass a
      ``TsdbConfig`` to sample the AGGREGATED exposition on its cadence
      — pooled ``mpi_serve_*`` families plus the router's own — so
      ``GET /debug/tsdb`` answers "what did the fleet's p99 do during
      the last rolling restart" from one process; a pre-built
      ``TsdbRecorder`` is adopted un-started (tests). The same endpoint
      always fans the query out to every backend's ring too.
    slo: client-perceived SLO tracking over the ROUTER'S own request
      stream. The backends' trackers only see
      requests that reach a backend; the 502s of an exhausted replica
      walk and the fast 503s of a drained retry budget are failures
      only the router witnesses — exactly the availability the client
      experiences. Pass an ``SloConfig`` (the default tracks the same
      objectives as a backend), a pre-built ``SloTracker`` (tests
      inject fake clocks), or None to disable. Surfaced as the
      ``router`` entry of the ``/stats`` ``slo`` block, next to the
      fleet summary distilled from the backends.
    clock: one injectable monotonic base for breakers, metrics, the SLO
      tracker, and the exposition cache.
  """

  def __init__(self, backends=None, replication: int = 2, vnodes: int = 64,
               breaker_threshold: int = 3, breaker_reset_s: float = 10.0,
               render_timeout_s: float = 120.0,
               health_timeout_s: float = 2.0, metrics_ttl_s: float = 0.25,
               tracer: Tracer | None = None, transport=None,
               events: EventLog | None = None,
               retry_budget_ratio: float = 0.1,
               retry_budget_initial: float = 10.0,
               load_aware: bool = True, load_ttl_s: float = 5.0,
               load_threshold: int = 4,
               route_cell: float = 0.0,
               route_rot_bucket_deg: float = 10.0,
               tsdb: "tsdb_mod.TsdbConfig | tsdb_mod.TsdbRecorder | None" = None,
               slo: "SloConfig | SloTracker | None" = SloConfig(),
               clock=time.monotonic):
    self.replication = int(replication)
    self.breaker_threshold = int(breaker_threshold)
    self.breaker_reset_s = float(breaker_reset_s)
    self.render_timeout_s = float(render_timeout_s)
    self.health_timeout_s = float(health_timeout_s)
    self.tracer = tracer if tracer is not None else NULL_TRACER
    self.transport = transport if transport is not None else HttpTransport()
    self.events = events if events is not None else EventLog()
    self.retry_budget = (
        RetryBudget(ratio=retry_budget_ratio,
                    initial=retry_budget_initial,
                    cap=max(10.0 * retry_budget_initial, 100.0))
        if retry_budget_ratio > 0 else None)
    self.load_aware = bool(load_aware)
    self.load_ttl_s = float(load_ttl_s)
    self.load_threshold = int(load_threshold)
    # Cell/tile-granular routing (serve/tiles.py + the edge lattice):
    # > 0 quantizes each request's pose into a view cell and places the
    # request by the (scene, cell) ring key, so a hot scene spreads over
    # many backends AND a given cell deterministically lands on the one
    # backend whose edge/tile caches already serve it. 0 keeps the
    # scene-level placement.
    self.route_cell = float(route_cell)
    self.route_rot_bucket_deg = float(route_rot_bucket_deg)
    if self.route_cell > 0 and self.route_rot_bucket_deg <= 0:
      raise ValueError(
          f"route_rot_bucket_deg must be > 0 with cell routing, "
          f"got {route_rot_bucket_deg}")
    self._clock = clock
    if isinstance(slo, SloTracker):
      self.slo = slo
    elif slo is not None:
      self.slo = SloTracker(slo, clock=clock)
    else:
      self.slo = None
    self.metrics = RouterMetrics(clock=clock)
    self._lock = threading.Lock()
    self._backends: dict[str, _Backend] = {}
    self._fanout_pool: ThreadPoolExecutor | None = None  # lazy, reused
    self._load: dict[str, tuple[float, float]] = {}  # bid -> (depth, at)
    self._ring = HashRing(vnodes=vnodes, replication=replication)
    self._metrics_cache = prom.ExpositionCache(
        self._render_metrics_text, ttl_s=metrics_ttl_s, clock=clock)
    # The router's own flight-recorder ring samples the AGGREGATED
    # exposition (fresh renders, not the cache) — fleet history, not one
    # backend's.
    if isinstance(tsdb, tsdb_mod.TsdbRecorder):
      self.tsdb = tsdb
    elif tsdb is not None:
      self.tsdb = tsdb_mod.TsdbRecorder(
          self._render_metrics_text, tsdb).start()
    else:
      self.tsdb = None
    self._closed = False
    self.gossip = None  # GossipNode, via set_gossip (router peering)
    self.lease = None  # supervision lease, via set_lease
    self.incidents = None  # fleet IncidentRecorder, via set_incidents
    if backends:
      items = (backends.items() if isinstance(backends, dict)
               else ((f"b{i}", addr) for i, addr in enumerate(backends)))
      for backend_id, address in items:
        self.add_backend(backend_id, address)

  # -- membership ---------------------------------------------------------

  def add_backend(self, backend_id: str, address: str) -> None:
    backend_id, address = str(backend_id), str(address)
    with self._lock:
      if backend_id in self._backends:
        raise ValueError(f"backend {backend_id!r} already registered")
      def on_transition(old, new, _backend=backend_id):
        if new == CircuitBreaker.OPEN:
          self.metrics.record_breaker_open()
        self.events.emit("breaker", backend=_backend, old=old, new=new)

      breaker = CircuitBreaker(
          failure_threshold=self.breaker_threshold,
          reset_after_s=self.breaker_reset_s, clock=self._clock,
          on_transition=on_transition)
      self._backends[backend_id] = _Backend(backend_id, address, breaker)
      self._ring.add(backend_id)

  def remove_backend(self, backend_id: str) -> None:
    with self._lock:
      self._backends.pop(str(backend_id), None)
      self._ring.remove(str(backend_id))

  def eject(self, backend_id: str, reason: str = "") -> None:
    """Administratively stop routing to a backend (supervisor hook).

    Unlike ``remove_backend`` the ring is untouched — placement (and
    with it every OTHER scene's cache locality) is stable, the backend's
    slots in each replica list are simply skipped without spending an
    attempt. The supervisor ejects before a planned kill (rolling
    restart) and on quarantine; ``readmit`` reverses it. Re-ejecting
    with a NEW reason updates it and logs the edge (a quarantine must
    not be masked by the transient crash reason that preceded it);
    re-ejecting with the same reason is a silent no-op.
    """
    with self._lock:
      backend = self._backends.get(str(backend_id))
      if backend is None:
        return
      unchanged = (backend.ejected
                   and backend.eject_reason == (reason or None))
      backend.ejected = True
      backend.eject_reason = reason or None
    if unchanged:
      return
    self.events.emit("backend_eject", backend=str(backend_id),
                     reason=reason)

  def readmit(self, backend_id: str) -> None:
    """Resume routing to an ejected backend (supervisor hook).

    The breaker is left alone on purpose: if it opened from unplanned
    failures, the standard half-open probe re-closes it — readmit only
    says "the backend may be probed again", not "the backend is good".
    """
    with self._lock:
      backend = self._backends.get(str(backend_id))
      if backend is None or not backend.ejected:
        return
      backend.ejected = False
      backend.eject_reason = None
    self.events.emit("backend_readmit", backend=str(backend_id))

  def ejected(self) -> list[str]:
    with self._lock:
      return sorted(b for b, be in self._backends.items() if be.ejected)

  def breaker_state(self, backend_id: str) -> str | None:
    """The backend's breaker state (None for unknown ids) — what a
    supervisor polls to confirm a restarted backend re-closed."""
    with self._lock:
      backend = self._backends.get(str(backend_id))
      return backend.breaker.state if backend is not None else None

  def backend_ids(self) -> list[str]:
    with self._lock:
      return sorted(self._backends)

  def addresses(self) -> dict[str, str]:
    """``backend_id -> host:port`` for every registered backend (the
    autoscaler's donor list for pre-admit warming)."""
    with self._lock:
      return {b: be.address for b, be in sorted(self._backends.items())}

  # -- elastic membership (the autoscaler's ring actuation) ----------------

  def resize_preview(self, add=(), remove=(), keys=()) -> dict:
    """What ``resize`` WOULD move, without touching the live ring: the
    ``HashRing.resize`` diff computed on a clone. The autoscaler warms a
    new backend's ``after``-assignment from this before admitting it —
    placement must be known pre-admit or warming warms the wrong keys."""
    with self._lock:
      trial = self._ring.clone()
    return trial.resize(add=add, remove=remove, keys=keys)

  def resize(self, add=None, remove=(), keys=()) -> dict:
    """Apply a membership change and return the ``HashRing.resize``
    placement diff for ``keys``.

    ``add`` maps new backend ids to addresses (full ``add_backend``
    registration: fresh breaker, ring points); ``remove`` retires ids
    outright (ring points gone — unlike ``eject``, placement moves, but
    consistent hashing moves ONLY keys whose replica set touched a
    changed backend; the diff is the receipt). The preview-then-apply
    split exists so callers can warm before keys move.
    """
    add = dict(add or {})
    diff = self.resize_preview(add=list(add), remove=remove, keys=keys)
    for backend_id, address in add.items():
      self.add_backend(backend_id, address)
    for backend_id in remove:
      self.remove_backend(backend_id)
    return diff

  # -- router peering (gossip + supervision lease) ------------------------

  def set_gossip(self, node) -> None:
    """Attach the anti-entropy gossip node (the CLI wires this; the
    node's ``on_merge`` should be ``apply_gossip_observations``)."""
    self.gossip = node

  def set_lease(self, lease) -> None:
    """Attach the supervision lease so /stats and /healthz can report
    the current holder (the supervisor drives the lease itself)."""
    self.lease = lease

  def set_incidents(self, recorder) -> None:
    """Attach the ROUTER-side incident recorder (fleet-lifecycle black
    box: quarantines, crash loops, gossip peer deaths, autoscale
    decisions — edges no single backend's recorder can see). Its
    bundles ride ``/debug/incidents`` next to the per-backend rings."""
    self.incidents = recorder

  def gossip_exchange(self, remote: dict) -> dict:
    """The /gossip endpoint body: merge the peer's push, answer with
    this router's state (push-pull in one round trip)."""
    if self.gossip is None:
      raise KeyError("gossip is not enabled on this router")
    return self.gossip.receive(remote)

  def apply_gossip_observations(self, backend_ids) -> None:
    """Fold adopted gossip verdicts into this router's own rotation: a
    peer-observed quarantine/eject takes the backend out WITHOUT this
    router spending breaker probes on the corpse, and a peer-observed
    recovery readmits it. Only administrative flags move — breakers
    stay local judgment."""
    if self.gossip is None:
      return
    for backend_id in backend_ids:
      obs = self.gossip.state.observation(backend_id)
      if obs is None:
        continue
      fields = obs["fields"]
      if fields.get("quarantined"):
        self.eject(backend_id, reason="quarantined (gossip)")
      elif fields.get("ejected"):
        self.eject(backend_id,
                   reason=fields.get("reason") or "ejected (gossip)")
      else:
        self.readmit(backend_id)

  # -- load awareness -----------------------------------------------------

  def note_backend_load(self, backend_id: str, queue_depth: float) -> None:
    """Record one backend's scheduler queue depth (stamped now; stale
    after ``load_ttl_s``). Fed by ``stats()``/``refresh_load()``."""
    with self._lock:
      if str(backend_id) in self._backends:
        self._load[str(backend_id)] = (float(queue_depth), self._clock())

  def _feed_load(self, per_backend: dict) -> dict[str, float]:
    """Record every ``queue_depth`` found in a ``/stats`` fan-out's
    payloads (non-dicts and error entries contribute nothing)."""
    out = {}
    for backend_id, payload in per_backend.items():
      depth = payload.get("queue_depth") if isinstance(payload, dict) \
          else None
      if isinstance(depth, (int, float)):
        self.note_backend_load(backend_id, depth)
        out[backend_id] = float(depth)
    return out

  def refresh_load(self) -> dict[str, float]:
    """One concurrent ``/stats`` fan-out -> queue depths recorded for
    load-aware replica choice (the supervisor's monitor loop calls this;
    any ``stats()`` scrape feeds the same table for free)."""
    return self._feed_load(
        self._fan_out_get("/stats", self.health_timeout_s))

  def _load_ordered(self, replicas: list[_Backend]) -> list[_Backend]:
    """Demote an overloaded primary behind its least-loaded replica.

    Placement order is the default (stable primaries = cache locality);
    the swap only happens on FRESH load data showing the primary at
    least ``load_threshold`` requests deeper than the best replica —
    bit-identical replicas make serving from either one correct.
    """
    if not self.load_aware or len(replicas) < 2:
      return replicas
    now = self._clock()
    depths = {}
    with self._lock:
      for backend in replicas:
        entry = self._load.get(backend.backend_id)
        if entry is not None and now - entry[1] <= self.load_ttl_s:
          depths[backend.backend_id] = entry[0]
    primary = replicas[0]
    if primary.backend_id not in depths:
      return replicas
    if primary.ejected or not primary.breaker.would_allow():
      # The walk skips this primary regardless; "demoting" it would
      # only inflate the reroute counter during its outage window.
      return replicas
    # Only replicas the walk could actually serve from are demotion
    # candidates: fronting an ejected or breaker-refusing replica on
    # its pre-outage depth would count a reroute that never happens —
    # during exactly the supervision windows an operator watches it.
    candidates = [b for b in replicas[1:]
                  if b.backend_id in depths and not b.ejected
                  and b.breaker.would_allow()]
    if not candidates:
      return replicas
    best = min(candidates, key=lambda b: depths[b.backend_id])
    if depths[primary.backend_id] - depths[best.backend_id] \
        < self.load_threshold:
      return replicas
    self.metrics.record_load_reroute()
    return [best] + [b for b in replicas if b is not best]

  def placement(self, scene_id: str, cell: str | None = None) -> list[str]:
    """The scene's (or ``(scene, cell)``'s) replica set (backend ids,
    primary first) — a pure function of the backend set, identical
    across router replicas."""
    with self._lock:
      return self._ring.placement(str(scene_id), tile=cell)

  def request_cell(self, req: dict) -> str | None:
    """The view-cell token for one parsed ``/render`` body, or None.

    None when cell routing is off or the pose is missing/malformed —
    a request the backend will 400 anyway must not fail in the router's
    placement math, it just rides the scene-level key.
    """
    if self.route_cell <= 0:
      return None
    try:
      pose = np.asarray(req.get("pose"), np.float32)
      if pose.shape != (4, 4) or not np.isfinite(pose).all():
        return None
      cell = edge_lattice.quantize_pose(pose, self.route_cell,
                                        self.route_rot_bucket_deg)
    except (TypeError, ValueError):
      return None
    return ",".join(str(c) for c in cell)

  def _replicas(self, scene_id: str,
                cell: str | None = None) -> list[_Backend]:
    with self._lock:
      if cell is None:
        return [self._backends[b]
                for b in self._ring.placement(str(scene_id))
                if b in self._backends]
      cell_place = self._ring.placement(str(scene_id), tile=cell)
      out = [self._backends[b] for b in cell_place if b in self._backends]
      # The scene-level PRIMARY alone feeds the reroute counter —
      # primary() is the O(log n) first-point lookup, not a second
      # replica walk.
      scene_primary = self._ring.primary(str(scene_id))
    # Affinity accounting: the reroute counter says how often the
    # (scene, cell) key actually moved the request off the scene-level
    # primary — the cache-locality dividend an operator watches.
    self.metrics.record_cell_route(
        rerouted=bool(cell_place and scene_primary is not None
                      and cell_place[0] != scene_primary))
    return out

  # -- request path -------------------------------------------------------

  def forward_render(self, scene_id: str, body: bytes,
                     accept: str | None = None, trace_id: str | None = None,
                     trace=NULL_TRACE,
                     if_none_match: str | None = None,
                     cell: str | None = None,
                     request_class: str | None = None) -> tuple[int, dict,
                                                                bytes]:
    """Route one ``/render`` body to the scene's replica set.

    ``cell`` (``request_cell``'s token, when cell routing is on) keys
    the placement on ``(scene, cell)`` instead of the scene alone: one
    hot scene spreads over many backends, and every request for a view
    cell deterministically prefers the backend whose edge/tile caches
    last served that cell (reroutes counted in
    ``mpi_cluster_cell_reroutes_total``).

    ``if_none_match`` forwards the client's revalidation header so a
    backend's edge cache can answer 304 without rendering — the router
    stays a pure conditional-request conduit (the backend owns ETag
    identity; 304s ride back like any other answered status).

    ``request_class`` forwards the client's ``X-Request-Class`` header
    so a browned-out backend's priority admission sees the class the
    client declared — the router never reclassifies traffic.

    Walks the placement list primary-first (load-aware demotion may
    front a measurably idler replica), skipping ejected backends
    (administratively down: quarantined or mid-rolling-restart) and
    backends whose breaker refuses (an ``allow_primary()`` True from a
    non-closed breaker IS the half-open probe; its outcome re-closes or
    re-opens that backend's circuit). Transport failures, 5xx statuses,
    and malformed response bodies count against the backend's breaker
    and fail over to the next replica — each failover past the first
    attempt withdraws from the fleet-wide ``RetryBudget``; an empty
    bucket stops the walk (fast 503, no amplification). A backend that
    *answers* with 4xx is healthy — its response is returned as-is and
    its breaker resets.

    Returns ``(status, headers, body)`` of the winning response.
    Raises ``AllReplicasOpenError`` (-> 503 + Retry-After) when every
    replica was ejected or breaker-refused, ``RetryBudgetExhaustedError``
    (-> 503) when the failover budget ran dry mid-walk,
    ``ReplicasExhaustedError`` (-> 502) when every attempt failed,
    ``KeyError`` when the ring is empty.
    """
    t0 = self._clock()
    self.metrics.record_request()
    if self.retry_budget is not None:
      self.retry_budget.deposit()
    replicas = self._replicas(scene_id, cell=cell)
    if not replicas:
      self._slo_bad()
      raise KeyError("no backends registered")
    replicas = self._load_ordered(replicas)
    trace_id = trace_id or new_trace_id_32()
    headers = {
        "Content-Type": "application/json",
        "traceparent": make_traceparent(trace_id),
    }
    if accept:
      headers["Accept"] = accept
    if if_none_match:
      headers["If-None-Match"] = if_none_match
    if request_class:
      headers[brownout_mod.REQUEST_CLASS_HEADER] = request_class
    attempts: list[str] = []
    retry_afters: list[float] = []
    tried_any = False
    for backend in replicas:
      if backend.ejected:
        retry_afters.append(1.0)  # supervised restarts are seconds-scale
        continue
      if not backend.breaker.allow_primary():
        retry_afters.append(backend.breaker.retry_after_s())
        continue
      if tried_any:
        if (self.retry_budget is not None
            and not self.retry_budget.try_withdraw()):
          # allow_primary() above may have claimed this backend's
          # half-open probe slot; a budget refusal says nothing about
          # the device, so free the slot or the breaker wedges in
          # HALF_OPEN forever (no other caller feeds it).
          backend.breaker.release_probe()
          self.metrics.record_retry_budget_exhausted()
          self._slo_bad()
          raise RetryBudgetExhaustedError(scene_id, attempts)
        self.metrics.record_failover()
        self.events.emit("failover", scene_id=str(scene_id),
                         to_backend=backend.backend_id)
      tried_any = True
      span = trace.start_span("forward", backend=backend.backend_id,
                              address=backend.address)
      outcome_recorded = False
      try:
        try:
          status, resp_headers, resp_body = self.transport.request(
              "POST", backend.base_url + "/render", body=body,
              headers=headers, timeout=self.render_timeout_s)
        except ConnectionError as e:
          backend.breaker.record_failure()
          outcome_recorded = True
          attempts.append(f"{backend.backend_id}: unreachable ({e})")
          trace.end_span(span, error=f"unreachable: {e}")
          continue
        if status >= 500:
          backend.breaker.record_failure()
          outcome_recorded = True
          attempts.append(f"{backend.backend_id}: HTTP {status}")
          trace.end_span(span, error=f"HTTP {status}")
          continue
        if status == 200:
          reason = self._validate_render_body(resp_headers, resp_body)
          if reason is not None:
            # A 200 carrying garbage is a sick backend (half-dead
            # process, truncating proxy): never forward it — the client
            # gets a clean 502 or a replica's good pixels, and the
            # garbage counts toward THIS backend's breaker.
            backend.breaker.record_failure()
            outcome_recorded = True
            self.metrics.record_bad_response()
            attempts.append(f"{backend.backend_id}: bad body ({reason})")
            trace.end_span(span, error=f"bad body: {reason}")
            continue
        backend.breaker.record_success()
        outcome_recorded = True
        self.metrics.record_forward(backend.backend_id)
        trace.end_span(span, status=status)
        if self.slo is not None:
          # The client got an answer: good for availability (a backend-
          # judged 4xx is the CLIENT's error), timed end to end — queue
          # time on a hot replica walk counts against latency here even
          # though no single backend saw it.
          self.slo.record(ok=True, latency_s=self._clock() - t0)
        resp_headers = dict(resp_headers)
        resp_headers["X-Backend-Id"] = backend.backend_id
        return status, resp_headers, resp_body
      finally:
        if not outcome_recorded:
          # An unexpected exception in the router itself says nothing
          # about the backend: free a claimed half-open probe slot so
          # the breaker cannot wedge in HALF_OPEN.
          backend.breaker.release_probe()
    self._slo_bad()
    if not tried_any:
      self.metrics.record_breaker_fastfail()
      raise AllReplicasOpenError(
          scene_id, min(retry_afters) if retry_afters else 0.0)
    self.metrics.record_replica_exhausted()
    raise ReplicasExhaustedError(scene_id, attempts)

  def _slo_bad(self) -> None:
    """One client-perceived failure (502/503 the backends never saw)."""
    if self.slo is not None:
      self.slo.record_bad()

  def forward_scene_get(self, scene_id: str, path: str,
                        if_none_match: str | None = None,
                        kind: str = "manifest") \
      -> tuple[int, dict, bytes]:
    """Route an asset-tier GET (manifest / viewer / asset) to the
    scene's replicas.

    The walk is ``forward_render``'s shape (placement order first,
    ejected and breaker-refused replicas skipped, transport failures
    and 5xx count against the backend's breaker and fail over) with one
    twist: an answered 404 does not end the walk. It continues through
    the FULL backend set — content addressing means ANY backend still
    holding the digest (e.g. the old generation's bytes mid-rollout)
    may answer an asset GET, and a joined fleet's scenes live on
    backends placement never chose; a 404 is only final when every
    reachable backend said so. ``kind`` ("manifest" for manifest/viewer
    pages, "asset" for digest-addressed bytes) picks the metric family;
    fan-out accounting (``asset_fanouts`` / ``asset_misses``) tracks
    the asset walks, where cross-generation scatter is the signal.
    Conditional headers forward untouched: 304s ride back like any
    answered status.

    Raises ``AllReplicasOpenError`` / ``ReplicasExhaustedError`` /
    ``KeyError`` exactly like ``forward_render``.
    """
    self.metrics.record_scene_get(kind)
    replicas = self._replicas(scene_id)
    with self._lock:
      placed = {b.backend_id for b in replicas}
      replicas = replicas + [b for b in self._backends.values()
                             if b.backend_id not in placed]
    if not replicas:
      raise KeyError("no backends registered")
    headers = {}
    if if_none_match:
      headers["If-None-Match"] = if_none_match
    attempts: list[str] = []
    retry_afters: list[float] = []
    tried_any = False
    missed: tuple[int, dict, bytes] | None = None
    for backend in replicas:
      if backend.ejected:
        retry_afters.append(1.0)
        continue
      if not backend.breaker.allow_primary():
        retry_afters.append(backend.breaker.retry_after_s())
        continue
      tried_any = True
      try:
        status, resp_headers, resp_body = self.transport.request(
            "GET", backend.base_url + path, headers=headers or None,
            timeout=self.render_timeout_s)
      except ConnectionError as e:
        backend.breaker.record_failure()
        attempts.append(f"{backend.backend_id}: unreachable ({e})")
        continue
      if status >= 500:
        backend.breaker.record_failure()
        attempts.append(f"{backend.backend_id}: HTTP {status}")
        continue
      backend.breaker.record_success()
      if status == 404:
        # This backend doesn't hold the digest/scene; remember the miss
        # and keep walking — another may.
        if kind == "asset":
          self.metrics.record_asset_fanout()
        missed = (status, dict(resp_headers), resp_body)
        attempts.append(f"{backend.backend_id}: HTTP 404")
        continue
      self.metrics.record_forward(backend.backend_id)
      resp_headers = dict(resp_headers)
      resp_headers["X-Backend-Id"] = backend.backend_id
      return status, resp_headers, resp_body
    if missed is not None:
      if kind == "asset":
        self.metrics.record_asset_miss()
      return missed
    if not tried_any:
      self.metrics.record_breaker_fastfail()
      raise AllReplicasOpenError(
          scene_id, min(retry_afters) if retry_afters else 0.0)
    self.metrics.record_replica_exhausted()
    raise ReplicasExhaustedError(scene_id, attempts)

  def scenes(self) -> dict:
    """The fleet's scene index (``GET /scenes``): the union of every
    backend's registered ids — what a ``SceneFetcher`` pointed at the
    router sweeps."""
    union: set[str] = set()
    for result in self._fan_out_get("/scenes",
                                    self.health_timeout_s).values():
      union.update(result.get("scenes") or [])
    return {"scenes": sorted(union)}

  @staticmethod
  def _validate_render_body(headers: dict, body: bytes) -> str | None:
    """Why a 200 response body is unusable, or None when it checks out.

    Cheap structural checks only (no base64 decode of megapixels): JSON
    parses to an object with the response contract's keys and a b64
    payload whose LENGTH matches the shape; binary bodies match their
    shape headers byte-for-byte. Catches truncation (killed backend,
    broken proxy) and non-JSON garbage.
    """
    ctype = ""
    for key, value in headers.items():
      if key.lower() == "content-type":
        ctype = value
        break
    if "application/octet-stream" in ctype:
      shape_hdr = next((v for k, v in headers.items()
                        if k.lower() == "x-image-shape"), "")
      try:
        shape = [int(d) for d in shape_hdr.split(",")]
        want = 4  # <f4 itemsize
        for d in shape:
          want *= d
      except ValueError:
        return f"unparseable X-Image-Shape {shape_hdr!r}"
      if not shape or want <= 0:
        return f"degenerate X-Image-Shape {shape_hdr!r}"
      if len(body) != want:
        return f"binary body is {len(body)} bytes, shape says {want}"
      return None
    try:
      payload = json.loads(body)
    except (ValueError, UnicodeDecodeError):
      return "unparseable JSON"
    if not isinstance(payload, dict):
      return f"JSON body is {type(payload).__name__}, not an object"
    missing = {"scene_id", "shape", "image_b64"} - set(payload)
    if missing:
      return f"missing keys {sorted(missing)}"
    try:
      nbytes = 4
      for d in payload["shape"]:
        nbytes *= int(d)
      want_b64 = 4 * ((nbytes + 2) // 3)
    except (TypeError, ValueError):
      return f"unparseable shape {payload['shape']!r}"
    b64 = payload["image_b64"]
    if not isinstance(b64, str) or len(b64) != want_b64:
      got = len(b64) if isinstance(b64, str) else type(b64).__name__
      return f"image_b64 length {got} != expected {want_b64}"
    return None

  # -- aggregated observability ------------------------------------------

  def _fan_out_each(self, fn) -> dict[str, object]:
    """Run ``fn(backend)`` against every backend CONCURRENTLY.

    One slow or timing-out backend must cost its own per-backend
    timeout, not stall the whole fleet scrape behind it (a serial walk made an aggregated ``/healthz`` take
    ``backends x health_timeout_s`` during a partial outage). Results
    keep deterministic backend order; a raising ``fn`` yields the
    exception object as that backend's value.
    """
    with self._lock:
      backends = list(self._backends.values())
    if not backends:
      return {}
    if len(backends) == 1:  # no pool thread for a pool of one
      backend = backends[0]
      try:
        return {backend.backend_id: fn(backend)}
      except Exception as e:  # noqa: BLE001 - caller classifies
        return {backend.backend_id: e}

    def safe(backend):
      try:
        return fn(backend)
      except Exception as e:  # noqa: BLE001 - caller classifies
        return e

    # One long-lived pool, not an executor per scrape: a monitoring
    # stack polling /healthz + /stats + /metrics at a few Hz (plus the
    # supervisor's load refresh) must not churn thread create/join for
    # identical work on every call. A scrape racing close() must not
    # resurrect a pool on a closed router (leaked threads) or 500 on
    # the shut-down executor — it degrades to the serial walk instead.
    with self._lock:
      if self._fanout_pool is None and not self._closed:
        self._fanout_pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="mpi-router-fanout")
      pool = self._fanout_pool
    if pool is not None:
      try:
        results = list(pool.map(safe, backends))
        return {b.backend_id: r for b, r in zip(backends, results)}
      except RuntimeError:  # executor shut down between capture and map
        pass
    return {b.backend_id: safe(b) for b in backends}

  def _fan_out_get(self, path: str, timeout: float) -> dict[str, dict]:
    """GET ``path`` from every backend (concurrently) ->
    ``{backend_id: result}`` where result is the parsed JSON body or
    ``{"error": ...}``."""
    def one(backend):
      _, _, body = self.transport.request(
          "GET", backend.base_url + path, timeout=timeout)
      payload = json.loads(body)
      if not isinstance(payload, dict):
        raise ValueError(f"non-object JSON ({type(payload).__name__})")
      return payload

    out: dict[str, dict] = {}
    for backend_id, result in self._fan_out_each(one).items():
      if isinstance(result, dict):
        out[backend_id] = result
      elif isinstance(result, (ConnectionError, ValueError,
                               UnicodeDecodeError)):
        out[backend_id] = {"error": str(result) or repr(result)}
      else:
        raise result  # a router bug, not a backend failure
    return out

  def healthz(self) -> dict:
    """The aggregated health machine: ok / degraded / unhealthy.

    ``degraded`` — not ``unhealthy`` — while any backend is down or
    non-ok but at least one backend still answers: replicas are covering
    (or will fast-fail crisply), and a liveness probe that killed the
    router over one lost backend would turn a partial outage into a
    total one. ``unhealthy`` only when the router itself is closed or
    NO backend is reachable.
    """
    per_backend = self._fan_out_get("/healthz", self.health_timeout_s)
    with self._lock:
      breakers = {b: be.breaker.snapshot()
                  for b, be in self._backends.items()}
      ejected = sorted(b for b, be in self._backends.items() if be.ejected)
    statuses = {b: h.get("status", "unreachable")
                for b, h in per_backend.items()}
    reachable = [b for b, h in per_backend.items() if "error" not in h]
    bad = sorted(b for b, s in statuses.items() if s != "ok")
    open_breakers = sorted(b for b, s in breakers.items()
                           if s["state"] != CircuitBreaker.CLOSED)
    if self._closed:
      status, reason = "unhealthy", "router closed"
    elif not per_backend:
      status, reason = "unhealthy", "no backends registered"
    elif not reachable:
      status, reason = "unhealthy", "no backend reachable"
    elif bad or open_breakers:
      status = "degraded"
      parts = []
      if bad:
        parts.append(f"backends not ok: {', '.join(bad)}")
      if open_breakers:
        parts.append(f"breakers non-closed: {', '.join(open_breakers)}")
      reason = ("; ".join(parts)
                + f"; {len(reachable)}/{len(per_backend)} backends "
                  "serving (replicas cover sharded scenes)")
    else:
      status, reason = "ok", None
    out = {
        "status": status,
        "backends": {b: statuses[b] for b in sorted(statuses)},
        "backends_total": len(per_backend),
        "backends_reachable": len(reachable),
        "replication": self.replication,
        "breakers": {b: breakers[b] for b in sorted(breakers)},
        "ejected": ejected,
    }
    if self.gossip is not None:
      gsnap = self.gossip.snapshot()
      out["peers"] = {p: e["ok"] for p, e in gsnap["peers"].items()}
      out["supervision_lease"] = gsnap["lease"]
    if self.lease is not None:
      out["supervision_lease"] = self.lease.holder()
    if reason is not None:
      out["reason"] = reason
    return out

  def stats(self) -> dict:
    """Aggregated ``/stats``: the router's own counters + every
    backend's snapshot (or its fan-out error), plus the fleet-level SLO
    summary distilled from the backends' ``slo`` blocks. The fan-out's
    queue depths feed the load-aware replica table for free."""
    per_backend = self._fan_out_get("/stats", self.health_timeout_s)
    self._feed_load(per_backend)
    with self._lock:
      backends = {b: be.snapshot() for b, be in self._backends.items()}
    slo_block = self._slo_summary(per_backend)
    if self.slo is not None:
      # The router's OWN client-perceived stream: includes the 502s and
      # retry-budget 503s no backend tracker ever saw.
      slo_block["router"] = self.slo.snapshot()
    out = {
        "router": self.metrics.snapshot(),
        "backend_info": {b: backends[b] for b in sorted(backends)},
        "backends": {b: per_backend[b] for b in sorted(per_backend)},
        "slo": slo_block,
        "brownout": self._brownout_summary(per_backend),
        "attrib": self._attrib_summary(per_backend),
    }
    if self.retry_budget is not None:
      out["retry_budget"] = self.retry_budget.snapshot()
    if self.gossip is not None:
      out["gossip"] = self.gossip.snapshot()
    if self.lease is not None:
      out["supervision_lease"] = self.lease.holder()
    return out

  @staticmethod
  def _slo_summary(per_backend_stats: dict) -> dict:
    """Fleet SLO judgment from the backends' own ``slo`` blocks: which
    backends have alerts firing, the hottest fast-window burn per
    objective, and the pool-weighted slow-window attainment (total good
    over total scored — the number a fleet report card quotes)."""
    firing: dict[str, list[str]] = {}
    worst: dict[str, dict] = {}
    totals: dict[str, list[int]] = {}
    reporting = 0
    for backend_id in sorted(per_backend_stats):
      st = per_backend_stats[backend_id]
      slo = st.get("slo") if isinstance(st, dict) else None
      if not isinstance(slo, dict) or "objectives" not in slo:
        continue
      reporting += 1
      for name in slo.get("alerts_firing", []):
        firing.setdefault(backend_id, []).append(name)
      for name, obj in slo["objectives"].items():
        burn = obj["fast"]["burn_rate"]
        if name not in worst or burn > worst[name]["fast_burn"]:
          worst[name] = {"backend": backend_id,
                         "fast_burn": burn,
                         "slow_burn": obj["slow"]["burn_rate"]}
        tot = totals.setdefault(name, [0, 0])
        tot[0] += obj["slow"]["requests"]
        tot[1] += obj["slow"]["bad"]
    return {
        "backends_reporting": reporting,
        "alerts_firing": firing,
        "worst": worst,
        "attainment": {
            name: {"requests": tot[0], "bad": tot[1],
                   "attained": (round(1.0 - tot[1] / tot[0], 6)
                                if tot[0] else None)}
            for name, tot in sorted(totals.items())
        },
    }

  @staticmethod
  def _brownout_summary(per_backend_stats: dict) -> dict:
    """Fleet brownout judgment from the backends' ``brownout`` blocks:
    the hottest ladder level anywhere (the number a dashboard's
    single-stat panel shows), per-backend levels for the browned-out
    set, and pooled shed/degrade totals. Backends running without the
    controller report ``enabled: false`` and count only toward
    ``backends_reporting``."""
    levels: dict[str, int] = {}
    sheds: dict[str, int] = {}
    degraded = 0
    reporting = enabled = 0
    for backend_id in sorted(per_backend_stats):
      st = per_backend_stats[backend_id]
      bo = st.get("brownout") if isinstance(st, dict) else None
      if not isinstance(bo, dict):
        continue
      reporting += 1
      if not bo.get("enabled"):
        continue
      enabled += 1
      level = int(bo.get("level", 0))
      if level > 0:
        levels[backend_id] = level
      for cls, n in (bo.get("sheds") or {}).items():
        sheds[cls] = sheds.get(cls, 0) + int(n)
      degraded += sum(int(n) for n in (bo.get("degraded") or {}).values())
    return {
        "backends_reporting": reporting,
        "backends_enabled": enabled,
        "max_level": max(levels.values(), default=0),
        "levels": levels,
        "sheds": sheds,
        "degraded_total": degraded,
    }

  @staticmethod
  def _attrib_summary(per_backend_stats: dict) -> dict:
    """The fleet attribution ledger: every reporting backend's
    ``attrib`` block merged cell-wise (``obs.attrib.merge_snapshots``) —
    the same aggregation the pool-summed ``mpi_serve_attrib_*`` families
    get in ``/metrics``, here with the cells as JSON. Backends running
    without the ledger simply contribute nothing."""
    return attrib_mod.merge_snapshots(
        st.get("attrib") for st in per_backend_stats.values()
        if isinstance(st, dict))

  def attrib_snapshot(self) -> dict:
    """The aggregated ``/debug/attrib``: every backend's ledger (one
    fan-out) plus the fleet merge — who is eating the fleet, by cell."""
    per_backend = self._fan_out_get("/debug/attrib",
                                    self.health_timeout_s)
    return {
        "fleet": attrib_mod.merge_snapshots(
            st for st in per_backend.values()
            if isinstance(st, dict) and "error" not in st),
        "backends": {b: per_backend[b] for b in sorted(per_backend)},
    }

  def incidents_snapshot(self, incident_id: str | None = None) -> dict:
    """The aggregated ``/debug/incidents``: every backend's bundle ring
    index (or, with ``incident_id``, the full bundle from whichever
    backends hold it — ids are per-backend sequences, so several may).
    Backends running without a recorder contribute their 503 body."""
    qs = "/debug/incidents"
    if incident_id:
      qs += f"?id={urllib.parse.quote(str(incident_id))}"
    per_backend = self._fan_out_get(qs, self.health_timeout_s)
    out: dict = {"backends": {b: per_backend[b]
                              for b in sorted(per_backend)}}
    if incident_id and self.incidents is not None:
      # Fleet-lifecycle bundles live router-side; the id may name one
      # of ours instead of (or as well as) a backend's.
      try:
        out["router"] = self.incidents.get(incident_id)
      except KeyError:
        pass
    elif self.incidents is not None:
      out["router"] = {"incidents": self.incidents.list(),
                       "stats": self.incidents.stats()}
    if not incident_id:
      out["incidents_total"] = sum(
          len(st.get("incidents") or []) for st in per_backend.values()
          if isinstance(st, dict)) + (
              len(self.incidents.list()) if self.incidents is not None
              else 0)
    return out

  def events_snapshot(self, recent: int = 128) -> dict:
    """The aggregated ``/debug/events``: the router's own lifecycle log
    plus every backend's (one fan-out; a dead backend contributes its
    error entry) — the single place an incident review starts."""
    per_backend = self._fan_out_get(
        f"/debug/events?recent={int(recent)}", self.health_timeout_s)
    return {
        "router": self.events.snapshot(recent=recent),
        "backends": {b: per_backend[b] for b in sorted(per_backend)},
    }

  def find_trace(self, trace_id: str) -> dict:
    """One trace id -> the stitched cross-process span view.

    The router's outbound ``traceparent`` puts the SAME 32-hex id on its
    own recorded trace and on every backend that served a forward, so a
    single fan-out of ``/debug/traces?id=`` reassembles the distributed
    tree from one endpoint — no grepping N hosts.
    """
    per_backend = self._fan_out_get(
        f"/debug/traces?id={urllib.parse.quote(trace_id)}",
        self.health_timeout_s)
    backends = {}
    spans = 0
    for backend_id in sorted(per_backend):
      payload = per_backend[backend_id]
      traces = payload.get("traces") if isinstance(payload, dict) else None
      if traces:
        backends[backend_id] = traces
        spans += sum(len(t.get("spans", [])) for t in traces)
    router_traces = self.tracer.find(trace_id)
    spans += sum(len(t.get("spans", [])) for t in router_traces)
    return {
        "trace_id": trace_id,
        "router": router_traces,
        "backends": backends,
        "processes": (1 if router_traces else 0) + len(backends),
        "spans_total": spans,
    }

  def tsdb_snapshot(self, family: str | None = None,
                    recent_s: float | None = None,
                    points: int | None = None) -> dict:
    """The aggregated ``/debug/tsdb``: the router's own ring (fleet-level
    pooled families, when configured) next to every backend's ring — one
    query reads the whole fleet's history ("what did p99 look like
    during the last rolling restart").
    """
    if family:
      qs = f"/debug/tsdb?family={urllib.parse.quote(str(family))}"
      if recent_s is not None:
        qs += f"&recent={float(recent_s):g}"
      if points is not None:
        qs += f"&points={int(points)}"
      per_backend = self._fan_out_get(qs, self.health_timeout_s)
      router_view = (self.tsdb.query(family, recent_s=recent_s,
                                     points=points)
                     if self.tsdb is not None else None)
    else:
      per_backend = self._fan_out_get("/debug/tsdb",
                                      self.health_timeout_s)
      router_view = ({"families": self.tsdb.families(),
                      "stats": self.tsdb.stats()}
                     if self.tsdb is not None else None)
    return {
        "family": family,
        "router": router_view,
        "backends": {b: per_backend[b] for b in sorted(per_backend)},
    }

  def _cluster_registry(self, pooled_request_hist: dict | None = None) \
      -> prom.Registry:
    snap = self.metrics.snapshot()
    with self._lock:
      backends = list(self._backends.values())
    reg = prom.Registry()
    p = "mpi_cluster_"
    reg.gauge(p + "backends", "Backends registered on the ring.",
              len(backends))
    reg.counter(p + "requests_total", "Render requests routed.",
                snap["requests"])
    fwd = reg.counter(p + "forwards_total",
                      "Successful forwards per backend.")
    for backend_id in sorted(snap["forwards"]):
      fwd.sample(snap["forwards"][backend_id], {"backend": backend_id})
    reg.counter(p + "failovers_total",
                "Attempts that fell over to a replica.", snap["failovers"])
    reg.counter(p + "bad_responses_total",
                "200-status backend bodies rejected by validation.",
                snap["bad_responses"])
    reg.counter(p + "replica_exhausted_total",
                "Requests that failed every replica (502).",
                snap["replica_exhausted"])
    reg.counter(p + "breaker_fastfails_total",
                "Requests refused by every replica's breaker (503).",
                snap["breaker_fastfails"])
    reg.counter(p + "breaker_opens_total",
                "Per-backend breaker CLOSED->OPEN transitions.",
                snap["breaker_opens"])
    restarts = reg.counter(
        p + "restarts_total",
        "Supervisor backend respawns (crash/wedge recovery, "
        "rolling-restart steps, readmits).")
    for backend_id in sorted(snap["restarts"]):
      restarts.sample(snap["restarts"][backend_id], {"backend": backend_id})
    quarantines = reg.counter(
        p + "quarantines_total",
        "Backends quarantined after exhausting their restart budget.")
    for backend_id in sorted(snap["quarantines"]):
      quarantines.sample(snap["quarantines"][backend_id],
                         {"backend": backend_id})
    reg.counter(p + "load_reroutes_total",
                "Requests routed to a less-loaded replica over the "
                "primary.", snap["load_reroutes"])
    reg.counter(p + "retry_budget_exhausted_total",
                "Failover walks stopped by an empty retry budget (503).",
                snap["retry_budget_exhausted"])
    reg.counter(p + "cell_routes_total",
                "Requests placed by their (scene, view-cell) ring key "
                "(tile-granular routing).", snap["cell_routes"])
    reg.counter(p + "cell_reroutes_total",
                "Cell-keyed placements whose primary differed from the "
                "scene-level primary (affinity moved the request).",
                snap["cell_reroutes"])
    reg.counter(p + "session_proxies_total",
                "Streaming sessions tunneled to a backend (POST "
                "/session; cell-affine when the hello carries a pose).",
                snap["session_proxies"])
    reg.counter(p + "scene_sync_manifest_forwards_total",
                "Scene manifest/viewer GETs routed to a replica.",
                snap["scene_sync"]["manifest_forwards"])
    reg.counter(p + "scene_sync_asset_forwards_total",
                "Digest-addressed asset GETs routed to a replica.",
                snap["scene_sync"]["asset_forwards"])
    reg.counter(p + "scene_sync_asset_fanouts_total",
                "Asset GETs that walked past a replica's 404 (content "
                "addressing lets any digest holder answer).",
                snap["scene_sync"]["asset_fanouts"])
    reg.counter(p + "scene_sync_asset_misses_total",
                "Asset GETs 404'd by every reachable backend.",
                snap["scene_sync"]["asset_misses"])
    reg.counter(p + "scene_sync_asset_revalidations_total",
                "Asset GETs answered 304 at the router itself "
                "(If-None-Match named the digest's ETag — content "
                "addressing proves freshness without a backend).",
                snap["scene_sync"]["asset_revalidations"])
    reg.counter(p + "gossip_rounds_total",
                "Anti-entropy gossip rounds this router initiated.",
                snap["gossip_rounds"])
    reg.counter(p + "gossip_merges_total",
                "Peer observations adopted by newest-wins merge.",
                snap["gossip_merges"])
    reg.counter(p + "gossip_conflicts_total",
                "Equal-version gossip disagreements (broken "
                "deterministically by origin id).",
                snap["gossip_conflicts"])
    reg.counter(p + "gossip_peer_failures_total",
                "Gossip rounds that could not reach a peer router.",
                snap["gossip_peer_failures"])
    reg.gauge(p + "supervisor_lease_held",
              "1 while this router holds the fleet-supervision lease.",
              snap["supervisor_lease_held"])
    reg.counter(p + "supervisor_takeovers_total",
                "Supervision leases adopted from a dead or wedged peer "
                "router.", snap["supervisor_takeovers"])
    reg.counter(p + "autoscale_up_total",
                "Executed scale-ups (backend spawned, warmed, and "
                "admitted to the ring).", snap["autoscale"]["ups"])
    reg.counter(p + "autoscale_down_total",
                "Executed scale-downs (drainless eject -> drain -> "
                "SIGTERM -> retire).", snap["autoscale"]["downs"])
    reg.counter(p + "autoscale_aborts_total",
                "Scale actuations abandoned (spawn/warm failure, or a "
                "stranded scale-out reaped after leaseholder death).",
                snap["autoscale"]["aborts"])
    reg.counter(p + "autoscale_budget_denied_total",
                "Autoscale decisions refused by the per-window scaling "
                "budget (flap guard).",
                snap["autoscale"]["budget_denied"])
    if self.retry_budget is not None:
      reg.gauge(p + "retry_budget_tokens",
                "Failover tokens currently in the retry budget.",
                self.retry_budget.snapshot()["tokens"])
    up = reg.gauge(p + "backend_up",
                   "1 while the backend's breaker is closed and it is "
                   "not ejected.")
    for backend in sorted(backends, key=lambda b: b.backend_id):
      up.sample(1 if (backend.breaker.state == CircuitBreaker.CLOSED
                      and not backend.ejected) else 0,
                {"backend": backend.backend_id})
    # Pooled request-latency quantiles, estimated from the POOL-MERGED
    # native histogram (per-idx bucket sums are the exact merge — the
    # per-backend quantile gauges are dropped because summing p99s is
    # garbage, but the merged buckets give the fleet's true quantiles).
    pooled = reg.gauge(
        p + "request_quantile_seconds",
        "Fleet request-latency quantiles from the pool-merged native "
        "histogram (NaN while idle), label q.")
    for q in hist_mod.QUANTILES:
      pooled.sample(hist_mod.quantile_of(pooled_request_hist, q),
                    {"q": hist_mod.q_label(q)})
    return reg

  def _render_metrics_text(self) -> str:
    def one(backend):
      # ?exemplars=1: the backend's default exposition strips exemplars
      # for vanilla scrapers; the router wants them so they survive the
      # pool merge (its own /metrics strips them again by default).
      status, _, body = self.transport.request(
          "GET", backend.base_url + "/metrics?exemplars=1",
          timeout=self.health_timeout_s)
      return body.decode("utf-8", "replace") if status == 200 else None

    scraped = self._fan_out_each(one)
    texts = []
    for backend_id in sorted(scraped):
      result = scraped[backend_id]
      if isinstance(result, str):
        texts.append(result)
      elif isinstance(result, Exception) and not isinstance(
          result, ConnectionError):
        raise result  # a dead backend contributes nothing; a bug raises
    from mpi_vision_tpu_torch.obs import slo as slo_mod

    # Ratio/target SLO gauges and per-backend quantile gauges are
    # per-backend statements — summing them exports garbage (and one
    # idle backend's NaN poisons the sample); the summable mpi_slo_*
    # slices and the native-histogram buckets still aggregate (the
    # buckets EXACTLY: shared idx space, counts add). The brownout
    # LEVEL gauge is likewise per-backend (a sum of ladder levels means
    # nothing); /stats carries the per-backend levels and fleet max.
    parsed: dict = {}
    agg = prom.aggregate_metrics_texts(
        texts,
        drop=(slo_mod.NON_ADDITIVE_FAMILIES | hist_mod.NON_ADDITIVE_FAMILIES
              | brownout_mod.NON_ADDITIVE_FAMILIES),
        collect=parsed)
    pooled_hists = hist_mod.snapshots_from_samples(
        parsed.get("mpi_serve_request_latency_nativehist",
                   {}).get("samples", {}))
    return agg + self._cluster_registry(
        pooled_request_hist=pooled_hists.get(())).render()

  def metrics_text(self) -> str:
    """Aggregated ``/metrics``: pool-summed ``mpi_serve_*`` families plus
    the router's ``mpi_cluster_*`` families, memoized ``metrics_ttl_s``."""
    return self._metrics_cache.get()

  def close(self) -> None:
    self._closed = True
    if self.tsdb is not None:
      self.tsdb.stop()
    with self._lock:
      pool, self._fanout_pool = self._fanout_pool, None
    if pool is not None:
      pool.shutdown(wait=False)

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


# Response headers forwarded verbatim from the winning backend (plus the
# router's own X-Trace-Id / X-Backend-Id). Hop-by-hop headers like
# Content-Length are recomputed by the sender. ETag / Cache-Control /
# X-Edge-Cache carry the backend edge cache's HTTP caching contract
# through the router so browsers and CDNs fronting the FLEET revalidate
# exactly like ones fronting a single backend.
_FORWARD_HEADERS = ("Content-Type", "X-Image-Shape", "X-Image-Dtype",
                    "X-Scene-Id", "Retry-After", "ETag", "Cache-Control",
                    "X-Edge-Cache", "X-Asset-Encoding",
                    brownout_mod.DEGRADED_HEADER, brownout_mod.LEVEL_HEADER)

# The asset-tier GET surface a backend exposes (serve/server.py) — the
# router mirrors it so a SceneFetcher or browser pointed at the fleet
# sees one scene-asset origin.
_SCENE_ASSET_RE = re.compile(r"^/scene/([^/]+)/asset/([0-9a-f]{64})$")
_SCENE_PAGE_RE = re.compile(r"^/scene/([^/]+)/(manifest|viewer)$")


class _RouterHandler(BaseHTTPRequestHandler):
  """The cluster front door: same endpoint surface as a backend, so a
  client (or load balancer) cannot tell one process from the fleet."""

  def __init__(self, router: Router, *args, **kwargs):
    self.router = router
    super().__init__(*args, **kwargs)

  def log_message(self, fmt, *args):  # noqa: A003 - stdlib signature
    pass

  def _send_bytes(self, body: bytes, status: int = 200,
                  content_type: str = "application/json",
                  extra_headers: dict | None = None) -> None:
    try:
      self.send_response(status)
      headers = dict(extra_headers or {})
      headers.setdefault("Content-Type", content_type)
      headers["Content-Length"] = str(len(body))
      for key, value in headers.items():
        self.send_header(key, value)
      self.end_headers()
      self.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError):
      self.close_connection = True

  def _send_json(self, payload: dict, status: int = 200,
                 extra_headers: dict | None = None) -> None:
    self._send_bytes(json.dumps(payload).encode(), status=status,
                     extra_headers=extra_headers)

  def do_GET(self):  # noqa: N802 - stdlib name
    parsed = urllib.parse.urlsplit(self.path)
    if parsed.path == "/healthz":
      health = self.router.healthz()
      self._send_json(health,
                      status=503 if health["status"] == "unhealthy" else 200)
    elif parsed.path == "/stats":
      self._send_json(self.router.stats())
    elif parsed.path == "/metrics":
      # Same contract as a backend: classic format by default (a `#`
      # after the value fails a vanilla Prometheus scrape), exemplars
      # inline at ?exemplars=1.
      text = self.router.metrics_text()
      if urllib.parse.parse_qs(parsed.query).get(
          "exemplars", ["0"])[0] not in ("1", "true"):
        text = prom.strip_exemplars(text)
      self._send_bytes(
          text.encode(),
          content_type="text/plain; version=0.0.4; charset=utf-8")
    elif parsed.path == "/debug/traces":
      # ?id= fans the search out to every backend and returns the
      # stitched cross-process view; without it, the router's own ring.
      tid = urllib.parse.parse_qs(parsed.query).get("id", [None])[0]
      if tid:
        self._send_json(self.router.find_trace(tid))
      else:
        self._send_json(self.router.tracer.snapshot())
    elif parsed.path == "/debug/events":
      try:
        recent = int(urllib.parse.parse_qs(parsed.query)
                     .get("recent", ["128"])[0])
      except ValueError:
        self._send_json({"error": "recent must be an integer"}, status=400)
        return
      self._send_json(self.router.events_snapshot(recent=recent))
    elif parsed.path == "/debug/tsdb":
      # One query reads fleet history: the router's own ring (pooled
      # families) plus every backend's, fanned out concurrently.
      try:
        family, recent, points = tsdb_mod.parse_query(
            urllib.parse.parse_qs(parsed.query))
      except ValueError:
        self._send_json({"error": "recent must be a number and points "
                                  "an integer"}, status=400)
        return
      self._send_json(self.router.tsdb_snapshot(
          family=family, recent_s=recent, points=points))
    elif parsed.path == "/debug/attrib":
      # One fan-out reads the whole fleet's ledger + the cell-wise merge.
      self._send_json(self.router.attrib_snapshot())
    elif parsed.path == "/debug/incidents":
      iid = urllib.parse.parse_qs(parsed.query).get("id", [None])[0]
      self._send_json(self.router.incidents_snapshot(incident_id=iid))
    elif parsed.path == "/scenes":
      self._send_json(self.router.scenes())
    elif parsed.path.startswith("/scene/"):
      self._do_scene_get(parsed.path)
    else:
      self._send_json({"error": f"unknown path {self.path}"}, status=404)

  def _do_scene_get(self, path: str) -> None:
    """Route a scene-asset GET (manifest / viewer / digest-addressed
    asset) with the same error mapping as ``/render``: 503 + Retry-After
    when every breaker is open, 502 when every replica failed, 404 for
    unplaced scenes. Conditional headers forward both ways so a 304
    from a backend's immutable asset rides through unchanged."""
    asset = _SCENE_ASSET_RE.match(path)
    page = _SCENE_PAGE_RE.match(path)
    if asset is None and page is None:
      self._send_json({"error": f"unknown path {path}"}, status=404)
      return
    scene_id = urllib.parse.unquote((asset or page).group(1))
    if asset is not None:
      # Digest-addressed assets are IMMUTABLE: the URL names the
      # content, so a client whose If-None-Match carries the digest's
      # own strong ETag is proven fresh by arithmetic — answer 304 at
      # the router without waking any backend. This is what lets an
      # edge tier ride out a backend brownout on revalidations alone.
      etag = assets_mod.asset_etag(asset.group(2))
      inm = self.headers.get("If-None-Match") or ""
      if etag in inm:
        self.router.metrics.record_asset_revalidated()
        self._send_bytes(b"", status=304, extra_headers={
            "ETag": etag,
            "Cache-Control": "public, max-age=31536000, immutable"})
        return
    try:
      status, headers, body = self.router.forward_scene_get(
          scene_id, path,
          if_none_match=self.headers.get("If-None-Match"),
          kind="asset" if asset is not None else "manifest")
    except KeyError as e:
      self._send_json({"error": str(e)}, status=404)
      return
    except AllReplicasOpenError as e:
      retry_after = max(1, math.ceil(e.retry_after_s)) if e.retry_after_s \
          else 1
      self._send_json(
          {"error": str(e), "retry_after_s": e.retry_after_s}, status=503,
          extra_headers={"Retry-After": str(retry_after)})
      return
    except ReplicasExhaustedError as e:
      self._send_json({"error": str(e), "attempts": e.attempts},
                      status=502)
      return
    except Exception as e:  # noqa: BLE001 - the contract is 502, never 500
      self._send_json({"error": f"routing failed: {e}"}, status=502)
      return
    out_headers = {}
    for name in _FORWARD_HEADERS:
      value = next((v for k, v in headers.items()
                    if k.lower() == name.lower()), None)
      if value is not None:
        out_headers[name] = value
    if "X-Backend-Id" in headers:
      out_headers["X-Backend-Id"] = headers["X-Backend-Id"]
    self._send_bytes(body, status=status, extra_headers=out_headers)

  def do_POST(self):  # noqa: N802 - stdlib name
    if self.path == "/gossip":
      self._do_gossip()
      return
    if self.path == "/session":
      self._do_session_proxy()
      return
    if self.path != "/render":
      self._send_json({"error": f"unknown path {self.path}"}, status=404)
      return
    inbound_tid = _inbound_trace_id(self.headers)
    trace_id = inbound_tid or new_trace_id_32()
    tid_hdr = {"X-Trace-Id": trace_id}
    return self._do_render(trace_id, tid_hdr)

  def _do_session_proxy(self) -> None:
    """POST /session: tunnel a streaming session to the scene's primary.

    Sessions are long-lived sockets, not request/response — so after
    validating the hello body and picking a backend (placement order,
    cell-affine when the hello carries an initial ``pose``, skipping
    ejected and breaker-refused replicas; connect failures fail over and
    count against the breaker) the handler becomes a raw byte pump: the
    backend's entire response — status line, headers, frame stream —
    relays to the client verbatim, and the client's pose frames relay to
    the backend on a companion thread. There is no mid-stream failover:
    once any backend byte reaches the client, the session lives and dies
    with that backend.
    """
    router = self.router
    inbound_tid = _inbound_trace_id(self.headers)
    trace_id = inbound_tid or new_trace_id_32()
    tid_hdr = {"X-Trace-Id": trace_id}
    try:
      length = int(self.headers.get("Content-Length", "0"))
      if not 0 <= length <= _MAX_BODY_BYTES:
        raise ValueError(f"bad body length ({length} bytes)")
      body = self.rfile.read(length)
      req = json.loads(body or b"{}")
      if not isinstance(req, dict):
        raise ValueError(
            f"body must be a JSON object, got {type(req).__name__}")
      scene_id = req["scene_id"]
      if not isinstance(scene_id, str):
        raise ValueError(
            f"scene_id must be a string, got {type(scene_id).__name__}")
      if any(ord(c) < 0x20 for c in scene_id):
        raise ValueError("scene_id must not contain control characters")
    except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
      router.metrics.record_bad_request()
      self._send_json({"error": f"bad request: {e}"}, status=400,
                      extra_headers=tid_hdr)
      return
    except (BrokenPipeError, ConnectionResetError):
      self.close_connection = True
      return
    try:
      replicas = router._replicas(scene_id, cell=router.request_cell(req))
    except Exception as e:  # noqa: BLE001 - the contract is 502, never 500
      self._send_json({"error": f"routing failed: {e}"}, status=502,
                      extra_headers=tid_hdr)
      return
    if not replicas:
      self._send_json({"error": "no backends registered"}, status=503,
                      extra_headers=tid_hdr)
      return
    request_class = self.headers.get(brownout_mod.REQUEST_CLASS_HEADER)
    head_lines = [
        b"POST /session HTTP/1.1",
        b"Content-Type: application/json",
        b"Content-Length: %d" % len(body),
        b"traceparent: " + make_traceparent(trace_id).encode("ascii"),
    ]
    if request_class:
      head_lines.append(
          brownout_mod.REQUEST_CLASS_HEADER.encode("ascii") + b": "
          + request_class.encode("latin-1"))
    sock = None
    attempts: list[str] = []
    retry_afters: list[float] = []
    for backend in replicas:
      if backend.ejected:
        retry_afters.append(1.0)
        continue
      if not backend.breaker.allow_primary():
        retry_afters.append(backend.breaker.retry_after_s())
        continue
      host, _, port = backend.address.rpartition(":")
      try:
        sock = socket.create_connection((host, int(port)),
                                        timeout=router.health_timeout_s)
        lines = head_lines + [b"Host: " + backend.address.encode("ascii")]
        sock.sendall(b"\r\n".join(lines) + b"\r\n\r\n" + body)
      except OSError as e:
        if sock is not None:
          sock.close()
          sock = None
        backend.breaker.record_failure()
        attempts.append(f"{backend.backend_id}: unreachable ({e})")
        continue
      backend.breaker.record_success()
      router.metrics.record_session_proxy()
      router.metrics.record_forward(backend.backend_id)
      break
    if sock is None:
      if attempts:
        router.metrics.record_replica_exhausted()
        self._send_json({"error": f"all replicas failed for scene "
                                  f"{scene_id!r}", "attempts": attempts},
                        status=502, extra_headers=tid_hdr)
      else:
        router.metrics.record_breaker_fastfail()
        retry_after = max(1, math.ceil(min(retry_afters))) \
            if retry_afters else 1
        self._send_json(
            {"error": f"all replicas for scene {scene_id!r} are "
                      "ejected or breaker-refused"}, status=503,
            extra_headers={"Retry-After": str(retry_after), **tid_hdr})
      return
    # From here the handler is a byte pump; the connection never goes
    # back into keep-alive rotation. Both hops carry small interactive
    # frames, so Nagle + delayed ACK would stall them — disable it.
    self.close_connection = True
    sock.settimeout(None)
    for conn in (sock, self.connection):
      try:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
      except OSError:
        pass

    def upstream():
      try:
        while True:
          chunk = self.rfile.read1(65536)
          if not chunk:
            break
          sock.sendall(chunk)
      except (OSError, ValueError):
        pass
      finally:
        try:
          sock.shutdown(socket.SHUT_WR)
        except OSError:
          pass

    pump = threading.Thread(target=upstream, daemon=True,
                            name="mpi-router-session-up")
    pump.start()
    try:
      while True:
        chunk = sock.recv(65536)
        if not chunk:
          break
        self.wfile.write(chunk)
        self.wfile.flush()
    except (OSError, ValueError):
      pass
    finally:
      sock.close()

  def _do_gossip(self) -> None:
    """POST /gossip: a peer pushes its state, the reply is ours (one
    push-pull round trip). 404 when peering is off — a bare router is
    indistinguishable from one predating the endpoint."""
    try:
      length = int(self.headers.get("Content-Length", "0"))
      if not 0 <= length <= _MAX_BODY_BYTES:
        raise ValueError(f"bad body length ({length} bytes)")
      remote = json.loads(self.rfile.read(length) or b"{}")
      if not isinstance(remote, dict):
        raise ValueError("gossip body must be a JSON object")
    except (TypeError, ValueError, json.JSONDecodeError) as e:
      self._send_json({"error": f"bad gossip: {e}"}, status=400)
      return
    except (BrokenPipeError, ConnectionResetError):
      self.close_connection = True
      return
    try:
      reply = self.router.gossip_exchange(remote)
    except KeyError as e:
      self._send_json({"error": str(e)}, status=404)
      return
    self._send_json(reply)

  def _do_render(self, trace_id, tid_hdr) -> None:
    try:
      length = int(self.headers.get("Content-Length", "0"))
      if not 0 <= length <= _MAX_BODY_BYTES:
        raise ValueError(f"bad body length ({length} bytes)")
      body = self.rfile.read(length)
      req = json.loads(body or b"{}")
      if not isinstance(req, dict):
        raise ValueError(
            f"body must be a JSON object, got {type(req).__name__}")
      scene_id = req["scene_id"]
      if not isinstance(scene_id, str):
        raise ValueError(
            f"scene_id must be a string, got {type(scene_id).__name__}")
      if any(ord(c) < 0x20 for c in scene_id):
        # \x1f is the (scene, tile/cell) ring-key separator — a scene
        # id carrying it could alias another scene's tile keys.
        raise ValueError("scene_id must not contain control characters")
    except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
      self.router.metrics.record_bad_request()
      self._send_json({"error": f"bad request: {e}"}, status=400,
                      extra_headers=tid_hdr)
      return
    except (BrokenPipeError, ConnectionResetError):
      self.close_connection = True
      return
    tr = self.router.tracer.start_trace("route", trace_id=trace_id,
                                        scene_id=scene_id, http=True)
    try:
      status, headers, resp_body = self.router.forward_render(
          scene_id, body, accept=self.headers.get("Accept"),
          trace_id=trace_id, trace=tr,
          if_none_match=self.headers.get("If-None-Match"),
          cell=self.router.request_cell(req),
          request_class=self.headers.get(brownout_mod.REQUEST_CLASS_HEADER))
    except KeyError as e:
      tr.finish(error=repr(e))
      self._send_json({"error": str(e)}, status=503, extra_headers=tid_hdr)
      return
    except AllReplicasOpenError as e:
      tr.finish(error=repr(e))
      retry_after = max(1, math.ceil(e.retry_after_s)) if e.retry_after_s \
          else 1
      self._send_json(
          {"error": str(e), "retry_after_s": e.retry_after_s}, status=503,
          extra_headers={"Retry-After": str(retry_after), **tid_hdr})
      return
    except RetryBudgetExhaustedError as e:
      # A brownout drained the failover budget: fast 503, not a 502 —
      # the service is overloaded, not gone; clients should back off.
      tr.finish(error=repr(e))
      self._send_json({"error": str(e), "attempts": e.attempts},
                      status=503,
                      extra_headers={"Retry-After": "1", **tid_hdr})
      return
    except ReplicasExhaustedError as e:
      tr.finish(error=repr(e))
      self._send_json({"error": str(e), "attempts": e.attempts},
                      status=502, extra_headers=tid_hdr)
      return
    except Exception as e:  # noqa: BLE001 - the contract is 502, never 500
      tr.finish(error=repr(e))
      self._send_json({"error": f"routing failed: {e}"}, status=502,
                      extra_headers=tid_hdr)
      return
    tr.finish()
    out_headers = dict(tid_hdr)
    for name in _FORWARD_HEADERS:
      value = next((v for k, v in headers.items()
                    if k.lower() == name.lower()), None)
      if value is not None:
        out_headers[name] = value
    if "X-Backend-Id" in headers:
      out_headers["X-Backend-Id"] = headers["X-Backend-Id"]
    self._send_bytes(resp_body, status=status, extra_headers=out_headers)


def make_router_http_server(router: Router, host: str = "127.0.0.1",
                            port: int = 0) -> ThreadingHTTPServer:
  """A ready-to-``serve_forever`` threaded front end (port 0 = ephemeral;
  the bound port is ``server.server_address[1]``)."""
  handler = functools.partial(_RouterHandler, router)
  server = ThreadingHTTPServer((host, port), handler)
  server.daemon_threads = True
  return server
