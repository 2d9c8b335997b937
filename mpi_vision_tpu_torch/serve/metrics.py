"""Serving metrics: request latencies, throughput, batches, queue depth.

Lock-guarded counters plus a bounded window of recent request latencies;
``snapshot()`` returns a plain-JSON dict (the ``/stats`` payload and the
load generator's source of truth). Percentiles are nearest-rank over the
last ``window`` completed requests — serving tails, not lifetime means,
are what capacity planning reads (p99 is the headline number for "heavy
traffic from millions of users").
"""

from __future__ import annotations

import collections
import threading
import time

from mpi_vision_tpu_torch.obs import hist as hist_mod


def percentile(sorted_values, q: float) -> float:
  """Nearest-rank percentile of an already-sorted non-empty sequence."""
  idx = round(q * (len(sorted_values) - 1))
  return float(sorted_values[idx])


# Per-scene latency tracking is bounded: at most this many distinct
# scenes get their own bucket; the rest aggregate under "_other" so a
# scene-id cardinality explosion cannot balloon /stats.
PER_SCENE_CAP = 32
# Recent-latency window per scene (percentiles are recent-only, like the
# global window, just smaller — per-scene tails are for hot-scene
# regression hunting, not capacity planning).
PER_SCENE_WINDOW = 512

# Prometheus-histogram bucket bounds (seconds) for request latency.
# Log-ish spacing from 1 ms to 10 s: serving latencies span sub-ms edge
# hits to cold-bake + retry-storm tails, and a scraper needs the whole
# range. Cumulative lifetime counts (unlike the percentile window, which
# is recent-only by design).
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class ServeMetrics:
  """Aggregates the serving layer's observability counters."""

  def __init__(self, window: int = 4096, clock=time.monotonic):
    self._clock = clock
    self._lock = threading.Lock()
    self._window = window
    # Optional obs.slo.SloTracker fed by record_request/record_error/
    # record_rejected/record_breaker_fastfail (set by RenderService).
    # Called OUTSIDE this object's lock: the tracker locks itself, and
    # its alert callback may fan out to the event log.
    self.slo = None
    # Optional obs.attrib.AttribLedger fed from record_request (set by
    # RenderService). Feeding it HERE is what makes the conservation
    # invariant structural: the ledger's request count and this object's
    # ``requests`` increment on the same call. Like slo, called outside
    # this lock (the ledger locks itself).
    self.attrib = None
    self.reset()

  def reset(self) -> None:
    """Zero every counter and restart the uptime clock (load generators
    call this after warm-up so measurements are steady-state only)."""
    if self.attrib is not None:
      # The ledger must forget warm-up traffic together with the totals
      # it reconciles against, or conservation breaks at the first
      # post-warmup snapshot.
      self.attrib.reset()
    with self._lock:
      self._t0 = self._clock()
      self._latencies = collections.deque(maxlen=self._window)
      self._lat_bucket_counts = [0] * len(LATENCY_BUCKETS_S)
      self._lat_overflow = 0  # latencies above the largest bound
      self._lat_sum = 0.0
      self._batch_hist = collections.Counter()
      self._queue_depth = 0
      self.requests = 0
      self.batches = 0
      self.render_seconds = 0.0
      # Device-phase split of render_seconds (InFlightBatch.timings):
      # host->device transfer / compute / device->host readback.
      self.phase_seconds = {"h2d": 0.0, "compute": 0.0, "readback": 0.0}
      # Failure accounting: without these, failed renders vanish from the
      # snapshot entirely (record_request fires only on success) and
      # /stats reads "healthy" straight through an outage.
      self.errors_transient = 0
      self.errors_permanent = 0
      self.errors_deadline = 0
      self.rejected = 0
      self.retries = 0
      self.watchdog_trips = 0
      self.breaker_opens = 0
      self.breaker_fastfails = 0
      self.client_disconnects = 0
      # Batches served by the degraded-mode CPU fallback engine while the
      # breaker refused the card.
      self.fallback_renders = 0
      # Pipeline accounting: flights in the air, device idle gaps
      # between dispatches (the "device never waits on the host" proof),
      # completions that beat an earlier-dispatched straggler, and
      # batches the watchdog abandoned mid-flight.
      self._inflight = 0
      self.dispatch_gaps = 0
      self.dispatch_gap_seconds = 0.0
      self.dispatch_gap_max_s = 0.0
      self.out_of_order_completions = 0
      self.abandoned_batches = 0
      # Tile-granular accounting (serve/tiles.py): how many source tiles
      # each frustum touched / the crop rendered / the cull skipped.
      # tiled_requests counts requests that went through a tile plan at
      # all, so the ratios stay meaningful on mixed fleets.
      self.tiled_requests = 0
      self.tiles_touched = 0
      self.tiles_rendered = 0
      self.tiles_culled = 0
      # Planes each tiled request composites after the content cull
      # (plane count -> requests): how much depth the cull removed.
      self._planes_hist: dict[int, int] = {}
      # Per-scene latency breakdown (hot-scene regression hunting):
      # scene -> [count, sum_s, max_s, deque(recent latencies)].
      self._per_scene: dict = {}
      # Native histograms (obs/hist.py): percentile-true, mergeable,
      # with per-bucket trace-id exemplars — the flight recorder's
      # measurement layer next to the classic fixed-bucket histogram.
      self._hist_request = hist_mod.NativeHistogram()
      self._hist_phase = {phase: hist_mod.NativeHistogram()
                          for phase in ("h2d", "compute", "readback")}
      self._hist_batch = hist_mod.NativeHistogram()
      # Brownout accounting (serve/brownout.py): sheds by priority class
      # and degraded serves by ladder level. Deliberate load management,
      # NOT SLO bad events — feeding these to the tracker would hold the
      # burn rate high and deadlock the ladder's recovery.
      self.brownout_sheds = {cls: 0 for cls in
                             ("interactive", "prefetch", "background")}
      self.brownout_degraded = {lvl: 0 for lvl in (1, 2, 3, 4)}
      # Asset-tier accounting (serve/assets/): manifest/asset request
      # outcomes on the serving side, tile-diff sync outcomes on the
      # fetching side. Always present in the snapshot (zeros while the
      # tier is off) so the mpi_serve_asset_* / mpi_serve_scene_sync_*
      # families are always exposed.
      self.asset_manifest_requests = 0
      self.asset_requests = 0
      self.asset_not_found = 0
      self.asset_not_modified = 0
      self.asset_bytes_served = 0
      self.asset_encodes = 0
      self.asset_publish_rejects = 0
      self.scene_sync_runs = 0
      self.scene_sync_tiles_fetched = 0
      self.scene_sync_tiles_reused = 0
      self.scene_sync_bytes = 0
      self.scene_sync_failures = 0
      self.scene_sync_retries = 0
      # Session-tier accounting (serve/session/): open/close/shed
      # lifecycle, fused-flush shape, and the trajectory prefetcher's
      # outcomes. Always present in the snapshot (zeros while sessions
      # are off) so the mpi_serve_session_* families are always exposed.
      self.session_opens = 0
      self.session_closes = 0
      self.session_rejects = 0
      self.session_idle_reaps = 0
      self.session_frames = 0
      self.session_frame_errors = 0
      self.session_flushes = 0
      self.session_flush_poses = 0
      self.session_prefetch_issued = 0
      self.session_prefetch_hits = 0
      self.session_prefetch_suppressed = 0
      # Edge warp serves' pose error (serve/edge/): how far the served
      # frame's render pose was from the request.
      self._hist_warp_pose_error = {
          "trans": hist_mod.NativeHistogram(),
          "rot_deg": hist_mod.NativeHistogram(),
      }
    if self.slo is not None:
      self.slo.reset()

  def record_request(self, latency_s: float, scene_id: str | None = None,
                     trace_id: str | None = None,
                     attrib: dict | None = None) -> None:
    """One request completed, queue-to-response latency.

    ``scene_id`` feeds the bounded per-scene breakdown; None skips it.
    ``trace_id`` becomes the latency bucket's exemplar so a quantile
    reading links to a recorded trace.

    ``attrib`` carries the request's attribution context when a ledger
    is attached (``{"class", "level", "device", "queue_wait_s",
    "edge"}`` — all optional): the scheduler passes the flight's
    per-request device share and queue wait, the edge cache passes the
    hit/warp kind. With no ledger attached it is ignored; with a ledger
    attached but no context the request still lands in a default cell,
    so the request-count conservation holds for every caller.
    """
    with self._lock:
      self.requests += 1
      self._lat_sum += latency_s
      self._latencies.append(latency_s)
      self._hist_request.record(latency_s, exemplar=trace_id)
      for i, bound in enumerate(LATENCY_BUCKETS_S):
        if latency_s <= bound:
          self._lat_bucket_counts[i] += 1
          break
      else:
        self._lat_overflow += 1
      if scene_id is not None:
        key = str(scene_id)
        if key not in self._per_scene and len(self._per_scene) >= PER_SCENE_CAP:
          key = "_other"
        entry = self._per_scene.get(key)
        if entry is None:
          entry = self._per_scene[key] = [
              0, 0.0, 0.0, collections.deque(maxlen=PER_SCENE_WINDOW)]
        entry[0] += 1
        entry[1] += latency_s
        entry[2] = max(entry[2], latency_s)
        entry[3].append(latency_s)
    ledger = self.attrib
    if ledger is not None:
      ctx = attrib or {}
      ledger.record(scene_id, ctx.get("class"), ctx.get("level", 0),
                    device=ctx.get("device"),
                    queue_wait_s=ctx.get("queue_wait_s", 0.0),
                    edge=ctx.get("edge"))
    if self.slo is not None:
      # trace_id rides into the SLO windows' native histograms too, so
      # quantile alerts carry a worst-offender exemplar.
      self.slo.record(ok=True, latency_s=latency_s, scene_id=scene_id,
                      trace_id=trace_id)

  def record_error(self, kind: str, count: int = 1) -> None:
    """``count`` requests failed with a ``kind``-class error.

    Kinds: "transient" / "permanent" (``resilience.classify_error``) plus
    "deadline" for requests that expired in the queue before dispatch —
    kept apart so ``errors.transient`` keeps meaning *device* trouble and
    pure overload doesn't read as a flapping tunnel in ``/stats``.
    """
    with self._lock:
      if kind == "transient":
        self.errors_transient += count
      elif kind == "deadline":
        self.errors_deadline += count
      else:
        self.errors_permanent += count
    if self.slo is not None:
      self.slo.record_bad(count)

  def record_rejected(self) -> None:
    """One submission shed at the door (queue full, HTTP 503) — an SLO
    bad event: the caller saw a 503 whatever the queue's reasons were."""
    with self._lock:
      self.rejected += 1
    if self.slo is not None:
      self.slo.record_bad()

  def record_retry(self) -> None:
    with self._lock:
      self.retries += 1

  def record_watchdog_trip(self) -> None:
    with self._lock:
      self.watchdog_trips += 1

  def record_breaker_open(self) -> None:
    with self._lock:
      self.breaker_opens += 1

  def record_fallback(self) -> None:
    """One batch served by the degraded-mode CPU fallback engine."""
    with self._lock:
      self.fallback_renders += 1

  def record_breaker_fastfail(self) -> None:
    """One request fast-failed against an open circuit (HTTP 503) — an
    SLO bad event like a queue shed."""
    with self._lock:
      self.breaker_fastfails += 1
    if self.slo is not None:
      self.slo.record_bad()

  def record_brownout_shed(self, request_class: str) -> None:
    """One request shed by brownout admission control.

    Deliberately NOT an SLO bad event (unlike ``record_rejected``):
    brownout sheds are the controller doing its job, and counting them
    bad would hold the fast-window burn at its trigger level forever —
    the ladder could never step back up.
    """
    with self._lock:
      cls = (request_class if request_class in self.brownout_sheds
             else "interactive")
      self.brownout_sheds[cls] += 1

  def record_degraded(self, level: int) -> None:
    """One response served below full quality at ladder ``level``."""
    with self._lock:
      self.brownout_degraded[min(max(int(level), 1), 4)] += 1

  def record_asset_request(self, kind: str, outcome: str,
                           nbytes: int = 0) -> None:
    """One asset-tier GET: ``kind`` is "manifest" or "asset"; ``outcome``
    is "ok" / "not_modified" (304 revalidation) / "not_found"; ``nbytes``
    the body bytes actually sent (0 for 304s and 404s)."""
    with self._lock:
      if kind == "manifest":
        self.asset_manifest_requests += 1
      else:
        self.asset_requests += 1
      if outcome == "not_modified":
        self.asset_not_modified += 1
      elif outcome == "not_found":
        self.asset_not_found += 1
      self.asset_bytes_served += int(nbytes)

  def record_asset_encode(self) -> None:
    """One asset (re-)encoded from live scene data (publish or LRU
    miss) — the cost content addressing amortizes away."""
    with self._lock:
      self.asset_encodes += 1

  def record_asset_publish_reject(self) -> None:
    """One corrupt bake refused at the digest-vs-bytes gate."""
    with self._lock:
      self.asset_publish_rejects += 1

  def record_scene_sync(self, tiles_fetched: int, tiles_reused: int,
                        bytes_fetched: int) -> None:
    """One completed tile-diff scene sync pulled INTO this service."""
    with self._lock:
      self.scene_sync_runs += 1
      self.scene_sync_tiles_fetched += int(tiles_fetched)
      self.scene_sync_tiles_reused += int(tiles_reused)
      self.scene_sync_bytes += int(bytes_fetched)

  def record_scene_sync_failure(self) -> None:
    with self._lock:
      self.scene_sync_failures += 1

  def record_scene_sync_retry(self) -> None:
    """One transient per-fetch failure retried (with backoff) inside a
    scene sync instead of failing the whole sweep."""
    with self._lock:
      self.scene_sync_retries += 1

  def record_session_open(self) -> None:
    """One streaming session admitted (POST /session accepted)."""
    with self._lock:
      self.session_opens += 1

  def record_session_close(self, idle: bool = False) -> None:
    """One session ended; ``idle`` marks reaper-driven closes."""
    with self._lock:
      self.session_closes += 1
      if idle:
        self.session_idle_reaps += 1

  def record_session_reject(self) -> None:
    """One session open shed at the bound (503 + Retry-After)."""
    with self._lock:
      self.session_rejects += 1

  def record_session_flush(self, poses: int) -> None:
    """One fused drain of a session's queue: ``poses`` submitted
    concurrently so the scheduler can coalesce them into one flight."""
    with self._lock:
      self.session_flushes += 1
      self.session_flush_poses += int(poses)

  def record_session_frame(self) -> None:
    """One frame streamed to a session client."""
    with self._lock:
      self.session_frames += 1

  def record_session_frame_error(self) -> None:
    """One session frame failed (shed/timeout/queue-full error frame)."""
    with self._lock:
      self.session_frame_errors += 1

  def record_session_prefetch_issued(self) -> None:
    """One speculative prefetch-class render issued for a predicted cell."""
    with self._lock:
      self.session_prefetch_issued += 1

  def record_session_prefetch_hit(self) -> None:
    """One real session frame served from a cell prefetch warmed."""
    with self._lock:
      self.session_prefetch_hits += 1

  def record_session_prefetch_suppressed(self) -> None:
    """One prefetch round skipped at brownout L3+ (predictor muted)."""
    with self._lock:
      self.session_prefetch_suppressed += 1

  def record_warp_pose_error(self, trans: float, rot_deg: float,
                             trace_id: str | None = None) -> None:
    """One edge warp-serve's pose error (how far the served frame's
    render pose was from the request pose)."""
    with self._lock:
      self._hist_warp_pose_error["trans"].record(trans, exemplar=trace_id)
      self._hist_warp_pose_error["rot_deg"].record(rot_deg,
                                                   exemplar=trace_id)

  def record_client_disconnect(self) -> None:
    """The client hung up mid-response (BrokenPipe/ConnectionReset)."""
    with self._lock:
      self.client_disconnects += 1

  def set_inflight(self, n: int) -> None:
    """Gauge: flights currently in the pipeline window."""
    with self._lock:
      self._inflight = int(n)

  def record_dispatch_gap(self, gap_s: float) -> None:
    """The device sat idle ``gap_s`` between the previous flight's
    completion and the next launch (with the pipeline saturated this
    must stay ~0 — the streaming engine's headline invariant)."""
    with self._lock:
      self.dispatch_gaps += 1
      self.dispatch_gap_seconds += max(gap_s, 0.0)
      self.dispatch_gap_max_s = max(self.dispatch_gap_max_s, gap_s)

  def record_out_of_order(self) -> None:
    """A flight completed while an earlier-dispatched one was still in
    the air — completions are not serialized behind stragglers."""
    with self._lock:
      self.out_of_order_completions += 1

  def record_abandoned_batch(self) -> None:
    """A whole flight exhausted its deadline/watchdog budget and was
    abandoned with device work possibly still running."""
    with self._lock:
      self.abandoned_batches += 1

  def record_batch(self, size: int, render_s: float,
                   phases: dict | None = None) -> None:
    """One device dispatch of ``size`` coalesced requests.

    ``phases`` is the engine's per-dispatch phase split (keys ``h2d_s``,
    ``compute_s``, ``readback_s``), accumulated into lifetime totals so
    ``/metrics`` can say where device time actually goes.
    """
    with self._lock:
      self.batches += 1
      self._batch_hist[int(size)] += 1
      self.render_seconds += render_s
      self._hist_batch.record(render_s)
      if phases:
        for key in ("h2d", "compute", "readback"):
          phase_s = float(phases.get(key + "_s", 0.0))
          self.phase_seconds[key] += phase_s
          self._hist_phase[key].record(phase_s)

  def record_tiles(self, touched: int, rendered: int, total: int,
                   planes: int | None = None) -> None:
    """One request's frustum-cull outcome against a tiled scene:
    ``touched`` tiles the frustum can sample, ``rendered`` tiles inside
    the dispatched crop, ``total - rendered`` culled outright, and the
    ``planes`` its crop composites."""
    with self._lock:
      self.tiled_requests += 1
      self.tiles_touched += int(touched)
      self.tiles_rendered += int(rendered)
      self.tiles_culled += max(int(total) - int(rendered), 0)
      if planes is not None:
        self._planes_hist[int(planes)] = \
            self._planes_hist.get(int(planes), 0) + 1

  def latency_histogram(self) -> dict:
    """Cumulative Prometheus-style latency histogram.

    ``buckets`` are ``(upper_bound_s, cumulative_count)`` ascending plus
    the ``+Inf`` bucket; ``sum``/``count`` follow the exposition format.
    """
    with self._lock:
      cum, buckets = 0, []
      for bound, n in zip(LATENCY_BUCKETS_S, self._lat_bucket_counts):
        cum += n
        buckets.append((bound, cum))
      total = cum + self._lat_overflow
      buckets.append((float("inf"), total))
      return {"buckets": buckets, "sum": round(self._lat_sum, 6),
              "count": total}

  def attrib_reference(self) -> dict:
    """The attribution ledger's conservation reference — the UNROUNDED
    request/phase totals (``snapshot()`` rounds to 3 decimals, which
    would swamp the reconciliation's 1e-6 tolerance)."""
    with self._lock:
      return {"requests": self.requests,
              "device_phase_seconds": dict(self.phase_seconds)}

  def set_queue_depth(self, depth: int) -> None:
    with self._lock:
      self._queue_depth = int(depth)

  def snapshot(self, cache_stats: dict | None = None) -> dict:
    """JSON-ready state: latency percentiles, throughput, batch shape."""
    with self._lock:
      uptime = max(self._clock() - self._t0, 1e-9)
      lat = sorted(self._latencies)
      out = {
          "uptime_s": round(uptime, 3),
          "requests": self.requests,
          "renders_per_sec": round(self.requests / uptime, 3),
          "latency_ms": None,
          "batches": self.batches,
          "batch_size_hist": {str(k): v
                              for k, v in sorted(self._batch_hist.items())},
          "mean_batch_size": (round(self.requests / self.batches, 3)
                              if self.batches else None),
          "device_render_seconds": round(self.render_seconds, 3),
          "device_phase_seconds": {k: round(v, 3)
                                   for k, v in self.phase_seconds.items()},
          "queue_depth": self._queue_depth,
          "errors": {
              "transient": self.errors_transient,
              "permanent": self.errors_permanent,
              "deadline": self.errors_deadline,
          },
          "rejected": self.rejected,
          "resilience": {
              "retries": self.retries,
              "watchdog_trips": self.watchdog_trips,
              "fallback_renders": self.fallback_renders,
              "breaker_opens": self.breaker_opens,
              "breaker_fastfails": self.breaker_fastfails,
              "client_disconnects": self.client_disconnects,
          },
          "pipeline": {
              "inflight": self._inflight,
              "out_of_order_completions": self.out_of_order_completions,
              "abandoned_batches": self.abandoned_batches,
              "dispatch_gap": {
                  "count": self.dispatch_gaps,
                  "total_s": round(self.dispatch_gap_seconds, 6),
                  "mean_ms": (round(
                      self.dispatch_gap_seconds / self.dispatch_gaps * 1e3, 3)
                      if self.dispatch_gaps else None),
                  "max_ms": round(self.dispatch_gap_max_s * 1e3, 3),
              },
          },
          "tiles": {
              "tiled_requests": self.tiled_requests,
              "touched_total": self.tiles_touched,
              "rendered_total": self.tiles_rendered,
              "culled_total": self.tiles_culled,
              "mean_touched": (round(
                  self.tiles_touched / self.tiled_requests, 3)
                  if self.tiled_requests else None),
              "planes_hist": {str(k): v for k, v in
                              sorted(self._planes_hist.items())},
          },
          # Native-histogram snapshots (JSON-ready, obs/hist.py):
          # percentile-true and mergeable across services.
          "hist": {
              "request": self._hist_request.snapshot(),
              "phase": {phase: h.snapshot()
                        for phase, h in self._hist_phase.items()},
              "batch": self._hist_batch.snapshot(),
              "warp_pose_error": {
                  comp: h.snapshot()
                  for comp, h in self._hist_warp_pose_error.items()},
          },
          "assets": {
              "manifest_requests": self.asset_manifest_requests,
              "requests": self.asset_requests,
              "not_found": self.asset_not_found,
              "not_modified": self.asset_not_modified,
              "bytes_served": self.asset_bytes_served,
              "encodes": self.asset_encodes,
              "publish_rejects": self.asset_publish_rejects,
          },
          "scene_sync": {
              "runs": self.scene_sync_runs,
              "tiles_fetched": self.scene_sync_tiles_fetched,
              "tiles_reused": self.scene_sync_tiles_reused,
              "bytes_fetched": self.scene_sync_bytes,
              "failures": self.scene_sync_failures,
              "retries": self.scene_sync_retries,
          },
          # Session tier (serve/session/): counters here, live state
          # ("enabled"/"active" and the knobs) overlaid by the service's
          # stats() when a SessionManager is attached.
          "session": {
              "enabled": False,
              "active": 0,
              "opened": self.session_opens,
              "closed": self.session_closes,
              "rejected": self.session_rejects,
              "idle_reaped": self.session_idle_reaps,
              "frames": self.session_frames,
              "frame_errors": self.session_frame_errors,
              "flushes": self.session_flushes,
              "mean_flush_size": (
                  round(self.session_flush_poses / self.session_flushes, 3)
                  if self.session_flushes else None),
              "prefetch": {
                  "issued": self.session_prefetch_issued,
                  "hits": self.session_prefetch_hits,
                  "suppressed": self.session_prefetch_suppressed,
              },
          },
          # The service overlays controller state (level, transitions,
          # signals) when brownout is on; the counters live here so a
          # load generator's reset() zeroes them with everything else.
          "brownout": {
              "enabled": False,
              "level": 0,
              "sheds": dict(self.brownout_sheds),
              "degraded": {str(k): v
                           for k, v in self.brownout_degraded.items()},
          },
          "per_scene": {
              sid: {
                  "requests": entry[0],
                  "mean_ms": round(entry[1] / entry[0] * 1e3, 3),
                  "p50_ms": round(
                      percentile(sorted(entry[3]), 0.50) * 1e3, 3),
                  "p99_ms": round(
                      percentile(sorted(entry[3]), 0.99) * 1e3, 3),
                  "max_ms": round(entry[2] * 1e3, 3),
              }
              for sid, entry in sorted(self._per_scene.items())
          },
      }
      if lat:
        out["latency_ms"] = {
            "p50": round(percentile(lat, 0.50) * 1e3, 3),
            "p95": round(percentile(lat, 0.95) * 1e3, 3),
            "p99": round(percentile(lat, 0.99) * 1e3, 3),
            "max": round(lat[-1] * 1e3, 3),
        }
    if cache_stats is not None:
      out["cache"] = cache_stats
    return out
