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


class ServeMetrics:
  """Aggregates the serving layer's observability counters."""

  def __init__(self, window: int = 4096, clock=time.monotonic):
    self._clock = clock
    self._lock = threading.Lock()
    self._window = window
    self.reset()

  def reset(self) -> None:
    """Zero every counter and restart the uptime clock (load generators
    call this after warm-up so measurements are steady-state only)."""
    with self._lock:
      self._t0 = self._clock()
      self._latencies = collections.deque(maxlen=self._window)
      self._batch_hist = collections.Counter()
      self._queue_depth = 0
      self.requests = 0
      self.batches = 0
      self.render_seconds = 0.0
      # Device-phase split of render_seconds (engine.last_timings):
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

  def record_request(self, latency_s: float, scene_id: str | None = None,
                     trace_id: str | None = None) -> None:
    """One request completed, queue-to-response latency.

    ``scene_id`` feeds the bounded per-scene breakdown; None skips it.
    ``trace_id`` becomes the latency bucket's exemplar so a quantile
    reading links to a recorded trace.
    """
    with self._lock:
      self.requests += 1
      self._latencies.append(latency_s)
      self._hist_request.record(latency_s, exemplar=trace_id)
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

  def record_rejected(self) -> None:
    """One submission shed at the door (queue full, HTTP 503)."""
    with self._lock:
      self.rejected += 1

  def record_retry(self) -> None:
    with self._lock:
      self.retries += 1

  def record_watchdog_trip(self) -> None:
    with self._lock:
      self.watchdog_trips += 1

  def record_breaker_open(self) -> None:
    with self._lock:
      self.breaker_opens += 1

  def record_breaker_fastfail(self) -> None:
    """One request fast-failed against an open circuit (HTTP 503)."""
    with self._lock:
      self.breaker_fastfails += 1

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
