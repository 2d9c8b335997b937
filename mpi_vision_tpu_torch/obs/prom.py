"""Prometheus text exposition for the serving metrics.

A copy of ``mpi_vision_tpu/obs/prom.py`` with its imports rewritten.

A small registry (``Metric`` families collected into a ``Registry``,
rendered as ``# HELP``/``# TYPE`` + samples) so ``/metrics`` is built
declaratively here instead of string-formatted through ``server.py``.
``serve_registry`` maps the ``/stats`` snapshot — every ``ServeMetrics``
counter, the cumulative latency histogram, breaker state, cache stats —
onto stable metric names a stock Prometheus scraper ingests as-is.

Conventions follow the exposition-format spec: counters end in
``_total``, histograms emit cumulative ``_bucket{le=...}`` series plus
``_sum``/``_count``, enum-style state (breaker) is one gauge per state
with exactly one sample at 1. ``parse_metrics_text`` is the minimal
inverse used by the tier-1 test that pins ``/metrics`` against
``/stats``.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time

from mpi_vision_tpu_torch.obs import hist as hist_mod

_TYPES = ("counter", "gauge", "histogram")

# The shared metric-name prefix: one grep (or one Grafana variable) finds
# every series this stack exports.
PREFIX = "mpi_serve_"


def _escape_help(text: str) -> str:
  return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
  return (value.replace("\\", "\\\\").replace("\n", "\\n")
          .replace('"', '\\"'))


def format_value(value) -> str:
  """Prometheus sample value: integers bare, floats via repr, +Inf/NaN."""
  if value is None:
    return "NaN"
  if isinstance(value, bool):
    return "1" if value else "0"
  if isinstance(value, int):
    return str(value)
  value = float(value)
  if math.isinf(value):
    return "+Inf" if value > 0 else "-Inf"
  if math.isnan(value):
    return "NaN"
  if value == int(value) and abs(value) < 1e15:
    return str(int(value))
  return repr(value)


@dataclasses.dataclass
class Metric:
  """One metric family: name, type, help, and its samples.

  Samples are ``(suffix, labels, value, exemplar)`` — suffix is appended
  to the family name (histograms use ``_bucket``/``_sum``/``_count``).
  ``exemplar`` is an optional ``(trace_id, observed_value)`` pair,
  rendered OpenMetrics-style after the sample
  (`` # {trace_id="..."} value``) — the native-histogram families use it
  to link a bucket to a recorded trace.
  """

  name: str
  mtype: str
  help: str

  def __post_init__(self):
    if self.mtype not in _TYPES:
      raise ValueError(f"metric type must be one of {_TYPES}, "
                       f"got {self.mtype!r}")
    self.samples: list[tuple[str, dict, object, tuple | None]] = []

  def sample(self, value, labels: dict | None = None,
             suffix: str = "", exemplar: tuple | None = None) -> "Metric":
    self.samples.append((suffix, dict(labels or {}), value, exemplar))
    return self

  def render(self) -> str:
    lines = [f"# HELP {self.name} {_escape_help(self.help)}",
             f"# TYPE {self.name} {self.mtype}"]
    for suffix, labels, value, exemplar in self.samples:
      label_str = ""
      if labels:
        inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                         for k, v in labels.items())
        label_str = "{" + inner + "}"
      line = f"{self.name}{suffix}{label_str} {format_value(value)}"
      if exemplar is not None:
        tid, observed = exemplar
        line += (f' # {{trace_id="{_escape_label(str(tid))}"}} '
                 f"{format_value(observed)}")
      lines.append(line)
    return "\n".join(lines)


class Registry:
  """An ordered collection of metric families rendered as one exposition."""

  def __init__(self):
    self._metrics: list[Metric] = []

  def extend(self, other: "Registry") -> "Registry":
    """Append every family of ``other`` into this registry (one joint
    exposition; the caller owns name uniqueness across the two)."""
    self._metrics.extend(other._metrics)
    return self

  def counter(self, name: str, help: str, value=None,
              labels: dict | None = None) -> Metric:
    m = Metric(name, "counter", help)
    if value is not None:
      m.sample(value, labels)
    self._metrics.append(m)
    return m

  def gauge(self, name: str, help: str, value=None,
            labels: dict | None = None) -> Metric:
    m = Metric(name, "gauge", help)
    if value is not None:
      m.sample(value, labels)
    self._metrics.append(m)
    return m

  def histogram(self, name: str, help: str, buckets, sum_value,
                count) -> Metric:
    """``buckets``: iterable of ``(upper_bound_or_inf, cumulative_count)``
    in ascending bound order; the ``+Inf`` bucket is added when absent."""
    m = Metric(name, "histogram", help)
    saw_inf = False
    for le, cum in buckets:
      saw_inf = saw_inf or math.isinf(float(le))
      m.sample(cum, {"le": format_value(float(le))}, suffix="_bucket")
    if not saw_inf:
      m.sample(count, {"le": "+Inf"}, suffix="_bucket")
    m.sample(sum_value, suffix="_sum")
    m.sample(count, suffix="_count")
    self._metrics.append(m)
    return m

  def histogram_family(self, name: str, help: str) -> Metric:
    """A histogram-typed family whose samples the caller fills directly
    (the native-histogram families: ``_bucket{idx=,le=}`` / ``_zero`` /
    ``_sum`` / ``_count``, see ``obs/hist.py``)."""
    m = Metric(name, "histogram", help)
    self._metrics.append(m)
    return m

  def enum(self, name: str, help: str, states, active: str) -> Metric:
    """One gauge sample per state; the active one is 1, the rest 0."""
    m = Metric(name, "gauge", help)
    for state in states:
      m.sample(1 if state == active else 0, {"state": state})
    self._metrics.append(m)
    return m

  def render(self) -> str:
    return "\n".join(m.render() for m in self._metrics) + "\n"


def serve_registry(stats: dict,
                   latency_hist: dict | None = None) -> Registry:
  """Map a ``RenderService.stats()`` snapshot onto the metric families.

  ``latency_hist`` is ``ServeMetrics.latency_histogram()`` (cumulative
  bucket counts + sum + count); None omits the histogram family.
  """
  reg = Registry()
  p = PREFIX
  reg.gauge(p + "uptime_seconds",
            "Seconds since the metrics window started.",
            stats.get("uptime_s", 0.0))
  reg.counter(p + "requests_total", "Completed render requests.",
              stats.get("requests", 0))
  reg.counter(p + "batches_total", "Device dispatches (micro-batches).",
              stats.get("batches", 0))
  reg.counter(p + "device_render_seconds_total",
              "Cumulative device time inside engine render calls.",
              stats.get("device_render_seconds", 0.0))
  phases = stats.get("device_phase_seconds") or {}
  phase_m = reg.counter(
      p + "device_phase_seconds_total",
      "Device render time split by phase (h2d / compute / readback).")
  for phase in ("h2d", "compute", "readback"):
    phase_m.sample(phases.get(phase, 0.0), {"phase": phase})
  errors = stats.get("errors") or {}
  err_m = reg.counter(
      p + "errors_total",
      "Failed requests by class (transient device / permanent bad-input "
      "/ deadline-expired).")
  for cls in ("transient", "permanent", "deadline"):
    err_m.sample(errors.get(cls, 0), {"class": cls})
  reg.counter(p + "rejected_total",
              "Submissions shed at the door (queue full).",
              stats.get("rejected", 0))
  res = stats.get("resilience") or {}
  for key, help_text in (
      ("retries", "Retry attempts after transient dispatch failures."),
      ("watchdog_trips", "Dispatches abandoned by the hang watchdog."),
      ("fallback_renders", "Batches served by the degraded-mode "
                           "fallback engine."),
      ("breaker_opens", "Circuit breaker CLOSED->OPEN transitions."),
      ("breaker_fastfails", "Requests fast-failed against an open "
                            "circuit."),
      ("client_disconnects", "Clients that hung up mid-response."),
  ):
    reg.counter(p + key + "_total", help_text, res.get(key, 0))
  reg.gauge(p + "queue_depth", "Pending requests in the scheduler queue.",
            stats.get("queue_depth", 0))
  pipeline = stats.get("pipeline") or {}
  gap = pipeline.get("dispatch_gap") or {}
  reg.gauge(p + "inflight", "Flights currently in the pipeline window.",
            pipeline.get("inflight", 0))
  reg.counter(p + "dispatch_gaps_total",
              "Launches that found the device idle (nothing in flight).",
              gap.get("count", 0))
  reg.counter(p + "dispatch_gap_seconds_total",
              "Cumulative device idle time between flights.",
              gap.get("total_s", 0.0))
  reg.counter(p + "out_of_order_completions_total",
              "Flights completed while an earlier dispatch was in flight.",
              pipeline.get("out_of_order_completions", 0))
  reg.counter(p + "abandoned_batches_total",
              "Flights abandoned with device work possibly still running.",
              pipeline.get("abandoned_batches", 0))
  if latency_hist is not None:
    reg.histogram(p + "request_latency_seconds",
                  "End-to-end request latency (enqueue to response).",
                  latency_hist["buckets"], latency_hist["sum"],
                  latency_hist["count"])
  hist = stats.get("batch_size_hist") or {}
  sizes = sorted(int(k) for k in hist)
  cum, total_reqs, buckets = 0, 0, []
  for size in sizes:
    cum += hist[str(size)]
    total_reqs += size * hist[str(size)]
    buckets.append((float(size), cum))
  reg.histogram(p + "batch_size",
                "Coalesced requests per device dispatch.",
                buckets, total_reqs, stats.get("batches", 0))
  # Native histograms (obs/hist.py): sparse exponential buckets with
  # per-bucket trace-id exemplars — percentile-true latency families the
  # router can pool-merge exactly (shared idx space: per-sample sums ARE
  # the bucket merge). Always exposed, zeros and all.
  nh = stats.get("hist") or {}
  hist_mod.add_family(
      reg, p + "request_latency_nativehist",
      "Request latency (seconds) in native exponential buckets with "
      "trace-id exemplars.", [({}, nh.get("request"))])
  hist_mod.add_family(
      reg, p + "phase_latency_nativehist",
      "Per-dispatch device phase duration (seconds) in native buckets, "
      "label phase=h2d|compute|readback.",
      [({"phase": phase}, (nh.get("phase") or {}).get(phase))
       for phase in ("h2d", "compute", "readback")])
  hist_mod.add_family(
      reg, p + "batch_latency_nativehist",
      "Per-dispatch device render time (seconds) in native buckets.",
      [({}, nh.get("batch"))])
  wpe = nh.get("warp_pose_error") or {}
  hist_mod.add_family(
      reg, p + "edge_warp_pose_error",
      "Pose error of every edge warp-serve (how far the served frame's "
      "render pose was from the request), label component=trans "
      "(scene units) | rot_deg (degrees).",
      [({"component": "trans"}, wpe.get("trans")),
       ({"component": "rot_deg"}, wpe.get("rot_deg"))])
  quant = reg.gauge(
      p + "request_quantile_seconds",
      "Request-latency quantiles estimated from the native histogram "
      "(NaN while idle), label q.")
  for q in hist_mod.QUANTILES:
    quant.sample(hist_mod.quantile_of(nh.get("request"), q),
                 {"q": hist_mod.q_label(q)})
  # Edge frame cache (serve/edge/): families are always exposed (zeros
  # while the cache is off) so dashboards and the README metric
  # reference never depend on a knob.
  edge = stats.get("edge") or {}
  reg.counter(p + "edge_hits_total",
              "Edge frame-cache exact view-cell hits (served stored "
              "bytes).", edge.get("hits", 0))
  reg.counter(p + "edge_warp_serves_total",
              "Edge near-misses served by warping the nearest cached "
              "frame.", edge.get("warp_serves", 0))
  reg.counter(p + "edge_misses_total",
              "Edge lookups that fell through to a real render.",
              edge.get("misses", 0))
  reg.counter(p + "edge_revalidations_total",
              "If-None-Match revalidations answered 304 (no render, no "
              "body).", edge.get("revalidations", 0))
  reg.counter(p + "edge_evictions_total",
              "Edge frame-cache LRU evictions.", edge.get("evictions", 0))
  reg.counter(p + "edge_invalidations_total",
              "Edge frames dropped by scene swaps / live reloads.",
              edge.get("invalidations", 0))
  reg.gauge(p + "edge_bytes", "Bytes of rendered frames resident in the "
            "edge cache.", edge.get("bytes", 0))
  reg.gauge(p + "edge_frames", "Rendered frames resident in the edge "
            "cache.", edge.get("frames", 0))
  reg.counter(p + "edge_negative_hits_total",
              "Requests shed fast by a live negative entry (view cell "
              "known queue-full within its negative TTL).",
              edge.get("negative_hits", 0))
  reg.gauge(p + "edge_negative_entries",
            "Live negative entries (view cells recently shed "
            "queue-full).", edge.get("negative_entries", 0))
  # Tile-granular serving (serve/tiles.py): frustum-cull outcomes + the
  # per-tile baked cache. Always exposed (zeros while --tiled is off).
  tiles = stats.get("tiles") or {}
  reg.counter(p + "tile_requests_total",
              "Requests rendered through a tile plan (frustum-culled "
              "crop of a tiled scene).", tiles.get("tiled_requests", 0))
  reg.counter(p + "tile_touched_total",
              "Source tiles the request frusta could sample.",
              tiles.get("touched_total", 0))
  reg.counter(p + "tile_rendered_total",
              "Source tiles inside the dispatched crops.",
              tiles.get("rendered_total", 0))
  reg.counter(p + "tile_culled_total",
              "Source tiles skipped by frustum culling.",
              tiles.get("culled_total", 0))
  tcache = stats.get("tile_cache") or {}
  reg.counter(p + "tile_cache_hits_total", "Baked-tile cache hits.",
              tcache.get("hits", 0))
  reg.counter(p + "tile_cache_misses_total",
              "Baked-tile cache misses (per-tile bakes).",
              tcache.get("misses", 0))
  reg.counter(p + "tile_cache_evictions_total",
              "Baked-tile LRU evictions (cold tiles freed while hot "
              "tiles stay).", tcache.get("evictions", 0))
  reg.counter(p + "tile_cache_invalidations_total",
              "Baked tiles dropped because their bytes changed (live "
              "reload swaps ONLY these).", tcache.get("invalidations", 0))
  reg.gauge(p + "tile_cache_bytes", "Bytes of baked tiles resident.",
            tcache.get("bytes", 0))
  reg.gauge(p + "tile_cache_tiles", "Baked tiles resident.",
            tcache.get("scenes", 0))
  # Scene-asset delivery tier (serve/assets/): manifest + content-
  # addressed tile/layer assets on the serving side, tile-diff scene
  # sync on the fetching side. Always exposed (zeros while off).
  assets = stats.get("assets") or {}
  acache = assets.get("cache") or {}
  reg.counter(p + "asset_manifest_requests_total",
              "GET /scene/{id}/manifest requests (including 304s and "
              "404s).", assets.get("manifest_requests", 0))
  reg.counter(p + "asset_requests_total",
              "GET /scene/{id}/asset/{digest} requests (including 304s "
              "and 404s).", assets.get("requests", 0))
  reg.counter(p + "asset_not_found_total",
              "Asset-tier requests answered 404 (unknown scene, unknown "
              "or no-longer-live digest).", assets.get("not_found", 0))
  reg.counter(p + "asset_not_modified_total",
              "Asset-tier If-None-Match revalidations answered 304 (no "
              "body).", assets.get("not_modified", 0))
  reg.counter(p + "asset_bytes_total",
              "Body bytes served by the asset tier (manifests + "
              "assets).", assets.get("bytes_served", 0))
  reg.counter(p + "asset_encodes_total",
              "Assets (re-)encoded from live scene data (publish or "
              "LRU miss).", assets.get("encodes", 0))
  reg.counter(p + "asset_publish_rejects_total",
              "Corrupt bakes refused at the digest-vs-bytes gate.",
              assets.get("publish_rejects", 0))
  reg.counter(p + "asset_cache_evictions_total",
              "Encoded assets evicted by the asset LRU.",
              acache.get("evictions", 0))
  reg.gauge(p + "asset_cache_bytes",
            "Encoded asset bytes resident in the asset LRU.",
            acache.get("bytes", 0))
  reg.gauge(p + "asset_cache_assets",
            "Encoded assets resident in the asset LRU.",
            acache.get("assets", 0))
  sync = stats.get("scene_sync") or {}
  reg.counter(p + "scene_sync_runs_total",
              "Completed tile-diff scene syncs pulled into this service "
              "(SceneFetcher).", sync.get("runs", 0))
  reg.counter(p + "scene_sync_tiles_fetched_total",
              "Tiles fetched by scene syncs (digest changed or scene "
              "new).", sync.get("tiles_fetched", 0))
  reg.counter(p + "scene_sync_tiles_reused_total",
              "Tiles reused locally by scene syncs (digest unchanged — "
              "the bytes the diff protocol never moved).",
              sync.get("tiles_reused", 0))
  reg.counter(p + "scene_sync_bytes_total",
              "Bytes fetched over the wire by scene syncs.",
              sync.get("bytes_fetched", 0))
  reg.counter(p + "scene_sync_failures_total",
              "Scene syncs that failed (unreachable source, bad "
              "manifest, digest mismatch).", sync.get("failures", 0))
  reg.counter(p + "scene_sync_retries_total",
              "Transient per-fetch failures retried with backoff inside "
              "scene syncs (RetryPolicy) instead of failing the sweep.",
              sync.get("retries", 0))
  # Brownout ladder (serve/brownout.py): always exposed (zeros at L0 /
  # while brownout is off). The level gauge is NON-additive across a
  # fleet (brownout.NON_ADDITIVE_FAMILIES): the router's pooled /metrics
  # drops it and per-backend levels ride the /stats brownout block.
  bo = stats.get("brownout") or {}
  reg.gauge(p + "brownout_level",
            "Current brownout ladder level (0 = full quality ... 4 = "
            "shed with Retry-After).", bo.get("level", 0))
  bo_trans = bo.get("transitions") or {}
  trans_m = reg.counter(
      p + "brownout_transitions_total",
      "Ladder level changes, label direction=down (deeper degradation) "
      "| up (recovery).")
  for direction in ("down", "up"):
    trans_m.sample(bo_trans.get(direction, 0), {"direction": direction})
  bo_sheds = bo.get("sheds") or {}
  shed_m = reg.counter(
      p + "brownout_sheds_total",
      "Requests shed by brownout admission control, label class. "
      "Deliberate load management — excluded from the SLO bad stream.")
  for cls in ("interactive", "prefetch", "background"):
    shed_m.sample(bo_sheds.get(cls, 0), {"class": cls})
  bo_deg = bo.get("degraded") or {}
  deg_m = reg.counter(
      p + "brownout_degraded_total",
      "Responses served below full quality, label level (the ladder "
      "tier that produced them — never cached, never ETag'd).")
  for lvl in ("1", "2", "3", "4"):
    deg_m.sample(bo_deg.get(lvl, 0), {"level": lvl})
  # Session streaming tier (serve/session/): always exposed (zeros while
  # sessions are off).
  sess = stats.get("session") or {}
  reg.gauge(p + "session_active", "Open pose-stream sessions.",
            sess.get("active", 0))
  reg.counter(p + "session_opened_total",
              "Streaming sessions admitted (POST /session accepted).",
              sess.get("opened", 0))
  reg.counter(p + "session_closed_total",
              "Sessions ended for any reason (idle reaps included).",
              sess.get("closed", 0))
  reg.counter(p + "session_rejected_total",
              "Session opens shed at the session bound "
              "(503 + Retry-After).", sess.get("rejected", 0))
  reg.counter(p + "session_idle_reaped_total",
              "Sessions closed by the idle reaper.",
              sess.get("idle_reaped", 0))
  reg.counter(p + "session_frames_total",
              "Frames streamed to session clients.", sess.get("frames", 0))
  reg.counter(p + "session_frame_errors_total",
              "Session frames that failed and were surfaced as in-stream "
              "error frames.", sess.get("frame_errors", 0))
  reg.counter(p + "session_flushes_total",
              "Fused drains of a session's pose queue — each submits its "
              "poses concurrently so the scheduler coalesces one flight.",
              sess.get("flushes", 0))
  sess_pf = sess.get("prefetch") or {}
  reg.counter(p + "session_prefetch_issued_total",
              "Speculative prefetch-class renders issued for predicted "
              "view cells.", sess_pf.get("issued", 0))
  reg.counter(p + "session_prefetch_hits_total",
              "Real session frames served from a cell the prefetcher "
              "warmed.", sess_pf.get("hits", 0))
  reg.counter(p + "session_prefetch_suppressed_total",
              "Prefetch rounds skipped because the brownout ladder sat at "
              "L3+ (predictor muted at the source).",
              sess_pf.get("suppressed", 0))
  cache = stats.get("cache") or {}
  reg.counter(p + "cache_hits_total", "Scene-cache hits.",
              cache.get("hits", 0))
  reg.counter(p + "cache_misses_total", "Scene-cache misses (bakes).",
              cache.get("misses", 0))
  reg.counter(p + "cache_evictions_total", "Scene-cache LRU evictions.",
              cache.get("evictions", 0))
  reg.gauge(p + "cache_bytes", "Bytes of baked scenes resident.",
            cache.get("bytes", 0))
  reg.gauge(p + "cache_scenes", "Baked scenes resident.",
            cache.get("scenes", 0))
  breaker = stats.get("breaker")
  if breaker is not None:
    reg.enum(p + "breaker_state",
             "Circuit breaker state (one-hot).",
             ("closed", "open", "half_open"), breaker.get("state", ""))
    reg.gauge(p + "breaker_consecutive_failures",
              "Consecutive primary failures counted by the breaker.",
              breaker.get("consecutive_failures", 0))
  return reg


def render_serve_metrics(stats: dict,
                         latency_hist: dict | None = None) -> str:
  """The ``/metrics`` response body for one stats snapshot."""
  return serve_registry(stats, latency_hist).render()


class ExpositionCache:
  """Memoize a rendered exposition string for a short TTL.

  ``/metrics`` renders a full snapshot per scrape — cheap for one
  Prometheus at 15 s intervals, not for an aggregated cluster endpoint
  that fans out to every backend per scrape (ROADMAP obs follow-on). A
  ~250 ms TTL bounds staleness well below any real scrape interval while
  collapsing scrape storms to one render per window.

  The render runs under the lock, so concurrent scrapes inside one
  window cost exactly one render (the rest return the cached string).
  ``ttl_s <= 0`` disables caching entirely. The clock is injectable —
  the serve/-wide rule (tests pin freshness/staleness with fake clocks).
  """

  def __init__(self, render_fn, ttl_s: float = 0.25, clock=time.monotonic):
    self._render_fn = render_fn
    self.ttl_s = float(ttl_s)
    self._clock = clock
    self._lock = threading.Lock()
    self._text: str | None = None
    self._rendered_at = 0.0
    self.renders = 0
    self.cache_hits = 0

  def get(self) -> str:
    with self._lock:
      now = self._clock()
      if (self.ttl_s > 0 and self._text is not None
          and now - self._rendered_at < self.ttl_s):
        self.cache_hits += 1
        return self._text
      text = self._render_fn()
      self.renders += 1
      self._text = text
      self._rendered_at = now
      return text

  def invalidate(self) -> None:
    """Drop the cached string (the next ``get`` re-renders)."""
    with self._lock:
      self._text = None


def aggregate_metrics_texts(texts, extra: "Registry | None" = None,
                            drop=frozenset(),
                            collect: dict | None = None) -> str:
  """Sum several Prometheus expositions into one (the cluster /metrics).

  Every sample with the same ``(family, sample name, labels)`` key is
  summed across inputs — the right aggregation for counters and
  histograms, and for the gauges this stack exports (queue depths and
  cache bytes add; the breaker one-hot becomes "backends per state";
  ``uptime_seconds`` becomes total backend-seconds). Families keep
  first-seen order and HELP/TYPE text; ``extra`` (e.g. the router's own
  registry) is appended verbatim after the aggregated families.

  ``drop`` names families to OMIT from the aggregate: ratio/config
  gauges (SLO targets, attainment ratios, burn rates) are meaningless
  summed — 3 backends' 0.99 target would read 2.97, and one idle
  backend's NaN attainment would poison the whole fleet's sample. Those
  stay per-backend surfaces (``/stats``'s fan-out carries them); the
  summable slices (window request/bad counts, alert-firing one-hots,
  edge counters) still aggregate.

  Dead backends simply contribute nothing — aggregated counters dip when
  a backend is lost, which is itself the signal (the router's
  ``mpi_cluster_backend_up`` gauge says which one).

  ``collect``, when given, is filled with the aggregated families
  (``{family: {"samples": {key: value}, ...}}``) so a caller that needs
  the parsed form (the router's pooled-quantile computation) does not
  re-parse the multi-thousand-line output it just produced.
  """
  order: list[str] = []
  fams: dict[str, dict] = {}
  for text in texts:
    for name, fam in parse_metrics_text(text).items():
      if name in drop:
        continue
      agg = fams.get(name)
      if agg is None:
        agg = fams[name] = {"type": fam["type"], "help": fam["help"],
                            "samples": {}, "exemplars": {}, "order": []}
        order.append(name)
      for key, value in fam["samples"].items():
        if key not in agg["samples"]:
          agg["samples"][key] = 0.0
          agg["order"].append(key)
        agg["samples"][key] += value
      for key, exemplar in fam.get("exemplars", {}).items():
        # Exemplars survive the merge: counts add, but an exemplar is one
        # concrete observation — keep the largest across the pool (the
        # tail an operator chasing a quantile alert wants to see).
        mine = agg["exemplars"].get(key)
        if mine is None or exemplar[1] >= mine[1]:
          agg["exemplars"][key] = exemplar
  if collect is not None:
    collect.update(fams)
  lines = []
  for name in order:
    fam = fams[name]
    if fam["help"]:
      lines.append(f"# HELP {name} {fam['help']}")
    if fam["type"]:
      lines.append(f"# TYPE {name} {fam['type']}")
    for sample_name, labels in fam["order"]:
      label_str = ""
      if labels:
        inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                         for k, v in labels)
        label_str = "{" + inner + "}"
      line = (f"{sample_name}{label_str} "
              f"{format_value(fam['samples'][(sample_name, labels)])}")
      exemplar = fam["exemplars"].get((sample_name, labels))
      if exemplar is not None:
        line += (f' # {{trace_id="{_escape_label(str(exemplar[0]))}"}} '
                 f"{format_value(exemplar[1])}")
      lines.append(line)
  out = "\n".join(lines) + ("\n" if lines else "")
  if extra is not None:
    out += extra.render()
  return out


def strip_exemplars(text: str) -> str:
  """The exposition without exemplar suffixes.

  Exemplars (`` # {...} v``) are OpenMetrics syntax; the classic
  ``text/plain; version=0.0.4`` format allows only a timestamp after the
  value, and a vanilla Prometheus scrape that meets one fails the ENTIRE
  scrape. The HTTP layer serves this stripped form by default and the
  exemplar-ful form at ``?exemplars=1`` (which the cluster router's
  scrape uses, so exemplars still survive the pool merge).
  """
  if " # " not in text:
    return text
  return "\n".join(
      line if line.startswith("#") else line.partition(" # ")[0]
      for line in text.splitlines()) + ("\n" if text.endswith("\n") else "")


def parse_metrics_text(text: str) -> dict:
  """Minimal exposition-format parser (the test-side inverse).

  Returns ``{family: {"type": str, "help": str, "samples":
  {(sample_name, (("label", "value"), ...)): float}, "exemplars":
  {same key: (trace_id, observed_value)}}}``. Handles exactly what
  ``Registry.render`` emits (OpenMetrics-style `` # {...} v`` exemplars
  included; no timestamps, no escaped-quote labels with commas inside).
  """
  out: dict = {}

  def family(name: str) -> dict:
    return out.setdefault(name, {"type": None, "help": None,
                                 "samples": {}, "exemplars": {}})

  for line in text.splitlines():
    line = line.strip()
    if not line:
      continue
    if line.startswith("# HELP "):
      _, _, rest = line.partition("# HELP ")
      name, _, help_text = rest.partition(" ")
      family(name)["help"] = help_text
    elif line.startswith("# TYPE "):
      _, _, rest = line.partition("# TYPE ")
      name, _, mtype = rest.partition(" ")
      family(name)["type"] = mtype
    elif line.startswith("#"):
      continue
    else:
      exemplar = None
      if " # " in line:
        line, _, exemplar_part = line.partition(" # ")
        ex_labels, _, ex_value = exemplar_part.rpartition(" ")
        tid = ex_labels.partition('trace_id="')[2].partition('"')[0]
        try:
          exemplar = (tid, float(ex_value))
        except ValueError:
          exemplar = None
      name_part, _, value_str = line.rpartition(" ")
      labels: tuple = ()
      if "{" in name_part:
        sample_name, _, label_part = name_part.partition("{")
        label_part = label_part.rstrip("}")
        pairs = []
        for item in filter(None, label_part.split(",")):
          k, _, v = item.partition("=")
          pairs.append((k, v.strip('"')))
        labels = tuple(sorted(pairs))
      else:
        sample_name = name_part
      base = sample_name
      for suffix in ("_bucket", "_zero", "_sum", "_count"):
        if base.endswith(suffix) and base[:-len(suffix)] in out:
          base = base[:-len(suffix)]
          break
      value = float(value_str) if value_str != "+Inf" else math.inf
      fam = family(base)
      fam["samples"][(sample_name, labels)] = value
      if exemplar is not None:
        fam["exemplars"][(sample_name, labels)] = exemplar
  return out
