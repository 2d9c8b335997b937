"""Serving front ends: in-process service + stdlib HTTP server.

PyTorch counterpart of the core of ``mpi_vision_tpu/serve/server.py``.
``RenderService`` wires cache + engine + scheduler + metrics into one
object with a pure-Python API; ``make_http_server`` wraps a service in a
threaded stdlib ``http.server`` front end:

  GET  /healthz -> {"status": "ok" | "degraded" | "unhealthy", "devices",
                   "platform", "scenes", ...}
  GET  /stats   -> the metrics snapshot (latency percentiles, throughput,
                   batch-size histogram, queue depth, cache hit rate,
                   pipeline, engine, breaker, and the tsdb / ship /
                   attrib / incidents / alert_hook blocks when on)
  GET  /metrics -> Prometheus text exposition of the same snapshot under
                   the JAX package's ``mpi_*`` family names (exemplars
                   stripped unless ``?exemplars=1``)
  GET  /debug/tsdb -> windowed history from the on-box time-series ring
                   (?family=&recent=&points=; 503 unless built with tsdb)
  GET  /debug/attrib -> the resource-attribution ledger and its
                   conservation check against the metrics totals (?top=K;
                   503 unless built with attrib)
  GET  /debug/incidents -> the incident-bundle ring index (?id= one
                   bundle; 503 unless built with an incident dir)
  GET  /debug/traces -> recent + slowest-N finished request traces
                   (?id=<trace_id> returns just that id's records)
  GET  /debug/events -> the bounded structured lifecycle event log
                   (breaker transitions, watchdog trips, scene swaps, SLO
                   alert edges, brownout levels; ?kind= filters,
                   ?recent=N bounds)
  GET  /debug/profile?seconds=N -> capture a ``torch.profiler`` trace of
                   live traffic (409 while one is in flight; 503 unless
                   the service was built with a profile dir)
  POST /render  -> body {"scene_id": str, "pose": [[...4x4...]]} ->
                   {"scene_id", "shape", "dtype", "image_b64"} — raw
                   little-endian f32 pixels, base64 (shape [H, W, 3]).
                   ``Accept: application/octet-stream`` returns the raw
                   pixels instead, with ``X-Image-Shape`` and
                   ``X-Image-Dtype`` headers. Every response carries an
                   ``X-Trace-Id`` header (a valid inbound W3C
                   ``traceparent``'s trace-id is honoured). With the edge
                   cache on: a strong ``ETag``, ``If-None-Match`` -> 304,
                   ``Cache-Control: max-age`` and ``X-Edge-Cache``
                   (hit/warp/miss/revalidated). With brownout on:
                   ``X-Request-Class`` admission, ``X-Brownout-Level``,
                   ``X-Degraded`` on degraded frames, 503 + Retry-After
                   on a shed.

Scenes register host-side (``add_scene``) and bake lazily through the LRU
cache on first request; ``swap_scenes`` replaces registered scenes in place
under live traffic (``serve --reload-ckpt-s``). With ``tile=`` (``serve
--tiled``) every scene is split into a fixed tile grid (serve/tiles.py): a
request renders only the frustum-touched crop with content-free planes
culled, through ``method="pallas"`` (the warp, then the CUDA compose
kernel), bit-exact to the untiled render; the baked cache holds tiles, and
a bounded memo holds assembled crops. 404 for unknown scenes, 400 for
malformed requests, 503 when the scheduler sheds load or the circuit
breaker is open with no CPU fallback; handler threads block on the
scheduler future, so HTTP concurrency turns into micro-batch coalescing
on the device.

Degraded modes (the JAX service's, ported): while the breaker refuses the
card, batches render on a CPU fallback engine (``cpu_fallback``; the
kernels' plain versions, by name) and ``/healthz`` reads ``degraded``;
only errors ``classify_error`` calls transient open the breaker, so a
kernel that fails to build or launch fails its request instead of moving
it to the CPU. The edge frame cache (``serve/edge/``) serves exact view
cells from memory and near misses by a homography warp on the engine's
device. SLO tracking (``obs/slo.py``) drives the brownout ladder
(``serve/brownout.py``): thinned planes, half-resolution renders through
the warp and the compose kernel, widened edge warps, sheds.

The flight recorder (the JAX service's, ported): ``/metrics``, an on-box
time-series ring (``obs/tsdb.py``), off-host shipping with a disk spool
(``obs/ship.py``), the resource-attribution ledger (``obs/attrib.py``)
and SLO-triggered incident bundles (``obs/incident.py``), whose optional
profile runs through the same ``DeviceProfiler`` as ``/debug/profile``.
"""

from __future__ import annotations

import base64
import dataclasses
import functools
import hashlib
import json
import math
import re
import threading
import time
import urllib.parse
import zlib
from collections import OrderedDict
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from mpi_vision_tpu_torch.core import camera
from mpi_vision_tpu_torch.core.sampling import Convention
from mpi_vision_tpu_torch.obs import attrib as attrib_mod
from mpi_vision_tpu_torch.obs import incident as incident_mod
from mpi_vision_tpu_torch.obs import prom
from mpi_vision_tpu_torch.obs import ship as ship_mod
from mpi_vision_tpu_torch.obs import tsdb as tsdb_mod
from mpi_vision_tpu_torch.obs.events import EventLog
from mpi_vision_tpu_torch.obs.profile import DeviceProfiler, ProfileBusyError
from mpi_vision_tpu_torch.obs.slo import SloConfig, SloTracker
from mpi_vision_tpu_torch.obs.trace import (
    NULL_TRACE,
    NULL_TRACER,
    Tracer,
    new_trace_id,
)
from mpi_vision_tpu_torch.serve import brownout as brownout_mod
from mpi_vision_tpu_torch.serve import cache as cache_mod
from mpi_vision_tpu_torch.serve import tiles as tiles_mod
from mpi_vision_tpu_torch.serve.edge import (
    EdgeConfig,
    EdgeFrameCache,
    warp_frame,
)
from mpi_vision_tpu_torch.serve.edge.lattice import pose_error
from mpi_vision_tpu_torch.serve.engine import RenderEngine, upsample_nearest
from mpi_vision_tpu_torch.serve.metrics import ServeMetrics
from mpi_vision_tpu_torch.serve.resilience import (
    CircuitBreaker,
    CircuitOpenError,
    ResilienceConfig,
    ResilientExecutor,
    TransientDeviceError,
)
from mpi_vision_tpu_torch.serve.scheduler import MicroBatcher, QueueFullError


def synthetic_scene(scene_id: str, height: int = 256, width: int = 256,
                    planes: int = 16, seed: int = 0):
  """A procedural (rgba_layers, depths, intrinsics) scene for demos/load.

  Smooth per-plane color gradients with sparse alpha, seeded by
  ``(seed, scene_id)`` — the JAX package's recipe, so both packages make
  the same scene from the same seed.
  """
  rng = np.random.default_rng([seed, zlib.crc32(str(scene_id).encode())])
  yy, xx = np.meshgrid(np.linspace(0, 1, height, dtype=np.float32),
                       np.linspace(0, 1, width, dtype=np.float32),
                       indexing="ij")
  layers = np.empty((height, width, planes, 4), np.float32)
  for p in range(planes):
    phase = rng.uniform(0, 2 * np.pi, 3)
    freq = rng.uniform(1.0, 4.0, 3)
    for c in range(3):
      layers[..., p, c] = 0.5 + 0.5 * np.sin(
          freq[c] * (xx + yy) * np.pi + phase[c])
    alpha = 0.5 + 0.5 * np.sin(freq[0] * xx * 7 + phase[0] + p)
    layers[..., p, 3] = np.clip(alpha - 0.3, 0.0, 1.0)
  depths = camera.inv_depths(1.0, 100.0, planes).numpy()
  fx = 0.5 * width
  k = camera.intrinsics_matrix(fx, fx, width / 2.0, height / 2.0).numpy()
  return layers, depths, k


def synthetic_tiled_scene(scene_id: str, height: int = 512,
                          width: int = 512, planes: int = 32,
                          regions: int = 3, band: int | None = None,
                          seed: int = 0):
  """A depth-stratified procedural scene — the tiled-serving workload.

  ``synthetic_scene`` content, but each of ``regions x regions`` spatial
  blocks keeps alpha only on a contiguous band of ``band`` planes — the
  structure Tiled MPI exploits: real scenes put each image region's
  content in a narrow depth range, so a frustum touching few tiles
  needs few planes. The band is a left-to-right depth STAIRCASE (column
  0 holds the nearest slab, the last column the farthest — a room wall
  receding to one side), so a pan that excludes some columns excludes
  their depth slabs too. Plane RGB is left intact everywhere (the
  farthest plane composites unconditionally); only alpha is masked,
  which is exactly the property the plane cull keys on. The JAX
  package's recipe: both packages make the same scene from one seed.
  """
  layers, depths, k = synthetic_scene(scene_id, height, width, planes,
                                      seed=seed)
  if band is None:
    band = max(planes // max(regions, 1), 1)
  ry = -(-height // regions)
  rx = -(-width // regions)
  span = max(planes - band, 0)
  for i in range(regions):
    for j in range(regions):
      lo = round(j * span / max(regions - 1, 1))
      keep = set(range(lo, min(lo + band, planes)))
      drop = [p for p in range(planes) if p not in keep]
      layers[i * ry:(i + 1) * ry, j * rx:(j + 1) * rx][..., drop, 3] = 0.0
  return layers, depths, k


# Assembled-crop memo entries retained per service (serve/tiles.py): the
# steady-state signatures of live traffic are few (view cells cluster),
# and each entry duplicates its crop's bytes on device — keep it small.
_CROP_MEMO_CAP = 32


class RenderService:
  """The in-process serving API (the HTTP layer is a thin shell on this).

  Args:
    cache_bytes: scene-cache byte budget.
    max_batch / max_wait_ms: micro-batching knobs (scheduler.py).
    max_inflight: streaming-pipeline window (scheduler.py): concurrent
      flights whose upload/render/readback overlap and whose futures
      complete out of dispatch order; 1 = blocking dispatch. ``"auto"``
      starts at 2 and grows while growing keeps shrinking the dispatch
      gap, capped at ``max_inflight_cap``.
    max_inflight_cap: hard ceiling for ``max_inflight="auto"``.
    method: render method (engine.py). None (default) picks
      'fused_pallas', the fused CUDA kernel, for untiled services and
      'pallas' (the warp, then the CUDA compose kernel) for tiled or
      brownout ones: the fused kernel cannot render cropped sources or
      reduced-resolution targets.
    tile: tile edge in pixels (``serve/tiles.py``), ``"auto"`` for a
      per-scene edge (``tiles.auto_tile``), or None (default) for
      monolithic scenes. A tiled service splits every registered scene
      into a fixed tile grid: requests render only the frustum-touched
      crop with content-free planes culled (bit-exact to the monolithic
      render when the frustum covers every tile), and the baked cache
      holds, evicts and invalidates per tile.
    convention: coordinate convention for the engine (None keeps the
      engine default, the reference's REF_HOMOGRAPHY). Non-square scenes
      — 1080p included — should pass ``Convention.EXACT``: the reference
      convention's axis swap is only benign on square frames.
    device: "cuda" (default) or "cpu"; with no CUDA device the service
      raises unless the caller passes "cpu". Ignored with ``engine``.
    max_queue: pending-request cap; beyond it requests shed with 503.
    engine: explicit engine override (tests).
    resilience: retry/breaker/watchdog knobs (resilience.py); None turns
      the resilience layer off.
    cpu_fallback: degraded-mode routing while the breaker is open —
      "off" (default) fast-fails instead (503), so work never leaves the
      card unasked; "on" builds a CPU fallback engine; "auto" (the JAX
      package's default) builds one exactly when the primary is not
      already the CPU. The fallback engages only through the breaker,
      which counts only transient errors (watchdog trips included).
    fallback_engine: explicit fallback engine override (tests).
    edge: the pose-quantized edge frame cache (``serve/edge/``): None
      (default) serves every request through the scheduler; an
      ``EdgeConfig`` caches finished frames per view cell, serves exact
      cell hits directly, warps near-misses off the nearest cached frame
      on the engine's device, and gives the HTTP layer strong ETags /
      ``If-None-Match`` -> 304 / ``Cache-Control`` (``render_edge``).
    tracer: request tracing (obs/trace.py); None is the no-op tracer.
    profile_dir: enables ``/debug/profile`` captures into this directory
      (``obs.profile.DeviceProfiler`` over ``torch.profiler``).
    profiler: explicit profiler override (tests inject fake trace
      contexts); wins over ``profile_dir``.
    profile_hook: optional callable invoked with each finished capture's
      directory (``serve --profile-hook CMD``); failures are counted and
      reported in the capture response, never raised.
    slo: SLO tracking (``obs.slo``). The default ``SloConfig()`` tracks
      99% availability + 95%-under-1s latency with multi-window burn-rate
      alerting; pass a custom ``SloConfig``, a pre-built ``SloTracker``
      (tests inject fake clocks), or None to disable. Surfaced as the
      ``slo`` block of ``/stats`` and folded into ``/healthz``.
    brownout: the SLO-driven degradation ladder (``serve/brownout.py``):
      a ``BrownoutConfig`` turns on priority admission and degraded
      rendering (requires SLO tracking, and a method that renders
      reduced-resolution targets: not 'fused_pallas').
    events: the lifecycle event log (``obs.events.EventLog``; a private
      one is made if omitted) serving ``/debug/events``.
    alert_hook: optional callable invoked with each ``slo_alert`` event's
      record on every alert FIRE and CLEAR edge (``serve --alert-hook
      CMD``). Edges are delivered in order by one daemon worker thread,
      off the request path; failures are counted (``alert_hook`` block of
      ``/stats``) and never raised.
    tsdb: the on-box time-series ring (``obs.tsdb``): a ``TsdbConfig``
      samples every ``/metrics`` family on its cadence (the recorder
      thread starts here and stops in ``close``) and serves windowed
      history at ``GET /debug/tsdb``; a pre-built ``TsdbRecorder`` is
      adopted un-started (tests drive ``sample()``); None: 503.
    ship: off-host telemetry shipping (``obs.ship``): a ``ShipConfig``
      batches rotated event-log segments, SLO alert edges, incremental
      tsdb snapshots and incident bundles to its HTTP sink on a daemon
      thread (retry + disk spool; never on the request path); a pre-built
      ``TelemetryShipper`` is adopted un-started (tests drive ``tick()``);
      None disables shipping.
    attrib: resource attribution (``obs.attrib``): an ``AttribConfig``
      accounts every completed request's device phase-seconds (its share
      of the flight's ``last_timings``, timed on the card), queue wait,
      bytes and edge serves into bounded (scene x class x brownout level)
      cells served at ``GET /debug/attrib``; a pre-built ``AttribLedger``
      is adopted; None: 503.
    incidents: the SLO-triggered incident recorder (``obs.incident``): an
      ``IncidentConfig`` captures a bundle (alert and burn numbers,
      slowest traces, tsdb window, events, brownout state, top
      attribution cells, optionally a profile through ``profiler``) on
      every alert FIRE edge, deduplicated until the clear, into a bounded
      on-disk ring served at ``GET /debug/incidents`` and shipped through
      the shipper's spool; a pre-built ``IncidentRecorder`` is adopted
      un-started (tests drive ``drain()``); None: 503. Requires SLO
      tracking.
    metrics_ttl_s: ``/metrics`` exposition-string cache TTL
      (``obs.prom.ExpositionCache``); <= 0 renders fresh every scrape.
    clock: injectable monotonic clock for the scheduler's deadlines, the
      SLO windows, the brownout ladder, the edge cache, the exposition
      cache and the incident recorder.
  """

  def __init__(self, cache_bytes: int = 2 << 30, max_batch: int = 8,
               max_wait_ms: float = 2.0, max_inflight: "int | str" = 4,
               max_inflight_cap: int = 16, method: str | None = None,
               tile: "int | str | None" = None,
               convention: "Convention | None" = None, device="cuda",
               max_queue: int = 1024, engine: RenderEngine | None = None,
               resilience: ResilienceConfig | None = ResilienceConfig(),
               cpu_fallback: str = "off", fallback_engine=None,
               edge: EdgeConfig | None = None,
               tracer: Tracer | None = None, profile_dir: str | None = None,
               profiler: DeviceProfiler | None = None, profile_hook=None,
               slo: "SloConfig | SloTracker | None" = SloConfig(),
               brownout: "brownout_mod.BrownoutConfig | None" = None,
               events: EventLog | None = None, alert_hook=None,
               tsdb: "tsdb_mod.TsdbConfig | tsdb_mod.TsdbRecorder | None" = None,
               ship: "ship_mod.ShipConfig | ship_mod.TelemetryShipper | None" = None,
               attrib: "attrib_mod.AttribConfig | attrib_mod.AttribLedger | None" = None,
               incidents: "incident_mod.IncidentConfig | incident_mod.IncidentRecorder | None" = None,
               metrics_ttl_s: float = 0.25, clock=time.monotonic):
    if cpu_fallback not in ("auto", "on", "off"):
      raise ValueError(
          f"cpu_fallback must be auto/on/off, got {cpu_fallback!r}")
    if cpu_fallback == "on" and resilience is None and fallback_engine is None:
      # The fallback only engages through the resilience layer's breaker;
      # accepting the combination silently would drop an explicit knob.
      raise ValueError("cpu_fallback='on' requires resilience enabled")
    adaptive_inflight = max_inflight == "auto"
    if adaptive_inflight:
      if max_inflight_cap < 2:
        raise ValueError(
            f"max_inflight_cap must be >= 2 for auto, got {max_inflight_cap}")
      max_inflight = 2  # the adaptive starting window
    elif isinstance(max_inflight, str):
      raise ValueError(
          f"max_inflight must be an int or 'auto', got {max_inflight!r}")
    elif max_inflight < 1:
      raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
    if isinstance(tile, str) and tile != "auto":
      raise ValueError(f"tile must be an int, 'auto', or None, got {tile!r}")
    if tile is not None and tile != "auto" and tile < 8:
      # Below 8 px the crop-correction affines degenerate (1-px crops
      # divide by zero under the reference conventions) and the per-tile
      # bookkeeping dwarfs the pixels it manages.
      raise ValueError(f"tile must be >= 8 pixels, got {tile}")
    if method is None:
      method = (engine.method if engine is not None else
                "pallas" if tile is not None or brownout is not None
                else "fused_pallas")
    if tile is not None and method == "fused_pallas":
      # render_mpi rejects source windows for the fused kernel, so
      # every CULLED render would 500 while full-coverage warmup
      # succeeds — fail the misconfiguration at construction instead.
      raise ValueError(
          "tile-granular serving requires an XLA method "
          "('fused'/'scan'/'assoc') or the compose kernel ('pallas'); "
          "method='fused_pallas' cannot render cropped sources")
    if brownout is not None:
      if slo is None:
        # The ladder is DRIVEN by the SLO fast-window burn; without the
        # tracker it would only ever see queue depth and silently lose
        # half its trigger — fail the misconfiguration at construction.
        raise ValueError("brownout requires SLO tracking (slo=None "
                         "disables the burn signal that drives the "
                         "ladder)")
      if method == "fused_pallas":
        # L2's half-resolution renders need a target override, which
        # the fused kernel does not take: the warp, then the compose
        # kernel ('pallas') renders them.
        raise ValueError(
            "brownout degraded rendering requires the compose kernel "
            "('pallas') or a plain method ('fused'/'scan'/'assoc'); "
            "method='fused_pallas' cannot render reduced-resolution "
            "targets")
    if incidents is not None and slo is None:
      # The recorder only ever triggers on SLO alert edges; without the
      # tracker it would sit armed forever and never capture.
      raise ValueError("incidents require SLO tracking (slo=None "
                       "disables the alert edges that trigger capture)")
    # "auto" derives a per-scene size from its dims at publish
    # (tiles_mod.auto_tile); every `self.tile is not None` gate below
    # treats it exactly like an explicit size.
    self.tile = tile if tile == "auto" else (
        int(tile) if tile is not None else None)
    self._clock = clock
    # The engine's own window must not be the bottleneck under retries
    # (an abandoned attempt can briefly hold a slot next to its retry's)
    # nor under adaptive growth (size it for the cap, not the start).
    engine_window = max_inflight_cap if adaptive_inflight else max_inflight
    engine_kw = {} if convention is None else {"convention": convention}
    self.engine = engine if engine is not None else RenderEngine(
        method=method, device=device,
        max_inflight=max(8, 2 * engine_window), **engine_kw)
    self.cache = cache_mod.SceneCache(byte_budget=cache_bytes)
    self.metrics = ServeMetrics()
    # Resource-attribution ledger (obs/attrib.py): installed ON the
    # metrics object so the one record_request recording point feeds
    # both sides of the conservation invariant.
    if isinstance(attrib, attrib_mod.AttribLedger):
      self.attrib = attrib
    elif attrib is not None:
      self.attrib = attrib_mod.AttribLedger(attrib)
    else:
      self.attrib = None
    self.metrics.attrib = self.attrib
    self.events = events if events is not None else EventLog()
    # SLO judgment layer: alert edges land in the event log, request
    # outcomes feed the tracker via ServeMetrics (one recording point).
    if isinstance(slo, SloTracker):
      self.slo = slo
    elif slo is not None:
      self.slo = SloTracker(slo, clock=clock)
    else:
      self.slo = None
    if self.slo is not None:
      if self.slo.on_alert is None:
        self.slo.on_alert = self._on_slo_alert
      self.metrics.slo = self.slo
    self.tracer = tracer if tracer is not None else NULL_TRACER
    if profiler is not None:
      self.profiler = profiler
    else:
      self.profiler = DeviceProfiler(profile_dir) if profile_dir else None
    self.profile_hook = profile_hook
    self.profile_hook_failures = 0
    self.alert_hook = alert_hook
    self._alert_hook_lock = threading.Lock()
    self._alert_hook_queue = None  # lazy: only alerting services pay it
    self.alert_hook_runs = 0
    self.alert_hook_failures = 0
    self._closed = False
    self.resilient = None if resilience is None else ResilientExecutor(
        resilience, metrics=self.metrics, events=self.events)
    self.fallback_engine = fallback_engine
    if (self.fallback_engine is None and self.resilient is not None
        and (cpu_fallback == "on"
             or (cpu_fallback == "auto"
                 and self.engine.platform != "cpu"))):
      self.fallback_engine = self.engine.cpu_fallback()
    # The fallback bakes into caches of its own, so an outage does not
    # evict the card's residency.
    self._fallback_cache = (
        cache_mod.SceneCache(byte_budget=cache_bytes)
        if self.fallback_engine is not None else None)
    self._scene_data: dict[str, tuple] = {}
    self._scene_lock = threading.Lock()
    # Tile-granular serving state (serve/tiles.py): per-scene tiling
    # metadata (digests, plane masks, grid — guarded by _scene_lock), a
    # per-TILE baked LRU (its own cache so tile bytes and evictions are
    # first-class accounting, and a re-registration invalidates exactly
    # the changed tiles), and a small bounded memo of assembled crops so
    # the steady-state path pays one dict lookup instead of K device
    # concatenations per request.
    self._tile_meta: dict[str, tiles_mod.TileMeta] = {}
    self._tile_cache = (cache_mod.SceneCache(byte_budget=cache_bytes)
                        if self.tile is not None else None)
    self._fallback_tile_cache = (
        cache_mod.SceneCache(byte_budget=cache_bytes)
        if self.tile is not None and self.fallback_engine is not None
        else None)
    self._crop_memo: "OrderedDict[str, cache_mod.BakedScene]" = OrderedDict()
    self._crop_memo_bytes = 0
    # A quarter of the baked-cache allowance: each memo entry duplicates
    # its crop's device bytes ON TOP of the tiles it was concatenated
    # from, so the memo gets a bounded supplement, not a second full
    # budget (total tiled residency <= 1.25x cache_bytes).
    self._crop_memo_budget = max(int(cache_bytes) // 4, 1)
    self._crop_lock = threading.Lock()
    # The edge frame cache (serve/edge/): per-scene generation counters
    # make the params digest change on every add_scene/swap_scenes, so a
    # re-registration orphans every cached cell of the old pixels; the
    # base digest folds in the render-affecting engine identity so two
    # differently-configured services never share frame identities.
    self.edge = None if edge is None else EdgeFrameCache(edge,
                                                         clock=self._clock)
    self._scene_gen: dict[str, int] = {}
    desc = self.engine.describe()
    self._edge_base = hashlib.sha1(repr(tuple(
        (k, desc.get(k))
        for k in ("platform", "method", "sharded", "devices")
    )).encode()).hexdigest()[:8]
    if self.edge is not None:
      self.events.emit(
          "edge_cache_enabled",
          trans_cell=self.edge.config.trans_cell,
          rot_bucket_deg=self.edge.config.rot_bucket_deg,
          warp_max_trans=self.edge.config.warp_max_trans,
          warp_max_rot_deg=self.edge.config.warp_max_rot_deg,
          byte_budget=self.edge.config.byte_budget)
    self.brownout = None
    self.scheduler = MicroBatcher(
        self.engine, self._get_scene, metrics=self.metrics,
        max_batch=max_batch, max_wait_ms=max_wait_ms,
        max_queue=max_queue, max_inflight=max_inflight,
        adaptive_inflight=adaptive_inflight,
        max_inflight_cap=max_inflight_cap if adaptive_inflight else None,
        resilient=self.resilient,
        fallback_engine=self.fallback_engine,
        fallback_scene_provider=(
            self._get_scene_fallback
            if self.fallback_engine is not None else None),
        # The keyer carries the brownout degrade tier into batch keys, so
        # untiled brownout services need it installed too (its untiled
        # arm is the identity key at degrade 0).
        batch_keyer=(self._tile_batch_key
                     if self.tile is not None or brownout is not None
                     else None),
        clock=clock).start()
    # Brownout ladder (serve/brownout.py): built after the scheduler so
    # its queue-occupancy signal reads the live queue; the burn signal is
    # the SLO tracker's fast window (validated non-None above).
    if brownout is not None:
      self.brownout = brownout_mod.BrownoutController(
          brownout, burn_fn=self.slo.fast_burn,
          queue_fn=self.scheduler.queue_fraction,
          on_transition=self._on_brownout_transition, clock=clock)
    self._metrics_cache = prom.ExpositionCache(
        self._render_metrics_text, ttl_s=metrics_ttl_s, clock=clock)
    # Flight-recorder legs (obs/tsdb.py, obs/ship.py): configs build and
    # START the daemon threads; pre-built objects are adopted un-started
    # (tests drive sample()/tick() against fake clocks and sinks). The
    # tsdb recorder samples _render_metrics_text directly: history must
    # be fresh samples, not the exposition cache's memoized string.
    if isinstance(tsdb, tsdb_mod.TsdbRecorder):
      self.tsdb = tsdb
    elif tsdb is not None:
      self.tsdb = tsdb_mod.TsdbRecorder(
          self._render_metrics_text, tsdb).start()
    else:
      self.tsdb = None
    if isinstance(ship, ship_mod.TelemetryShipper):
      self.shipper = ship
      if self.shipper.tsdb is None:
        self.shipper.tsdb = self.tsdb
    elif ship is not None:
      self.shipper = ship_mod.TelemetryShipper(ship, tsdb=self.tsdb).start()
    else:
      self.shipper = None
    # Incident recorder (obs/incident.py): built last — its collector
    # freezes every surface wired above (slo, tracer, tsdb, events,
    # brownout, attrib, profiler). Configs build and START the worker;
    # pre-built recorders are adopted un-started (tests drive drain())
    # with the service's collector and shipper wired in if absent.
    if isinstance(incidents, incident_mod.IncidentRecorder):
      self.incidents = incidents
      if self.incidents.collect is None:
        self.incidents.collect = self._incident_context
      if self.incidents.on_bundle is None and self.shipper is not None:
        self.incidents.on_bundle = self.shipper.note_incident
    elif incidents is not None:
      self.incidents = incident_mod.IncidentRecorder(
          incidents, collect=self._incident_context,
          on_bundle=(self.shipper.note_incident
                     if self.shipper is not None else None),
          events=self.events, clock=clock).start()
    else:
      self.incidents = None

  def _on_slo_alert(self, name: str, firing: bool, details: dict) -> None:
    record = self.events.emit("slo_alert", slo=name, firing=firing,
                              **details)
    # NULL_EVENTS returns None; the shipper and the hook still need the
    # facts.
    if record is None:
      record = {"kind": "slo_alert", "slo": name, "firing": firing,
                **details}
    shipper = getattr(self, "shipper", None)
    if shipper is not None:
      # O(1) queue append — the off-host delivery happens on the
      # shipper's own thread, never inside the alert (request) path.
      shipper.note_alert(record)
    incidents = getattr(self, "incidents", None)
    if incidents is not None:
      # Same contract: O(1) edge note here, bundle capture on the
      # recorder's own worker thread (deduplicated until the clear).
      incidents.note_alert(name, firing, details)
    if self.alert_hook is None or self._closed:
      return
    # Off the request path, ONE worker draining a queue: a slow FIRE
    # delivery must not be overtaken by its own CLEAR.
    with self._alert_hook_lock:
      if self._alert_hook_queue is None:
        import queue

        self._alert_hook_queue = queue.SimpleQueue()
        threading.Thread(target=self._alert_hook_worker,
                         name="mpi-serve-alert-hook", daemon=True).start()
    self._alert_hook_queue.put(dict(record))

  def _alert_hook_worker(self) -> None:
    while True:
      record = self._alert_hook_queue.get()
      if record is None:  # close() sentinel: drain done, exit
        return
      try:
        self.alert_hook(record)
        with self._alert_hook_lock:
          self.alert_hook_runs += 1
      except Exception as e:  # noqa: BLE001 - a dead pager must not kill serving
        with self._alert_hook_lock:
          self.alert_hook_runs += 1
          self.alert_hook_failures += 1
        self.events.emit("alert_hook_failed", slo=record.get("slo"),
                         firing=record.get("firing"), error=repr(e))

  def _incident_context(self, alert: dict) -> dict:
    """One incident bundle's context (the recorder's ``collect`` hook):
    the SLO burn numbers, the slowest traces, the tsdb window over the
    spike, the recent events, the brownout state, the hottest
    attribution cells — frozen at the fire edge, plus optionally a
    device-profile capture through the service's ``DeviceProfiler`` (a
    capture already in flight, e.g. a concurrent ``/debug/profile``,
    leaves ``{"error": ...ProfileBusyError...}`` instead). Runs on the
    recorder's worker thread, never the request path."""
    del alert  # the recorder already embeds the alert record itself
    cfg = self.incidents.config
    out: dict = {}
    if self.slo is not None:
      out["slo"] = self.slo.snapshot()
    if self.tracer is not NULL_TRACER:
      out["traces"] = self.tracer.snapshot(recent=cfg.traces_recent)
    if self.tsdb is not None:
      out["tsdb_window"] = {
          "window_s": cfg.tsdb_window_s,
          "families": self.tsdb.snapshot_since(
              self.tsdb.now() - cfg.tsdb_window_s)}
    out["events"] = self.events.snapshot(recent=cfg.events_recent)
    if self.brownout is not None:
      out["brownout"] = self.brownout.snapshot()
    if self.attrib is not None:
      out["attrib_top"] = self.attrib.top_cells(cfg.top_k_cells)
    if cfg.profile_seconds > 0 and self.profiler is not None:
      try:
        out["profile"] = self.profile(cfg.profile_seconds)
      except Exception as e:  # noqa: BLE001 - a busy/failing profiler
        # must not cost the bundle its other slices.
        out["profile"] = {"error": repr(e)}
    return out

  def _on_brownout_transition(self, old: int, new: int,
                              reason: str) -> None:
    self.events.emit("brownout_level", old=old, new=new, reason=reason)

  # -- scenes -------------------------------------------------------------

  def add_scene(self, scene_id: str, rgba_layers, depths,
                intrinsics) -> None:
    """Register a scene (host arrays); it bakes lazily on first request.
    Re-registering an id drops its baked copies and its edge frames.

    With tiling on, the scene is split into its tile grid here (per-tile
    digests + plane masks) and a re-registration invalidates ONLY the
    tiles whose bytes changed.
    """
    entry = (np.asarray(rgba_layers, np.float32),
             np.asarray(depths, np.float32),
             np.asarray(intrinsics, np.float32))
    sid = str(scene_id)
    if tiles_mod.KEY_SEP in sid:
      # The tile/crop batch- and cache-key separator: a scene id
      # carrying it would alias tile keys (the HTTP layer rejects all
      # control characters for the same reason).
      raise ValueError("scene_id must not contain '\\x1f'")
    if self.tile is not None:
      self._publish_tiled(sid, entry)
      return
    with self._scene_lock:
      self._scene_data[sid] = entry
      # New content under this id: a fresh generation makes every edge
      # frame digest of the old pixels unreachable.
      self._scene_gen[sid] = self._scene_gen.get(sid, 0) + 1
    self.cache.invalidate(sid)
    if self._fallback_cache is not None:
      self._fallback_cache.invalidate(sid)
    if self.edge is not None:
      self.edge.invalidate_scene(sid)

  def _publish_tiled(self, sid: str, entry: tuple) -> list[tuple[int, int]]:
    """Publish (or re-publish) one scene into the tiled registry and
    invalidate exactly the tiles whose bytes changed — in the card's tile
    cache, the fallback's, and the edge frames that sampled them. Returns
    the changed tile ids (every tile for a first publish or a
    grid/geometry change)."""
    tile_px = (self.tile if isinstance(self.tile, int)
               else tiles_mod.auto_tile(entry[0].shape[0],
                                        entry[0].shape[1]))
    meta = tiles_mod.TileMeta.build(entry[0], entry[1], entry[2], tile_px)
    with self._scene_lock:
      old = self._tile_meta.get(sid)
      self._scene_data[sid] = entry
      self._tile_meta[sid] = meta
    prefix = sid + tiles_mod.KEY_SEP
    tile_caches = [c for c in (self._tile_cache, self._fallback_tile_cache)
                   if c is not None]
    if old is None:
      # First publish under this id: nothing valid can be cached.
      for c in tile_caches:
        c.invalidate_prefix(prefix)
      self.cache.invalidate(sid)
      self._purge_crop_memo(sid)
      if self.edge is not None:
        self.edge.invalidate_scene(sid)
      return [(i, j) for i in range(meta.grid.rows)
              for j in range(meta.grid.cols)]
    changed = old.changed_tiles(meta)
    all_changed = len(changed) == len(meta.grid) or old.grid != meta.grid
    for c in tile_caches:
      if all_changed:
        # Grid or geometry changed: every old tile id is dead.
        c.invalidate_prefix(prefix)
      else:
        for (i, j) in changed:
          c.invalidate(tiles_mod.tile_cache_key(sid, i, j))
    if changed:
      self._purge_crop_memo(sid)
      if self.edge is not None:
        # Frames that never sampled a changed tile keep their bytes AND
        # their strong ETags; a geometry change may move every frame.
        if all_changed:
          self.edge.invalidate_scene(sid)
        else:
          self.edge.invalidate_tiles(sid, changed)
    return changed

  def swap_scenes(self, scenes: dict, prebake: bool = False) -> list[str]:
    """Atomically publish new host data for ``scenes`` (live checkpoint
    reload, ``serve --reload-ckpt-s``).

    ``scenes`` maps scene id -> ``(rgba_layers, depths, intrinsics)``.
    The registry updates first, under the scene lock, then the baked
    caches — the card's and the CPU fallback's — and the edge frame cache
    invalidate the swapped ids, so a request that raced the swap renders
    either the old bake or the new one, never a mix, and no in-flight
    request is dropped: futures already holding a ``BakedScene`` render
    it to completion, and the old device buffers free when the last
    reference drops. A bake that read the old data and finishes after
    the invalidation serves only its own request:
    ``SceneCache.get_or_bake`` keeps it out of the cache, so no later
    request renders the old scene. A tiled service re-publishes through
    ``_publish_tiled``, which invalidates only the tiles whose digests
    changed (and only the edge frames that sampled them). ``prebake=True``
    bakes the swapped scenes (only the changed tiles, when tiled) before
    returning, so the first post-swap request does not pay the bake.
    Emits ``edge_cache_invalidated`` (untiled, with an edge cache) and
    ``scene_swap`` events. Returns the swapped ids.
    """
    entries = {
        str(sid): (np.asarray(rgba, np.float32),
                   np.asarray(depths, np.float32),
                   np.asarray(k, np.float32))
        for sid, (rgba, depths, k) in scenes.items()}
    swapped = sorted(entries)
    if self.tile is not None:
      changed = {sid: self._publish_tiled(sid, entry)
                 for sid, entry in entries.items()}
      if prebake:
        for sid, tiles in changed.items():
          if tiles:
            self._get_scene(sid)
      self.events.emit("scene_swap", scenes=swapped, prebake=bool(prebake),
                       tiles_changed={sid: len(t)
                                      for sid, t in changed.items()})
      return swapped
    with self._scene_lock:
      self._scene_data.update(entries)
      for sid in entries:
        self._scene_gen[sid] = self._scene_gen.get(sid, 0) + 1
    for sid in entries:
      self.cache.invalidate(sid)
      if self._fallback_cache is not None:
        self._fallback_cache.invalidate(sid)
    if self.edge is not None:
      # The edge cache invalidates exactly like the baked caches: a
      # request racing the swap serves old pixels under the OLD etag or
      # new pixels under a NEW one, never stale bytes under a fresh tag
      # (the generation bump above already orphaned the old digests;
      # the sweep frees their bytes).
      dropped = sum(self.edge.invalidate_scene(sid) for sid in swapped)
      self.events.emit("edge_cache_invalidated", scenes=swapped,
                       frames=dropped)
    if prebake:
      for sid in entries:
        self._get_scene(sid)
    self.events.emit("scene_swap", scenes=swapped, prebake=bool(prebake))
    return swapped

  def _purge_crop_memo(self, sid: str) -> None:
    with self._crop_lock:
      for key in [k for k in self._crop_memo
                  if k.startswith(sid + tiles_mod.KEY_SEP)]:
        self._crop_memo_bytes -= self._crop_memo.pop(key).nbytes

  def add_synthetic_scenes(self, n: int, height: int = 256, width: int = 256,
                           planes: int = 16, seed: int = 0) -> list[str]:
    ids = []
    for i in range(n):
      sid = f"scene_{i:03d}"
      self.add_scene(sid, *synthetic_scene(sid, height, width, planes,
                                           seed=seed + i))
      ids.append(sid)
    return ids

  def scene_ids(self) -> list[str]:
    with self._scene_lock:
      return sorted(self._scene_data)

  def tile_meta(self, scene_id: str):
    """The current ``TileMeta`` of a tiled scene (None if unknown or the
    service is untiled)."""
    with self._scene_lock:
      return self._tile_meta.get(str(scene_id))

  def _tile_batch_key(self, scene_id: str, pose,
                      degrade: int = 0) -> tuple[str, dict | None]:
    """The scheduler's batch-key hook for tiled and brownout services:
    frustum-cull the request into a ``TileSignature`` so it batches only
    with requests sharing its exact render plan. Untiled scenes pass
    through on the plain id (the scene provider answers unknown ones with
    KeyError).

    Under brownout the admitted level arrives as ``degrade``: L1 thins
    the signature's plane set (the key changes with it, so degraded and
    full-quality requests can never coalesce into one batch), and L2
    additionally appends the half-res marker field — a distinct key AND
    a distinct scene-provider plan."""
    with self._scene_lock:
      meta = self._tile_meta.get(scene_id)
    if meta is None:
      if degrade >= 2:
        return brownout_mod.half_res_key(scene_id), None
      return scene_id, None
    sig = meta.plan(np.asarray(pose, np.float32)[None],
                    self.engine.convention)
    if degrade >= 1 and self.brownout is not None:
      sig = dataclasses.replace(sig, planes=tiles_mod.thin_planes(
          sig.planes, self.brownout.config.plane_keep))
    key = scene_id + tiles_mod.KEY_SEP + sig.token()
    if degrade >= 2:
      key = brownout_mod.half_res_key(key)
    # No metrics here: the scheduler records the attrs only for
    # requests it actually ENQUEUES, so queue-full rejections never skew
    # the cull ratios.
    return key, {
        "tiles_touched": sig.tiles_touched,
        "tiles_rendered": sig.tiles_rendered,
        "tiles_culled": sig.tiles_total - sig.tiles_rendered,
        "tiles_total": sig.tiles_total,
        "planes": len(sig.planes),
    }

  def _get_scene(self, scene_id: str) -> cache_mod.BakedScene:
    base, half_res = brownout_mod.split_degrade_key(scene_id)
    sid, _, token = base.partition(tiles_mod.KEY_SEP)
    if self.tile is not None:
      with self._scene_lock:
        meta = self._tile_meta.get(sid)
      if meta is not None:
        scene = self._assemble_crop(sid, meta, token, fallback=False)
        return (self._half_res_view(scene, meta.intrinsics) if half_res
                else scene)

    def bake():
      with self._scene_lock:
        entry = self._scene_data.get(base)
      if entry is None:
        raise KeyError(f"unknown scene {base!r}")
      # Bake-fault hook (FaultyEngine.check_bake): inside the cache-miss
      # path so injected bake failures fire exactly where a dead device
      # would fail a real bake — never on cache hits.
      check_bake = getattr(self.engine, "check_bake", None)
      if check_bake is not None:
        check_bake(base)
      return cache_mod.bake_scene(base, *entry, device=self.engine.device)

    scene = self.cache.get_or_bake(base, bake)
    if half_res:
      # L2 half-res view of the full bake: shares the device planes
      # (nothing extra resident), overrides only the render target.
      with self._scene_lock:
        entry = self._scene_data.get(base)
      if entry is None:
        raise KeyError(f"unknown scene {base!r}")
      scene = self._half_res_view(scene, entry[2])
    return scene

  def _half_res_view(self, scene: cache_mod.BakedScene,
                     intrinsics) -> cache_mod.BakedScene:
    """The L2 target override of a full-quality bake: the scene's host
    ``intrinsics`` scaled by 1/2 in their first two rows (exact in f32)
    and the output raster halved. The source planes are shared by
    reference. The target intrinsics go up from the host (a synchronous
    copy), so the engine's stream reads finished bytes."""
    if scene.out_hw is not None:
      h, w = scene.out_hw
    elif scene.src_window is not None:
      h, w = scene.src_window[2:]
    else:
      h, w = int(scene.planes.shape[1]), int(scene.planes.shape[2])
    tgt_k = np.asarray(intrinsics, np.float32) * np.asarray(
        [[0.5], [0.5], [1.0]], np.float32)
    return dataclasses.replace(
        scene, scene_id=brownout_mod.half_res_key(scene.scene_id),
        tgt_intrinsics=torch.from_numpy(tgt_k).to(scene.device),
        out_hw=(max(int(h) // 2, 1), max(int(w) // 2, 1)))

  def _assemble_crop(self, sid: str, meta: tiles_mod.TileMeta,
                     token: str, fallback: bool) -> cache_mod.BakedScene:
    """The tiled scene provider: per-tile get-or-bake, then one device
    concatenation of the signature's crop with its culled plane set,
    marked with its window of the scene (``BakedScene.src_window``). A
    bounded memo makes the repeat path one dict lookup; a full-coverage
    crop is a plain whole-scene ``BakedScene``, the untiled path's call.
    ``fallback`` assembles on the CPU fallback's device from its own tile
    cache.

    The JAX package folds the crop into corrected source intrinsics; at
    1080p that moves a tap by up to ~1e-4 px (the f32 spacing near 1920),
    enough to show at a hard alpha edge. The window keeps every tap the
    full render's, so a culled frame is bit-identical to the untiled one:
    taps with content land in the crop (the frustum test), and a culled
    plane's alpha is exactly 0 there, an exact no-op in the composite."""
    grid = meta.grid
    sig = None
    if token:
      # The token was minted by the batch keyer against the meta CURRENT
      # at submit time; a re-registration that changed the grid or plane
      # count while the request sat queued makes it stale. Validate
      # against THIS meta and fall back to full coverage of the current
      # scene — a correct fresh frame beats a misrender or a 500.
      try:
        parsed = tiles_mod.TileSignature.parse(token, grid)
        y0, y1, x0, x1 = parsed.crop
        if (0 <= y0 < y1 <= grid.height and 0 <= x0 < x1 <= grid.width
            and parsed.planes
            and all(0 <= p < meta.planes for p in parsed.planes)):
          sig = parsed
      except ValueError:
        pass
    if sig is None:
      # Plain scene-id lookups (warmup, prebake) assemble full coverage.
      sig = meta.signature(np.ones((grid.rows, grid.cols), bool))
    memo_key = sid + tiles_mod.KEY_SEP + sig.token() + (
        tiles_mod.KEY_SEP + "fb" if fallback else "")
    with self._crop_lock:
      memo = self._crop_memo.get(memo_key)
      if memo is not None:
        self._crop_memo.move_to_end(memo_key)
        return memo
    cache = self._fallback_tile_cache if fallback else self._tile_cache
    device = (self.fallback_engine.device if fallback
              else self.engine.device)
    rows, cols = meta.crop_tiles(sig.crop)

    def bake_tile(i, j):
      key = tiles_mod.tile_cache_key(sid, i, j)

      def bake():
        with self._scene_lock:
          entry = self._scene_data.get(sid)
        if entry is None:
          raise KeyError(f"unknown scene {sid!r}")
        if not fallback:
          check_bake = getattr(self.engine, "check_bake", None)
          if check_bake is not None:
            check_bake(sid)
        y0, y1, x0, x1 = grid.rect(i, j)
        return cache_mod.bake_scene(key, entry[0][y0:y1, x0:x1], entry[1],
                                    entry[2], device=device)
      return cache.get_or_bake(key, bake)

    all_planes = len(sig.planes) == meta.planes
    idx = torch.tensor(sig.planes, dtype=torch.long, device=device)

    def planes_of(tile):
      return tile.planes if all_planes else tile.planes[idx]

    tile_rows, depths, intrinsics = [], None, None
    for i in rows:
      row = [bake_tile(i, j) for j in cols]
      depths, intrinsics = row[0].depths, row[0].intrinsics
      tile_rows.append(planes_of(row[0]) if len(row) == 1 else torch.cat(
          [planes_of(t) for t in row], dim=2))
    planes = tile_rows[0] if len(tile_rows) == 1 else torch.cat(tile_rows,
                                                                dim=1)
    planes = planes.contiguous()
    y0, _, x0, _ = sig.crop
    window = (None if sig.crop == (0, grid.height, 0, grid.width)
              else (y0, x0, grid.height, grid.width))
    depths_sel = depths if all_planes else depths[idx]
    if device.type == "cuda":
      # The concatenation ran on this thread's stream; the engine reads
      # the crop on its own.
      torch.cuda.current_stream(device).synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in (planes, depths_sel, intrinsics))
    scene = cache_mod.BakedScene(memo_key, planes, depths_sel, intrinsics,
                                 nbytes, src_window=window)
    # Memoize ONLY if no re-registration raced this assembly — verified
    # and inserted under the scene lock, so a publish either
    # happens-before this check (stale branch below) or happens-after,
    # in which case its memo purge runs after this insert.
    with self._scene_lock:
      if self._tile_meta.get(sid) is meta:
        with self._crop_lock:
          old = self._crop_memo.pop(memo_key, None)
          if old is not None:  # a concurrent same-key assembly won
            self._crop_memo_bytes -= old.nbytes
          self._crop_memo[memo_key] = scene
          self._crop_memo_bytes += scene.nbytes
          # Bounded by entries AND bytes (each entry duplicates its crop
          # on the device).
          while self._crop_memo and (
              len(self._crop_memo) > _CROP_MEMO_CAP
              or self._crop_memo_bytes > self._crop_memo_budget):
            _, evicted = self._crop_memo.popitem(last=False)
            self._crop_memo_bytes -= evicted.nbytes
        return scene
    # Stale: the tiles baked above may hold pre-publish bytes inserted
    # AFTER the publish's invalidation sweep. Drop them and serve this
    # result uncached.
    for i in rows:
      for j in cols:
        cache.invalidate(tiles_mod.tile_cache_key(sid, i, j))
    return scene

  def _get_scene_fallback(self, scene_id: str) -> cache_mod.BakedScene:
    """Scene provider for the degraded-mode engine: same host arrays,
    baked onto the fallback's (CPU) device, cached separately so an
    outage does not evict the card's residency. The L2 half-res marker
    is ignored: the fallback is already the degraded-capacity path, and
    a full-resolution frame needs no upsample at readback."""
    base, _ = brownout_mod.split_degrade_key(scene_id)
    sid, _, token = base.partition(tiles_mod.KEY_SEP)
    if self.tile is not None:
      with self._scene_lock:
        meta = self._tile_meta.get(sid)
      if meta is not None:
        return self._assemble_crop(sid, meta, token, fallback=True)

    def bake():
      with self._scene_lock:
        entry = self._scene_data.get(base)
      if entry is None:
        raise KeyError(f"unknown scene {base!r}")
      return cache_mod.bake_scene(base, *entry,
                                  device=self.fallback_engine.device)

    return self._fallback_cache.get_or_bake(base, bake)

  def prebake_fallback(self, k: int | None = None,
                       scene_ids=None) -> list[str]:
    """Pre-bake the hottest-K scenes onto the degraded-mode CPU engine, so
    the first breaker-open render of each does not pay a cold CPU bake on
    top of an already-degraded request. "Hottest" defaults to
    registration order; pass ``scene_ids`` to override. Returns the ids
    baked ([] when there is no fallback engine)."""
    if self.fallback_engine is None:
      return []
    ids = list(scene_ids) if scene_ids is not None else self.scene_ids()
    if k is not None:
      ids = ids[:max(int(k), 0)]
    for sid in ids:
      self._get_scene_fallback(sid)
    return ids

  def warmup(self, scene_ids=None) -> None:
    """Bake scenes (default: all registered) and render every batch
    bucket up to the scheduler's ``max_batch`` once on the first, so the
    kernel is built and the pinned buffers are allocated before traffic.
    With brownout on, the half-resolution (L2) buckets render too; with
    the edge cache on, one warp of each scene resolution runs."""
    ids = list(scene_ids) if scene_ids is not None else self.scene_ids()
    if not ids:
      return
    scenes = [self._get_scene(sid) for sid in ids]
    eye = np.eye(4, dtype=np.float32)
    buckets = sorted({self.engine.batch_bucket(v)
                      for v in range(1, self.scheduler.max_batch + 1)})
    variants = [scenes[0]]
    if self.brownout is not None:
      with self._scene_lock:
        k = self._scene_data[ids[0]][2]
      variants.append(self._half_res_view(scenes[0], k))
    for scene in variants:
      for b in buckets:
        self.engine.render_batch(scene, np.broadcast_to(eye, (b, 4, 4)))
    if self.edge is not None:
      warmed: set[tuple[int, int]] = set()
      for sid in ids:
        try:
          hw = self._full_hw(sid)
          if hw in warmed:
            continue
          _, intrinsics, plane_depth, _ = self._edge_meta(sid)
        except KeyError:
          continue
        warmed.add(hw)
        frame = np.zeros((hw[0], hw[1], 3), np.float32)
        warp_frame(frame, eye, eye, intrinsics, plane_depth,
                   device=self.engine.device)

  # -- request path -------------------------------------------------------

  def render(self, scene_id: str, pose, timeout: float = 60.0,
             trace=NULL_TRACE) -> np.ndarray:
    """Blocking render of one ``[4, 4]`` pose -> ``[H, W, 3]`` f32."""
    return self.scheduler.render(scene_id, pose, timeout=timeout,
                                 trace=trace)

  def render_async(self, scene_id: str, pose):
    """Non-blocking render; returns a ``concurrent.futures.Future``."""
    return self.scheduler.submit(scene_id, pose)

  def _full_hw(self, scene_id: str) -> tuple[int, int]:
    """The scene's full output raster ``(H, W)`` — the shape contract a
    degraded (half-res) render is upsampled back to at readback."""
    sid = str(scene_id)
    with self._scene_lock:
      meta = self._tile_meta.get(sid)
      entry = self._scene_data.get(sid)
    if meta is not None:
      return meta.grid.height, meta.grid.width
    if entry is None:
      raise KeyError(f"unknown scene {sid!r}")
    return int(entry[0].shape[0]), int(entry[0].shape[1])

  def _attrib_kwargs(self, attrib: "tuple | None",
                     edge: str | None) -> dict:
    """``record_request``'s attribution context for an edge-served
    request (kwargs form: with the ledger off nothing is passed)."""
    if self.attrib is None:
      return {}
    cls, level = attrib if attrib is not None else (None, 0)
    return {"attrib": {"class": cls, "level": level, "edge": edge}}

  def _attrib_bytes(self, scene_id, attrib: "tuple | None",
                    nbytes) -> None:
    """Account response payload bytes to the request's attribution cell
    (no-op with the ledger off). Recorded at the serving front doors
    (``render_edge``/``render_request``); raw ``render()`` callers get no
    bytes attribution — they never serialized a response."""
    if self.attrib is None:
      return
    cls, level = attrib if attrib is not None else (None, 0)
    self.attrib.record_bytes(scene_id, cls, level, nbytes=int(nbytes))

  def _render_scheduled(self, scene_id: str, pose, timeout: float,
                        trace, degrade: int,
                        attrib: "tuple | None" = None) -> np.ndarray:
    """Scheduler render at the admitted degrade tier. L2+ renders at
    half resolution on the device (a quarter of the compositing work) and
    nearest-upsamples back to the full raster on the host at readback,
    so every response keeps the scene's shape contract."""
    img = self.scheduler.render(scene_id, pose, timeout=timeout,
                                trace=trace, degrade=min(degrade, 2),
                                attrib=attrib)
    if degrade >= 2:
      img = upsample_nearest(img, self._full_hw(scene_id))
    return img

  # -- edge frame cache ---------------------------------------------------

  def _edge_meta(self, scene_id: str) -> tuple[str, np.ndarray, float,
                                               str | None]:
    """``(params_digest, intrinsics, plane_depth, content_token)``.

    The digest is the edge cache-key component. Untiled scenes fold in
    the scene's generation, so any content change retires every cached
    cell (token None — stale puts key an unreachable digest and need no
    guard). TILED scenes keep a STABLE digest — correctness comes from
    tile-addressed invalidation instead, which is what lets frames that
    never sampled a changed tile survive a reload with their ETags — and
    the token (the tile-digest hash) guards ``_edge_put`` against a
    render that raced a swap. Raises ``KeyError`` for unknown scenes.
    """
    sid = str(scene_id)
    with self._scene_lock:
      entry = self._scene_data.get(sid)
      if entry is None:
        raise KeyError(f"unknown scene {sid!r}")
      gen = self._scene_gen.get(sid, 0)
      meta = self._tile_meta.get(sid)
      depths, intrinsics = entry[1], entry[2]
    # Representative warp depth: the geometric mean of the scene's depth
    # range — the single plane that splits typical MPI content evenly.
    d_near, d_far = float(depths.min()), float(depths.max())
    plane_depth = math.sqrt(max(d_near, 1e-6) * max(d_far, 1e-6))
    if meta is not None:
      return (f"{self._edge_base}:tiled", intrinsics, plane_depth,
              meta.scene_digest)
    return f"{self._edge_base}:g{gen}", intrinsics, plane_depth, None

  def _touched_tiles(self, scene_id: str, pose) -> frozenset | None:
    """The tile ids this pose's frustum can sample (None for untiled
    scenes) — recorded on edge entries for tile-addressed invalidation."""
    with self._scene_lock:
      meta = self._tile_meta.get(str(scene_id))
    if meta is None:
      return None
    return meta.touched_tile_ids(
        meta.touched(np.asarray(pose, np.float32)[None],
                     self.engine.convention))

  def _edge_put(self, sid: str, digest: str, cell, pose, img, intrinsics,
                plane_depth: float, token: str | None, tiles):
    """Populate the edge cell, guarded against a swap that raced the
    render: a tiled scene's digest is stable across reloads, so a stale
    put must be REFUSED (checked and inserted under the scene lock).
    Untiled scenes need no guard: their digest carries the generation."""
    if token is None:
      return self.edge.put(sid, digest, cell, pose, img, intrinsics,
                           plane_depth)
    with self._scene_lock:
      meta = self._tile_meta.get(sid)
      if meta is None or meta.scene_digest != token:
        return None  # scene changed mid-render: serve it, don't cache it
      return self.edge.put(sid, digest, cell, pose, img, intrinsics,
                           plane_depth, tiles=tiles)

  def render_edge(self, scene_id: str, pose, timeout: float = 60.0,
                  trace=NULL_TRACE, degrade: int = 0,
                  attrib: "tuple | None" = None) -> tuple[np.ndarray,
                                                          dict]:
    """Render through the edge frame cache -> ``(image, info)``.

    ``info``: ``{"edge": "off" | "hit" | "warp" | "miss", "etag":
    str | None, "max_age_s": int | None, "degraded": bool}``. Exact cell
    hits return the stored frame (READ-ONLY — it is shared with every
    other hit) with its strong ETag; near-misses return a fresh
    single-homography warp of the nearest cached frame, resampled on the
    engine's device (pose-specific, so no ETag); misses render through
    the scheduler and populate the cell. Hit and warp latencies are
    recorded into the same request metrics/SLO stream as rendered ones.
    With the edge cache disabled this is exactly a scheduled render (plus
    the ``"off"`` info).

    ``degrade`` is the admitted brownout tier. It reshapes this path,
    never the cache: L3 widens the warp tolerance (stale-while-
    overloaded), and a degraded MISS renders thinned/half-res and is
    served WITHOUT an ETag and WITHOUT populating the cell. The edge
    cache holds only full-quality frames, ever. ``attrib`` is the
    request's ``(class, level)``, threaded to its trace.
    """
    if self.edge is None:
      img = self._render_scheduled(str(scene_id), pose, timeout, trace,
                                   degrade, attrib)
      self._attrib_bytes(scene_id, attrib, img.nbytes)
      return (img, {"edge": "off", "etag": None, "max_age_s": None,
                    "degraded": degrade > 0})
    t0 = self._clock()
    try:
      # Everything before the scheduler hand-off owns the trace's error
      # edge: a 404 (unknown scene) or a failing warp happens entirely
      # up here. Past the hand-off the flight finishes the trace.
      pose = np.asarray(pose, np.float32)
      digest, intrinsics, plane_depth, token = self._edge_meta(scene_id)
      max_age = self.edge.config.max_age_s
      warp_scale = (self.brownout.config.l3_warp_scale
                    if degrade >= 3 and self.brownout is not None else 1.0)
      kind, entry, cell = self.edge.lookup(scene_id, digest, pose,
                                           warp_scale=warp_scale)
      if kind == "hit":
        span = trace.start_span("edge_hit", cell=list(cell))
        trace.end_span(span)
        self.metrics.record_request(self._clock() - t0, scene_id=scene_id,
                                    trace_id=trace.trace_id or None,
                                    **self._attrib_kwargs(attrib, "hit"))
        self._attrib_bytes(scene_id, attrib, entry.frame.nbytes)
        trace.finish()
        # An exact hit is the stored full-quality frame whatever the
        # brownout level — it keeps its strong ETag and is NOT degraded.
        return entry.frame, {"edge": "hit", "etag": entry.etag,
                             "max_age_s": max_age, "degraded": False}
      if kind == "warp":
        span = trace.start_span("edge_warp", cell=list(cell),
                                from_cell=list(entry.cell))
        img = warp_frame(entry.frame, entry.pose, pose, entry.intrinsics,
                         entry.plane_depth, device=self.engine.device)
        trace.end_span(span)
        warp_trans, warp_rot_deg = pose_error(pose, entry.pose)
        self.metrics.record_warp_pose_error(
            warp_trans, warp_rot_deg, trace_id=trace.trace_id or None)
        self.metrics.record_request(self._clock() - t0, scene_id=scene_id,
                                    trace_id=trace.trace_id or None,
                                    **self._attrib_kwargs(attrib, "warp"))
        self._attrib_bytes(scene_id, attrib, img.nbytes)
        trace.finish()
        # A warp served only because L3 widened the tolerance is
        # labelled degraded; one within the base tolerance is ordinary
        # quality whatever the level.
        cfg = self.edge.config
        stale = (warp_trans > cfg.warp_max_trans
                 or warp_rot_deg > cfg.warp_max_rot_deg)
        return img, {"edge": "warp", "etag": None, "max_age_s": max_age,
                     "degraded": stale}
    except Exception as e:
      trace.finish(error=repr(e))
      raise
    # Negative cache: this view cell was shed queue-full moments ago and
    # its negative TTL has not lapsed — fail fast with the remaining TTL
    # as Retry-After instead of re-entering the saturated queue.
    shed_remaining_s = self.edge.negative_lookup(scene_id, digest, pose)
    if shed_remaining_s is not None:
      err = QueueFullError(
          "request queue full (negative-cached view cell)")
      err.retry_after_s = shed_remaining_s
      trace.finish(error=repr(err))
      raise err
    # Miss: a real render (latency recorded by the scheduler as usual),
    # then populate the cell. First writer wins — serving the RESIDENT
    # entry's frame keeps every response consistent with the cell's one
    # strong ETag even when two misses race. Tiled scenes record the
    # frustum's tile set (captured BEFORE the render, consistent with
    # the token) so a tile-granular reload drops only dependent frames.
    tiles = self._touched_tiles(scene_id, pose) if token is not None \
        else None
    try:
      img = self._render_scheduled(str(scene_id), pose, timeout, trace,
                                   degrade, attrib)
    except QueueFullError as e:
      # Shed for real: plant the negative entry so the NEXT request for
      # this cell (and everyone piling behind it) skips the queue.
      ttl = self.edge.negative_put(scene_id, digest, pose)
      if ttl is not None and e.retry_after_s is None:
        e.retry_after_s = ttl
      raise
    self._attrib_bytes(scene_id, attrib, img.nbytes)
    if self.attrib is not None and tiles:
      # Tile-tier demand: the source tiles this miss's frustum could
      # sample (hits and warps reuse pixels — no new tile reads).
      cls, level = attrib if attrib is not None else (None, 0)
      self.attrib.record_tiles(scene_id, cls, level, tiles=len(tiles))
    if degrade > 0:
      # Degraded render: labelled, un-ETag'd, and NEVER cached — the
      # cell stays empty until a full-quality render fills it.
      return img, {"edge": "miss", "etag": None, "max_age_s": max_age,
                   "degraded": True}
    entry = self._edge_put(str(scene_id), digest, cell, pose, img,
                           intrinsics, plane_depth, token, tiles)
    if entry is None:  # a swap raced the render: correct, just uncached
      return img, {"edge": "miss", "etag": None, "max_age_s": max_age,
                   "degraded": False}
    return entry.frame, {"edge": "miss", "etag": entry.etag,
                         "max_age_s": max_age, "degraded": False}

  def render_request(self, scene_id: str, pose, request_class=None,
                     timeout: float = 60.0,
                     trace=NULL_TRACE) -> tuple[np.ndarray, dict]:
    """The brownout-aware front door: priority admission, then a render
    at the admitted degrade tier. ``info`` is ``render_edge``'s dict
    plus ``"level"`` (the brownout level this response was served
    under). With no brownout controller this is exactly ``render_edge``
    (level 0, never degraded).

    Sheds raise ``BrownoutShedError`` (a ``QueueFullError``, so the HTTP
    503 + Retry-After arm handles it). Brownout sheds and degraded serves
    are counted in their own metric families and NEVER fed to the SLO
    tracker as bad — shedding is the mechanism that brings the burn rate
    DOWN; counting it as failure would wedge the ladder at max level.
    The ``(class, level)`` pair rides to the request's trace.
    """
    cls = brownout_mod.normalize_class(request_class)
    if self.brownout is None:
      img, info = self.render_edge(scene_id, pose, timeout=timeout,
                                   trace=trace, attrib=(cls, 0))
      info.setdefault("degraded", False)
      info["level"] = 0
      return img, info
    try:
      level = self.brownout.admit(cls)
    except brownout_mod.BrownoutShedError as e:
      self.metrics.record_brownout_shed(cls)
      trace.finish(error=repr(e))
      raise
    degrade = min(level, 3)
    img, info = self.render_edge(scene_id, pose, timeout=timeout,
                                 trace=trace, degrade=degrade,
                                 attrib=(cls, level))
    info["level"] = level
    if info.get("degraded"):
      self.metrics.record_degraded(level)
    return img, info

  def edge_cell_resident(self, scene_id: str, pose) -> tuple:
    """``(view_cell, resident?)`` for a pose — a planning probe that does
    not count as a hit or a miss. ``(None, True)`` when there is nothing
    to prefetch into (edge off, scene unknown)."""
    if self.edge is None:
      return None, True
    try:
      digest, _, _, _ = self._edge_meta(scene_id)
    except KeyError:
      return None, True
    pose = np.asarray(pose, dtype=np.float32)
    cell = self.edge.cell_of(pose)
    return cell, self.edge.resident(str(scene_id), digest, cell)

  def edge_revalidate(self, scene_id: str, pose,
                      if_none_match: str | None) -> str | None:
    """The matching strong ETag when ``if_none_match`` still identifies
    the request's view cell (HTTP 304: skip the render AND the body),
    else None. Unknown scenes return None — the render path owns 404."""
    if self.edge is None or not if_none_match:
      return None
    try:
      digest, _, _, _ = self._edge_meta(scene_id)
    except KeyError:
      return None
    return self.edge.revalidate(scene_id, digest,
                                np.asarray(pose, np.float32), if_none_match)

  # -- observability ------------------------------------------------------

  def attrib_snapshot(self, top: int | None = None) -> dict:
    """The ``/debug/attrib`` payload: the ledger snapshot plus the
    conservation reconciliation against the metrics layer's own
    (unrounded) request and phase totals. Raises ``RuntimeError`` when the
    service was built without attribution (the handler answers 503)."""
    if self.attrib is None:
      raise RuntimeError(
          "attribution disabled: construct RenderService with attrib "
          "(serve --attrib)")
    return self.attrib.snapshot(top=top,
                                reference=self.metrics.attrib_reference())

  def _render_metrics_text(self) -> str:
    text = prom.render_serve_metrics(self.stats(),
                                     self.metrics.latency_histogram())
    if self.slo is not None:
      text += self.slo.metrics_text()
    # Flight-recorder families ride every exposition (zeros while the
    # knobs are off — the always-exposed convention).
    tsdb = getattr(self, "tsdb", None)
    text += tsdb_mod.registry(
        tsdb.stats() if tsdb is not None else None).render()
    shipper = getattr(self, "shipper", None)
    text += ship_mod.registry(
        shipper.stats() if shipper is not None else None).render()
    ledger = getattr(self, "attrib", None)
    text += attrib_mod.registry(
        ledger.snapshot() if ledger is not None else None).render()
    incidents = getattr(self, "incidents", None)
    text += incident_mod.registry(
        incidents.stats() if incidents is not None else None).render()
    return text

  def metrics_text(self) -> str:
    """The ``/metrics`` body: Prometheus text exposition of ``stats()``,
    memoized for ``metrics_ttl_s`` (scrape storms cost one render)."""
    return self._metrics_cache.get()

  def events_snapshot(self, recent: int = 128,
                      kind: str | None = None) -> dict:
    """The ``/debug/events`` payload: the ring's snapshot and, with a
    shipper attached, how many rotated segments made it off-host and how
    many still wait on disk."""
    out = self.events.snapshot(recent=recent, kind=kind)
    if self.shipper is not None:
      ship_stats = self.shipper.stats()
      out.setdefault("retention", {})["shipped"] = {
          "segments_shipped": ship_stats["segments_shipped"],
          "segments_pending": self.shipper.pending_segments(),
          "segment_errors": ship_stats["segment_errors"],
      }
    return out

  def profile(self, seconds: float) -> dict:
    """Capture a device profile of live traffic (``/debug/profile``).

    With a ``profile_hook``, the finished capture's directory is handed
    to it; a failing hook is counted and reported in the response —
    never fatal, the capture on disk is still good.
    """
    if self.profiler is None:
      raise RuntimeError(
          "profiling disabled: construct RenderService with profile_dir "
          "(serve --profile-dir)")
    result = self.profiler.capture(seconds)
    if self.profile_hook is not None:
      try:
        self.profile_hook(result["logdir"])
        result["hook"] = "ok"
      except Exception as e:  # noqa: BLE001 - upload failure is not capture failure
        self.profile_hook_failures += 1
        result["hook"] = f"failed: {e}"
        self.events.emit("profile_hook_failed", logdir=result["logdir"],
                         error=repr(e))
    return result

  def stats(self) -> dict:
    out = self.metrics.snapshot(cache_stats=self.cache.stats())
    out.setdefault("pipeline", {})["max_inflight"] = \
        self.scheduler.max_inflight
    adaptive = self.scheduler.adaptive_snapshot()
    if adaptive is not None:
      out["pipeline"]["adaptive"] = adaptive
    if self.edge is not None:
      out["edge"] = self.edge.stats()
    if self.tile is not None:
      out["tiles"]["tile"] = self.tile
      with self._scene_lock:
        out["tiles"]["scenes_tiled"] = len(self._tile_meta)
      with self._crop_lock:
        out["tiles"]["crop_memo"] = {"entries": len(self._crop_memo),
                                     "cap": _CROP_MEMO_CAP,
                                     "bytes": self._crop_memo_bytes,
                                     "byte_budget": self._crop_memo_budget}
      out["tile_cache"] = self._tile_cache.stats()
    out["engine"] = self.engine.describe()
    if self.resilient is not None:
      out["breaker"] = self.resilient.breaker.snapshot()
    if self.fallback_engine is not None:
      out["fallback"] = {"engine": self.fallback_engine.describe(),
                         "cache": self._fallback_cache.stats()}
    if self.slo is not None:
      out["slo"] = self.slo.snapshot()
    if self.brownout is not None:
      # Overlay the controller's live state onto the metrics block (the
      # snapshot's counters stay — they are the shed/degrade history).
      out["brownout"].update(self.brownout.snapshot())
    out["events"] = {"emitted": self.events.emitted,
                     "dropped": self.events.dropped,
                     "sink_errors": self.events.sink_errors}
    if self.tsdb is not None:
      out["tsdb"] = self.tsdb.stats()
    if self.shipper is not None:
      out["ship"] = self.shipper.stats()
    if self.attrib is not None:
      out["attrib"] = self.attrib_snapshot()
    if self.incidents is not None:
      out["incidents"] = self.incidents.stats()
    if self.profiler is not None:
      out["profile"] = {"captures": self.profiler.captures,
                        "hook_failures": self.profile_hook_failures}
    if self.alert_hook is not None:
      with self._alert_hook_lock:
        out["alert_hook"] = {"runs": self.alert_hook_runs,
                             "failures": self.alert_hook_failures}
    return out

  def healthz(self) -> dict:
    """The health state machine: ok / degraded / unhealthy + reason.

    ``degraded``: the service still answers but not at full fidelity —
    the breaker has given up on the card and requests either ride the
    CPU fallback or fast-fail 503 (``fallback_active`` says which), or an
    SLO burn-rate alert is firing. ``unhealthy``: the service is closed or
    its dispatch pipeline died.
    """
    out = {
        "devices": len(self.engine.devices),
        "platform": self.engine.platform,
        "scenes": len(self.scene_ids()),
    }
    snap = (self.resilient.breaker.snapshot()
            if self.resilient is not None else None)
    slo_firing = self.slo.alerts_firing() if self.slo is not None else []
    slo_reason = None
    if slo_firing:
      snap_slo = self.slo.snapshot()
      parts = []
      for name in slo_firing:
        obj = snap_slo["objectives"].get(name)
        if obj is None:
          parts.append(name)  # a per-scene quantile alert
        elif "quantile" in obj:
          q_ms = obj["fast"]["quantile_ms"]
          parts.append(
              f"{name} at {q_ms:g}ms (> {obj['threshold_ms']:g}ms "
              "threshold)" if q_ms is not None else name)
        else:
          parts.append(f"{name} burning at {obj['fast']['burn_rate']:g}x "
                       f"(>= {snap_slo['config']['burn_threshold']:g}x "
                       f"of a {obj['target']:g} target)")
      slo_reason = "SLO alert firing: " + "; ".join(parts)
    if self._closed:
      status, reason = "unhealthy", "service closed"
    elif not self.scheduler.dispatcher_alive():
      status, reason = "unhealthy", "dispatcher thread is not running"
    elif snap is not None and snap["state"] != CircuitBreaker.CLOSED:
      status = "degraded"
      reason = (f"circuit {snap['state']} after "
                f"{snap['consecutive_failures']} consecutive device "
                "failures; ")
      reason += ("rendering on CPU fallback"
                 if self.fallback_engine is not None
                 else "fast-failing renders (503)")
      if slo_reason is not None:
        reason += "; " + slo_reason
    elif slo_firing:
      # A firing burn-rate alert is degraded, not unhealthy: the service
      # still answers, but probes must see that objectives are missed.
      status, reason = "degraded", slo_reason
    else:
      status, reason = "ok", None
    out["status"] = status
    if reason is not None:
      out["reason"] = reason
    if self.slo is not None:
      out["slo_alerts_firing"] = slo_firing
    if snap is not None:
      out["breaker"] = snap
      out["fallback_active"] = (
          self.fallback_engine is not None
          and snap["state"] != CircuitBreaker.CLOSED)
    return out

  def close(self) -> None:
    if not self._closed:
      self._closed = True
      if self.tsdb is not None:
        self.tsdb.stop()
      # Incidents stop BEFORE the shipper: the stop sentinel lands behind
      # queued fire edges, so a capture racing close still reaches disk
      # AND still hands its bundle to a live shipper.
      if self.incidents is not None:
        self.incidents.stop()
      if self.shipper is not None:
        self.shipper.stop()
      self.scheduler.stop()
      with self._alert_hook_lock:
        hook_queue = self._alert_hook_queue
      if hook_queue is not None:
        hook_queue.put(None)  # let the alert-hook worker exit

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


# A /render body is a scene id + 4x4 pose (< 1 KB); anything near this cap
# is malformed or hostile, and the handler must not buffer it.
_MAX_BODY_BYTES = 1 << 20

# W3C traceparent: version, 32-hex trace-id, 16-hex parent span id,
# 2-hex flags. Versions above "00" may append dash-separated fields.
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})(-.+)?$")


def _inbound_trace_id(headers) -> str | None:
  """The trace-id of a valid inbound ``traceparent`` header, else None
  (invalid headers are ignored, never rejected)."""
  value = headers.get("traceparent")
  if value is None:
    return None
  m = _TRACEPARENT_RE.match(value.strip())
  if m is None or m.group(1) == "ff":
    return None
  if m.group(5) is not None and m.group(1) == "00":
    return None  # version 00 forbids trailing fields
  trace_id, parent_id = m.group(2), m.group(3)
  if trace_id == "0" * 32 or parent_id == "0" * 16:
    return None
  return trace_id


class _Handler(BaseHTTPRequestHandler):
  """One request per thread (ThreadingHTTPServer); blocking on the
  scheduler future is what feeds concurrent HTTP load into one batch."""

  def __init__(self, service: RenderService, *args, **kwargs):
    self.service = service
    super().__init__(*args, **kwargs)

  def log_message(self, fmt, *args):  # noqa: A003 - stdlib signature
    pass  # request logging is the metrics layer's job, not stderr's

  def _send_bytes(self, body: bytes, status: int = 200,
                  content_type: str = "application/json",
                  extra_headers: dict | None = None) -> None:
    # A client that hangs up mid-response must cost a counter, not a
    # stderr traceback from the handler thread.
    try:
      self.send_response(status)
      self.send_header("Content-Type", content_type)
      self.send_header("Content-Length", str(len(body)))
      for key, value in (extra_headers or {}).items():
        self.send_header(key, value)
      self.end_headers()
      self.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError):
      self.service.metrics.record_client_disconnect()
      self.close_connection = True

  def _send_json(self, payload: dict, status: int = 200,
                 extra_headers: dict | None = None) -> None:
    self._send_bytes(json.dumps(payload).encode(), status=status,
                     extra_headers=extra_headers)

  def do_GET(self):  # noqa: N802 - stdlib name
    parsed = urllib.parse.urlsplit(self.path)
    if parsed.path == "/healthz":
      health = self.service.healthz()
      # Status-code probes never read the body: unhealthy must be non-2xx.
      self._send_json(health,
                      status=503 if health["status"] == "unhealthy" else 200)
    elif parsed.path == "/stats":
      self._send_json(self.service.stats())
    elif parsed.path == "/metrics":
      # Default: classic text format, exemplars STRIPPED — a `#` after the
      # value is a parse error that fails a vanilla Prometheus scrape.
      # ?exemplars=1 (OpenMetrics-aware collectors) serves them inline.
      text = self.service.metrics_text()
      query = urllib.parse.parse_qs(parsed.query)
      if query.get("exemplars", ["0"])[0] not in ("1", "true"):
        text = prom.strip_exemplars(text)
      self._send_bytes(
          text.encode(),
          content_type="text/plain; version=0.0.4; charset=utf-8")
    elif parsed.path == "/debug/traces":
      query = urllib.parse.parse_qs(parsed.query)
      tid = query.get("id", [None])[0]
      if tid:
        self._send_json({"trace_id": tid,
                         "traces": self.service.tracer.find(tid)})
      else:
        self._send_json(self.service.tracer.snapshot())
    elif parsed.path == "/debug/events":
      query = urllib.parse.parse_qs(parsed.query)
      kind = query.get("kind", [None])[0]
      try:
        recent = int(query.get("recent", ["128"])[0])
      except ValueError:
        self._send_json({"error": "recent must be an integer"}, status=400)
        return
      self._send_json(self.service.events_snapshot(recent=recent,
                                                   kind=kind))
    elif parsed.path == "/debug/tsdb":
      self._do_tsdb(parsed.query)
    elif parsed.path == "/debug/attrib":
      self._do_attrib(parsed.query)
    elif parsed.path == "/debug/incidents":
      self._do_incidents(parsed.query)
    elif parsed.path == "/debug/profile":
      self._do_profile(parsed.query)
    else:
      self._send_json({"error": f"unknown path {self.path}"}, status=404)

  def _do_tsdb(self, query: str) -> None:
    """``/debug/tsdb?family=&recent=&points=``: windowed history from the
    on-box time-series ring. Without ``family``, the index: resident
    family names + recorder stats."""
    if self.service.tsdb is None:
      self._send_json(
          {"error": "tsdb disabled: construct RenderService with tsdb "
                    "(serve --tsdb-interval-s)"}, status=503)
      return
    try:
      family, recent, points = tsdb_mod.parse_query(
          urllib.parse.parse_qs(query))
    except ValueError:
      self._send_json({"error": "recent must be a number and points an "
                                "integer"}, status=400)
      return
    if family:
      self._send_json(self.service.tsdb.query(family, recent_s=recent,
                                              points=points))
    else:
      self._send_json({"families": self.service.tsdb.families(),
                       "stats": self.service.tsdb.stats()})

  def _do_attrib(self, query: str) -> None:
    """``/debug/attrib?top=K``: the resource-attribution ledger plus the
    conservation reconciliation against the metrics totals."""
    if self.service.attrib is None:
      self._send_json(
          {"error": "attribution disabled: construct RenderService with "
                    "attrib (serve --attrib)"}, status=503)
      return
    try:
      raw = urllib.parse.parse_qs(query).get("top", [None])[0]
      top = int(raw) if raw is not None else None
    except ValueError:
      self._send_json({"error": "top must be an integer"}, status=400)
      return
    self._send_json(self.service.attrib_snapshot(top=top))

  def _do_incidents(self, query: str) -> None:
    """``/debug/incidents``: the bundle ring index (newest first) +
    recorder stats; ``?id=incident-NNNNNN`` fetches one full bundle."""
    if self.service.incidents is None:
      self._send_json(
          {"error": "incidents disabled: construct RenderService with "
                    "incidents (serve --incident-dir)"}, status=503)
      return
    iid = urllib.parse.parse_qs(query).get("id", [None])[0]
    if iid:
      try:
        self._send_json(self.service.incidents.get(iid))
      except KeyError:
        self._send_json({"error": f"unknown incident {iid!r}"},
                        status=404)
      return
    self._send_json({"incidents": self.service.incidents.list(),
                     "stats": self.service.incidents.stats()})

  def _do_profile(self, query: str) -> None:
    try:
      seconds = float(
          urllib.parse.parse_qs(query).get("seconds", ["1.0"])[0])
    except ValueError:
      self._send_json({"error": "seconds must be a number"}, status=400)
      return
    try:
      # Blocks this handler thread for the capture window — render
      # traffic keeps flowing on the other threads, which is the point:
      # the profile shows live serving, not an idle device.
      self._send_json(self.service.profile(seconds))
    except ValueError as e:
      self._send_json({"error": str(e)}, status=400)
    except ProfileBusyError as e:
      self._send_json({"error": str(e)}, status=409,
                      extra_headers={"Retry-After": "1"})
    except RuntimeError as e:  # profiling not configured
      self._send_json({"error": str(e)}, status=503)

  def do_POST(self):  # noqa: N802 - stdlib name
    if self.path != "/render":
      self._send_json({"error": f"unknown path {self.path}"}, status=404)
      return
    inbound_tid = _inbound_trace_id(self.headers)
    tid_hdr = {"X-Trace-Id": inbound_tid or new_trace_id()}
    try:
      length = int(self.headers.get("Content-Length", "0"))
      if not 0 <= length <= _MAX_BODY_BYTES:
        raise ValueError(f"bad body length ({length} bytes)")
      req = json.loads(self.rfile.read(length) or b"{}")
      if not isinstance(req, dict):
        raise ValueError(f"body must be a JSON object, got {type(req).__name__}")
      scene_id = req["scene_id"]
      if not isinstance(scene_id, str):
        raise ValueError(
            f"scene_id must be a string, got {type(scene_id).__name__}")
      if any(ord(c) < 0x20 for c in scene_id):
        # \x1f among them is the tile/crop key separator
        # (serve/tiles.py): a client must not smuggle key tokens in.
        raise ValueError("scene_id must not contain control characters")
      pose = np.asarray(req["pose"], np.float32)
      if pose.shape != (4, 4):
        raise ValueError(f"pose must be 4x4, got {pose.shape}")
      if not np.isfinite(pose).all():
        raise ValueError("pose contains non-finite values")
    except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
      self._send_json({"error": f"bad request: {e}"}, status=400,
                      extra_headers=tid_hdr)
      return
    except (BrokenPipeError, ConnectionResetError):
      self.service.metrics.record_client_disconnect()
      self.close_connection = True
      return
    svc = self.service
    edge_on = svc.edge is not None
    if edge_on:
      # Revalidation BEFORE any render work: a matching strong ETag
      # means the client's cached bytes are still exactly the cell's
      # resident frame, so the whole request costs one dict lookup.
      etag = svc.edge_revalidate(scene_id, pose,
                                 self.headers.get("If-None-Match"))
      if etag is not None:
        self._send_bytes(b"", status=304, extra_headers={
            "ETag": etag,
            "Cache-Control": f"max-age={svc.edge.config.max_age_s}",
            "X-Edge-Cache": "revalidated", **tid_hdr})
        return
    tr = svc.tracer.start_trace("render", trace_id=inbound_tid,
                                scene_id=str(scene_id), http=True)
    if tr.trace_id:
      tid_hdr = {"X-Trace-Id": tr.trace_id}
    bo_on = svc.brownout is not None
    try:
      if edge_on or bo_on:
        img, info = svc.render_request(
            scene_id, pose,
            request_class=self.headers.get(
                brownout_mod.REQUEST_CLASS_HEADER),
            trace=tr)
        tid_hdr = dict(tid_hdr)
        if edge_on:
          tid_hdr["X-Edge-Cache"] = info["edge"]
          tid_hdr["Cache-Control"] = f"max-age={info['max_age_s']}"
          if info["etag"] is not None:
            tid_hdr["ETag"] = info["etag"]
        if bo_on:
          tid_hdr[brownout_mod.LEVEL_HEADER] = str(info["level"])
        if info.get("degraded"):
          # Degraded frames are always labelled and must never be cached
          # by any intermediary: no ETag, and no-store overrides any edge
          # max-age set above.
          tid_hdr[brownout_mod.DEGRADED_HEADER] = "1"
          tid_hdr["Cache-Control"] = "no-store"
      else:
        img = svc.render(scene_id, pose, trace=tr)
    except KeyError as e:
      self._send_json({"error": str(e)}, status=404, extra_headers=tid_hdr)
      return
    except QueueFullError as e:
      # Shed at the door. A negative-cache fast shed knows when the cell
      # clears; a raw queue-full shed advises the standard 1 s backoff; a
      # brownout shed also names the ladder level that refused the
      # request's class.
      if isinstance(e, brownout_mod.BrownoutShedError):
        tid_hdr = {brownout_mod.LEVEL_HEADER: str(e.level), **tid_hdr}
      if e.retry_after_s is not None:
        self._send_json(
            {"error": str(e), "retry_after_s": e.retry_after_s},
            status=503,
            extra_headers={
                "Retry-After": str(max(1, math.ceil(e.retry_after_s))),
                **tid_hdr})
      else:
        self._send_json({"error": str(e)}, status=503,
                        extra_headers={"Retry-After": "1", **tid_hdr})
      return
    except CircuitOpenError as e:
      retry_after = max(1, math.ceil(e.retry_after_s))
      self._send_json({"error": str(e), "retry_after_s": e.retry_after_s},
                      status=503,
                      extra_headers={"Retry-After": str(retry_after),
                                     **tid_hdr})
      return
    except TransientDeviceError as e:
      if getattr(e, "deadline_capped", False):
        self._send_json({"error": f"request deadline exceeded: {e}"},
                        status=504, extra_headers=tid_hdr)
      else:
        self._send_json({"error": f"transient device failure: {e}"},
                        status=503,
                        extra_headers={"Retry-After": "1", **tid_hdr})
      return
    except FuturesTimeoutError:
      self._send_json({"error": "render timed out in queue"}, status=504,
                      extra_headers=tid_hdr)
      return
    except Exception as e:  # noqa: BLE001 - surfaced to the client
      self._send_json({"error": f"render failed: {e}"}, status=500,
                      extra_headers=tid_hdr)
      return
    img = np.ascontiguousarray(img, np.dtype("<f4"))
    if "application/octet-stream" in self.headers.get("Accept", ""):
      self._send_bytes(
          img.tobytes(), content_type="application/octet-stream",
          extra_headers={
              "X-Image-Shape": ",".join(str(d) for d in img.shape),
              "X-Image-Dtype": "<f4",
              "X-Scene-Id": str(scene_id),
              **tid_hdr,
          })
      return
    self._send_json({
        "scene_id": scene_id,
        "shape": list(img.shape),
        "dtype": "<f4",
        "image_b64": base64.b64encode(img.tobytes()).decode(),
    }, extra_headers=tid_hdr)


def make_http_server(service: RenderService, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
  """A ready-to-``serve_forever`` threaded HTTP server (port 0 = ephemeral;
  the bound port is ``server.server_address[1]``)."""
  handler = functools.partial(_Handler, service)
  server = ThreadingHTTPServer((host, port), handler)
  server.daemon_threads = True
  return server
