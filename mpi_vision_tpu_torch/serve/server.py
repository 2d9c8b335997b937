"""Serving front ends: in-process service + stdlib HTTP server.

PyTorch counterpart of the core of ``mpi_vision_tpu/serve/server.py``.
``RenderService`` wires cache + engine + scheduler + metrics into one
object with a pure-Python API; ``make_http_server`` wraps a service in a
threaded stdlib ``http.server`` front end:

  GET  /healthz -> {"status": "ok" | "degraded" | "unhealthy", "devices",
                   "platform", "scenes", ...}
  GET  /stats   -> the metrics snapshot (latency percentiles, throughput,
                   batch-size histogram, queue depth, cache hit rate,
                   pipeline, engine, breaker)
  GET  /debug/traces -> recent + slowest-N finished request traces
                   (?id=<trace_id> returns just that id's records)
  POST /render  -> body {"scene_id": str, "pose": [[...4x4...]]} ->
                   {"scene_id", "shape", "dtype", "image_b64"} — raw
                   little-endian f32 pixels, base64 (shape [H, W, 3]).
                   ``Accept: application/octet-stream`` returns the raw
                   pixels instead, with ``X-Image-Shape`` and
                   ``X-Image-Dtype`` headers. Every response carries an
                   ``X-Trace-Id`` header (a valid inbound W3C
                   ``traceparent``'s trace-id is honoured).

Scenes register host-side (``add_scene``) and bake lazily through the LRU
cache on first request; ``swap_scenes`` replaces registered scenes in place
under live traffic (``serve --reload-ckpt-s``). With ``tile=`` (``serve
--tiled``) every scene is split into a fixed tile grid (serve/tiles.py): a
request renders only the frustum-touched crop with content-free planes
culled, through ``method="pallas"`` (the warp, then the CUDA compose
kernel), bit-exact to the untiled render; the baked cache holds tiles, and
a bounded memo holds assembled crops. 404 for unknown scenes, 400 for
malformed requests, 503 when the scheduler sheds load or the circuit
breaker is open; handler threads block on the scheduler future, so HTTP
concurrency turns into micro-batch coalescing on the device.
"""

from __future__ import annotations

import base64
import functools
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
from mpi_vision_tpu_torch.obs.trace import (
    NULL_TRACE,
    NULL_TRACER,
    Tracer,
    new_trace_id,
)
from mpi_vision_tpu_torch.serve import cache as cache_mod
from mpi_vision_tpu_torch.serve import tiles as tiles_mod
from mpi_vision_tpu_torch.serve.engine import RenderEngine
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
      'pallas' (the warp, then the CUDA compose kernel) for tiled ones:
      the fused kernel cannot render cropped sources.
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
    tracer: request tracing (obs/trace.py); None is the no-op tracer.
    clock: injectable monotonic clock for the scheduler's deadlines.
  """

  def __init__(self, cache_bytes: int = 2 << 30, max_batch: int = 8,
               max_wait_ms: float = 2.0, max_inflight: "int | str" = 4,
               max_inflight_cap: int = 16, method: str | None = None,
               tile: "int | str | None" = None,
               convention: "Convention | None" = None, device="cuda",
               max_queue: int = 1024, engine: RenderEngine | None = None,
               resilience: ResilienceConfig | None = ResilienceConfig(),
               tracer: Tracer | None = None, clock=time.monotonic):
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
                "pallas" if tile is not None else "fused_pallas")
    if tile is not None and method == "fused_pallas":
      # render_mpi rejects source windows for the fused kernel, so
      # every CULLED render would 500 while full-coverage warmup
      # succeeds — fail the misconfiguration at construction instead.
      raise ValueError(
          "tile-granular serving requires an XLA method "
          "('fused'/'scan'/'assoc') or the compose kernel ('pallas'); "
          "method='fused_pallas' cannot render cropped sources")
    # "auto" derives a per-scene size from its dims at publish
    # (tiles_mod.auto_tile); every `self.tile is not None` gate below
    # treats it exactly like an explicit size.
    self.tile = tile if tile == "auto" else (
        int(tile) if tile is not None else None)
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
    self.tracer = tracer if tracer is not None else NULL_TRACER
    self.resilient = None if resilience is None else ResilientExecutor(
        resilience, metrics=self.metrics)
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
    self._crop_memo: "OrderedDict[str, cache_mod.BakedScene]" = OrderedDict()
    self._crop_memo_bytes = 0
    # A quarter of the baked-cache allowance: each memo entry duplicates
    # its crop's device bytes ON TOP of the tiles it was concatenated
    # from, so the memo gets a bounded supplement, not a second full
    # budget (total tiled residency <= 1.25x cache_bytes).
    self._crop_memo_budget = max(int(cache_bytes) // 4, 1)
    self._crop_lock = threading.Lock()
    self.scheduler = MicroBatcher(
        self.engine, self._get_scene, metrics=self.metrics,
        max_batch=max_batch, max_wait_ms=max_wait_ms,
        max_queue=max_queue, max_inflight=max_inflight,
        adaptive_inflight=adaptive_inflight,
        max_inflight_cap=max_inflight_cap if adaptive_inflight else None,
        resilient=self.resilient,
        batch_keyer=self._tile_batch_key if self.tile is not None else None,
        clock=clock).start()
    self._closed = False

  def add_scene(self, scene_id: str, rgba_layers, depths,
                intrinsics) -> None:
    """Register a scene (host arrays); it bakes lazily on first request.
    Re-registering an id drops its baked copy.

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
    self.cache.invalidate(sid)

  def _publish_tiled(self, sid: str, entry: tuple) -> list[tuple[int, int]]:
    """Publish (or re-publish) one scene into the tiled registry and
    invalidate exactly the tiles whose bytes changed. Returns the
    changed tile ids (every tile for a first publish or a grid/geometry
    change)."""
    tile_px = (self.tile if isinstance(self.tile, int)
               else tiles_mod.auto_tile(entry[0].shape[0],
                                        entry[0].shape[1]))
    meta = tiles_mod.TileMeta.build(entry[0], entry[1], entry[2], tile_px)
    with self._scene_lock:
      old = self._tile_meta.get(sid)
      self._scene_data[sid] = entry
      self._tile_meta[sid] = meta
    prefix = sid + tiles_mod.KEY_SEP
    if old is None:
      # First publish under this id: nothing valid can be cached.
      self._tile_cache.invalidate_prefix(prefix)
      self.cache.invalidate(sid)
      self._purge_crop_memo(sid)
      return [(i, j) for i in range(meta.grid.rows)
              for j in range(meta.grid.cols)]
    changed = old.changed_tiles(meta)
    if len(changed) == len(meta.grid) or old.grid != meta.grid:
      # Grid or geometry changed: every old tile id is dead.
      self._tile_cache.invalidate_prefix(prefix)
    else:
      for (i, j) in changed:
        self._tile_cache.invalidate(tiles_mod.tile_cache_key(sid, i, j))
    if changed:
      self._purge_crop_memo(sid)
    return changed

  def swap_scenes(self, scenes: dict, prebake: bool = False) -> list[str]:
    """Atomically publish new host data for ``scenes`` (live checkpoint
    reload, ``serve --reload-ckpt-s``).

    ``scenes`` maps scene id -> ``(rgba_layers, depths, intrinsics)``.
    The registry updates first, under the scene lock, then the baked
    cache invalidates the swapped ids — so a request that raced the swap
    renders either the old bake or the new one, never a mix, and no
    in-flight request is dropped: futures already holding a
    ``BakedScene`` render it to completion, and the old device buffers
    free when the last reference drops. A bake that read the old data
    and finishes after the invalidation serves only its own request:
    ``SceneCache.get_or_bake`` keeps it out of the cache, so no later
    request renders the old scene. A tiled service re-publishes
    through ``_publish_tiled``, which invalidates only the tiles whose
    digests changed. ``prebake=True`` bakes the swapped scenes (only the
    changed tiles, when tiled) before returning, so the first post-swap
    request does not pay the bake. Returns the swapped ids.

    The JAX package's version also invalidates its CPU-fallback cache and
    edge frame cache and emits swap events; the port has none of those
    modules yet.
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
      return swapped
    with self._scene_lock:
      self._scene_data.update(entries)
    for sid in entries:
      self.cache.invalidate(sid)
    if prebake:
      for sid in entries:
        self._get_scene(sid)
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

  def _tile_batch_key(self, scene_id: str,
                      pose) -> tuple[str, dict | None]:
    """The scheduler's batch-key hook for tiled services: frustum-cull
    the request into a ``TileSignature`` so it batches only with
    requests sharing its exact render plan. Unknown scenes pass through
    on the plain id (the scene provider answers them with KeyError)."""
    with self._scene_lock:
      meta = self._tile_meta.get(scene_id)
    if meta is None:
      return scene_id, None
    sig = meta.plan(np.asarray(pose, np.float32)[None],
                    self.engine.convention)
    # No metrics here: the scheduler records the attrs only for
    # requests it actually ENQUEUES, so queue-full rejections never skew
    # the cull ratios.
    return (scene_id + tiles_mod.KEY_SEP + sig.token(), {
        "tiles_touched": sig.tiles_touched,
        "tiles_rendered": sig.tiles_rendered,
        "tiles_culled": sig.tiles_total - sig.tiles_rendered,
        "tiles_total": sig.tiles_total,
        "planes": len(sig.planes),
    })

  def _get_scene(self, scene_id: str) -> cache_mod.BakedScene:
    sid, _, token = scene_id.partition(tiles_mod.KEY_SEP)
    if self.tile is not None:
      with self._scene_lock:
        meta = self._tile_meta.get(sid)
      if meta is not None:
        return self._assemble_crop(sid, meta, token)

    def bake():
      with self._scene_lock:
        entry = self._scene_data.get(scene_id)
      if entry is None:
        raise KeyError(f"unknown scene {scene_id!r}")
      return cache_mod.bake_scene(scene_id, *entry,
                                  device=self.engine.device)

    return self.cache.get_or_bake(scene_id, bake)

  def _assemble_crop(self, sid: str, meta: tiles_mod.TileMeta,
                     token: str) -> cache_mod.BakedScene:
    """The tiled scene provider: per-tile get-or-bake, then one device
    concatenation of the signature's crop with its culled plane set,
    marked with its window of the scene (``BakedScene.src_window``). A
    bounded memo makes the repeat path one dict lookup; a full-coverage
    crop is a plain whole-scene ``BakedScene``, the untiled path's call.

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
      # Plain scene-id lookups (warmup) assemble full coverage.
      sig = meta.signature(np.ones((grid.rows, grid.cols), bool))
    memo_key = sid + tiles_mod.KEY_SEP + sig.token()
    with self._crop_lock:
      memo = self._crop_memo.get(memo_key)
      if memo is not None:
        self._crop_memo.move_to_end(memo_key)
        return memo
    device = self.engine.device
    rows, cols = meta.crop_tiles(sig.crop)

    def bake_tile(i, j):
      key = tiles_mod.tile_cache_key(sid, i, j)

      def bake():
        with self._scene_lock:
          entry = self._scene_data.get(sid)
        if entry is None:
          raise KeyError(f"unknown scene {sid!r}")
        y0, y1, x0, x1 = grid.rect(i, j)
        return cache_mod.bake_scene(key, entry[0][y0:y1, x0:x1], entry[1],
                                    entry[2], device=device)
      return self._tile_cache.get_or_bake(key, bake)

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
        self._tile_cache.invalidate(tiles_mod.tile_cache_key(sid, i, j))
    return scene

  def warmup(self, scene_ids=None) -> None:
    """Bake scenes (default: all registered) and render every batch
    bucket up to the scheduler's ``max_batch`` once on the first, so the
    kernel is built and the pinned buffers are allocated before traffic."""
    ids = list(scene_ids) if scene_ids is not None else self.scene_ids()
    if not ids:
      return
    scenes = [self._get_scene(sid) for sid in ids]
    eye = np.eye(4, dtype=np.float32)
    buckets = sorted({self.engine.batch_bucket(v)
                      for v in range(1, self.scheduler.max_batch + 1)})
    for b in buckets:
      self.engine.render_batch(scenes[0], np.broadcast_to(eye, (b, 4, 4)))

  # -- request path -------------------------------------------------------

  def render(self, scene_id: str, pose, timeout: float = 60.0,
             trace=NULL_TRACE) -> np.ndarray:
    """Blocking render of one ``[4, 4]`` pose -> ``[H, W, 3]`` f32."""
    return self.scheduler.render(scene_id, pose, timeout=timeout,
                                 trace=trace)

  def render_async(self, scene_id: str, pose):
    """Non-blocking render; returns a ``concurrent.futures.Future``."""
    return self.scheduler.submit(scene_id, pose)

  def stats(self) -> dict:
    out = self.metrics.snapshot(cache_stats=self.cache.stats())
    out.setdefault("pipeline", {})["max_inflight"] = \
        self.scheduler.max_inflight
    adaptive = self.scheduler.adaptive_snapshot()
    if adaptive is not None:
      out["pipeline"]["adaptive"] = adaptive
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
    return out

  def healthz(self) -> dict:
    """The health state machine: ok / degraded / unhealthy + reason.

    ``degraded``: the breaker has given up on the device and requests
    fast-fail 503 until its half-open probe succeeds. ``unhealthy``: the
    service is closed or its dispatch pipeline died.
    """
    out = {
        "devices": len(self.engine.devices),
        "platform": self.engine.platform,
        "scenes": len(self.scene_ids()),
    }
    snap = (self.resilient.breaker.snapshot()
            if self.resilient is not None else None)
    if self._closed:
      status, reason = "unhealthy", "service closed"
    elif not self.scheduler.dispatcher_alive():
      status, reason = "unhealthy", "dispatcher thread is not running"
    elif snap is not None and snap["state"] != CircuitBreaker.CLOSED:
      status = "degraded"
      reason = (f"circuit {snap['state']} after "
                f"{snap['consecutive_failures']} consecutive device "
                "failures; fast-failing renders (503)")
    else:
      status, reason = "ok", None
    out["status"] = status
    if reason is not None:
      out["reason"] = reason
    if snap is not None:
      out["breaker"] = snap
    return out

  def close(self) -> None:
    if not self._closed:
      self._closed = True
      self.scheduler.stop()

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
    elif parsed.path == "/debug/traces":
      query = urllib.parse.parse_qs(parsed.query)
      tid = query.get("id", [None])[0]
      if tid:
        self._send_json({"trace_id": tid,
                         "traces": self.service.tracer.find(tid)})
      else:
        self._send_json(self.service.tracer.snapshot())
    else:
      self._send_json({"error": f"unknown path {self.path}"}, status=404)

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
    tr = self.service.tracer.start_trace("render", trace_id=inbound_tid,
                                         scene_id=str(scene_id), http=True)
    if tr.trace_id:
      tid_hdr = {"X-Trace-Id": tr.trace_id}
    try:
      img = self.service.render(scene_id, pose, trace=tr)
    except KeyError as e:
      self._send_json({"error": str(e)}, status=404, extra_headers=tid_hdr)
      return
    except QueueFullError as e:
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
