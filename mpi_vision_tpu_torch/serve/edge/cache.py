"""Byte-budgeted LRU of finished frames keyed by (scene, params, view cell).

A copy of ``mpi_vision_tpu/serve/edge/cache.py`` with its imports rewritten.

The frame-level twin of ``serve/cache.py``: that cache holds *baked
scenes* (inputs to the renderer), this one holds *rendered frames*
(outputs), keyed by ``(scene_id, params_digest, cell)`` where the cell
is the request pose quantized onto the view-cell lattice
(``lattice.py``). FastNeRF's lesson applied at the serving edge: the expensive function is pure, so cache its value and spend the
hot path on lookups and cheap warps instead of plane-sweep composites.

Lookup has three outcomes, counted separately because they cost three
different amounts:

  * **hit** — the exact cell is resident: serve the stored frame, zero
    render work. Bit-stable: a cell's bytes never change while the
    entry lives, which is what makes its ETag strong.
  * **warp** — the cell is empty but a neighboring entry's pose is
    within the warp thresholds: serve a single-homography resample of
    that frame (``warp.py``). Warp serves never populate the cell —
    caching an approximation would make its error permanent.
  * **miss** — nothing close enough: the caller renders for real and
    ``put``s the result, populating the cell for everyone behind it.

The near-miss search is adaptive: while a scene has few residents it
scans them directly, but past the size of the warp-radius neighborhood
it probes the translation-cell buckets around the request instead —
O(radius^3) dict probes rather than O(residents) pose errors, which
matters once streaming-session trajectories leave hundreds of entries
behind. Both paths pick the genuinely nearest candidate (translation
error, under both thresholds), so the serving outcome is identical.

ETags are per-entry nonces, not pure key hashes: an evicted cell
re-populated by a *different* pose in the same cell would carry
different bytes, so a key-derived tag could validate a stale client
copy against fresh pixels. Deriving the tag from key + insertion
sequence means ``If-None-Match`` can only ever match the entry that is
actually resident — the strong-ETag contract by construction.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import threading
import time
from collections import OrderedDict

import numpy as np

from mpi_vision_tpu_torch.serve.edge import lattice

# Shared empty read-only bucket for neighborhood probes that miss.
_NO_BUCKET: dict = {}


@dataclasses.dataclass(frozen=True)
class EdgeConfig:
  """Edge-cache knobs (the ``serve`` CLI's ``--edge-*`` flags map 1:1).

  ``trans_cell``/``rot_bucket_deg`` set the lattice pitch (how close two
  poses must be to share a cell — the reuse/fidelity dial);
  ``warp_max_trans``/``warp_max_rot_deg`` bound how far a near-miss may
  be from a cached frame before a warp is judged worse than a render;
  ``max_age_s`` is the ``Cache-Control: max-age`` browsers/CDNs get.
  """

  byte_budget: int = 512 << 20
  trans_cell: float = 0.05
  rot_bucket_deg: float = 2.0
  warp_max_trans: float = 0.1
  warp_max_rot_deg: float = 4.0
  max_age_s: int = 5
  # Negative caching under queue pressure: a render shed queue-full
  # plants a short-TTL negative entry on its view cell, so repeated
  # hammering of an unservable pose degrades to a fast 503 +
  # Retry-After instead of re-entering the full queue each time.
  # <= 0 disables (the default: shedding stays per-request).
  negative_ttl_s: float = 0.0

  def __post_init__(self):
    if self.byte_budget <= 0:
      raise ValueError(f"byte_budget must be positive, got {self.byte_budget}")
    for name in ("trans_cell", "rot_bucket_deg"):
      if getattr(self, name) <= 0:
        raise ValueError(f"{name} must be > 0, got {getattr(self, name)}")
    for name in ("warp_max_trans", "warp_max_rot_deg"):
      if getattr(self, name) < 0:
        raise ValueError(f"{name} must be >= 0, got {getattr(self, name)}")
    if self.max_age_s < 0:
      raise ValueError(f"max_age_s must be >= 0, got {self.max_age_s}")
    if self.negative_ttl_s < 0:
      raise ValueError(
          f"negative_ttl_s must be >= 0, got {self.negative_ttl_s}")


@dataclasses.dataclass(frozen=True)
class CachedFrame:
  """One resident rendered frame and everything needed to re-serve it
  (directly on an exact hit, or warped to a nearby pose)."""

  scene_id: str
  digest: str
  cell: tuple
  pose: np.ndarray        # [4, 4] the pose the frame was rendered at
  frame: np.ndarray       # [H, W, 3] f32, write-locked (shared, read-only)
  intrinsics: np.ndarray  # [3, 3]
  plane_depth: float      # representative depth for near-miss warps
  etag: str               # strong HTTP ETag (quoted), unique per entry
  nbytes: int
  # The source tiles this frame's frustum could sample (serve/tiles.py
  # ids), or None for frames of untiled scenes. A tile-granular reload
  # drops ONLY the frames whose tile set intersects the changed tiles —
  # every other frame's bytes are provably untouched, so its strong ETag
  # survives the swap (``invalidate_tiles``).
  tiles: frozenset | None = None


def strong_etag(token: str) -> str:
  """Quote an opaque token as a strong HTTP ETag — the one quoting
  convention shared by edge frames and the content-addressed asset tier
  (``serve/assets``), so If-None-Match comparisons are byte-exact
  across both."""
  return f'"{token}"'


def _etag(scene_id: str, digest: str, cell: tuple, seq: int) -> str:
  token = hashlib.sha1(
      f"{scene_id}\x00{digest}\x00{cell}\x00{seq}".encode()).hexdigest()[:20]
  return strong_etag(token)


class EdgeFrameCache:
  """Thread-safe LRU over ``CachedFrame`` with lattice-aware lookup.

  Eviction mirrors ``SceneCache``: least-recently-used past the byte
  budget, always keeping at least one entry (a cache that refuses every
  frame cannot serve). Counters feed the ``edge`` block of ``/stats``
  and the ``mpi_serve_edge_*`` families.
  """

  def __init__(self, config: EdgeConfig | None = None, clock=time.monotonic):
    self.config = config if config is not None else EdgeConfig()
    self._clock = clock
    self._lock = threading.Lock()
    self._entries: OrderedDict[tuple, CachedFrame] = OrderedDict()
    # (scene_id, digest) -> {cell: entry}: the near-miss scan and the
    # invalidation sweep walk one scene's residents, not the whole LRU.
    self._by_scene: dict[tuple, dict[tuple, CachedFrame]] = {}
    # (scene_id, digest) -> {(tx, ty, tz): {cell: entry}}: residents
    # bucketed by translation cell, so the near-miss search probes the
    # warp-radius neighborhood instead of scanning every resident — a
    # session trajectory leaves hundreds of entries behind, and an O(n)
    # scan under this lock was the serving ceiling.
    self._by_trans: dict[tuple, dict[tuple, dict[tuple, CachedFrame]]] = {}
    # (scene_id, digest, cell) -> expiry clock time: view cells recently
    # shed queue-full. Consulted before the scheduler hand-off so a
    # saturated pose fails fast instead of re-queueing (negative_ttl_s).
    self._negative: dict[tuple, float] = {}
    self._bytes = 0
    self._seq = 0
    self.hits = 0
    self.warp_serves = 0
    self.misses = 0
    self.revalidations = 0
    self.evictions = 0
    self.invalidations = 0
    self.negative_hits = 0

  def cell_of(self, pose) -> tuple:
    return lattice.quantize_pose(pose, self.config.trans_cell,
                                 self.config.rot_bucket_deg)

  def resident(self, scene_id: str, digest: str, cell) -> bool:
    """Non-counting residency probe for one exact view cell.

    The session prefetcher plans against cache state; its planning reads
    must not pollute serving telemetry, so this neither bumps hit/miss
    counters nor touches LRU order.
    """
    key = (str(scene_id), str(digest), tuple(cell))
    with self._lock:
      return key in self._entries

  # -- lookup -------------------------------------------------------------

  def lookup(self, scene_id: str, digest: str, pose,
             warp_scale: float = 1.0) -> tuple[str, CachedFrame | None, tuple]:
    """Classify one request: ``("hit" | "warp" | "miss", entry, cell)``.

    ``hit`` returns the exact cell's entry; ``warp`` the nearest
    resident entry within the warp thresholds (the caller resamples it
    to the request pose); ``miss`` returns no entry — the caller must
    render and ``put``. ``warp_scale`` multiplies both warp thresholds
    for this lookup only — the brownout ladder's L3
    stale-while-overloaded tier widens the tolerance so nearby cached
    full-quality frames absorb traffic that would otherwise render (the
    caller labels beyond-base-tolerance warps as degraded).
    """
    cell = self.cell_of(pose)
    key = (str(scene_id), str(digest), cell)
    with self._lock:
      entry = self._entries.get(key)
      if entry is not None:
        self._entries.move_to_end(key)
        self.hits += 1
        return "hit", entry, cell
      near = self._nearest_locked(str(scene_id), str(digest), pose,
                                  float(warp_scale))
      if near is not None:
        self._entries.move_to_end((near.scene_id, near.digest, near.cell))
        self.warp_serves += 1
        return "warp", near, cell
      self.misses += 1
      return "miss", None, cell

  def _nearest_locked(self, scene_id: str, digest: str, pose,
                      warp_scale: float = 1.0) -> CachedFrame | None:
    cfg = self.config
    max_trans = cfg.warp_max_trans * warp_scale
    max_rot_deg = cfg.warp_max_rot_deg * warp_scale
    if max_trans <= 0 and max_rot_deg <= 0:
      return None
    cells = self._by_scene.get((scene_id, digest), {})
    if not cells:
      return None
    # A warp candidate's camera center lies within max_trans of the
    # request's, so its translation cell is within ceil(max_trans/cell)
    # lattice steps on every axis — probe that neighborhood when it is
    # smaller than the resident set, else the straight scan is cheaper.
    radius = math.ceil(max_trans / cfg.trans_cell) if max_trans > 0 else 0
    span = 2 * radius + 1
    if span ** 3 < len(cells):
      buckets = self._by_trans.get((scene_id, digest), {})
      t = np.asarray(pose, np.float64)[:3, 3]
      tx = math.floor(t[0] / cfg.trans_cell)
      ty = math.floor(t[1] / cfg.trans_cell)
      tz = math.floor(t[2] / cfg.trans_cell)
      candidates = [
          entry
          for dx in range(-radius, radius + 1)
          for dy in range(-radius, radius + 1)
          for dz in range(-radius, radius + 1)
          for entry in buckets.get((tx + dx, ty + dy, tz + dz),
                                   _NO_BUCKET).values()
      ]
    else:
      candidates = cells.values()
    best, best_trans = None, None
    for entry in candidates:
      trans, rot_deg = lattice.pose_error(pose, entry.pose)
      if trans <= max_trans and rot_deg <= max_rot_deg \
          and (best is None or trans < best_trans):
        best, best_trans = entry, trans
    return best

  # -- population ---------------------------------------------------------

  def put(self, scene_id: str, digest: str, cell: tuple, pose, frame,
          intrinsics, plane_depth: float,
          tiles: frozenset | None = None) -> CachedFrame:
    """Insert a freshly rendered frame; first writer wins.

    A concurrent miss on the same cell may have populated it already —
    the resident entry is returned (and kept) so every caller serves
    bytes matching the cell's one strong ETag. The stored frame is
    write-locked: it is shared with every future hit.
    """
    key = (str(scene_id), str(digest), tuple(cell))
    frame = np.ascontiguousarray(frame, np.float32)
    frame.setflags(write=False)
    with self._lock:
      resident = self._entries.get(key)
      if resident is not None:
        self._entries.move_to_end(key)
        return resident
      self._seq += 1
      entry = CachedFrame(
          scene_id=str(scene_id), digest=str(digest), cell=tuple(cell),
          pose=np.asarray(pose, np.float32).copy(), frame=frame,
          intrinsics=np.asarray(intrinsics, np.float32).copy(),
          plane_depth=float(plane_depth),
          etag=_etag(str(scene_id), str(digest), tuple(cell), self._seq),
          nbytes=frame.nbytes + 16 * 4 + 9 * 4,
          tiles=None if tiles is None else frozenset(tiles))
      self._entries[key] = entry
      self._by_scene.setdefault((entry.scene_id, entry.digest),
                                {})[entry.cell] = entry
      self._by_trans.setdefault(
          (entry.scene_id, entry.digest), {}).setdefault(
              entry.cell[:3], {})[entry.cell] = entry
      self._bytes += entry.nbytes
      self._evict_locked()
      return entry

  def _drop_locked(self, key: tuple) -> None:
    entry = self._entries.pop(key)
    self._bytes -= entry.nbytes
    scene_key = (entry.scene_id, entry.digest)
    cells = self._by_scene.get(scene_key)
    if cells is not None:
      cells.pop(entry.cell, None)
      if not cells:
        del self._by_scene[scene_key]
    buckets = self._by_trans.get(scene_key)
    if buckets is not None:
      bucket = buckets.get(entry.cell[:3])
      if bucket is not None:
        bucket.pop(entry.cell, None)
        if not bucket:
          del buckets[entry.cell[:3]]
      if not buckets:
        del self._by_trans[scene_key]

  def _evict_locked(self) -> None:
    while self._bytes > self.config.byte_budget and len(self._entries) > 1:
      key = next(iter(self._entries))
      self._drop_locked(key)
      self.evictions += 1

  # -- negative caching ---------------------------------------------------

  def negative_lookup(self, scene_id: str, digest: str,
                      pose) -> float | None:
    """Seconds until the request's view cell stops being known-shed, or
    None when the cell carries no live negative entry.

    A non-None return means a render for this cell was shed queue-full
    within ``negative_ttl_s`` — the caller should 503 immediately with
    the remaining TTL as ``Retry-After`` instead of re-entering the
    queue. Expired entries are pruned on access (no sweeper thread).
    """
    if self.config.negative_ttl_s <= 0:
      return None
    key = (str(scene_id), str(digest), self.cell_of(pose))
    with self._lock:
      expiry = self._negative.get(key)
      if expiry is None:
        return None
      remaining = expiry - self._clock()
      if remaining <= 0:
        del self._negative[key]
        return None
      self.negative_hits += 1
      return remaining

  def negative_put(self, scene_id: str, digest: str, pose) -> float | None:
    """Record that this view cell was just shed queue-full; returns the
    negative TTL planted (None when negative caching is disabled)."""
    ttl = self.config.negative_ttl_s
    if ttl <= 0:
      return None
    key = (str(scene_id), str(digest), self.cell_of(pose))
    with self._lock:
      now = self._clock()
      self._negative[key] = now + ttl
      # Opportunistic prune: queue pressure comes in bursts, so the dead
      # entries of the last burst are cleared by the next one's puts.
      expired = [k for k, exp in self._negative.items() if exp <= now]
      for k in expired:
        del self._negative[k]
      return ttl

  # -- revalidation -------------------------------------------------------

  def revalidate(self, scene_id: str, digest: str, pose,
                 if_none_match: str | None) -> str | None:
    """The matching ETag when ``if_none_match`` validates the request's
    cell (HTTP 304 — no render, no body), else None.

    Only a *resident* entry can validate (the entry nonce is in the
    tag), so a 304 is always a true statement about current bytes. A
    match refreshes the entry's LRU position: a client revalidating a
    frame is using it.
    """
    if not if_none_match:
      return None
    candidates = {tag.strip() for tag in if_none_match.split(",")}
    key = (str(scene_id), str(digest), self.cell_of(pose))
    with self._lock:
      entry = self._entries.get(key)
      if entry is None or (entry.etag not in candidates
                           and "*" not in candidates):
        return None
      self._entries.move_to_end(key)
      self.revalidations += 1
      return entry.etag

  # -- invalidation -------------------------------------------------------

  def invalidate_scene(self, scene_id: str) -> int:
    """Drop every resident frame of ``scene_id`` (all digests — a live
    checkpoint reload changed the pixels behind every one of them).
    Returns the number of frames dropped."""
    sid = str(scene_id)
    with self._lock:
      # Walk the per-scene index, not the whole LRU: the sweep runs
      # under the lock on every add_scene/swap_scenes, and a full-cache
      # scan would stall concurrent lookups for O(all entries).
      keys = [(entry.scene_id, entry.digest, entry.cell)
              for scene_key, cells in self._by_scene.items()
              if scene_key[0] == sid
              for entry in cells.values()]
      for key in keys:
        self._drop_locked(key)
      for nkey in [k for k in self._negative if k[0] == sid]:
        del self._negative[nkey]
      self.invalidations += len(keys)
      return len(keys)

  def invalidate_tiles(self, scene_id: str, changed_tiles) -> int:
    """Drop only the frames whose recorded tile set intersects
    ``changed_tiles`` (a tile-granular live reload changed those bytes).

    Frames recording a disjoint tile set are provably untouched — their
    pixels are a function of tiles that did not change — so they stay
    resident WITH their strong ETags (the partial-reload acceptance
    pin). Frames with no tile record (``tiles=None``) drop
    conservatively. Returns the number of frames dropped.
    """
    sid = str(scene_id)
    changed = frozenset(changed_tiles)
    with self._lock:
      keys = [(entry.scene_id, entry.digest, entry.cell)
              for scene_key, cells in self._by_scene.items()
              if scene_key[0] == sid
              for entry in cells.values()
              if entry.tiles is None or (entry.tiles & changed)]
      for key in keys:
        self._drop_locked(key)
      # Negatives record queue pressure, not pixels, but a reload is new
      # enough state that holding a pre-reload 503 verdict is wrong.
      for nkey in [k for k in self._negative if k[0] == sid]:
        del self._negative[nkey]
      self.invalidations += len(keys)
      return len(keys)

  # -- introspection ------------------------------------------------------

  def __len__(self) -> int:
    with self._lock:
      return len(self._entries)

  def stats(self) -> dict:
    with self._lock:
      lookups = self.hits + self.warp_serves + self.misses
      served = self.hits + self.warp_serves
      return {
          "frames": len(self._entries),
          "bytes": self._bytes,
          "byte_budget": self.config.byte_budget,
          "hits": self.hits,
          "warp_serves": self.warp_serves,
          "misses": self.misses,
          "revalidations": self.revalidations,
          "evictions": self.evictions,
          "invalidations": self.invalidations,
          "negative_hits": self.negative_hits,
          "negative_entries": sum(
              1 for exp in self._negative.values() if exp > self._clock()),
          "negative_ttl_s": self.config.negative_ttl_s,
          "hit_rate": (served / lookups) if lookups else None,
          "exact_hit_rate": (self.hits / lookups) if lookups else None,
          "trans_cell": self.config.trans_cell,
          "rot_bucket_deg": self.config.rot_bucket_deg,
      }
