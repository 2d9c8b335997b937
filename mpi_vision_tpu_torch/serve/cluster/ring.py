"""Consistent-hash scene placement with configurable replication.

A copy of ``mpi_vision_tpu/serve/cluster/ring.py``: the multi-host
tier's placement function (the scene cache sharded by scene id across
hosts). Scenes land on backends via a classic
consistent-hash ring: each backend owns ``vnodes`` points on a 64-bit
circle (SHA-256 of ``"{backend}#{vnode}"`` — deterministic across
processes and Python hash seeds, unlike ``hash()``), and a scene's
replica set is the first ``replication`` DISTINCT backends clockwise
from SHA-256 of its id. Two properties serving depends on:

  * **determinism** — placement is a pure function of (backend set,
    vnodes, replication); router restarts, a second router replica, and
    the tests all compute identical placements with no coordination.
  * **minimal movement** — removing a backend only remaps scenes whose
    replica set contained it (its ring points disappear; everyone
    else's are untouched), so a failover or resize re-bakes the fewest
    possible scenes (the FastNeRF/Potamoi lesson: the bake is the
    expensive half, don't move it gratuitously).

Replication means a scene is *servable* by ``replication`` backends;
the first live one in replica order serves it, the rest are failover
targets (``router.py`` walks the list breaker-aware).
"""

from __future__ import annotations

import bisect
import hashlib


def _hash64(key: str) -> int:
  return int.from_bytes(
      hashlib.sha256(key.encode("utf-8")).digest()[:8], "big")


class HashRing:
  """A consistent-hash ring over backend ids.

  Args:
    backends: initial backend ids (any strings; order irrelevant —
      placement depends only on the *set*).
    vnodes: ring points per backend. More points = smoother balance
      (stddev of ownership ~ 1/sqrt(vnodes)); 64 keeps worst-case skew
      under ~15% for small pools at negligible memory.
    replication: replica-set size returned by ``placement``; clamped to
      the live backend count at lookup time, so a 2-replica ring with
      one backend degrades to single-copy instead of failing.
  """

  def __init__(self, backends=(), vnodes: int = 64, replication: int = 2):
    if vnodes < 1:
      raise ValueError(f"vnodes must be >= 1, got {vnodes}")
    if replication < 1:
      raise ValueError(f"replication must be >= 1, got {replication}")
    self.vnodes = int(vnodes)
    self.replication = int(replication)
    self._backends: set[str] = set()
    self._points: list[tuple[int, str]] = []  # sorted (hash, backend)
    for b in backends:
      self.add(b)

  def add(self, backend: str) -> None:
    backend = str(backend)
    if backend in self._backends:
      return
    self._backends.add(backend)
    for v in range(self.vnodes):
      self._points.append((_hash64(f"{backend}#{v}"), backend))
    self._points.sort()

  def remove(self, backend: str) -> None:
    backend = str(backend)
    if backend not in self._backends:
      return
    self._backends.discard(backend)
    self._points = [p for p in self._points if p[1] != backend]

  def backends(self) -> list[str]:
    return sorted(self._backends)

  def __len__(self) -> int:
    return len(self._backends)

  def __contains__(self, backend: str) -> bool:
    return str(backend) in self._backends

  @staticmethod
  def placement_key(scene_id: str, tile: object | None = None) -> str:
    """The ring key for a scene (or one of its tiles / view cells).

    Tile-granular placement (Tiled MPI, PAPERS.md): keying on
    ``(scene_id, tile)`` spreads one hot scene over MANY backends —
    each tile/cell lands on its own replica set — instead of pinning
    the whole scene to one primary. The separator cannot appear in a
    scene id that passed the HTTP layer's string validation, so
    ``("a", "1")`` and ``("a\\x1f1", None)`` cannot collide by
    accident.
    """
    if tile is None:
      return str(scene_id)
    return f"{scene_id}\x1f{tile}"

  def placement(self, scene_id: str, tile: object | None = None) -> list[str]:
    """The key's replica set: first ``replication`` distinct backends
    clockwise from its ring point, primary first.

    The order is part of the contract — every router computes the same
    primary, so a healthy fleet serves each key from one backend and
    its cache locality is stable; failover walks the same list. With
    ``tile`` (a tile id or view-cell token), placement is per
    ``(scene, tile)``: a hot scene's tiles spread across the pool, and
    a given view cell deterministically prefers the one backend whose
    edge/tile caches already hold it.
    """
    if not self._points:
      return []
    want = min(self.replication, len(self._backends))
    key = self.placement_key(scene_id, tile)
    start = bisect.bisect_left(self._points, (_hash64(key), ""))
    out: list[str] = []
    for i in range(len(self._points)):
      backend = self._points[(start + i) % len(self._points)][1]
      if backend not in out:
        out.append(backend)
        if len(out) == want:
          break
    return out

  def resize(self, add=(), remove=(), keys=()) -> dict:
    """Apply a membership change and return the placement diff for
    ``keys`` — the minimal-movement receipt the autoscaler audits.

    Adds land before removes (a simultaneous swap keeps every key
    servable throughout). The returned ``moved`` maps each key whose
    replica set changed to its old/new placement; consistent hashing
    guarantees only keys whose replica set touched a changed backend
    appear there, so a scale event re-warms the fewest possible scenes.
    ``after`` carries every key's post-resize placement (how a caller
    computes a NEW backend's (scene, tile) assignment for pre-admit
    warming). Preview without mutating by calling this on ``clone()``.
    """
    keys = [str(k) for k in keys]
    before = {k: self.placement(k) for k in keys}
    for backend in add:
      self.add(backend)
    for backend in remove:
      self.remove(backend)
    after = {k: self.placement(k) for k in keys}
    moved = {k: {"old": before[k], "new": after[k]}
             for k in keys if before[k] != after[k]}
    return {"added": sorted(str(b) for b in add),
            "removed": sorted(str(b) for b in remove),
            "moved": moved, "after": after}

  def clone(self) -> "HashRing":
    """An independent copy (same members/vnodes/replication) — the
    preview substrate for ``resize`` what-ifs."""
    return HashRing(self._backends, self.vnodes, self.replication)

  def primary(self, scene_id: str, tile: object | None = None) -> str | None:
    """``placement(...)[0]`` without the full replica walk: the first
    ring point clockwise IS the primary (O(log n) — the router's cell
    reroute accounting calls this per request)."""
    if not self._points:
      return None
    key = self.placement_key(scene_id, tile)
    start = bisect.bisect_left(self._points, (_hash64(key), ""))
    return self._points[start % len(self._points)][1]
