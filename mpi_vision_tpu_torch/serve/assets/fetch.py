"""Tile-diff scene streaming: sync scenes across processes by manifest
diff, fetching only changed-digest tiles.

PyTorch-package copy of ``mpi_vision_tpu/serve/assets/fetch.py``
(host-only; fetched scenes land through the port's
``RenderService.add_scene``, whose renders run on the card).

The cross-process half of the asset tier (``store.py`` is the serving
half): a replica (``serve --asset-sync-from``) or a ``swap_scenes``
propagation target diffs its LOCAL tile digests against a remote
scene's manifest and fetches ONLY the tiles whose digests changed — a
retrained scene propagates to a joined fleet as a tile diff, not a full
checkpoint. Every fetched asset is sha256-verified against the digest
that addressed it before a single byte lands in the scene, so a
corrupt or truncated transfer can never publish.

``SceneSyncWatcher`` is the fleet-propagation loop: the same
``PollWatcher`` base the checkpoint watcher uses (``ckpt/watch.py``),
polling remote manifests instead of a checkpoint directory — the
train -> serve -> fleet path is tile-granular end to end.
"""

from __future__ import annotations

import hashlib
import json
import random
import time
import urllib.error
import urllib.parse
import urllib.request
import zlib

import numpy as np

from mpi_vision_tpu_torch.ckpt.watch import PollWatcher
from mpi_vision_tpu_torch.serve import brownout as brownout_mod
from mpi_vision_tpu_torch.serve.assets import store as store_mod
from mpi_vision_tpu_torch.serve.resilience import RetryPolicy


class SceneSyncError(RuntimeError):
  """A sync attempt failed (remote unreachable, bad manifest, digest
  mismatch). The local scene is left untouched — syncs are atomic:
  either the full diff lands via ``add_scene`` or nothing does."""


class HttpFetchTransport:
  """Tiny injectable GET transport (stdlib urllib; tests inject an
  in-process fake and never open a socket)."""

  def __init__(self, timeout_s: float = 30.0):
    self.timeout_s = float(timeout_s)

  def get(self, url: str, headers: dict | None = None):
    req = urllib.request.Request(url, headers=headers or {}, method="GET")
    try:
      with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
        return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
      body = e.read()
      return e.code, dict(e.headers), body
    except (urllib.error.URLError, OSError) as e:
      raise ConnectionError(f"GET {url} failed: {e!r}") from e


class SceneFetcher:
  """Sync scenes INTO ``service`` from a remote asset tier by tile diff.

  ``service`` is a tiled ``RenderService`` (duck-typed: ``tile_meta``,
  ``scene_entry``, ``add_scene``, ``metrics``, ``events``). Fetched
  scenes land through ``add_scene``, so the service's own tile-diff
  publish invalidates exactly the changed tiles downstream (baked tile
  cache, crop memo, edge frames, local asset manifest).

  The diff only reuses local bytes when the grids agree; a replica
  configured with a different explicit ``--tile-size`` than its
  upstream degenerates to a full fetch every sync (digests over
  different crops never match) — use ``--tile-size auto`` on both sides
  so equal scene dims derive equal grids.
  """

  def __init__(self, service, base_url: str, transport=None,
               events=None, clock=time.monotonic,
               retry: RetryPolicy | None = RetryPolicy(),
               sleep=time.sleep, rng=None):
    self.service = service
    self.base_url = base_url.rstrip("/")
    self.transport = transport if transport is not None \
        else HttpFetchTransport()
    self.events = events if events is not None \
        else getattr(service, "events", None)
    self._clock = clock
    self.retry = retry
    self._sleep = sleep
    self._rng = rng if rng is not None else random.Random(0)

  def _emit(self, kind: str, **fields) -> None:
    if self.events is not None:
      self.events.emit(kind, **fields)

  def _get(self, path: str):
    """One GET through the transport choke point, with transient-fetch
    retries: a ``ConnectionError`` (socket refused/reset/timed out —
    the upstream briefly away, NOT an HTTP error status) backs off per
    ``retry`` and redials. Every request declares itself background
    traffic, so a browned-out upstream sheds the sync sweep before it
    sheds a single interactive render — the fetcher's whole job is
    deferrable."""
    headers = {brownout_mod.REQUEST_CLASS_HEADER: "background"}
    attempt = 0
    while True:
      try:
        return self.transport.get(self.base_url + path, headers=headers)
      except ConnectionError:
        if self.retry is None or attempt >= self.retry.max_retries:
          raise
        attempt += 1
        record = getattr(self.service.metrics, "record_scene_sync_retry",
                         None)
        if record is not None:
          record()
        self._emit("scene_sync_retry", path=path, attempt=attempt)
        self._sleep(self.retry.backoff_s(attempt, self._rng))

  def remote_scenes(self) -> list[str]:
    status, _, body = self._get("/scenes")
    if status != 200:
      raise SceneSyncError(f"GET /scenes returned {status}")
    return list(json.loads(body)["scenes"])

  def sync_scene(self, scene_id: str) -> dict:
    """One sync: manifest diff, fetch changed tiles, publish atomically.

    Returns per-sync stats (also recorded into ``service.metrics``):
    ``in_sync`` (nothing to do), ``tiles_fetched`` / ``tiles_reused``,
    ``bytes_fetched`` vs ``scene_bytes`` (what a full-checkpoint ship
    of the same scene would have cost).
    """
    t0 = self._clock()
    quoted = urllib.parse.quote(scene_id, safe="")
    self._emit("scene_sync_begin", scene_id=scene_id, source=self.base_url)
    try:
      stats = self._sync_scene(scene_id, quoted)
    except Exception as e:
      self.service.metrics.record_scene_sync_failure()
      self._emit("scene_sync_end", scene_id=scene_id, ok=False,
                 error=repr(e))
      raise
    stats["seconds"] = self._clock() - t0
    self.service.metrics.record_scene_sync(
        tiles_fetched=stats["tiles_fetched"],
        tiles_reused=stats["tiles_reused"],
        bytes_fetched=stats["bytes_fetched"])
    self._emit("scene_sync_end", scene_id=scene_id, ok=True,
               in_sync=stats["in_sync"],
               tiles_fetched=stats["tiles_fetched"],
               tiles_reused=stats["tiles_reused"],
               bytes_fetched=stats["bytes_fetched"])
    return stats

  def _sync_scene(self, scene_id: str, quoted: str) -> dict:
    status, _, body = self._get(f"/scene/{quoted}/manifest")
    if status != 200:
      raise SceneSyncError(
          f"manifest fetch for {scene_id!r} returned {status}")
    man = json.loads(body)
    if man.get("version") != store_mod.MANIFEST_VERSION:
      raise SceneSyncError(
          f"manifest version {man.get('version')!r} != "
          f"{store_mod.MANIFEST_VERSION} for {scene_id!r}")
    grid = man["grid"]
    height, width = int(grid["height"]), int(grid["width"])
    planes = int(man["planes"])
    local = self.service.tile_meta(scene_id)
    stats = {"scene_id": scene_id, "in_sync": False, "tiles_fetched": 0,
             "tiles_reused": 0, "bytes_fetched": 0,
             "tiles": int(grid["rows"]) * int(grid["cols"]),
             "scene_digest": man["scene_digest"],
             "scene_bytes": height * width * planes * 4 * 4}
    if local is not None and local.scene_digest == man["scene_digest"]:
      stats["in_sync"] = True
      stats["tiles_reused"] = stats["tiles"]
      return stats
    # Diff against local digests only when the grids agree — a local
    # scene under a different grid shares no crops with the remote one.
    reusable = (local is not None
                and local.grid.height == height
                and local.grid.width == width
                and local.grid.tile == int(grid["tile"])
                and int(local.depths.shape[0]) == planes)
    base = self.service.scene_entry(scene_id) if reusable else None
    if base is not None and base[0].shape != (height, width, planes, 4):
      base = None  # raced a concurrent swap; treat as full fetch
    rgba = (np.array(base[0], np.float32, copy=True) if base is not None
            else np.zeros((height, width, planes, 4), np.float32))
    tile_px = int(grid["tile"])
    for i, row in enumerate(man["tiles"]):
      for j, digest in enumerate(row):
        if (base is not None and local is not None
            and local.digests[i][j] == digest):
          stats["tiles_reused"] += 1
          continue
        raw = self._fetch_tile(quoted, digest, scene_id, stats)
        y0 = i * tile_px
        x0 = j * tile_px
        y1 = min(y0 + tile_px, height)
        x1 = min(x0 + tile_px, width)
        crop = np.frombuffer(raw, dtype="<f4")
        expect = (y1 - y0) * (x1 - x0) * planes * 4
        if crop.size != expect:
          raise SceneSyncError(
              f"tile ({i},{j}) of {scene_id!r} decoded to {crop.size} "
              f"floats, expected {expect}")
        rgba[y0:y1, x0:x1] = crop.reshape(y1 - y0, x1 - x0, planes, 4)
        stats["tiles_fetched"] += 1
    depths = np.asarray(man["depths"], np.float32)
    intrinsics = np.asarray(man["intrinsics"], np.float32)
    self.service.add_scene(scene_id, rgba, depths, intrinsics)
    return stats

  def _fetch_tile(self, quoted: str, digest: str, scene_id: str,
                  stats: dict) -> bytes:
    status, _, body = self._get(f"/scene/{quoted}/asset/{digest}")
    if status != 200:
      raise SceneSyncError(
          f"asset {digest[:12]}… of {scene_id!r} returned {status}")
    stats["bytes_fetched"] += len(body)
    try:
      raw = store_mod.decode_tile(body)
    except zlib.error as e:
      raise SceneSyncError(
          f"asset {digest[:12]}… of {scene_id!r} failed digest "
          f"verification (not {store_mod.TILE_ENCODING}: {e})") from e
    if hashlib.sha256(raw).hexdigest() != digest:
      # The whole point of content addressing: a corrupt transfer is
      # detected BEFORE any byte lands in the scene.
      raise SceneSyncError(
          f"asset {digest[:12]}… of {scene_id!r} failed digest "
          "verification (corrupt transfer)")
    return raw

  def sync_all(self) -> dict:
    """Sync every remote scene; per-scene failures are counted and do
    not stop the sweep (a fleet replica should converge on whatever is
    fetchable)."""
    out = {"scenes": 0, "in_sync": 0, "failures": 0, "tiles_fetched": 0,
           "tiles_reused": 0, "bytes_fetched": 0}
    for sid in self.remote_scenes():
      try:
        stats = self.sync_scene(sid)
      except (SceneSyncError, ConnectionError, ValueError):
        out["failures"] += 1
        continue
      out["scenes"] += 1
      out["in_sync"] += int(stats["in_sync"])
      out["tiles_fetched"] += stats["tiles_fetched"]
      out["tiles_reused"] += stats["tiles_reused"]
      out["bytes_fetched"] += stats["bytes_fetched"]
    return out

  def close(self) -> None:  # symmetry with the service lifecycle
    pass


class SceneSyncWatcher(PollWatcher):
  """Poll a remote asset tier and keep the local service converged.

  The fleet half of live reload: upstream, ``CheckpointWatcher`` swaps
  retrained scenes into the primary; here, each joined replica polls
  the primary's manifests and pulls tile diffs. Errors are counted,
  never fatal — a replica keeps serving its last good scenes through
  an upstream outage and converges when it ends.
  """

  thread_name = "mpi-scene-sync"

  def __init__(self, fetcher: SceneFetcher, poll_s: float = 5.0,
               sleep=None, log=None):
    super().__init__(poll_s, sleep=sleep)
    self.fetcher = fetcher
    self._log = log if log is not None else (lambda msg: None)
    self.polls = 0
    self.sync_errors = 0
    self.last_error: str | None = None
    self.last_sweep: dict | None = None

  def check_once(self) -> dict | None:
    self.polls += 1
    try:
      sweep = self.fetcher.sync_all()
    except (SceneSyncError, ConnectionError, ValueError) as e:
      self.sync_errors += 1
      self.last_error = repr(e)
      self._log(f"scene-sync: sweep failed: {e!r}")
      return None
    self.last_sweep = sweep
    if sweep["failures"]:
      self.sync_errors += sweep["failures"]
      self._log(f"scene-sync: {sweep['failures']} scene(s) failed to sync")
    else:
      self.last_error = None
    return sweep

  def snapshot(self) -> dict:
    return {
        "source": self.fetcher.base_url,
        "polls": self.polls,
        "sync_errors": self.sync_errors,
        "last_error": self.last_error,
        "last_sweep": self.last_sweep,
    }


def warm_backend(address: str, scenes, *, donors=(), transport=None,
                 timeout_s: float = 30.0, clock=time.monotonic,
                 sleep=time.sleep, poll_s: float = 0.25) -> dict:
  """Pre-admit warming: block until ``address`` can serve ``scenes``.

  The autoscaler's gate between *spawned* and *routed* (the FastNeRF
  lesson: un-warmed capacity tanks p99 worse than no capacity). Per
  scene, two probes race a shared deadline:

    * **manifest diff** — the new backend's ``/scene/{id}/manifest``
      ``scene_digest`` equals a donor's (the first already-admitted
      backend that answers): the tile store is converged, the cheap
      verdict.
    * **render warm** — a real identity-pose ``/render`` returns 200:
      the scene is resident and servable even where manifests are
      unavailable or still syncing; the render itself primes the
      backend's bake/crop caches for exactly the keys the ring will
      route to it.

  Both probes declare themselves background traffic, so a browned-out
  fleet sheds warming before a single interactive render. Returns
  ``{"ok", "warmed", "failed", "modes", "elapsed_s"}`` and never
  raises — an un-warmable backend is the CALLER's abort decision.
  ``transport`` is router-style (``request(method, url, ...)``); the
  default is the cluster tier's ``HttpTransport``.
  """
  if transport is None:
    from mpi_vision_tpu_torch.serve.cluster.router import HttpTransport

    transport = HttpTransport()
  headers = {brownout_mod.REQUEST_CLASS_HEADER: "background"}
  pose = [[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0],
          [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]]
  start = clock()
  deadline = start + timeout_s

  def _manifest_digest(host: str, quoted: str) -> str | None:
    try:
      status, _, body = transport.request(
          "GET", f"http://{host}/scene/{quoted}/manifest",
          headers=headers, timeout=min(timeout_s, 5.0))
      if status != 200:
        return None
      payload = json.loads(body)
    except (ConnectionError, ValueError, UnicodeDecodeError):
      return None
    digest = payload.get("scene_digest") if isinstance(payload, dict) \
        else None
    return digest if isinstance(digest, str) else None

  warmed: list[str] = []
  modes: dict[str, str] = {}
  for scene_id in scenes:
    quoted = urllib.parse.quote(str(scene_id), safe="")
    want = None
    for donor in donors:
      want = _manifest_digest(donor, quoted)
      if want is not None:
        break
    body = json.dumps({"scene_id": str(scene_id),
                       "pose": pose}).encode()
    while clock() < deadline:
      if want is not None and _manifest_digest(address, quoted) == want:
        warmed.append(str(scene_id))
        modes[str(scene_id)] = "manifest"
        break
      try:
        status, _, _ = transport.request(
            "POST", f"http://{address}/render", body=body,
            headers={**headers, "Content-Type": "application/json"},
            timeout=min(timeout_s, 10.0))
      except ConnectionError:
        status = None
      if status == 200:
        warmed.append(str(scene_id))
        modes[str(scene_id)] = "render"
        break
      sleep(min(poll_s, max(0.0, deadline - clock())))
  failed = [str(s) for s in scenes if str(s) not in modes]
  return {"ok": not failed, "warmed": warmed, "failed": failed,
          "modes": modes, "elapsed_s": round(clock() - start, 3)}
