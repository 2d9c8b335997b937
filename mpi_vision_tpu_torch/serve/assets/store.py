"""Content-addressed scene-asset store: serve layers, not frames.

PyTorch-package copy of ``mpi_vision_tpu/serve/assets/store.py`` (host
bytes only: digests and encodings come from the registered host arrays,
never from a read-back of the card).

The delivery tier behind ``GET /scene/{id}/manifest`` and
``GET /scene/{id}/asset/{digest}`` (most views need never touch a
server). A baked tile never changes — its sha256 digest
over the raw crop bytes (``serve/tiles.py`` computes them anyway for
diff-based reloads) IS its identity — so a tile asset is immutable and
infinitely cacheable: strong ETag, ``Cache-Control: public,
max-age=31536000, immutable``, and every edge/CDN between the service
and a browser may keep it forever.

Two asset kinds share one digest namespace:

  * ``tile``  — one tile's raw ``[th, tw, P, 4]`` f32 crop bytes,
    zlib-compressed on the wire (``raw-f32+zlib``). Addressed by the
    tile digest from ``TileMeta`` — the exact digest the tile-diff
    reload and the cross-process ``SceneFetcher`` sync key on.
  * ``layer`` — one whole MPI plane as a PNG (``viewer/export.py``
    encoding), what the ``/scene/{id}/viewer`` HTML composites.
    Addressed by the sha256 of the PNG bytes.

The store keeps an LRU of encoded bytes under a byte budget plus an
index of LIVE digests (the current generation of every published
scene), so an evicted asset re-encodes from scene data on demand; a
digest that is neither resident nor live 404s. Digest-vs-bytes is
verified on every ``put`` — a corrupt asset can never be published
(``AssetIntegrityError``, counted).
"""

from __future__ import annotations

import hashlib
import json
import threading
import zlib
from collections import OrderedDict

from mpi_vision_tpu_torch.serve.edge.cache import strong_etag

MANIFEST_VERSION = 1
TILE_ENCODING = "raw-f32+zlib"
LAYER_ENCODING = "png"
TILE_CONTENT_TYPE = "application/octet-stream"
LAYER_CONTENT_TYPE = "image/png"
# Immutable by construction: the URL names the bytes, so the bytes
# under a URL can never change — the strongest caching statement HTTP
# can make.
ASSET_CACHE_CONTROL = "public, max-age=31536000, immutable"
# Speed over ratio: tile assets re-encode on LRU miss in the request
# path, and MPI alpha planes are mostly zeros — level 1 already
# collapses them.
_ZLIB_LEVEL = 1


class AssetIntegrityError(ValueError):
  """Bytes offered under a digest they do not hash to (refused)."""


def digest_of(raw: bytes) -> str:
  return hashlib.sha256(raw).hexdigest()


def encode_tile(raw: bytes) -> bytes:
  return zlib.compress(raw, _ZLIB_LEVEL)


def decode_tile(data: bytes) -> bytes:
  return zlib.decompress(data)


def build_manifest(scene_id: str, meta, *, params_digest: str,
                   layers: list[str]) -> dict:
  """The versioned scene manifest: everything a client needs to fetch,
  verify, and composite the scene from immutable assets.

  ``meta`` is a ``serve/tiles.py`` ``TileMeta``. The manifest itself is
  mutable (it names the CURRENT generation) and is served with
  ``Cache-Control: no-cache`` + an ETag of the scene digest, so clients
  revalidate it cheaply and hard-cache everything it points at.
  """
  grid = meta.grid
  return {
      "version": MANIFEST_VERSION,
      "scene_id": scene_id,
      "scene_digest": meta.scene_digest,
      "params_digest": params_digest,
      "grid": {"height": grid.height, "width": grid.width,
               "tile": grid.tile, "rows": grid.rows, "cols": grid.cols},
      "planes": int(meta.depths.shape[0]),
      "dtype": "<f4",
      "depths": [float(d) for d in meta.depths],
      "intrinsics": [[float(v) for v in row] for row in meta.intrinsics],
      "encoding": {"tiles": TILE_ENCODING, "layers": LAYER_ENCODING},
      "tiles": [[meta.digests[i][j] for j in range(grid.cols)]
                for i in range(grid.rows)],
      "layers": list(layers),
      "asset_path": f"/scene/{scene_id}/asset/",
  }


def manifest_etag(scene_digest: str) -> str:
  return strong_etag(scene_digest)


def asset_etag(digest: str) -> str:
  return strong_etag(digest)


class AssetStore:
  """Thread-safe LRU of encoded asset bytes + live-digest index.

  ``publish_scene`` registers a scene generation's digests (the index
  maps digest -> how to re-encode it from live scene data); ``put``
  verifies and inserts bytes; ``get`` serves resident bytes. Residency
  and liveness are deliberately independent: a superseded generation's
  digest keeps serving while resident (it is immutable — a replica or
  CDN may still reference it) but can no longer re-encode once evicted,
  at which point it 404s.
  """

  def __init__(self, byte_budget: int = 256 << 20):
    if byte_budget < 1:
      raise ValueError(f"byte_budget must be >= 1, got {byte_budget}")
    self.byte_budget = int(byte_budget)
    self._lock = threading.Lock()
    self._lru: "OrderedDict[str, tuple[bytes, dict]]" = OrderedDict()
    self._bytes = 0
    # digest -> re-encode descriptor, per scene (a digest shared by two
    # scenes stays live while either is published; lookup scans scenes,
    # which is fine — misses are rare and re-encoding dwarfs the scan).
    self._scene_assets: dict[str, dict[str, dict]] = {}
    self._manifests: dict[str, tuple[str, dict]] = {}
    self.hits = 0
    self.misses = 0
    self.evictions = 0
    self.rejects = 0

  # -- liveness index -----------------------------------------------------

  def publish_scene(self, scene_id: str, assets: dict[str, dict]) -> None:
    """Replace ``scene_id``'s live digest set with ``assets`` (digest ->
    descriptor). Superseded digests stay resident until LRU-evicted;
    the cached manifest is dropped (next request rebuilds)."""
    with self._lock:
      self._scene_assets[scene_id] = dict(assets)
      self._manifests.pop(scene_id, None)

  def register_assets(self, scene_id: str, assets: dict[str, dict]) -> None:
    """Add descriptors (e.g. lazily-built layer assets) to a live
    scene's index without touching the tile set."""
    with self._lock:
      self._scene_assets.setdefault(scene_id, {}).update(assets)

  def drop_scene(self, scene_id: str) -> None:
    with self._lock:
      self._scene_assets.pop(scene_id, None)
      self._manifests.pop(scene_id, None)

  def source(self, digest: str) -> dict | None:
    """The re-encode descriptor for a LIVE digest, else None."""
    with self._lock:
      for assets in self._scene_assets.values():
        desc = assets.get(digest)
        if desc is not None:
          return desc
      return None

  # -- bytes --------------------------------------------------------------

  def put(self, digest: str, raw: bytes, encoded: bytes,
          meta: dict) -> None:
    """Insert verified bytes. ``raw`` must hash to ``digest`` — the
    bake-time integrity gate: a corrupt asset is refused (and counted)
    here, before anything can cache it forever."""
    if digest_of(raw) != digest:
      with self._lock:
        self.rejects += 1
      raise AssetIntegrityError(
          f"asset bytes do not hash to their digest {digest[:12]}… "
          "(corrupt bake refused)")
    with self._lock:
      if digest in self._lru:
        self._lru.move_to_end(digest)
        return
      self._lru[digest] = (encoded, dict(meta))
      self._bytes += len(encoded)
      while self._bytes > self.byte_budget and len(self._lru) > 1:
        _, (old, _) = self._lru.popitem(last=False)
        self._bytes -= len(old)
        self.evictions += 1

  def get(self, digest: str) -> tuple[bytes, dict] | None:
    with self._lock:
      entry = self._lru.get(digest)
      if entry is None:
        self.misses += 1
        return None
      self._lru.move_to_end(digest)
      self.hits += 1
      return entry

  # -- manifests ----------------------------------------------------------

  def manifest(self, scene_id: str, scene_digest: str) -> dict | None:
    """The cached manifest IF it matches the current scene digest."""
    with self._lock:
      cached = self._manifests.get(scene_id)
      if cached is not None and cached[0] == scene_digest:
        return cached[1]
      return None

  def cache_manifest(self, scene_id: str, scene_digest: str,
                     manifest: dict) -> None:
    with self._lock:
      self._manifests[scene_id] = (scene_digest, manifest)

  def manifest_bytes(self, manifest: dict) -> bytes:
    return json.dumps(manifest, sort_keys=True).encode()

  def stats(self) -> dict:
    with self._lock:
      return {
          "assets": len(self._lru),
          "bytes": self._bytes,
          "byte_budget": self.byte_budget,
          "live_scenes": len(self._scene_assets),
          "live_digests": sum(len(a) for a in self._scene_assets.values()),
          "hits": self.hits,
          "misses": self.misses,
          "evictions": self.evictions,
          "rejects": self.rejects,
      }
