"""Content-addressed scene-asset delivery: serve layers, not frames.

PyTorch-package copy of ``mpi_vision_tpu/serve/assets/`` (host-only). The
asset tier over the tiled registry (``serve/tiles.py``): every tile's
sha256 digest becomes an
immutable, CDN-cacheable HTTP asset; a versioned per-scene manifest
names the current generation; the browser viewer composites the layers
client-side from asset URLs; and ``SceneFetcher`` streams scenes
between processes as tile diffs instead of full checkpoints.

  * ``store`` — ``AssetStore`` (verified content-addressed LRU +
    live-digest index), manifest schema, tile/layer encodings.
  * ``fetch`` — ``SceneFetcher`` (manifest-diff sync client),
    ``SceneSyncWatcher`` (the fleet-propagation poll loop, on the same
    ``PollWatcher`` base as ``ckpt/watch.py``).
"""

from mpi_vision_tpu_torch.serve.assets.fetch import (
    HttpFetchTransport,
    SceneFetcher,
    SceneSyncError,
    SceneSyncWatcher,
)
from mpi_vision_tpu_torch.serve.assets.store import (
    ASSET_CACHE_CONTROL,
    AssetIntegrityError,
    AssetStore,
    MANIFEST_VERSION,
    build_manifest,
)

__all__ = [
    "ASSET_CACHE_CONTROL",
    "AssetIntegrityError",
    "AssetStore",
    "HttpFetchTransport",
    "MANIFEST_VERSION",
    "SceneFetcher",
    "SceneSyncError",
    "SceneSyncWatcher",
    "build_manifest",
]
