"""LRU cache of baked MPI scenes with a byte budget.

PyTorch counterpart of ``mpi_vision_tpu/serve/cache.py``. Baking a scene —
placing its MPI on the device in the layout the render kernel reads — is
expensive and per-scene cacheable; serving a pose is cheap and batches
well. This module holds the baked side: device-resident ``BakedScene``s
keyed by scene id, least-recently-used eviction once the byte budget is
exceeded, and hit/miss/eviction counters for ``serve/metrics.py``.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

import numpy as np
import torch

from mpi_vision_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BakedScene:
  """One servable scene, resident on its device.

  ``planes`` is the scene in the kernel's layout, ``[P, H, W, 4]`` float32
  contiguous (one bilinear tap is one 16-byte load); ``rgba_layers`` is the
  JAX package's ``[H, W, P, 4]`` view of the same memory, not a copy.

  ``src_window`` marks a tile crop (serve/tiles.py): ``(y0, x0, H, W)``,
  the planes are that window of the ``H x W`` scene, whose camera
  ``intrinsics`` still is, and the frame renders at ``H x W``
  (``core.render.render_mpi``'s ``src_window``). ``None`` (every
  whole-scene bake) keeps the engine's historical call.

  ``tgt_intrinsics``/``out_hw`` override the render target (the brownout
  ladder's L2 half-resolution view of a bake, ``RenderService.
  _half_res_view``): the frame renders at ``out_hw`` through
  ``tgt_intrinsics``. ``None`` renders at the scene's own raster.

  ``replicas`` holds a sharded engine's copies of ``planes``, ``depths``
  and ``intrinsics`` on its other devices, by device. Views that share
  the planes (``dataclasses.replace`` of a bake, as the L2 view is) share
  it; a new bake starts empty, so a swapped or evicted bake takes its
  replicas with it.
  """

  scene_id: str
  planes: torch.Tensor      # [P, H, W, 4], planes back-to-front
  depths: torch.Tensor      # [P], descending (see camera.inv_depths)
  intrinsics: torch.Tensor  # [3, 3]
  nbytes: int
  src_window: tuple | None = None
  tgt_intrinsics: torch.Tensor | None = None  # [3, 3]
  out_hw: tuple | None = None
  replicas: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

  @property
  def rgba_layers(self) -> torch.Tensor:
    """``[H, W, P, 4]`` view of ``planes``."""
    return self.planes.permute(1, 2, 0, 3)

  @property
  def device(self) -> torch.device:
    return self.planes.device


def bake_scene(scene_id, rgba_layers, depths, intrinsics,
               device="cuda") -> BakedScene:
  """Place host arrays on ``device`` as one servable scene (f32).

  ``rgba_layers [H, W, P, 4]``, ``depths [P]`` and ``intrinsics [3, 3]``
  are numpy arrays (``np.asarray`` of a JAX ``BakedScene``'s fields gives
  them). The scene is transposed once, here, to the kernel's
  ``[P, H, W, 4]`` layout, and the call synchronises so the bake cost is
  paid inside the cache-miss accounting, not inside the first render.
  ``device`` defaults to the card; with no CUDA device it raises unless
  the caller passes ``"cpu"``.
  """
  dev = resolve_device(device)
  # Host copies: the baked scene never aliases the caller's arrays (the CPU
  # device shares memory with numpy), and read-only inputs become writable.
  rgba = np.array(rgba_layers, np.float32)
  d = np.array(depths, np.float32)
  k = np.array(intrinsics, np.float32)
  if rgba.ndim != 4 or rgba.shape[-1] != 4:
    raise ValueError(f"rgba_layers must be [H, W, P, 4], got {rgba.shape}")
  if d.shape != (rgba.shape[2],):
    raise ValueError(
        f"depths {d.shape} must be [P] matching rgba planes {rgba.shape[2]}")
  if k.shape != (3, 3):
    raise ValueError(f"intrinsics must be [3, 3], got {k.shape}")
  # The transpose to the kernel's layout runs on the device.
  planes = torch.from_numpy(rgba).to(dev).permute(2, 0, 1, 3).contiguous()
  d_t = torch.from_numpy(d).to(dev)
  k_t = torch.from_numpy(k).to(dev)
  if dev.type == "cuda":
    torch.cuda.synchronize(dev)
  nbytes = sum(t.numel() * t.element_size() for t in (planes, d_t, k_t))
  return BakedScene(str(scene_id), planes, d_t, k_t, nbytes)


class SceneCache:
  """Thread-safe LRU over ``BakedScene`` with byte-budget eviction.

  Eviction keeps at least the most recent scene even when it alone
  exceeds the budget — a cache that refuses every scene cannot serve.
  """

  def __init__(self, byte_budget: int = 2 << 30):
    if byte_budget <= 0:
      raise ValueError(f"byte_budget must be positive, got {byte_budget}")
    self.byte_budget = int(byte_budget)
    self._scenes: OrderedDict[str, BakedScene] = OrderedDict()
    self._bytes = 0
    self._lock = threading.Lock()
    self.hits = 0
    self.misses = 0
    self.evictions = 0
    self.invalidations = 0
    # Per-key generation, moved by every invalidation: a bake that began
    # before an invalidation of its key must not insert after it.
    self._gens: dict[str, int] = {}

  def get(self, scene_id: str) -> BakedScene | None:
    with self._lock:
      scene = self._scenes.get(scene_id)
      if scene is None:
        self.misses += 1
        return None
      self._scenes.move_to_end(scene_id)
      self.hits += 1
      return scene

  def put(self, scene: BakedScene) -> None:
    with self._lock:
      self._insert_locked(scene)

  def _insert_locked(self, scene: BakedScene) -> None:
    old = self._scenes.pop(scene.scene_id, None)
    if old is not None:
      self._bytes -= old.nbytes
    self._scenes[scene.scene_id] = scene
    self._bytes += scene.nbytes
    self._evict_locked()

  def get_or_bake(self, scene_id: str, bake) -> BakedScene:
    """Cached scene, or ``bake()``'s result inserted (miss accounted).

    The result is inserted only if ``scene_id`` was not invalidated while
    ``bake()`` ran. A caller that re-registers a scene's data first and
    invalidates its id second (``RenderService.swap_scenes``) so keeps a
    bake that read the old data out of the cache: that bake serves only
    the request that made it, and the next request bakes the new data."""
    with self._lock:
      scene = self._scenes.get(scene_id)
      if scene is not None:
        self._scenes.move_to_end(scene_id)
        self.hits += 1
        return scene
      self.misses += 1
      gen = self._gens.setdefault(scene_id, 0)
    scene = bake()
    with self._lock:
      if self._gens.get(scene_id) == gen:
        self._insert_locked(scene)
    return scene

  def invalidate(self, scene_id: str) -> bool:
    """Drop one baked scene. Requests already holding it finish on it —
    device memory frees once the last reference drops. Returns whether
    the id was resident."""
    with self._lock:
      if scene_id in self._gens:
        self._gens[scene_id] += 1
      scene = self._scenes.pop(scene_id, None)
      if scene is None:
        return False
      self._bytes -= scene.nbytes
      self.invalidations += 1
      return True

  def invalidate_prefix(self, prefix: str) -> int:
    """Drop every entry whose key starts with ``prefix`` (a tiled
    scene's whole tile set). Returns the number of entries dropped."""
    with self._lock:
      for key in self._gens:
        if key.startswith(prefix):
          self._gens[key] += 1
      keys = [k for k in self._scenes if k.startswith(prefix)]
      for key in keys:
        self._bytes -= self._scenes.pop(key).nbytes
      self.invalidations += len(keys)
      return len(keys)

  def _evict_locked(self) -> None:
    while self._bytes > self.byte_budget and len(self._scenes) > 1:
      _, evicted = self._scenes.popitem(last=False)
      self._bytes -= evicted.nbytes
      self.evictions += 1

  def __contains__(self, scene_id: str) -> bool:
    with self._lock:
      return scene_id in self._scenes

  def __len__(self) -> int:
    with self._lock:
      return len(self._scenes)

  def stats(self) -> dict:
    with self._lock:
      lookups = self.hits + self.misses
      return {
          "scenes": len(self._scenes),
          "bytes": self._bytes,
          "byte_budget": self.byte_budget,
          "hits": self.hits,
          "misses": self.misses,
          "evictions": self.evictions,
          "invalidations": self.invalidations,
          "hit_rate": (self.hits / lookups) if lookups else None,
      }
