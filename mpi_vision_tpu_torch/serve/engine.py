"""Device dispatch for batched pose renders — streaming by design.

PyTorch counterpart of ``mpi_vision_tpu/serve/engine.py`` on one device.
One baked scene + a ``[V, 4, 4]`` pose batch in, ``[V, H, W, 3]`` host
images out, through ``core.render.render_views`` — by default
``method="fused_pallas"``, the CUDA kernel of ``kernels/render_fused.py``,
which renders any pose with no plan (the JAX engine cannot run its Pallas
kernels under its jit and serves through XLA instead). Tile-granular
services (serve/tiles.py) render cropped sources with ``method="pallas"``:
the warp, then the CUDA compose kernel of ``kernels/compose_over.py``. A
baked crop carries its window of the scene (``BakedScene.src_window``),
which the engine forwards.

The dispatch API is a streaming pipeline:

  * ``submit(scene, poses)`` enqueues the pose upload, the render and the
    frame readback on the engine's own CUDA stream, records a
    ``torch.cuda.Event`` behind them and returns an ``InFlightBatch`` at
    once — no synchronise on the submit path. Poses go up from a pinned
    host buffer; frames come back into a pinned host buffer that belongs
    to that batch alone, so a later batch's readback can never overwrite
    it. A bounded in-flight window (``max_inflight``) backpressures
    submitters.
  * ``poll(handle)`` is the non-blocking readiness probe (``Event.query``).
  * ``wait(handle)`` is the ONE synchronization point: it synchronises the
    batch's event, hands back its frames, releases the window slot, and
    stamps the handle's phase timings.
  * ``abandon(handle)`` releases a handle's window slot without waiting.

``render_batch`` is ``submit`` + ``wait``. Completion workers call these
from their own threads, so every call names the engine's device and stream
explicitly rather than relying on a thread's current ones.

Batches are padded up to powers of two by repeating the last pose, and the
padding views are sliced off at ``wait``. Per-view math is independent of
batch size — the kernel computes one pixel per thread with the planes in a
fixed order, and the plain path is elementwise — which is what lets the
scheduler promise bit-identical images whatever batch a request lands in.

On the CPU (``device="cpu"``, which a caller must ask for) the same API
runs the render synchronously inside ``submit`` through the kernel's plain
version.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from mpi_vision_tpu_torch.core import render
from mpi_vision_tpu_torch.core.sampling import Convention
from mpi_vision_tpu_torch.device import resolve_device
from mpi_vision_tpu_torch.serve.cache import BakedScene


def _next_pow2(n: int) -> int:
  return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def upsample_nearest(frames: np.ndarray, out_hw) -> np.ndarray:
  """Nearest-neighbour upsample of ``[..., h, w, C]`` host frames.

  A no-op (same array) when dims already match.
  """
  h, w = int(out_hw[0]), int(out_hw[1])
  ih, iw = frames.shape[-3], frames.shape[-2]
  if (ih, iw) == (h, w):
    return frames
  yy = (np.arange(h) * ih) // h
  xx = (np.arange(w) * iw) // w
  return np.ascontiguousarray(frames[..., yy[:, None], xx, :])


class InFlightBatch:
  """One dispatched batch: its host output buffer + bookkeeping.

  ``out`` is the batch's own ``[bucket, H, W, 3]`` host tensor (pinned on
  CUDA, filled once ``event`` completes); ``views`` is the live view count
  to slice back out. ``timings`` is populated by ``RenderEngine.wait``.
  The window slot is released exactly once — by ``wait`` or by
  ``abandon``, whichever runs first.
  """

  __slots__ = ("out", "event", "views", "t_submit", "h2d_enqueue_s",
               "timings", "_engine", "_released", "_lock")

  def __init__(self, engine: "RenderEngine", out: torch.Tensor, event,
               views: int, t_submit: float, h2d_enqueue_s: float):
    self.out = out
    self.event = event
    self.views = views
    self.t_submit = t_submit
    self.h2d_enqueue_s = h2d_enqueue_s
    self.timings: dict | None = None
    self._engine = engine
    self._released = False
    self._lock = threading.Lock()

  def release_slot(self) -> bool:
    """Free this handle's window slot (idempotent); True on first call."""
    with self._lock:
      if self._released:
        return False
      self._released = True
    self._engine._release_slot()
    return True

  def abandon(self) -> None:
    """Release the slot without waiting and count the abandonment on the
    engine that issued this handle. No-op on an already-released handle."""
    if self.release_slot():
      self._engine._count_abandoned()


class RenderEngine:
  """Batched render dispatch on one device.

  Args:
    method: ``core.render.render_mpi`` method — 'fused_pallas' (the CUDA
      kernel; its plain version on the CPU) by default, 'pallas' (the
      warp, then the CUDA compose kernel; the method that renders tile
      crops), or the plain 'fused'/'scan'/'assoc'.
    convention: coordinate convention forwarded to the renderer.
    device: "cuda" (default) or "cpu"; with no CUDA device the engine
      raises unless the caller passes "cpu".
    clock: injectable timer for the per-dispatch phase split.
    max_inflight: bound on concurrently submitted (un-waited) batches;
      ``submit`` past it blocks until a slot frees.
  """

  def __init__(self, method: str = "fused_pallas",
               convention: Convention = Convention.REF_HOMOGRAPHY,
               device="cuda", clock=time.perf_counter,
               max_inflight: int = 8):
    if max_inflight < 1:
      raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
    if method not in render.METHODS:
      raise ValueError(f"unknown render method {method!r}; one of "
                       f"{render.METHODS}")
    self.method = method
    self.convention = convention
    self.device = resolve_device(device)
    self._stream = (torch.cuda.Stream(device=self.device)
                    if self.device.type == "cuda" else None)
    self._clock = clock
    self.max_inflight = int(max_inflight)
    self._slots = threading.Semaphore(self.max_inflight)
    self._inflight_lock = threading.Lock()
    self._inflight = 0
    self.dispatches = 0
    self.abandoned = 0
    self.last_render_s = 0.0
    # Phase split of the last *waited* dispatch; with overlapped batches
    # prefer the per-handle ``InFlightBatch.timings``.
    self.last_timings = {"h2d_s": 0.0, "compute_s": 0.0, "readback_s": 0.0}

  @property
  def devices(self) -> list[torch.device]:
    return [self.device]

  def batch_bucket(self, v: int) -> int:
    """Padded batch size dispatched for a logical batch of ``v``."""
    if v <= 0:
      raise ValueError(f"batch must be non-empty, got {v}")
    return _next_pow2(v)

  @property
  def inflight(self) -> int:
    """Currently submitted batches whose slot is not yet released."""
    with self._inflight_lock:
      return self._inflight

  def _acquire_slot(self) -> None:
    self._slots.acquire()
    with self._inflight_lock:
      self._inflight += 1

  def _release_slot(self) -> None:
    with self._inflight_lock:
      self._inflight -= 1
    self._slots.release()

  def _count_abandoned(self) -> None:
    with self._inflight_lock:
      self.abandoned += 1

  # -- streaming API ------------------------------------------------------

  def _render(self, scene: BakedScene, poses: torch.Tensor) -> torch.Tensor:
    # A tile crop (serve/tiles.py) renders the full frame from its window
    # of the scene; a whole-scene bake keeps the historical call.
    kw = {} if scene.src_window is None else {"src_window": scene.src_window}
    return render.render_views(scene.rgba_layers, poses, scene.depths,
                               scene.intrinsics, convention=self.convention,
                               method=self.method, **kw)

  def submit(self, scene: BakedScene, poses) -> InFlightBatch:
    """Dispatch ``poses [V, 4, 4]`` against ``scene`` without waiting.

    Blocks only when ``max_inflight`` handles are already un-waited.
    Errors the device raises asynchronously surface at ``wait``.
    """
    poses = np.asarray(poses, np.float32)
    if poses.ndim != 3 or poses.shape[-2:] != (4, 4):
      raise ValueError(f"poses must be [V, 4, 4], got {poses.shape}")
    if scene.device != self.device:
      raise ValueError(f"scene {scene.scene_id!r} is baked on "
                       f"{scene.device}, the engine renders on {self.device}")
    v = poses.shape[0]
    bucket = self.batch_bucket(v)
    if bucket != v:
      poses = np.concatenate(
          [poses, np.repeat(poses[-1:], bucket - v, axis=0)])
    self._acquire_slot()
    try:
      t0 = self._clock()
      if self._stream is None:
        t1 = self._clock()
        out, event = self._render(scene, torch.tensor(poses)), None
      else:
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
          host_poses = torch.empty(poses.shape, dtype=torch.float32,
                                   pin_memory=True)
          host_poses.numpy()[...] = poses
          poses_dev = host_poses.to(self.device, non_blocking=True)
          t1 = self._clock()
          # The cache may evict the scene while this batch still reads it
          # on the engine's stream: keep its memory from being reused
          # until the stream has passed this point.
          for t in (scene.planes, scene.depths, scene.intrinsics):
            t.record_stream(self._stream)
          frames = self._render(scene, poses_dev)
          out = torch.empty(frames.shape, dtype=frames.dtype,
                            pin_memory=True)
          out.copy_(frames, non_blocking=True)
          event = torch.cuda.Event()
          event.record(self._stream)
    except BaseException:
      self._release_slot()
      raise
    with self._inflight_lock:  # concurrent submitters: don't drop counts
      self.dispatches += 1
    return InFlightBatch(self, out, event, v, t0, t1 - t0)

  def poll(self, handle: InFlightBatch) -> bool:
    """Non-blocking: is ``handle``'s result ready to read?"""
    return handle.event is None or bool(handle.event.query())

  def wait(self, handle: InFlightBatch) -> np.ndarray:
    """THE sync point: synchronise the batch's event, release the slot.

    Returns the live ``[V, H, W, 3]`` host views (padding sliced off).
    Device errors from the async dispatch raise here.
    """
    try:
      if handle.event is not None:
        handle.event.synchronize()
      t1 = self._clock()
      host = handle.out.numpy()
      t2 = self._clock()
    finally:
      handle.release_slot()
    # Phase split on the handle's timeline: h2d = host enqueue cost of the
    # pose upload, compute = submit-to-ready (render and the device-to-host
    # frame copy, both on the stream, plus queueing behind earlier
    # batches), readback = handing the finished host buffer over.
    handle.timings = {
        "h2d_s": handle.h2d_enqueue_s,
        "compute_s": max((t1 - handle.t_submit) - handle.h2d_enqueue_s, 0.0),
        "readback_s": t2 - t1,
    }
    self.last_render_s = t2 - handle.t_submit
    self.last_timings = dict(handle.timings)
    return host[:handle.views]

  def abandon(self, handle: InFlightBatch) -> None:
    """Release a handle's window slot without waiting on its result
    (the scheduler's watchdog gave up on it); counted in ``abandoned``."""
    handle.abandon()

  # -- blocking convenience ----------------------------------------------

  def render_batch(self, scene: BakedScene, poses) -> np.ndarray:
    """Blocking render: ``submit`` + ``wait``."""
    return self.wait(self.submit(scene, poses))

  def render_one(self, scene: BakedScene, pose) -> np.ndarray:
    """Single-pose convenience entry: ``[4, 4]`` -> ``[H, W, 3]``."""
    return self.render_batch(scene, np.asarray(pose, np.float32)[None])[0]

  @property
  def platform(self) -> str:
    return self.device.type

  def describe(self) -> dict:
    return {
        "devices": 1,
        "platform": self.platform,
        "device": (torch.cuda.get_device_name(self.device)
                   if self.device.type == "cuda" else "cpu"),
        "sharded": False,
        "method": self.method,
        "convention": self.convention.value,
        "dispatches": self.dispatches,
        "max_inflight": self.max_inflight,
        "abandoned": self.abandoned,
    }
