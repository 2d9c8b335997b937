"""Device dispatch for batched pose renders — streaming by design.

PyTorch counterpart of ``mpi_vision_tpu/serve/engine.py``. One baked
scene + a ``[V, 4, 4]`` pose batch in, ``[V, H, W, 3]`` host images out,
through ``core.render.render_views`` — by default
``method="fused_pallas"``, the CUDA kernel of ``kernels/render_fused.py``,
which renders any pose with no plan (the JAX engine cannot run its Pallas
kernels under its jit and serves through XLA instead). Tile-granular
services (serve/tiles.py) render cropped sources with ``method="pallas"``:
the warp, then the CUDA compose kernel of ``kernels/compose_over.py``. A
baked crop carries its window of the scene (``BakedScene.src_window``),
which the engine forwards.

The dispatch API is a streaming pipeline:

  * ``submit(scene, poses)`` enqueues the pose upload and the render on
    the engine's compute stream (one a card), records a
    ``torch.cuda.Event`` behind them and returns an ``InFlightBatch`` at
    once — no synchronise on the submit path. Poses go up from a pinned
    host buffer; frames land in a pinned host buffer that belongs to that
    batch alone, so a later batch can never overwrite it. A bounded
    in-flight window (``max_inflight``) backpressures submitters.
  * Write-through (``writes_through``): a whole-scene ``fused_pallas``
    flight renders straight into that pinned buffer. One launch of the
    kernel (``kernels/render_fused.render_to_host``) stores each composite
    over the host link as it is made, so the card keeps no frames buffer
    and runs no copy: a flight costs it the longer of the render and the
    link, not the two end to end. Tile crops, retargeted views and the
    other methods render into a device buffer that the card's copy stream
    reads back once the render is done. Both give the same pixels.
  * ``poll(handle)`` is the non-blocking readiness probe (``Event.query``).
  * ``wait(handle)`` is the ONE synchronization point: it synchronises the
    batch's event, hands back its frames, releases the window slot, and
    stamps the handle's phase timings, the JAX engine's three. On the card
    those are what the card did, from timing events on its streams:
    ``h2d_s`` the pose upload, ``compute_s`` the homographies and the
    render (the write-through's frames cross the link inside it), and
    ``readback_s`` the copy's own time (0 for a write-through flight,
    which runs none). The time a launch took to return on the host is not
    a device time. They feed ``/metrics``' ``device_phase_seconds`` and
    the attribution ledger.
  * ``abandon(handle)`` releases a handle's window slot without waiting.

``render_batch`` is ``submit`` + ``wait``. Completion workers call these
from their own threads, so every call names the engine's device and stream
explicitly rather than relying on a thread's current ones.

Sharded dispatch (``use_mesh``, the JAX engine's mesh path): the batch's
views split evenly over the engine's devices, as
``parallel.mesh.render_views_sharded`` splits them; each shard renders on
its device, on that device's stream, from that device's replica of the
scene, straight into its slice of the batch's pinned host buffer (or
read back into it on that device's copy stream) — serving needs host
frames, so no device-to-device gather; pinned memory is mapped into every
card's address space. A device that repeats in the list
(``[cuda:0, cuda:0]``) renders its shards one after the other on its
streams. A replica lives on the
``BakedScene`` it copies, so it is dropped with it when the cache swaps
or evicts that bake; the scene the cache holds is the first device's.

Batches are padded up to powers of two (sharded: the device count times a
power of two) by repeating the last pose, and the padding views are
sliced off at ``wait``. Per-view math is independent of
batch size — the kernel computes one pixel per thread with the planes in a
fixed order, and the plain path is elementwise — which is what lets the
scheduler promise bit-identical images whatever batch a request lands in.

On the CPU (``device="cpu"``, which a caller must ask for) the same API
runs the render synchronously inside ``submit`` through the kernel's plain
version.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from mpi_vision_tpu_torch.core import render
from mpi_vision_tpu_torch.core.sampling import Convention
from mpi_vision_tpu_torch.debug import named_scope
from mpi_vision_tpu_torch.device import resolve_device
from mpi_vision_tpu_torch.kernels import render_fused
from mpi_vision_tpu_torch.obs.trace import NULL_TRACER
from mpi_vision_tpu_torch.serve.cache import BakedScene


def _next_pow2(n: int) -> int:
  return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def writes_through(scene: BakedScene, method: str) -> bool:
  """Whether a card renders ``scene``'s flights straight into the
  flight's pinned host buffer (``kernels/render_fused.render_to_host``):
  whole-scene bakes under ``fused_pallas``. A tile crop and a retargeted
  (L2) view render through ``render_views``, and the plain methods have
  no kernel: they render into a device buffer that is then copied."""
  return (method == "fused_pallas" and scene.src_window is None
          and scene.out_hw is None)


def _copies_done(handle) -> bool:
  """Whether the card has passed ``handle``'s end event, after which
  nothing writes its host buffer; a failed device writes nothing more, so
  an error reads as done."""
  try:
    return bool(handle.event.query())
  except RuntimeError:
    return True


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

  __slots__ = ("out", "event", "marks", "views", "t_submit",
               "h2d_enqueue_s", "timings", "_engine", "_released", "_lock")

  def __init__(self, engine: "RenderEngine", out: torch.Tensor, event,
               views: int, t_submit: float, h2d_enqueue_s: float,
               marks: tuple | None = None):
    self.out = out
    self.event = event
    # Timing events (CUDA only), on the first card: on the compute stream
    # before the pose upload, after it and after the render; then, for a
    # flight that is copied, a (before, after) pair around each copy on the
    # copy stream.
    self.marks = marks
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
    engine that issued this handle. No-op on an already-released handle.
    The engine keeps the host buffer until the card has written it: the
    write-through kernel and the copies write pinned memory that PyTorch's
    allocator does not track."""
    if self.release_slot():
      self._engine._count_abandoned()
      self._engine._park(self)


class _Events:
  """The end events of one sharded batch, one per distinct device: ready
  when all are, synchronised one after the other."""

  __slots__ = ("events",)

  def __init__(self, events):
    self.events = events

  def query(self) -> bool:
    return all(e.query() for e in self.events)

  def synchronize(self) -> None:
    for e in self.events:
      e.synchronize()


def engine_devices(device="cuda", devices=None) -> list[torch.device]:
  """The devices an engine renders on: ``devices`` resolved, or, when
  none are named, ``device`` alone — except the default ``"cuda"``, which
  means every visible card (the JAX engine's ``jax.devices()``), the
  current one first."""
  if devices is not None:
    out = [resolve_device(d) for d in devices]
    if not out:
      raise ValueError("devices must name at least one device")
    if len({d.type for d in out}) > 1:
      raise ValueError(f"devices are all cuda or all cpu, got "
                       f"{[str(d) for d in out]}")
    return out
  first = resolve_device(device)
  if first.type != "cuda" or torch.device(device).index is not None:
    return [first]
  return [first] + [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())
                    if i != first.index]


class RenderEngine:
  """Batched render dispatch over one device or a mesh of them.

  Args:
    method: ``core.render.render_mpi`` method — 'fused_pallas' (the CUDA
      kernel; its plain version on the CPU) by default, 'pallas' (the
      warp, then the CUDA compose kernel; the method that renders tile
      crops), or the plain 'fused'/'scan'/'assoc'.
    convention: coordinate convention forwarded to the renderer.
    device: "cuda" (default) or "cpu"; with no CUDA device the engine
      raises unless the caller passes "cpu". Ignored when ``devices`` is
      given.
    use_mesh: force the sharded (True) or single-device (False) path;
      None shards exactly when more than one device is given or visible
      (the JAX engine's rule).
    devices: device list override (may repeat a device: ``["cpu"] * 8``,
      ``["cuda:0"] * 2``); default ``device`` — for ``"cuda"`` every
      visible card.
    clock: injectable timer for the per-dispatch phase split.
    max_inflight: bound on concurrently submitted (un-waited) batches;
      ``submit`` past it blocks until a slot frees.
    tracer: records the host spans ``engine/submit`` (after the window
      slot is held) and ``engine/event_wait`` (``obs.trace``); the default
      no-op tracer records nothing.
  """

  def __init__(self, method: str = "fused_pallas",
               convention: Convention = Convention.REF_HOMOGRAPHY,
               device="cuda", use_mesh: bool | None = None, devices=None,
               clock=time.perf_counter, max_inflight: int = 8,
               tracer=NULL_TRACER):
    if max_inflight < 1:
      raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
    if method not in render.METHODS:
      raise ValueError(f"unknown render method {method!r}; one of "
                       f"{render.METHODS}")
    self.method = method
    self.convention = convention
    self.devices = engine_devices(device, devices)
    self.use_mesh = (len(self.devices) > 1 if use_mesh is None
                     else bool(use_mesh))
    self.device = self.devices[0]
    # The devices a batch's shards render on, by shard; one stream per
    # distinct card.
    self._shard_devices = self.devices if self.use_mesh else [self.device]
    # A compute stream and a copy stream per distinct card: flights render
    # on the first, and the second copies the frames of flights that do
    # not write through.
    self._streams = self._copy_streams = None
    if self.device.type == "cuda":
      cards = list(dict.fromkeys(self._shard_devices))
      self._streams = {d: torch.cuda.Stream(device=d) for d in cards}
      self._copy_streams = {d: torch.cuda.Stream(device=d) for d in cards}
    self._parked: list[InFlightBatch] = []
    self._replica_lock = threading.Lock()
    self._clock = clock
    self.max_inflight = int(max_inflight)
    self._slots = threading.Semaphore(self.max_inflight)
    self._inflight_lock = threading.Lock()
    self._inflight = 0
    self.tracer = tracer
    self.dispatches = 0
    self.abandoned = 0

  def batch_bucket(self, v: int) -> int:
    """Padded batch size dispatched for a logical batch of ``v``."""
    if v <= 0:
      raise ValueError(f"batch must be non-empty, got {v}")
    if not self.use_mesh:
      return _next_pow2(v)
    n = len(self.devices)
    return n * _next_pow2(-(-v // n))

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

  def _park(self, handle: InFlightBatch) -> None:
    """Hold an abandoned handle's host buffer until the card has passed its
    end event, so the pinned allocator cannot hand it out while the card
    still writes it."""
    if handle.event is None:
      return
    with self._inflight_lock:
      self._parked = [h for h in self._parked + [handle]
                      if not _copies_done(h)]

  # -- streaming API ------------------------------------------------------

  def _render(self, scene: BakedScene, poses: torch.Tensor) -> torch.Tensor:
    # A tile crop (serve/tiles.py) renders the full frame from its window
    # of the scene, a half-resolution view (brownout L2) its own target;
    # a whole-scene bake keeps the historical call.
    kw = {} if scene.src_window is None else {"src_window": scene.src_window}
    if scene.out_hw is not None:
      kw["out_hw"] = scene.out_hw
      kw["tgt_intrinsics"] = scene.tgt_intrinsics
    return render.render_views(scene.rgba_layers, poses, scene.depths,
                               scene.intrinsics, convention=self.convention,
                               method=self.method, **kw)

  def _replica(self, scene: BakedScene, dev: torch.device) -> BakedScene:
    """``scene`` on ``dev``: itself on its own device, else a view of the
    copies ``scene.replicas`` holds for ``dev`` (made on first use)."""
    if dev == scene.device:
      return scene
    with self._replica_lock:
      copies = scene.replicas.get(dev)
      if copies is None:
        copies = tuple(t.to(dev) for t in (scene.planes, scene.depths,
                                           scene.intrinsics))
        if dev.type == "cuda":
          torch.cuda.synchronize(dev)
        scene.replicas[dev] = copies
    planes, depths, intrinsics = copies
    return dataclasses.replace(
        scene, planes=planes, depths=depths, intrinsics=intrinsics,
        tgt_intrinsics=(None if scene.tgt_intrinsics is None
                        else scene.tgt_intrinsics.to(dev)),
        replicas={})

  def submit(self, scene: BakedScene, poses) -> InFlightBatch:
    """Dispatch ``poses [V, 4, 4]`` against ``scene`` without waiting.

    On a card, the compute stream of every card the batch uses uploads the
    poses and renders. A write-through flight (``writes_through``)
    computes the homographies once and launches the kernel into its slice
    of the batch's pinned host buffer: the frames cross the host link as
    they are composited, and the batch's end event follows the render on
    the compute stream. Any other flight renders into a device buffer,
    which the copy stream copies into the pinned buffer once the render is
    done; the end event follows the copy.

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
    # Shard i renders views [i * k, (i + 1) * k) on its device.
    shards = list(enumerate(self._shard_devices))
    k = bucket // len(shards)
    # The streams that may write the batch's pinned host buffer.
    writing = []
    self._acquire_slot()
    try:
      with self.tracer.span("engine/submit"):
        t0 = self._clock()
        marks = None
        if self._streams is None:
          t1 = self._clock()
          poses_t = torch.tensor(poses)
          frames = [self._render(self._replica(scene, dev),
                                 poses_t[i * k:(i + 1) * k])
                    for i, dev in shards]
          out, event = (frames[0] if len(frames) == 1
                        else torch.cat(frames)), None
        else:
          through = writes_through(scene, self.method)
          first = self._streams[self.device]
          # Timing marks on the first card: the flight's start, the poses
          # uploaded, the render done; then a (start, end) pair around
          # each copy.
          marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
          host_poses = torch.empty(poses.shape, dtype=torch.float32,
                                   pin_memory=True)
          host_poses.numpy()[...] = poses
          # Uploads are enqueued for every shard before the renders, so the
          # timing marks on the first card bracket each stage.
          marks[0].record(first)
          poses_dev = []
          for i, dev in shards:
            with torch.cuda.device(dev), \
                torch.cuda.stream(self._streams[dev]):
              poses_dev.append(host_poses[i * k:(i + 1) * k].to(
                  dev, non_blocking=True))
          marks[1].record(first)
          t1 = self._clock()
          height, width = scene.planes.shape[1:3]
          out = (torch.empty((bucket, height, width, 3), dtype=torch.float32,
                             pin_memory=True) if through else None)
          frames = []
          for i, dev in shards:
            stream = self._streams[dev]
            with torch.cuda.device(dev), torch.cuda.stream(stream):
              rep = self._replica(scene, dev)
              # The cache may evict the scene while this batch still reads
              # it on the compute stream: keep its memory from being reused
              # until the stream has passed this point.
              for t in (rep.planes, rep.depths, rep.intrinsics,
                        rep.tgt_intrinsics):
                if t is not None:
                  t.record_stream(stream)
              if through:
                homs = render.views_homographies(
                    poses_dev[i], rep.depths, rep.intrinsics, height, width,
                    self.convention)
                writing.append(stream)
                # The range render_mpi's fused launch carries.
                with named_scope("render/warp_composite"):
                  render_fused.render_to_host(rep.planes, homs,
                                              out[i * k:(i + 1) * k])
              else:
                frames.append(self._render(rep, poses_dev[i]))
          marks[2].record(first)
          # The streams whose last work ends the batch, one a card.
          ends = self._streams
          if not through:
            ends = self._copy_streams
            out = torch.empty((bucket,) + tuple(frames[0].shape[1:]),
                              dtype=frames[0].dtype, pin_memory=True)
            for (i, dev), f in zip(shards, frames):
              copy = self._copy_streams[dev]
              copy.wait_stream(self._streams[dev])
              writing.append(copy)
              pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
              with torch.cuda.device(dev), torch.cuda.stream(copy):
                pair[0].record(copy)
                out[i * k:(i + 1) * k].copy_(f, non_blocking=True)
                pair[1].record(copy)
              if dev == self.device:
                marks += pair
              # The allocator must not hand the frames buffer to later work
              # on the compute stream before the copy has read it.
              f.record_stream(copy)
          events = [s.record_event() for s in ends.values()]
          event = events[0] if len(events) == 1 else _Events(events)
          marks = tuple(marks)
    except BaseException:
      # Write-through launches and copies already enqueued write pinned
      # memory that PyTorch's host allocator does not track: let them end
      # before ``out`` goes back to it.
      for stream in writing:
        try:
          stream.synchronize()
        except RuntimeError:  # a failed device writes nothing more
          pass
      self._release_slot()
      raise
    with self._inflight_lock:  # concurrent submitters: don't drop counts
      self.dispatches += 1
    return InFlightBatch(self, out, event, v, t0, t1 - t0, marks)

  def poll(self, handle: InFlightBatch) -> bool:
    """Non-blocking: is ``handle``'s result ready to read?"""
    return handle.event is None or bool(handle.event.query())

  def wait(self, handle: InFlightBatch) -> np.ndarray:
    """THE sync point: synchronise the batch's event, release the slot.

    Returns the live ``[V, H, W, 3]`` host views (padding sliced off).
    Device errors from the async dispatch raise here.
    """
    try:
      with self.tracer.span("engine/event_wait", "wait"):
        if handle.event is not None:
          handle.event.synchronize()
      t1 = self._clock()
      host = handle.out.numpy()
      t2 = self._clock()
    finally:
      handle.release_slot()
    if handle.marks is not None:
      # What the first card did, from the streams' timing events: the pose
      # upload, the render (homographies and kernel; a write-through's
      # frames cross the link inside it), and the copy into pinned memory
      # (its own time; none for a write-through).
      m = handle.marks
      handle.timings = {
          "h2d_s": m[0].elapsed_time(m[1]) / 1e3,
          "compute_s": m[1].elapsed_time(m[2]) / 1e3,
          "readback_s": sum(a.elapsed_time(b)
                            for a, b in zip(m[3::2], m[4::2])) / 1e3,
      }
    else:
      # The CPU renders synchronously inside submit: compute is submit to
      # wait on the host clock, readback the hand-over of the host buffer.
      handle.timings = {
          "h2d_s": handle.h2d_enqueue_s,
          "compute_s": max((t1 - handle.t_submit) - handle.h2d_enqueue_s,
                           0.0),
          "readback_s": t2 - t1,
      }
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

  def cpu_fallback(self) -> "RenderEngine":
    """A CPU engine with this engine's method, convention and window — the
    degraded-mode route while the circuit breaker refuses the card. On the
    CPU every kernel wrapper runs its plain version (the same method by
    name: ``fused_pallas`` renders through ``plain_render``, ``pallas``
    composites through ``plain_composite``), so a fallback frame is the
    kernel's function of the same inputs."""
    return RenderEngine(method=self.method, convention=self.convention,
                        device="cpu", use_mesh=False, clock=self._clock,
                        max_inflight=self.max_inflight, tracer=self.tracer)

  def describe(self) -> dict:
    return {
        "devices": len(self.devices),
        "platform": self.platform,
        "device": (torch.cuda.get_device_name(self.device)
                   if self.device.type == "cuda" else "cpu"),
        "sharded": self.use_mesh,
        "method": self.method,
        "convention": self.convention.value,
        "dispatches": self.dispatches,
        "max_inflight": self.max_inflight,
        "abandoned": self.abandoned,
    }
