"""Pipelined micro-batching scheduler: coalesce, stream, complete.

The serving win (Potamoi-style streaming renderers, PAPERS.md): per-pose
renders of an already-baked scene are cheap and *batch on the view axis
for free*, so concurrent requests for the same scene should ride one
device dispatch, not N. Requests enter a FIFO; a single dispatcher thread
takes the oldest pending request, coalesces every other pending request
for the SAME scene (up to ``max_batch``), waits up to ``max_wait_ms``
from that request's enqueue for stragglers, and hands the batch to the
pipeline as one compiled call. Each request's future resolves with its
own view — bit-identical to an unbatched render of the same pose
(``core.render.render_views`` batches element-independently; the engine
pads with repeated poses, never altering live views).

**The pipeline**: the dispatcher does not block on completion. Each
assembled batch becomes a *flight*; up to
``max_inflight`` flights run concurrently on a completion pool, each
asynchronously enqueuing its device work (``engine.submit`` — CUDA stream
work, no mid-pipeline syncs) and syncing only at readback
(``engine.wait``). While flight N waits on the device, the dispatcher is
assembling and submitting flight N+1 — pose h2d, compute, and readback
overlap, and the device never idles between batches (pinned by the
``dispatch_gap`` metric: time the device sat idle before a flight began
while nothing was in flight). Futures resolve **out of dispatch order**:
a straggler flight (retry storm, slow fault, cold bake) does not hold up
the completions queued behind it. ``max_inflight=1`` is blocking
dispatch — one flight at a time, the dispatcher backpressured until it
completes.

Resilience attaches to the *flight*, not the dispatcher: every flight
runs its attempts (retry/backoff/breaker/watchdog, and the degraded-mode
CPU fallback while the breaker refuses the card) on its own completion
worker, with its own deadline. A flight the watchdog gives up on is
*abandoned* — its futures fail, its device
work cannot be cancelled, but its engine window slot is released
(``engine.abandon``) and the abandonment is counted
(``abandoned_batches``) so a hung device degrades loudly instead of
silently wedging the window.

Tracing rides the queue: each ``_Pending`` carries its request's
``obs.trace.Trace`` (the no-op singleton when tracing is off), the
flight closes the queue-wait span, stamps the shared batch-assembly/
dispatch/attempt/phase spans into every batch member, and finishes the
trace when the future resolves. All time reads go through the injected
``clock`` so spans, deadlines, and latencies share one base.
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
import time
from collections import deque
from concurrent.futures import Future, TimeoutError as FuturesTimeoutError

import numpy as np

from mpi_vision_tpu_torch.obs.trace import NULL_TRACE, SpanRecorder
from mpi_vision_tpu_torch.serve.engine import RenderEngine
from mpi_vision_tpu_torch.serve.metrics import ServeMetrics
from mpi_vision_tpu_torch.serve.resilience import (
    DispatchTimeoutError,
    ResilientExecutor,
    classify_error,
)


class QueueFullError(RuntimeError):
  """Backpressure signal: the request queue is at ``max_queue``.

  Raised at submit time so overload is shed at the door (HTTP maps it to
  503) instead of building an unbounded backlog of requests whose callers
  will have timed out by the time the device reaches them.

  ``retry_after_s`` is optionally set by layers that know when the shed
  condition clears (the edge cache's negative entries carry their
  remaining TTL); the HTTP handler surfaces it as ``Retry-After``.
  """

  retry_after_s: float | None = None


@dataclasses.dataclass
class _Pending:
  scene_id: str
  pose: np.ndarray
  future: Future
  t_enqueue: float
  deadline: float | None = None  # absolute monotonic; None = no deadline
  trace: object = NULL_TRACE     # obs.trace.Trace (or the no-op singleton)
  qspan: int = 0                 # open queue_wait span handle
  key: str = ""                  # batch/scene-provider key (tile signature
                                 # appended for tiled scenes); defaults to
                                 # scene_id in submit()
  attrib: tuple | None = None    # (request_class, brownout_level) of the
                                 # request; None = unlabeled
  t_dispatch: float = 0.0        # when the flight claimed the request
                                 # (queue wait = t_dispatch - t_enqueue)


@dataclasses.dataclass
class _Flight:
  """One assembled batch moving through the pipeline."""

  seq: int                      # dispatch order (for out-of-order proof)
  batch: list                   # claimed, live _Pending requests
  poses: np.ndarray             # stacked [V, 4, 4]
  deadline: float | None        # the batch's most patient member
  recorder: object              # SpanRecorder or None (tracing off)
  assembly: tuple | None        # (t0, t1) of the straggler window
  retired: bool = False         # pipeline bookkeeping done (idempotent)


class MicroBatcher:
  """Request queue + streaming dispatch pipeline over a ``RenderEngine``.

  Args:
    engine: the device dispatch layer, with the streaming API
      (``submit``/``wait``) of ``RenderEngine``.
    scene_provider: ``scene_id -> BakedScene`` (typically
      ``SceneCache.get_or_bake`` partial'd over the server's scene
      registry); exceptions fail the whole batch's futures.
    metrics: counters sink (a private one is made if omitted).
    max_batch: hard cap on coalesced requests per dispatch.
    max_wait_ms: straggler window measured from the oldest request's
      enqueue time. 0 disables waiting (whatever is pending when the
      dispatcher wakes still coalesces).
    max_queue: pending-request cap; submissions beyond it raise
      ``QueueFullError`` (shed load instead of queueing past the point
      where callers' timeouts make the work dead anyway).
    max_inflight: concurrent flights (the pipeline window). 1 = the
      legacy blocking behavior: the dispatcher waits for each flight
      before assembling the next. >= 2 overlaps h2d/compute/readback
      across flights and completes out of dispatch order.
    adaptive_inflight: grow ``max_inflight`` automatically (the
      ``--max-inflight auto`` mode): every
      ``adapt_every`` flights the mean device-idle gap per flight is
      compared against the previous epoch's; while growing the window
      keeps improving it by at least ``adapt_improve`` (fractionally),
      the window grows by one, capped at ``max_inflight_cap``. The
      first epoch always probes upward (there is nothing to compare
      yet); a window whose device never idles, or whose growth stopped
      paying, settles and stays put. The window only grows — shrinking
      under a lull would just re-learn the same answer when load
      returns.
    max_inflight_cap: the adaptive mode's hard ceiling (completion
      workers are pre-spawned to it, so growth never races thread
      startup); defaults to ``max(max_inflight, 16)``.
    resilient: optional ``resilience.ResilientExecutor``; when set, every
      flight runs through its retry/breaker/watchdog machinery and an
      open breaker fast-fails submissions (``CircuitOpenError``) unless a
      fallback engine can degrade instead.
    fallback_engine / fallback_scene_provider: the degraded-mode route —
      a CPU engine plus a provider baking scenes onto *its* device; used
      only while the breaker refuses the primary.
    batch_keyer: optional ``(scene_id, pose, degrade) -> (key, attrs |
      None)`` hook of tile-granular and brownout services (serve/tiles.py;
      ``degrade`` is ``submit``'s). The key replaces the
      scene id for batch coalescing AND the scene-provider call, so
      requests batch only with frusta sharing their exact render plan —
      which keeps a request's pixels a pure function of its own pose,
      never of its batchmates'. ``attrs`` (tiles touched/culled) land on
      the request's trace as a zero-length ``tile_cull`` span and in
      ``metrics.record_tiles``.
    clock: injectable monotonic clock (deadlines, latencies, span edges
      all read it — share one instance with the tracer and the resilient
      executor so every timestamp is on one base).
  """

  def __init__(self, engine: RenderEngine, scene_provider,
               metrics: ServeMetrics | None = None,
               max_batch: int = 8, max_wait_ms: float = 2.0,
               max_queue: int = 1024, max_inflight: int = 1,
               adaptive_inflight: bool = False,
               max_inflight_cap: int | None = None,
               adapt_every: int = 32, adapt_improve: float = 0.05,
               resilient: ResilientExecutor | None = None,
               fallback_engine=None, fallback_scene_provider=None,
               batch_keyer=None, clock=time.monotonic):
    if max_batch < 1:
      raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if max_queue < 1:
      raise ValueError(f"max_queue must be >= 1, got {max_queue}")
    if max_inflight < 1:
      raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
    if max_inflight_cap is None:
      max_inflight_cap = max(max_inflight, 16)
    if max_inflight_cap < max_inflight:
      raise ValueError(
          f"max_inflight_cap {max_inflight_cap} < max_inflight "
          f"{max_inflight}")
    if adapt_every < 1:
      raise ValueError(f"adapt_every must be >= 1, got {adapt_every}")
    if fallback_engine is not None and fallback_scene_provider is None:
      raise ValueError("fallback_engine requires fallback_scene_provider")
    self.engine = engine
    self.scene_provider = scene_provider
    self.metrics = ServeMetrics() if metrics is None else metrics
    self.max_batch = max_batch
    self.max_wait_s = max(max_wait_ms, 0.0) / 1e3
    self.max_queue = max_queue
    self.max_inflight = int(max_inflight)
    self.adaptive_inflight = bool(adaptive_inflight)
    self.max_inflight_cap = int(max_inflight_cap)
    self._adapt_every = int(adapt_every)
    self._adapt_improve = float(adapt_improve)
    # Adaptive-epoch accumulators (guarded by _cond): gap seconds and
    # flight count since the last decision, the previous epoch's mean
    # gap per flight, and whether adaptation has settled for good.
    self._adapt_gap_s = 0.0
    self._adapt_flights = 0
    self._adapt_prev: float | None = None
    self._adapt_settled = not self.adaptive_inflight
    self._adapt_epochs = 0
    self.resilient = resilient
    self.fallback_engine = fallback_engine
    self.fallback_scene_provider = fallback_scene_provider
    self._batch_keyer = batch_keyer
    self._clock = clock
    self._queue: deque[_Pending] = deque()
    self._cond = threading.Condition()
    self._stop = False
    self._thread: threading.Thread | None = None
    self._last_assembly: tuple[float, float] | None = None
    # Pipeline state (guarded by _cond): live flight count + sequence
    # tracking for the dispatch-gap and out-of-order metrics.
    self._inflight = 0
    self._seq = 0
    self._live_seqs: set[int] = set()
    self._last_done_t: float | None = None
    self._flights: "queue_mod.Queue[_Flight | None]" = queue_mod.Queue()
    self._completers: list[threading.Thread] = []

  @property
  def rejected(self) -> int:
    """Queue-full sheds (lives in metrics so /stats reflects it)."""
    return self.metrics.rejected

  # -- lifecycle ----------------------------------------------------------

  def start(self) -> "MicroBatcher":
    if self._thread is not None:
      raise RuntimeError("MicroBatcher already started")
    self._thread = threading.Thread(target=self._loop,
                                    name="mpi-serve-dispatch", daemon=True)
    # Adaptive mode pre-spawns workers for the whole cap: growth then
    # only moves an integer bound, never races thread startup.
    workers = (self.max_inflight_cap if self.adaptive_inflight
               else self.max_inflight)
    self._completers = [
        threading.Thread(target=self._complete_loop,
                         name=f"mpi-serve-complete-{i}", daemon=True)
        for i in range(workers)]
    for t in self._completers:
      t.start()
    self._thread.start()
    return self

  def stop(self, timeout: float = 10.0) -> None:
    with self._cond:
      self._stop = True
      self._cond.notify_all()
    if self._thread is not None:
      self._thread.join(timeout)
      self._thread = None
    with self._cond:
      while self._queue:  # drain: fail leftovers instead of hanging callers
        req = self._queue.popleft()
        if req.future.set_running_or_notify_cancel():
          exc = RuntimeError(
              "scheduler stopped: request dropped at shutdown "
              "before it reached the device")
          req.trace.end_span(req.qspan, error="scheduler stopped")
          req.future.set_exception(exc)
          req.trace.finish(error=repr(exc))
      self.metrics.set_queue_depth(0)
    # In-flight flights complete naturally (their watchdogs/deadlines
    # bound them); the sentinel wakes each completer once the backlog is
    # drained, and the join is bounded so a truly hung flight can only
    # cost the timeout, never a wedged shutdown.
    for _ in self._completers:
      self._flights.put(None)
    for t in self._completers:
      t.join(timeout)
    self._completers = []

  def dispatcher_alive(self) -> bool:
    """Is the whole pipeline running? (healthz's liveness signal — a
    wedged/dead dispatcher OR a dead completion worker with a growing
    queue must not report ok; the completers resolve the futures now, so
    they are as load-bearing as the dispatcher itself.)"""
    return (self._thread is not None and self._thread.is_alive()
            and all(t.is_alive() for t in self._completers))

  # -- request path -------------------------------------------------------

  def submit(self, scene_id: str, pose, timeout: float | None = None,
             trace=NULL_TRACE, degrade: int = 0,
             attrib: tuple | None = None) -> Future:
    """Enqueue one pose render; the future resolves to ``[H, W, 3]``.

    ``timeout`` (seconds) sets the request's deadline: retries/backoff
    stop at it, the dispatch watchdog tightens to it, and a request still
    queued past it fails instead of burning a dispatch.

    ``trace`` is this request's ``obs.trace.Trace``; the pipeline
    records its span tree (queue-wait onward) and finishes it when the
    future resolves. The default no-op singleton costs nothing.

    ``degrade`` is the brownout render tier (0 = full quality) threaded
    to the batch keyer, which folds it into the batch key — degraded and
    full-quality requests can never coalesce into one flight.

    ``attrib`` is the request's ``(request_class, brownout_level)``
    (the service's front door sets it); it rides the pending entry and
    lands on the request's trace as a zero-length ``admit`` span.
    """
    pose = np.asarray(pose, np.float32)
    if pose.shape != (4, 4):
      raise ValueError(f"pose must be [4, 4], got {pose.shape}")
    if self.resilient is not None:
      # Fast-fail 503 at the door while the breaker is open and there is
      # no fallback to degrade to: queueing the request would only make
      # the caller wait to learn what is already known.
      self.resilient.check_fastfail(self.fallback_engine is not None)
    key, attrs = str(scene_id), None
    if self._batch_keyer is not None:
      # Frustum culling happens HERE, at the door: the key decides which
      # batch the request may ride (KeyError for unknown scenes
      # propagates to the caller — the same 404 the provider would
      # raise, just before any queue time is spent).
      key, attrs = self._batch_keyer(str(scene_id), pose, degrade)
    now = self._clock()
    fut: Future = Future()
    req = _Pending(str(scene_id), pose, fut, now,
                   deadline=None if timeout is None else now + timeout,
                   trace=trace, qspan=trace.start_span("queue_wait"),
                   key=key, attrib=attrib)
    with self._cond:
      if self._stop or self._thread is None:
        raise RuntimeError("scheduler is not running")
      if len(self._queue) >= self.max_queue:
        self.metrics.record_rejected()
        raise QueueFullError(
            f"request queue full ({self.max_queue} pending)")
      self._queue.append(req)
      self.metrics.set_queue_depth(len(self._queue))
      self._cond.notify_all()
    if attrib is not None:
      cls, level = attrib
      trace.end_span(trace.start_span("admit", request_class=cls,
                                      level=level))
    if attrs:
      # Enqueued for real: only now does the plan land on the trace and
      # in the tile counters — rejected requests never skew the ratios.
      tspan = trace.start_span("tile_cull", **attrs)
      trace.end_span(tspan)
      self.metrics.record_tiles(attrs["tiles_touched"],
                                attrs["tiles_rendered"],
                                attrs["tiles_total"], attrs.get("planes"))
    return fut

  def queue_fraction(self) -> float:
    """Queue occupancy in [0, 1] — the brownout controller's pressure
    signal (burn rate says users are hurting; this says why)."""
    with self._cond:
      return len(self._queue) / self.max_queue

  def render(self, scene_id: str, pose, timeout: float = 60.0,
             trace=NULL_TRACE, degrade: int = 0,
             attrib: tuple | None = None) -> np.ndarray:
    """Synchronous render: submit + wait.

    On timeout the request is cancelled (best-effort) so an overloaded
    queue is not burning device dispatches on results nobody will read.
    Never blocks past ``timeout``: the future resolves or times out even
    when the dispatch behind it hangs (the watchdog abandons it).

    Owns ``trace``'s error edge: submit-time rejections and caller
    timeouts finish it here; everything past the queue the flight
    finishes (``Trace.finish`` is idempotent, so the race with a late
    completion is safe).
    """
    try:
      fut = self.submit(scene_id, pose, timeout=timeout, trace=trace,
                        degrade=degrade, attrib=attrib)
    except Exception as e:
      trace.finish(error=repr(e))
      raise
    try:
      return fut.result(timeout)
    except FuturesTimeoutError:
      fut.cancel()
      trace.finish(error="caller timed out waiting on the future")
      raise
    except Exception as e:
      trace.finish(error=repr(e))  # the flight usually beat us (no-op)
      raise

  # -- dispatcher ---------------------------------------------------------

  def _take_batch(self) -> list[_Pending]:
    """Block for work, then coalesce one same-key batch (FIFO head's
    key). Returns [] only on stop."""
    with self._cond:
      while True:
        # Cancelled requests (caller timed out) must neither stall the
        # head slot nor burn a dispatch; drop them eagerly.
        while self._queue and self._queue[0].future.cancelled():
          self._queue.popleft()
        if self._stop:
          return []
        if not self._queue:
          self.metrics.set_queue_depth(0)
          self._cond.wait()
          continue
        head = self._queue[0]
        t_assembly = self._clock()  # head claimed; straggler window opens
        deadline = head.t_enqueue + self.max_wait_s
        # Straggler window: keep collecting same-key requests (same scene
        # — and, for tiled scenes, the same render plan) until the batch
        # is full or the head request's wait budget is spent.
        while True:
          same = sum(1 for r in self._queue
                     if r.key == head.key
                     and not r.future.cancelled())
          remaining = deadline - self._clock()
          if same >= self.max_batch or remaining <= 0 or self._stop:
            break
          self._cond.wait(remaining)
        batch, rest = [], deque()
        for req in self._queue:
          if req.future.cancelled():
            continue
          if req.key == head.key and len(batch) < self.max_batch:
            batch.append(req)
          else:
            rest.append(req)
        self._queue = rest
        self.metrics.set_queue_depth(len(self._queue))
        if batch:
          self._last_assembly = (t_assembly, self._clock())
          return batch
        # Everything same-scene was cancelled during the wait; go around
        # (other-scene requests are back in the queue, NOT a stop).

  def reset_gap_clock(self) -> None:
    """Forget the last completion time so the next launch records no
    dispatch gap. Load generators call this next to ``metrics.reset()``
    — otherwise the first measured-window gap would span the whole
    warmup-to-measurement idle and pollute the freshly-reset stats."""
    with self._cond:
      self._last_done_t = None

  def _wait_for_slot(self) -> bool:
    """Block until a pipeline slot frees (or stop). True = slot held.

    The dispatcher acquires its slot BEFORE assembling a batch, so with
    ``max_inflight=1`` requests keep queueing (and shedding at
    ``max_queue``) while the single flight runs — the legacy blocking
    backpressure, preserved exactly.
    """
    with self._cond:
      while self._inflight >= self.max_inflight and not self._stop:
        self._cond.wait()
      return not self._stop

  def _make_flight(self, batch: list[_Pending]) -> _Flight | None:
    """Claim futures, expire dead requests, stamp assembly spans."""
    # Claim every future first (PENDING -> RUNNING): a future that was
    # cancelled between dequeue and here drops out, and a claimed one can
    # no longer be cancelled under us (set_result would InvalidStateError,
    # killing a completion worker).
    batch = [r for r in batch if r.future.set_running_or_notify_cancel()]
    # A request whose deadline already passed has a caller that gave up
    # (or will, before the result lands): fail it now rather than let it
    # drag the live batch's watchdog budget down to zero.
    now = self._clock()
    live: list[_Pending] = []
    for req in batch:
      if req.deadline is not None and req.deadline <= now:
        self.metrics.record_error("deadline")  # overload, not device trouble
        exc = DispatchTimeoutError("request deadline expired before dispatch")
        exc.deadline_capped = True  # HTTP layer: 504, not a device 503
        req.trace.end_span(req.qspan, error="deadline expired in queue")
        req.future.set_exception(exc)
        req.trace.finish(error=repr(exc))
      else:
        live.append(req)
    if not live:
      return None
    assembly = self._last_assembly
    for req in live:
      req.t_dispatch = now  # queue wait ends where the qspan ends
      req.trace.end_span(req.qspan)
      if assembly is not None:
        req.trace.add_span("batch_assembly", assembly[0], assembly[1],
                           size=len(live))
    # Shared span records (one dispatch, many traces) — only allocated
    # when at least one batch member is actually traced, so the disabled
    # path stays allocation-free.
    recorder = (SpanRecorder(self._clock)
                if any(r.trace is not NULL_TRACE for r in live) else None)
    # The batch's dispatch budget follows its MOST patient member: a
    # short-timeout request must not drag its batchmates' watchdog down
    # to its own deadline (the impatient caller's future times out on its
    # own clock either way). A single deadline-free member lifts the cap
    # entirely, leaving the plain watchdog_s hang guard in charge.
    deadlines = [r.deadline for r in live if r.deadline is not None]
    deadline = max(deadlines) if len(deadlines) == len(live) else None
    poses = np.stack([r.pose for r in live])
    return _Flight(seq=0, batch=live, poses=poses, deadline=deadline,
                   recorder=recorder, assembly=assembly)

  def _launch(self, flight: _Flight) -> None:
    """Register the flight in the pipeline window and hand it to the
    completion pool. The dispatch-gap metric records how long the device
    sat with NOTHING in flight before this launch — the number that must
    stay ~0 for the pipeline to claim the device never idles."""
    with self._cond:
      flight.seq = self._seq
      self._seq += 1
      if self._inflight == 0 and self._last_done_t is not None:
        gap_s = self._clock() - self._last_done_t
        self.metrics.record_dispatch_gap(gap_s)
        if not self._adapt_settled:
          self._adapt_gap_s += max(gap_s, 0.0)
      self._inflight += 1
      self._live_seqs.add(flight.seq)
      self.metrics.set_inflight(self._inflight)
    self._flights.put(flight)

  def _retire(self, flight: _Flight) -> None:
    """Pipeline bookkeeping the moment the flight's device work is over
    (before futures/spans, so gap measurement reflects the device, not
    host-side completion work). Idempotent: the completer's crash guard
    may re-retire a flight that already retired before failing."""
    with self._cond:
      if flight.retired:
        return
      flight.retired = True
      self._live_seqs.discard(flight.seq)
      if any(s < flight.seq for s in self._live_seqs):
        # An earlier-dispatched flight is still in the air: this
        # completion is out of dispatch order (a straggler did not hold
        # us up) — the pipeline's whole point, so count the proof.
        self.metrics.record_out_of_order()
      self._inflight -= 1
      self._last_done_t = self._clock()
      self.metrics.set_inflight(self._inflight)
      if not self._adapt_settled:
        self._adapt_flights += 1
        if self._adapt_flights >= self._adapt_every:
          cur = self._adapt_gap_s / self._adapt_flights
          self.max_inflight, self._adapt_settled = self._next_window(
              self._adapt_prev, cur, self.max_inflight,
              self.max_inflight_cap, self._adapt_improve)
          self._adapt_prev = cur
          self._adapt_gap_s, self._adapt_flights = 0.0, 0
          self._adapt_epochs += 1
      self._cond.notify_all()

  @staticmethod
  def _next_window(prev_gap: float | None, cur_gap: float, window: int,
                   cap: int, min_improve: float) -> tuple[int, bool]:
    """One adaptive-window decision: ``(next_window, settled)``.

    Grow while growing keeps shrinking the mean device-idle gap per
    flight by at least ``min_improve``; settle the first time it stops
    (or the device never idles, or the cap is reached). Pure so the
    policy is unit-testable without threads.
    """
    if window >= cap:
      return window, True
    if cur_gap <= 1e-9:
      return window, True  # device never idles: the window is enough
    if prev_gap is None:
      return window + 1, False  # first epoch: nothing to compare, probe up
    if cur_gap <= prev_gap * (1.0 - min_improve):
      return window + 1, False
    return window, True

  def adaptive_snapshot(self) -> dict | None:
    """The ``/stats`` adaptive block (None when the mode is off)."""
    if not self.adaptive_inflight:
      return None
    with self._cond:
      return {"settled": self._adapt_settled,
              "cap": self.max_inflight_cap,
              "epochs": self._adapt_epochs}

  def _loop(self) -> None:
    while True:
      if not self._wait_for_slot():
        return
      batch = self._take_batch()
      if not batch:
        return
      flight = self._make_flight(batch)
      if flight is None:
        continue  # everything expired/cancelled; the slot was never used
      self._launch(flight)

  # -- completion path ----------------------------------------------------

  def _complete_loop(self) -> None:
    while True:
      flight = self._flights.get()
      if flight is None:
        return
      try:
        self._run_flight(flight)
      except BaseException as e:  # noqa: BLE001 - worker must survive
        # _run_flight handles expected failures itself; this guard is
        # for bugs in the resolution tail. The worker stays alive (a
        # dead completer would silently halt the pipeline while healthz
        # reads ok) and the flight's callers get the error instead of
        # hanging to their timeouts.
        self._retire(flight)  # idempotent; frees the window slot
        for req in flight.batch:
          if not req.future.done():
            try:
              req.future.set_exception(e)
            except Exception:  # noqa: BLE001 - racing a late resolution
              pass
            req.trace.finish(error=repr(e))

  def _bake_with_span(self, scene_provider, scene_id, recorder, parent):
    """Scene lookup/bake with its trace span — a cache hit is ~0 ms, a
    miss is the real bake, and a failed bake carries its error on the
    span before re-raising, so the trace tree stays complete through
    retries and fallback."""
    tb0 = self._clock()
    try:
      scene = scene_provider(scene_id)
    except Exception as e:
      if recorder is not None:
        recorder.record("bake", tb0, self._clock(), error=repr(e),
                        parent=parent, scene_id=scene_id)
      raise
    if recorder is not None:
      recorder.record("bake", tb0, self._clock(), parent=parent,
                      scene_id=scene_id)
    return scene

  def _record_phases(self, recorder, parent, t0, timings) -> None:
    """Anchor the engine's phase durations inside the attempt's render
    window front-to-back so the sub-spans tile it. Under overlap,
    "compute" includes device queue wait behind earlier flights — the
    honest per-flight number."""
    if recorder is None or not timings:
      return
    h2d_end = t0 + timings["h2d_s"]
    compute_end = h2d_end + timings["compute_s"]
    recorder.record("h2d", t0, h2d_end, parent=parent)
    recorder.record("compute", h2d_end, compute_end, parent=parent)
    recorder.record("readback", compute_end,
                    compute_end + timings["readback_s"], parent=parent)

  def _attempt(self, engine, scene_provider, scene_id, poses, recorder,
               handles):
    """One attempt via the streaming engine API of ``engine`` (the card's,
    or the CPU fallback's): bake through ``scene_provider`` + async submit
    + wait (the only sync). Returns ``(images, render_s, phase_timings)``.

    Runs on the watchdog's attempt thread, which may be ABANDONED
    mid-wait and finish after a retry already won: all results travel in
    the return value, spans record under the parent captured at entry,
    and every submitted handle is appended to ``handles`` so the flight
    can sweep-release engine window slots when it ends — whichever
    attempts were abandoned along the way.
    """
    parent = recorder.current_parent() if recorder is not None else None
    scene = self._bake_with_span(scene_provider, scene_id, recorder, parent)
    # device_render_seconds must stay DEVICE-window time: the timer runs
    # around submit+wait only — never around retry backoffs, abandoned
    # watchdog waits, or scene bakes.
    t0 = self._clock()
    handle = engine.submit(scene, poses)
    handles.append(handle)
    out = engine.wait(handle)
    t1 = self._clock()
    self._record_phases(recorder, parent, t0, handle.timings)
    return out, t1 - t0, handle.timings

  def _run_flight(self, flight: _Flight) -> None:
    batch, recorder = flight.batch, flight.recorder
    # Providers get the batch KEY (scene id + tile signature for tiled
    # scenes); metrics/traces keep the plain scene id via each request.
    scene_id = batch[0].key
    poses = flight.poses
    handles: list = []
    d0 = self._clock()
    try:
      # Each attempt returns (images, render_s, phases) — results travel
      # by return value so an attempt thread the watchdog abandoned can
      # never overwrite the winning attempt's accounting.
      def primary_fn():
        return self._attempt(self.engine, self.scene_provider, scene_id,
                             poses, recorder, handles)

      if self.resilient is not None:
        fallback_fn = None
        if self.fallback_engine is not None:
          # Bake onto the FALLBACK's device at call time: baking every
          # scene to the CPU up front would double the host traffic for
          # an outage that may never happen.
          def fallback_fn():
            return self._attempt(self.fallback_engine,
                                 self.fallback_scene_provider, scene_id,
                                 poses, recorder, handles)
        out, render_s, phases = self.resilient.run(
            primary_fn, fallback_fn=fallback_fn, deadline=flight.deadline,
            recorder=recorder)
      else:
        out, render_s, phases = primary_fn()
    except Exception as e:  # noqa: BLE001 - forwarded to every caller
      self._retire(flight)
      kind = ("deadline" if getattr(e, "deadline_capped", False)
              else classify_error(e))
      self.metrics.record_error(kind, count=len(batch))
      if isinstance(e, DispatchTimeoutError):
        # The batch is ABANDONED with device work possibly still running
        # on a zombie attempt thread.
        self.metrics.record_abandoned_batch()
      d1 = self._clock()
      err = repr(e)
      for req in batch:
        dspan = req.trace.add_span("dispatch", d0, d1, error=err,
                                   size=len(batch))
        if recorder is not None:
          recorder.replay(req.trace, parent=dspan)
        req.future.set_exception(e)
        req.trace.finish(error=err)
      return
    finally:
      # Sweep EVERY handle the flight ever submitted: a watchdog-
      # abandoned attempt's zombie thread may hold its engine window
      # slot forever (hung device) even when a later retry won — without
      # the sweep, each hung-then-recovered flight would leak one slot
      # until the window wedged every future submit. abandon() is a no-op
      # on handles wait() already released. Residual: a zombie abandoned
      # while still INSIDE submit appends its handle after this sweep;
      # that slot frees itself if the device ever completes/errors the
      # work (wait's finally), and a device hung forever has the breaker
      # fast-failing requests anyway.
      for handle in handles:
        handle.abandon()
    self._retire(flight)
    d1 = self._clock()
    self.metrics.record_batch(len(batch), render_s, phases=phases)
    done = self._clock()
    # Attribution: each member of the flight carries an equal share of
    # the dispatch's phase split, so the ledger's cell sums re-add to
    # exactly what record_batch just put into phase_seconds (the
    # conservation invariant). Built once per flight, only with a ledger
    # attached — the default path stays allocation-free.
    share = None
    if getattr(self.metrics, "attrib", None) is not None:
      n = len(batch)
      share = {phase: float((phases or {}).get(phase + "_s", 0.0)) / n
               for phase in ("h2d", "compute", "readback")}
    for i, req in enumerate(batch):
      kwargs = {}
      if share is not None:
        cls, level = req.attrib if req.attrib is not None else (None, 0)
        kwargs["attrib"] = {
            "class": cls, "level": level, "device": share,
            "queue_wait_s": max(req.t_dispatch - req.t_enqueue, 0.0)}
      self.metrics.record_request(done - req.t_enqueue,
                                  scene_id=req.scene_id,
                                  trace_id=req.trace.trace_id or None,
                                  **kwargs)
      dspan = req.trace.add_span("dispatch", d0, d1, size=len(batch))
      if recorder is not None:
        recorder.replay(req.trace, parent=dspan)
      # Copy: out[i] is a view into the whole padded batch buffer; a
      # caller holding one image must not pin bucket x image bytes.
      req.future.set_result(out[i].copy())
      req.trace.finish()
