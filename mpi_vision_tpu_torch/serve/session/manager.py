"""Per-session state: bounded session registry, fused drains, prefetch.

PyTorch-package copy of ``mpi_vision_tpu/serve/session/manager.py``
(host-only; the two differ in this docstring and their imports).

A ``Session`` owns one client's pose queue and drives the fused render
loop: each drain takes every queued pose (up to ``fuse_max``) and submits
them *concurrently* through the service front door
(``RenderService.render_request``), so the micro-batcher coalesces the
same-scene flight into one device dispatch while brownout admission,
SLO, retry/breaker, and attribution still see every frame individually.

After each drain the session feeds its poses to the trajectory predictor
and, for predicted view cells not yet resident in the edge cache, issues
speculative ``prefetch``-class renders on the manager's shared pool.
Prefetch is fully suppressed at brownout L3+ — the ladder sheds the
class there anyway, so the predictor must not even generate the queue
pressure.

The ``SessionManager`` bounds the live session count (opens beyond the
bound are shed with a retry hint -> HTTP 503 + Retry-After) and reaps
idle sessions on an injectable clock.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError

import numpy as np

from mpi_vision_tpu_torch.obs.events import NULL_EVENTS
from mpi_vision_tpu_torch.serve.resilience import CircuitOpenError, TransientDeviceError
from mpi_vision_tpu_torch.serve.scheduler import QueueFullError
from mpi_vision_tpu_torch.serve.session import protocol
from mpi_vision_tpu_torch.serve.session.predictor import TrajectoryPredictor

# Errors that fail one frame without poisoning the session: the client
# gets an error frame for that seq and the stream continues.
TRANSIENT_ERRORS = (
    QueueFullError,  # includes BrownoutShedError
    CircuitOpenError,
    TransientDeviceError,
    FuturesTimeoutError,
)

_PREFETCH_CELL_MEMO = 256  # per-session bound on remembered prefetched cells


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Knobs for the session tier (CLI: serve --session-*)."""

    max_sessions: int = 8
    idle_timeout_s: float = 30.0
    fuse_max: int = 4  # poses drained (and submitted concurrently) per flush
    prefetch_horizon: int = 3  # predicted steps probed per flush; 0 disables
    prefetch_workers: int = 2
    max_pending: int = 64  # queued poses before the reader blocks (backpressure)
    frame_timeout_s: float = 60.0
    retry_after_s: float = 1.0  # hint on bound-shed opens
    predictor_alpha: float = 0.5

    def __post_init__(self):
        if self.max_sessions < 1:
            raise ValueError(f"max_sessions must be >= 1, got {self.max_sessions}")
        if self.idle_timeout_s <= 0:
            raise ValueError(f"idle_timeout_s must be > 0, got {self.idle_timeout_s}")
        if self.fuse_max < 1:
            raise ValueError(f"fuse_max must be >= 1, got {self.fuse_max}")
        if self.prefetch_horizon < 0:
            raise ValueError(f"prefetch_horizon must be >= 0, got {self.prefetch_horizon}")
        if self.prefetch_workers < 1:
            raise ValueError(f"prefetch_workers must be >= 1, got {self.prefetch_workers}")
        if self.max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {self.max_pending}")
        if self.frame_timeout_s <= 0:
            raise ValueError(f"frame_timeout_s must be > 0, got {self.frame_timeout_s}")
        if not 0.0 < self.predictor_alpha <= 1.0:
            raise ValueError(f"predictor_alpha must be in (0, 1], got {self.predictor_alpha}")


class SessionLimitError(RuntimeError):
    """Open refused: the manager is at its session bound."""

    def __init__(self, active: int, max_sessions: int, retry_after_s: float):
        super().__init__(
            f"session bound reached ({active}/{max_sessions} open); retry in {retry_after_s:g}s"
        )
        self.active = int(active)
        self.max_sessions = int(max_sessions)
        self.retry_after_s = float(retry_after_s)


class Session:
    """One client's pose queue + fused render loop. Created by the manager."""

    def __init__(self, session_id: str, scene_id: str, request_class: str, manager: "SessionManager"):
        self.session_id = session_id
        self.scene_id = scene_id
        self.request_class = request_class
        self.manager = manager
        self.config = manager.config
        self._clock = manager._clock
        self._cond = threading.Condition()
        self._pending: deque[np.ndarray] = deque()
        self._input_done = False
        self._closed = False
        self.close_reason = "client"
        self.input_error: str | None = None
        self.last_activity = self._clock()
        self.frames = 0
        self.frame_errors = 0
        self._seq = 0
        self._pool: ThreadPoolExecutor | None = None
        self._predictor = TrajectoryPredictor(alpha=self.config.predictor_alpha)
        self._prefetched: OrderedDict[tuple, bool] = OrderedDict()

    # ---- input side (reader thread / in-process feeder) ----

    def feed_pose(self, pose) -> bool:
        """Queue a pose; blocks when the queue is full (socket backpressure).
        Returns False once the session is closed."""
        pose = np.asarray(pose, dtype=np.float32)
        with self._cond:
            while not self._closed and len(self._pending) >= self.config.max_pending:
                self._cond.wait(0.05)
            if self._closed:
                return False
            self._pending.append(pose)
            self.last_activity = self._clock()
            self._cond.notify_all()
            return True

    def end_input(self, error: str | None = None) -> None:
        with self._cond:
            if error is not None and self.input_error is None:
                self.input_error = error
            self._input_done = True
            self._cond.notify_all()

    def close(self, reason: str = "client") -> None:
        with self._cond:
            if not self._closed:
                self._closed = True
                self.close_reason = reason
            self._cond.notify_all()
        self.manager._finish(self)

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def idle_for(self, now: float) -> float:
        with self._cond:
            return now - self.last_activity

    # ---- render side ----

    def _drain(self):
        """Block for the next batch of queued poses; None when the stream
        is over (input ended and queue empty, or session closed)."""
        with self._cond:
            while True:
                if self._pending:
                    batch = []
                    while self._pending and len(batch) < self.config.fuse_max:
                        batch.append(self._pending.popleft())
                    self._cond.notify_all()  # wake a blocked feeder
                    return batch
                if self._closed or self._input_done:
                    return None
                idle = self._clock() - self.last_activity
                remaining = self.config.idle_timeout_s - idle
                if remaining <= 0:
                    self._closed = True
                    self.close_reason = "idle"
                    return None
                self._cond.wait(min(remaining, 0.25))

    def _render_one(self, pose):
        try:
            img, info = self.manager.service.render_request(
                self.scene_id,
                pose,
                request_class=self.request_class,
                timeout=self.config.frame_timeout_s,
            )
            return True, (img, info)
        except Exception as exc:  # surfaced per-frame by the run loop
            return False, exc

    def run(self, on_frame, on_error) -> None:
        """Drive the fused render loop until input ends or the session
        closes. ``on_frame(seq, img, info)`` delivers a frame;
        ``on_error(seq, exc) -> bool`` reports one and says whether the
        session survives it. Exceptions from either callback abort the
        loop (socket gone)."""
        metrics = self.manager.metrics
        try:
            while True:
                poses = self._drain()
                if poses is None:
                    break
                metrics.record_session_flush(len(poses))
                if len(poses) == 1:
                    results = [self._render_one(poses[0])]
                else:
                    # Concurrent submits of same-scene poses land inside the
                    # scheduler's straggler window and fuse into one flight.
                    pool = self._ensure_pool()
                    futures = [pool.submit(self._render_one, p) for p in poses]
                    results = [f.result() for f in futures]
                stop = False
                for pose, (ok, payload) in zip(poses, results):
                    seq = self._seq
                    self._seq += 1
                    if ok:
                        img, info = payload
                        self._note_served(pose, info)
                        self.frames += 1
                        metrics.record_session_frame()
                        on_frame(seq, img, info)
                    else:
                        self.frame_errors += 1
                        metrics.record_session_frame_error()
                        if not on_error(seq, payload):
                            stop = True
                with self._cond:
                    self.last_activity = self._clock()
                if stop:
                    with self._cond:
                        self._closed = True
                        self.close_reason = "error"
                    break
                try:
                    self._maybe_prefetch(poses)
                except Exception:  # noqa: BLE001 - speculation never kills the stream
                    pass
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            self.close(self.close_reason)

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.config.fuse_max,
                thread_name_prefix=f"mpi-sess-{self.session_id}",
            )
        return self._pool

    # ---- prefetch side ----

    def _note_served(self, pose, info) -> None:
        if info.get("edge") != "hit":
            return
        edge = self.manager.service.edge
        if edge is None:
            return
        cell = edge.cell_of(np.asarray(pose, dtype=np.float32))
        if cell in self._prefetched:
            # Count each warmed cell at most once, else a slow pan through
            # one cell would inflate the hit counter.
            self._prefetched.pop(cell, None)
            self.manager.metrics.record_session_prefetch_hit()

    def _maybe_prefetch(self, poses) -> None:
        for pose in poses:
            self._predictor.observe(pose)
        horizon = self.config.prefetch_horizon
        service = self.manager.service
        if horizon <= 0 or service.edge is None:
            return
        brownout = service.brownout
        if brownout is not None and brownout.level >= 3:
            # L3+ sheds the prefetch class at admission anyway; stop the
            # predictor at the source so the queue pressure never exists.
            self.manager.metrics.record_session_prefetch_suppressed()
            return
        # Lead the camera by the work already in flight: poses queued
        # behind this flush plus one more flush already have (or are
        # about to get) an interactive render queued AHEAD of any
        # speculative one, so predictions inside that envelope lose the
        # race by construction. The horizon is therefore measured in
        # flushes — one candidate per future flush, each a flush-width
        # of steps further out.
        with self._cond:
            backlog = len(self._pending)
        stride = max(len(poses), 1)
        lead = backlog + stride
        predicted = self._predictor.predict(lead + horizon * stride)
        if not predicted:
            return  # predictor not warmed up yet (fewer than 2 poses seen)
        for k in range(1, horizon + 1):
            if self.manager.spec_backlog() >= 2 * self.config.prefetch_workers:
                # Speculation rides idle capacity only: once the prefetch
                # pool is saturated, more candidates would just queue
                # stale guesses behind fresh ones (and steal device time
                # from the frames clients are waiting for).
                self.manager.metrics.record_session_prefetch_suppressed()
                break
            target = predicted[lead + k * stride - 1]
            cell, resident = service.edge_cell_resident(self.scene_id, target)
            if cell is None or resident or cell in self._prefetched:
                continue
            self._prefetched[cell] = True
            while len(self._prefetched) > _PREFETCH_CELL_MEMO:
                self._prefetched.popitem(last=False)
            self.manager.metrics.record_session_prefetch_issued()
            self.manager._submit_prefetch(self.scene_id, target)

    # ---- socket plumbing (used by the HTTP handler) ----

    def serve_stream(self, rfile, wfile) -> None:
        """Pump the session over an open socket pair: reader thread feeds
        poses from ``rfile``; this thread renders and writes frames to
        ``wfile``. Raises socket errors to the caller (disconnects)."""
        reader = threading.Thread(
            target=self._read_loop, args=(rfile,), name=f"mpi-sess-rd-{self.session_id}", daemon=True
        )
        reader.start()

        def on_frame(seq, img, info):
            wfile.write(protocol.pack_image(seq, img))
            wfile.flush()

        def on_error(seq, exc):
            transient = isinstance(exc, TRANSIENT_ERRORS)
            wfile.write(protocol.pack_error(seq, f"{type(exc).__name__}: {exc}", transient))
            wfile.flush()
            return transient

        self.run(on_frame, on_error)
        if self.input_error is not None:
            wfile.write(protocol.pack_error(self._seq, f"bad pose stream: {self.input_error}", False))
        wfile.write(protocol.pack_frame(protocol.KIND_END))
        wfile.flush()

    def _read_loop(self, rfile) -> None:
        try:
            while True:
                frame = protocol.read_frame(rfile, max_payload=protocol.POSE_BYTES)
                if frame is None:
                    break
                kind, payload = frame
                if kind == protocol.KIND_END:
                    break
                if kind != protocol.KIND_POSE:
                    raise protocol.ProtocolError(f"unexpected client frame kind {kind!r}")
                if not self.feed_pose(protocol.unpack_pose(payload)):
                    break
            self.end_input()
        except protocol.ProtocolError as exc:
            self.end_input(error=str(exc))
        except (OSError, ValueError):
            # Socket torn down under the reader; the writer side surfaces
            # the disconnect.
            self.end_input()


class SessionManager:
    """Bounded registry of live sessions with idle reaping.

    ``clock`` is injectable (tests drive reaping with a fake clock); the
    default is the process monotonic clock, matching the service.
    """

    def __init__(self, config: SessionConfig, service, clock=time.monotonic):
        self.config = config
        self.service = service
        self._clock = clock
        self._lock = threading.Lock()
        self._sessions: dict[str, Session] = {}
        self._finished: set[str] = set()
        self._next_id = 0
        self._closed = False
        self._prefetch_pool: ThreadPoolExecutor | None = None
        self._spec_inflight = 0

    @property
    def metrics(self):
        return self.service.metrics

    @property
    def events(self):
        return getattr(self.service, "events", None) or NULL_EVENTS

    def open(self, scene_id: str, request_class: str | None = None) -> Session:
        """Register a session or raise SessionLimitError at the bound."""
        self.reap_idle()
        with self._lock:
            if self._closed:
                raise SessionLimitError(0, self.config.max_sessions, self.config.retry_after_s)
            if len(self._sessions) >= self.config.max_sessions:
                self.metrics.record_session_reject()
                active = len(self._sessions)
                self.events.emit(
                    "session_reject", active=active, max_sessions=self.config.max_sessions
                )
                raise SessionLimitError(
                    active, self.config.max_sessions, self.config.retry_after_s
                )
            self._next_id += 1
            session_id = f"s-{self._next_id:06d}"
            cls = request_class if request_class else "interactive"
            session = Session(session_id, str(scene_id), cls, self)
            self._sessions[session_id] = session
        self.metrics.record_session_open()
        self.events.emit("session_open", session_id=session_id, scene_id=str(scene_id))
        return session

    def _finish(self, session: Session) -> None:
        with self._lock:
            if session.session_id in self._finished:
                return
            self._finished.add(session.session_id)
            self._sessions.pop(session.session_id, None)
        idle = session.close_reason == "idle"
        self.metrics.record_session_close(idle=idle)
        self.events.emit(
            "session_close",
            session_id=session.session_id,
            reason=session.close_reason,
            frames=session.frames,
        )

    def reap_idle(self) -> list[str]:
        """Close sessions idle beyond the timeout; returns their ids."""
        now = self._clock()
        with self._lock:
            stale = [
                s
                for s in self._sessions.values()
                if s.idle_for(now) > self.config.idle_timeout_s
            ]
        reaped = []
        for session in stale:
            with session._cond:
                if session._closed:
                    continue
                session._closed = True
                session.close_reason = "idle"
                session._cond.notify_all()
            self._finish(session)
            reaped.append(session.session_id)
        return reaped

    def spec_backlog(self) -> int:
        """Speculative renders submitted and not yet finished."""
        with self._lock:
            return self._spec_inflight

    def _submit_prefetch(self, scene_id: str, pose) -> None:
        with self._lock:
            if self._closed:
                return
            if self._prefetch_pool is None:
                self._prefetch_pool = ThreadPoolExecutor(
                    max_workers=self.config.prefetch_workers,
                    thread_name_prefix="mpi-sess-prefetch",
                )
            pool = self._prefetch_pool
            self._spec_inflight += 1
        pool.submit(self._speculative_render, scene_id, pose)

    def _speculative_render(self, scene_id: str, pose) -> None:
        try:
            self.service.render_request(
                scene_id,
                pose,
                request_class="prefetch",
                timeout=self.config.frame_timeout_s,
            )
        except Exception:
            # Speculative work: sheds, queue-fulls, and races are all fine.
            pass
        finally:
            with self._lock:
                self._spec_inflight -= 1

    @property
    def active(self) -> int:
        with self._lock:
            return len(self._sessions)

    def snapshot(self) -> dict:
        """Live-state overlay for /stats (counters live in ServeMetrics)."""
        with self._lock:
            active = len(self._sessions)
        return {
            "enabled": True,
            "active": active,
            "max_sessions": self.config.max_sessions,
            "idle_timeout_s": self.config.idle_timeout_s,
            "fuse_max": self.config.fuse_max,
            "prefetch_horizon": self.config.prefetch_horizon,
        }

    def close_all(self) -> None:
        with self._lock:
            self._closed = True
            sessions = list(self._sessions.values())
        for session in sessions:
            session.close("shutdown")
        with self._lock:
            pool = self._prefetch_pool
            self._prefetch_pool = None
        if pool is not None:
            pool.shutdown(wait=False)
