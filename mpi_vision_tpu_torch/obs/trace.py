"""Request tracing: trace ids, span trees, ring buffer, JSON log lines.

One ``Trace`` per request; spans are flat records with parent handles, so
the tree covers phases that do not nest lexically (queue-wait starts on
the submitter thread and ends on the dispatcher thread). Times come from
the tracer's injectable clock — the same clock the scheduler uses, so
span edges and request deadlines share one timebase.

Finished traces go three places: an optional ``emit`` callable receives
one structured JSON line per trace (ship to a log pipeline), a bounded
ring buffer holds the most recent N for ``/debug/traces``, and a
slowest-N exemplar set retains the worst offenders past ring eviction —
the trace you want during an incident is precisely the one a FIFO ring
would have dropped first.

Disabled tracing is the ``NULL_TRACE``/``NULL_TRACER`` singletons: every
method is an empty body on a shared object — no allocation, no lock, no
clock read — so the hot path's cost with tracing off is a handful of
no-op method calls.

``SpanRecorder`` solves the batching fan-out: a micro-batch shares one
dispatch (one set of attempt/bake/h2d/compute/readback timings) across
many requests' traces, so the dispatcher records shared spans once and
``replay``\\ s them onto every batch member's trace.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from collections import deque


def new_trace_id() -> str:
  """A fresh 16-hex-char trace id — the one id format repo-wide (the
  HTTP layer mints these for untraceable requests too, so the header
  format never diverges from recorded traces)."""
  return uuid.uuid4().hex[:16]


class _NullTrace:
  """The disabled-tracing singleton: every operation is a no-op.

  ``trace_id`` is the empty string — callers that must hand out an id
  anyway (the HTTP layer's ``X-Trace-Id``) generate their own on top.
  """

  trace_id = ""
  __slots__ = ()

  def start_span(self, name, parent=0, **attrs) -> int:  # noqa: ARG002
    return 0

  def end_span(self, handle, error=None, **attrs) -> None:  # noqa: ARG002
    pass

  def add_span(self, name, t0, t1, parent=0, error=None,  # noqa: ARG002
               **attrs) -> int:
    return 0

  def finish(self, error=None) -> None:  # noqa: ARG002
    pass


NULL_TRACE = _NullTrace()


class Trace:
  """One request's span tree. Span handles are 1-based ints (0 = root).

  Methods are lock-guarded: a trace is touched by the submitter thread
  (root + queue-wait), the dispatcher thread (everything else), and on
  error paths both may race to ``finish`` — which is idempotent, first
  caller wins.
  """

  __slots__ = ("trace_id", "name", "attrs", "t_start", "t_end", "error",
               "_spans", "_tracer", "_lock", "_finished")

  def __init__(self, tracer: "Tracer", name: str, attrs: dict,
               trace_id: str | None = None):
    self.trace_id = trace_id or new_trace_id()
    self.name = name
    self.attrs = attrs
    self._tracer = tracer
    self._lock = threading.Lock()
    self._spans: list[dict] = []
    self.t_start = tracer._clock()
    self.t_end: float | None = None
    self.error: str | None = None
    self._finished = False

  def start_span(self, name: str, parent: int = 0, **attrs) -> int:
    """Open a span; returns its handle (close with ``end_span``)."""
    with self._lock:
      self._spans.append({"name": name, "parent": parent,
                          "t0": self._tracer._clock(), "t1": None,
                          "error": None, "attrs": attrs})
      return len(self._spans)

  def end_span(self, handle: int, error: str | None = None,
               **attrs) -> None:
    if handle <= 0:
      return
    with self._lock:
      span = self._spans[handle - 1]
      if span["t1"] is None:
        span["t1"] = self._tracer._clock()
      if error is not None:
        span["error"] = error
      if attrs:
        span["attrs"].update(attrs)

  def add_span(self, name: str, t0: float, t1: float, parent: int = 0,
               error: str | None = None, **attrs) -> int:
    """Record an already-timed span (shared batch timings, sub-phases)."""
    with self._lock:
      self._spans.append({"name": name, "parent": parent, "t0": t0,
                          "t1": t1, "error": error, "attrs": attrs})
      return len(self._spans)

  def finish(self, error: str | None = None) -> None:
    """Close the trace: record duration, emit, ring. Idempotent —
    the dispatcher and a timed-out caller may both reach here."""
    with self._lock:
      if self._finished:
        return
      self._finished = True
      self.t_end = self._tracer._clock()
      self.error = error
    self._tracer._record_finished(self)

  @property
  def duration_s(self) -> float:
    end = self.t_end if self.t_end is not None else self._tracer._clock()
    return end - self.t_start

  def to_dict(self) -> dict:
    """JSON-ready form; span times are ms relative to the trace start
    (absolute monotonic timestamps mean nothing outside the process)."""
    with self._lock:
      t0 = self.t_start
      end = self.t_end if self.t_end is not None else t0
      out = {
          "trace_id": self.trace_id,
          "name": self.name,
          "duration_ms": round((end - t0) * 1e3, 3),
          "error": self.error,
          "spans": [],
      }
      if self.attrs:
        out["attrs"] = dict(self.attrs)
      for i, s in enumerate(self._spans):
        s1 = s["t1"] if s["t1"] is not None else end
        span = {
            "id": i + 1,
            "parent": s["parent"],
            "name": s["name"],
            "t0_ms": round((s["t0"] - t0) * 1e3, 3),
            "duration_ms": round((s1 - s["t0"]) * 1e3, 3),
        }
        if s["error"] is not None:
          span["error"] = s["error"]
        if s["attrs"]:
          span["attrs"] = {k: v for k, v in s["attrs"].items()}
        out["spans"].append(span)
      return out


class Tracer:
  """Trace factory + finished-trace sinks (emit / ring / slowest-N).

  Args:
    enabled: False routes ``start_trace`` to the shared ``NULL_TRACE``
      singleton — the zero-overhead off switch.
    clock: injectable monotonic clock; share it with the scheduler so
      spans and deadlines agree.
    emit: optional callable receiving one JSON line per finished trace.
    ring: finished traces retained for ``/debug/traces`` (FIFO).
    slow_keep: slowest-N exemplars retained past ring eviction.
  """

  def __init__(self, enabled: bool = True, clock=time.monotonic,
               emit=None, ring: int = 256, slow_keep: int = 16):
    if ring < 1:
      raise ValueError(f"ring must be >= 1, got {ring}")
    if slow_keep < 0:
      raise ValueError(f"slow_keep must be >= 0, got {slow_keep}")
    self.enabled = bool(enabled)
    self.emit = emit
    self._clock = clock
    self._lock = threading.Lock()
    self._ring: deque = deque(maxlen=ring)
    self._slow_keep = slow_keep
    self._slowest: list[tuple[float, int, dict]] = []  # sorted ascending
    self._seq = 0
    self.started = 0
    self.finished = 0
    self.emit_errors = 0

  def start_trace(self, name: str, trace_id: str | None = None, **attrs):
    """A new ``Trace`` — or ``NULL_TRACE`` when tracing is disabled.

    ``trace_id`` overrides the generated id (the HTTP layer passes an
    inbound W3C ``traceparent`` trace-id through so a fronting proxy
    can stitch its trace to the recorded one)."""
    if not self.enabled:
      return NULL_TRACE
    with self._lock:
      self.started += 1
    return Trace(self, name, attrs, trace_id=trace_id)

  def _record_finished(self, trace: Trace) -> None:
    record = trace.to_dict()
    line = None
    if self.emit is not None:
      line = json.dumps({"event": "trace", **record})
    with self._lock:
      self.finished += 1
      self._seq += 1
      self._ring.append(record)
      if self._slow_keep > 0:
        dur = record["duration_ms"]
        if (len(self._slowest) < self._slow_keep
            or dur > self._slowest[0][0]):
          self._slowest.append((dur, self._seq, record))
          self._slowest.sort(key=lambda x: (x[0], x[1]))
          self._slowest = self._slowest[-self._slow_keep:]
    if line is not None:
      # finish() runs on the scheduler's only dispatcher thread: a dying
      # emit sink (closed stderr pipe, full log socket) must cost dropped
      # trace lines, never the dispatcher. Ring/exemplars stay intact.
      try:
        self.emit(line)
      except Exception:  # noqa: BLE001 - sink failure is not our caller's
        with self._lock:
          self.emit_errors += 1

  def snapshot(self, recent: int = 32) -> dict:
    """The ``/debug/traces`` payload: counters + recent + slowest."""
    with self._lock:
      return {
          "enabled": self.enabled,
          "started": self.started,
          "finished": self.finished,
          "emit_errors": self.emit_errors,
          "ring_size": self._ring.maxlen,
          "recent": list(self._ring)[-recent:] if recent > 0 else [],
          "slowest": [r for _, _, r in reversed(self._slowest)],
      }

  def find(self, trace_id: str) -> list[dict]:
    """Every retained finished-trace record carrying ``trace_id``.

    Searches the ring AND the slowest-N exemplars (an incident trace
    evicted from the ring is exactly the one being searched for) and
    de-duplicates records living in both. The ``/debug/traces?id=``
    endpoint serves this.
    """
    with self._lock:
      out, seen = [], set()
      for rec in list(self._ring) + [r for _, _, r in self._slowest]:
        if rec.get("trace_id") == trace_id and id(rec) not in seen:
          seen.add(id(rec))
          out.append(rec)
      return out

  def reset(self) -> None:
    """Drop recorded traces and counters (load generators call this after
    warm-up, mirroring ``ServeMetrics.reset``)."""
    with self._lock:
      self.started = 0
      self.finished = 0
      self.emit_errors = 0
      self._ring.clear()
      self._slowest = []


NULL_TRACER = Tracer(enabled=False)


class SpanRecorder:
  """Collect shared span records once, replay onto many traces.

  The dispatcher runs ONE device dispatch for a whole micro-batch; its
  attempt/bake/h2d/compute/readback timings belong in every batch
  member's trace. Records are plain dicts with intra-recorder parent
  indices; ``replay`` re-parents them under a per-trace anchor span.

  ``begin``/``end`` maintain a parent stack so records created inside a
  group (e.g. a bake inside a retry attempt) nest under it. The stack is
  only meaningful on the group-owning (dispatcher) thread; a watchdog
  attempt thread that may outlive its group must capture
  ``current_parent()`` at entry and record with an explicit ``parent`` —
  then an abandoned attempt's late records still land under the *dead*
  attempt, not whichever group is live when they arrive. All mutation is
  lock-guarded because exactly that zombie thread can append
  concurrently with the dispatcher's next begin/record. Records appended
  after ``replay`` are dropped.
  """

  _AUTO = object()  # record(): "parent = whatever group is open now"

  def __init__(self, clock=time.monotonic):
    self._clock = clock
    self._lock = threading.Lock()
    self.records: list[dict] = []
    self._stack: list[int] = []

  def current_parent(self) -> int | None:
    """The open group's record index (capture at attempt entry)."""
    with self._lock:
      return self._stack[-1] if self._stack else None

  def record(self, name: str, t0: float, t1: float,
             error: str | None = None, parent=_AUTO, **attrs) -> int:
    with self._lock:
      if parent is SpanRecorder._AUTO:
        parent = self._stack[-1] if self._stack else None
      self.records.append({"name": name, "parent": parent, "t0": t0,
                           "t1": t1, "error": error, "attrs": attrs})
      return len(self.records) - 1

  def begin(self, name: str, **attrs) -> int:
    """Open a group: records made before ``end`` nest under it."""
    t0 = self._clock()
    with self._lock:
      parent = self._stack[-1] if self._stack else None
      self.records.append({"name": name, "parent": parent, "t0": t0,
                           "t1": None, "error": None, "attrs": attrs})
      idx = len(self.records) - 1
      self._stack.append(idx)
      return idx

  def end(self, idx: int, error: str | None = None, **attrs) -> None:
    t1 = self._clock()
    with self._lock:
      rec = self.records[idx]
      if rec["t1"] is None:
        rec["t1"] = t1
      if error is not None:
        rec["error"] = error
      if attrs:
        rec["attrs"].update(attrs)
      if self._stack and self._stack[-1] == idx:
        self._stack.pop()

  def replay(self, trace, parent: int = 0) -> None:
    """Copy every record into ``trace``, rooted under ``parent``."""
    handles: dict[int, int] = {}
    end = self._clock()
    with self._lock:
      snapshot = list(self.records)
    for i, rec in enumerate(snapshot):
      p = handles.get(rec["parent"], parent)
      t1 = rec["t1"] if rec["t1"] is not None else end
      handles[i] = trace.add_span(
          rec["name"], rec["t0"], t1, parent=p, error=rec["error"],
          **rec["attrs"])
