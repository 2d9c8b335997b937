"""Bounded structured lifecycle event log.

A copy of ``mpi_vision_tpu/obs/events.py`` with its imports rewritten.

Metrics say *how much*; traces say *where one request went*; neither
answers "what happened to this fleet at 14:32?". ``EventLog`` is the
third leg: a lock-guarded, bounded ring of structured lifecycle events —
breaker transitions, failovers, scene swaps, checkpoint save / restore /
quarantine, NaN rollbacks, preemptions, watchdog trips, SLO alert
fire/clear — each a plain JSON-ready dict with a monotone sequence
number and a wall-clock timestamp.

Finished events go two places: the bounded ring (served at
``/debug/events``; oldest events drop when the ring is full, counted in
``dropped``) and an optional ``sink`` callable receiving one JSON line
per event (``serve --event-log FILE`` appends them to a file). A dying
sink costs a counter, never the emitting thread — the event log rides
hot paths (breaker transitions fire inside the dispatch loop) and must
never be able to fail them.

Clocks are injectable (the serve/-wide rule): event timestamps use wall time by
default because events are cross-process artifacts (a router's failover
and a backend's breaker-open must be orderable side by side), unlike the
monotonic in-process spans.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import Counter, deque


def file_sink(path: str, max_bytes: int | None = None, keep: int = 3):
  """A sink appending one line per event to ``path`` (line-buffered).

  Opened once, append mode — a restarted process extends the log rather
  than truncating the fleet's history.

  Retention (``serve --event-log-max-bytes``):
  with ``max_bytes`` set, a write that pushes the file past it rotates
  ``path -> path.1 -> ... -> path.keep`` (oldest dropped), so a
  long-running fleet's JSONL log is bounded at roughly
  ``(keep + 1) * max_bytes``. A failed rotation costs a counter
  (``sink.rotate_errors``) and the sink keeps appending to the current
  file — retention must never be able to kill the event stream it
  retains.
  """
  if max_bytes is not None and max_bytes <= 0:
    raise ValueError(f"max_bytes must be positive, got {max_bytes}")
  if keep < 1:
    raise ValueError(f"keep must be >= 1, got {keep}")
  # The sink owns its own lock: EventLog.emit deliberately calls sinks
  # OUTSIDE its lock (a slow write must not serialize emitters against
  # the ring), so concurrent emitters land here in parallel — and a
  # rotation closing the file under another thread's write would lose
  # that thread's event. The pre-rotation sink was safe by accident
  # (one fh.write is atomic under CPython); rotation makes the
  # write-then-maybe-swap a real critical section.
  lock = threading.Lock()
  state = {"fh": open(path, "a", buffering=1)}
  state["size"] = state["fh"].tell()

  def _rotate_locked() -> None:
    try:
      state["fh"].close()
      # The oldest slot is about to be overwritten: that segment's
      # events leave local disk forever UNLESS a shipper (obs/ship.py)
      # already delivered-and-deleted it. Counting the drop here is
      # what closes the /debug/events retention blind spot — the
      # snapshot can now say how many segments rotated away unshipped.
      if os.path.exists(f"{path}.{keep}"):
        sink.segments_dropped += 1
      for i in range(keep - 1, 0, -1):
        rotated = f"{path}.{i}"
        if os.path.exists(rotated):
          os.replace(rotated, f"{path}.{i + 1}")
      os.replace(path, f"{path}.1")
      sink.rotations += 1
    except OSError:
      sink.rotate_errors += 1
    finally:
      # Reopen whatever is at ``path`` now: the fresh file after a clean
      # rotation, or the over-size original after a failed one — either
      # way the stream keeps flowing.
      state["fh"] = open(path, "a", buffering=1)
      state["size"] = state["fh"].tell()

  def sink(line: str) -> None:
    with lock:
      state["fh"].write(line + "\n")
      state["size"] += len(line) + 1
      if max_bytes is not None and state["size"] >= max_bytes:
        _rotate_locked()

  def close() -> None:
    with lock:
      state["fh"].close()

  sink.rotations = 0
  sink.rotate_errors = 0
  sink.segments_dropped = 0
  sink.close = close
  return sink


class EventLog:
  """Bounded ring + optional line sink for lifecycle events.

  Args:
    capacity: events retained for ``/debug/events`` (oldest dropped).
    clock: wall-clock source for the ``ts_unix_s`` field (injectable).
    sink: optional ``str -> None`` receiving one JSON line per event.
  """

  def __init__(self, capacity: int = 512, clock=time.time, sink=None):
    if capacity < 1:
      raise ValueError(f"capacity must be >= 1, got {capacity}")
    self._clock = clock
    self.sink = sink
    self._lock = threading.Lock()
    self._ring: deque = deque(maxlen=capacity)
    self._by_kind: Counter = Counter()
    self._seq = 0
    self.emitted = 0
    self.dropped = 0
    self.sink_errors = 0

  def emit(self, kind: str, **fields) -> dict:
    """Record one event; returns the stored record.

    ``fields`` must be JSON-serializable (they ride ``/debug/events``
    and the line sink verbatim). Never raises on a failing sink.
    """
    with self._lock:
      self._seq += 1
      record = {"seq": self._seq, "ts_unix_s": round(self._clock(), 6),
                "kind": str(kind), **fields}
      if len(self._ring) == self._ring.maxlen:
        self.dropped += 1
      self._ring.append(record)
      self._by_kind[str(kind)] += 1
      self.emitted += 1
      sink = self.sink
    if sink is not None:
      # Outside the lock: a slow file write must not serialize emitters,
      # and a dying sink must cost a counter, not the emitting thread.
      try:
        sink(json.dumps(record))
      except Exception:  # noqa: BLE001 - sink failure is not the emitter's
        with self._lock:
          self.sink_errors += 1
    return record

  def count(self, kind: str) -> int:
    """Lifetime count of events of ``kind`` (ring eviction included)."""
    with self._lock:
      return self._by_kind.get(str(kind), 0)

  def snapshot(self, recent: int = 128, kind: str | None = None) -> dict:
    """The ``/debug/events`` payload: counters + the most recent events
    (optionally filtered to one ``kind``).

    With a rotating file sink attached, a ``retention`` block accounts
    for the JSONL segments the ring endpoint can no longer see: how many
    rotations happened and how many segments rotated off local disk
    entirely (``segments_dropped`` stays 0 while a shipper keeps
    delivering-and-deleting them first).
    """
    with self._lock:
      events = list(self._ring)
      if kind is not None:
        events = [e for e in events if e["kind"] == kind]
      out = {
          "emitted": self.emitted,
          "dropped": self.dropped,
          "sink_errors": self.sink_errors,
          "capacity": self._ring.maxlen,
          "by_kind": dict(sorted(self._by_kind.items())),
          "events": events[-recent:] if recent > 0 else [],
      }
      sink = self.sink
    if sink is not None and hasattr(sink, "rotations"):
      out["retention"] = {
          "rotations": sink.rotations,
          "rotate_errors": sink.rotate_errors,
          "segments_dropped": getattr(sink, "segments_dropped", 0),
      }
    return out


class _NullEventLog:
  """The disabled-events singleton: ``emit`` is a no-op (no allocation,
  no lock) so library code can emit unconditionally."""

  __slots__ = ()
  emitted = 0
  dropped = 0
  sink_errors = 0

  def emit(self, kind, **fields):  # noqa: ARG002 - mirror EventLog
    return None

  def count(self, kind):  # noqa: ARG002
    return 0

  def snapshot(self, recent: int = 128, kind=None):  # noqa: ARG002
    return {"emitted": 0, "dropped": 0, "sink_errors": 0, "capacity": 0,
            "by_kind": {}, "events": []}


NULL_EVENTS = _NullEventLog()
