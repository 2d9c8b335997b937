"""On-demand device profiling around live serving traffic.

PyTorch counterpart of ``mpi_vision_tpu/obs/profile.py``.
``DeviceProfiler`` wraps the ``torch.profiler`` trace context (reused from
``debug.trace`` so there is exactly one profiler entry point in the
package) to capture N seconds of whatever the serving stack is doing —
CUDA kernels, copies, the host ops and the ``render/*`` ranges of every
thread — into a Chrome trace under ``logdir/profile_<n>/``. The capture
window just sleeps: the traffic being profiled is the live request load,
not a synthetic workload.

Exactly one capture at a time: the profiler is global per process, so a
second concurrent capture would either fail or corrupt the first. The
guard is a non-blocking lock — a concurrent ``/debug/profile`` gets
``ProfileBusyError`` (HTTP 409) instead of queueing behind a capture it
didn't ask for.
"""

from __future__ import annotations

import os
import threading
import time

# The longest capture the HTTP endpoint will accept: profiles grow with
# wall time and a forgotten ?seconds=86400 must not fill the disk.
MAX_CAPTURE_SECONDS = 300.0


class ProfileBusyError(RuntimeError):
  """A capture is already in flight (the HTTP layer maps this to 409)."""


class DeviceProfiler:
  """Concurrency-guarded ``torch.profiler`` captures into ``logdir``.

  Args:
    logdir: root directory; each capture writes ``profile_<n>/`` under it.
    trace_ctx: the trace context factory (``logdir -> context manager``);
      defaults to ``debug.trace``. Injectable so tests exercise the guard
      without a real profiler session.
    clock / sleep: injectable time sources.
  """

  def __init__(self, logdir: str, trace_ctx=None, clock=time.monotonic,
               sleep=time.sleep):
    if not logdir:
      raise ValueError("profiler needs a non-empty logdir")
    self.logdir = str(logdir)
    if trace_ctx is None:
      from mpi_vision_tpu_torch import debug

      trace_ctx = debug.trace
    self._trace_ctx = trace_ctx
    self._clock = clock
    self._sleep = sleep
    self._lock = threading.Lock()
    self.captures = 0

  @property
  def busy(self) -> bool:
    if self._lock.acquire(blocking=False):
      self._lock.release()
      return False
    return True

  def capture(self, seconds: float) -> dict:
    """Profile live traffic for ``seconds``; returns the capture summary.

    Raises ``ValueError`` on an out-of-range window and
    ``ProfileBusyError`` when a capture is already running.
    """
    seconds = float(seconds)
    if not 0 < seconds <= MAX_CAPTURE_SECONDS:
      raise ValueError(
          f"seconds must be in (0, {MAX_CAPTURE_SECONDS:g}], got {seconds}")
    if not self._lock.acquire(blocking=False):
      raise ProfileBusyError(
          "a profile capture is already in flight; retry when it finishes")
    try:
      self.captures += 1
      run_dir = os.path.join(self.logdir, f"profile_{self.captures:04d}")
      os.makedirs(run_dir, exist_ok=True)
      t0 = self._clock()
      with self._trace_ctx(run_dir):
        self._sleep(seconds)
      return {
          "logdir": run_dir,
          "seconds": seconds,
          "wall_s": round(self._clock() - t0, 3),
          "capture": self.captures,
      }
    finally:
      self._lock.release()
