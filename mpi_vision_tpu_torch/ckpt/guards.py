"""Step-loop guard rails: NaN policy, stall watchdog, preemption flag.

Small, deterministic state machines with injectable clocks, so every
behavior is testable on the CPU with fake time.

  * ``NanGuard`` — policy for non-finite losses: how many
    rollback-to-last-good attempts are allowed and how hard to cut the
    learning rate each time. The *mechanism* (restore + LR surgery)
    lives in ``train.loop.fit_resumable``; the guard only counts and
    decides.
  * ``StallWatchdog`` — detects a training step that stopped returning
    (device hang, tunnel drop). The loop ``beat()``s after every step; a
    monitor (thread or caller-driven ``check()``) fires ``on_stall``
    once per stall episode. It cannot abort a hung kernel — what
    it CAN do is surface the hang and let a supervisor act on it, which
    is exactly what the open-loop ``fit`` could not.
  * ``PreemptionGuard`` — SIGTERM (by default; pass ``signals=`` to add
    more) -> a checked flag. The signal handler only sets an event
    (handlers must not touch the device or filesystem); the loop
    performs the preemption save at the next step boundary.
"""

from __future__ import annotations

import contextlib
import signal
import threading
import time
from typing import Callable


class NonFiniteLossError(RuntimeError):
  """Training hit a non-finite loss and the NaN policy was exhausted
  (or absent)."""

  def __init__(self, step: int, loss: float, detail: str = ""):
    msg = f"non-finite loss {loss!r} at step {step}"
    if detail:
      msg += f" ({detail})"
    super().__init__(msg)
    self.step = step
    self.loss = loss


class NanGuard:
  """Rollback budget + LR-cut policy for non-finite losses.

  Args:
    lr_cut: multiplier applied to the learning rate on every rollback
      (0.5 halves it); the learning rate lives in the optimizer's
      ``param_groups`` and rides in every checkpoint.
    max_rollbacks: rollbacks allowed before giving up; the next
      non-finite loss then raises ``NonFiniteLossError``.
  """

  def __init__(self, lr_cut: float = 0.5, max_rollbacks: int = 3):
    if not 0.0 < lr_cut <= 1.0:
      raise ValueError(f"lr_cut must be in (0, 1], got {lr_cut}")
    if max_rollbacks < 0:
      raise ValueError(f"max_rollbacks must be >= 0, got {max_rollbacks}")
    self.lr_cut = float(lr_cut)
    self.max_rollbacks = int(max_rollbacks)
    self.rollbacks = 0

  def note_rollback(self, step: int, loss: float) -> None:
    """Account one rollback; raises once the budget is exhausted."""
    if self.rollbacks >= self.max_rollbacks:
      raise NonFiniteLossError(
          step, loss,
          f"NaN guard exhausted after {self.rollbacks} rollbacks")
    self.rollbacks += 1


class StallWatchdog:
  """Detects a step loop that stopped making progress.

  The loop calls ``beat()`` after every completed step. ``check()``
  (called by the monitor thread, or directly by tests with a fake
  clock) fires ``on_stall(idle_s)`` exactly once per stall episode —
  re-armed by the next beat — so a supervisor gets one page per hang,
  not one per poll.

  Args:
    timeout_s: idle seconds after which the loop counts as stalled.
    clock: injectable monotonic clock.
    on_stall: callback ``(idle_s) -> None``; None just counts.
  """

  def __init__(self, timeout_s: float, clock: Callable[[], float] = time.monotonic,
               on_stall: Callable[[float], None] | None = None):
    if timeout_s <= 0:
      raise ValueError(f"timeout_s must be positive, got {timeout_s}")
    self.timeout_s = float(timeout_s)
    self._clock = clock
    self.on_stall = on_stall
    self._lock = threading.Lock()
    self._last_beat = clock()
    self._fired = False
    self._suspended = 0
    self.stalls = 0
    self._thread: threading.Thread | None = None
    self._stop = threading.Event()

  def beat(self) -> None:
    with self._lock:
      self._last_beat = self._clock()
      self._fired = False

  @contextlib.contextmanager
  def suspended(self):
    """Bracket host-side work that may legitimately outlast ``timeout_s``
    (a large synchronous checkpoint write): ``check()`` holds fire for
    the duration — a beat before the work would not survive a write
    longer than the timeout — and the clock re-arms on exit. Re-entrant;
    the monitor resumes once the outermost block closes."""
    with self._lock:
      self._suspended += 1
    try:
      yield
    finally:
      with self._lock:
        self._suspended -= 1
        self._last_beat = self._clock()
        self._fired = False

  def idle_s(self) -> float:
    with self._lock:
      return self._clock() - self._last_beat

  def stalled(self) -> bool:
    return self.idle_s() > self.timeout_s

  def check(self) -> bool:
    """One monitor poll; returns True exactly when a new stall fires."""
    with self._lock:
      idle = self._clock() - self._last_beat
      if self._suspended or idle <= self.timeout_s or self._fired:
        return False
      self._fired = True
      self.stalls += 1
    if self.on_stall is not None:
      self.on_stall(idle)
    return True

  @property
  def running(self) -> bool:
    return self._thread is not None and self._thread.is_alive()

  def start(self, poll_s: float | None = None,
            sleep: Callable[[float], None] = time.sleep) -> "StallWatchdog":
    """Spawn the daemon monitor thread (idempotent)."""
    if self.running:
      return self
    poll = poll_s if poll_s is not None else max(self.timeout_s / 4.0, 0.01)
    # A FRESH event per thread: a monitor whose stop() join timed out
    # (long poll cadence) must never be revived by a later start()
    # clearing a shared event — it holds its own, permanently-set one.
    stop = threading.Event()
    self._stop = stop

    def monitor():
      while not stop.is_set():
        self.check()
        sleep(poll)

    self._thread = threading.Thread(target=monitor, daemon=True,
                                    name="ckpt-stall-watchdog")
    self._thread.start()
    return self

  def stop(self) -> None:
    self._stop.set()
    # The monitor wakes on its own poll cadence; daemon threads need no
    # join to let the process exit, but join briefly to keep tests tidy.
    if self._thread is not None:
      self._thread.join(timeout=0.5)
      self._thread = None


class PreemptionGuard:
  """SIGTERM (default; ``signals=`` widens) -> an event the step loop
  checks between steps.

  The handler does the minimum legal work (set the event); the loop
  owns the preemption save. ``install()``/``uninstall()`` bracket the
  training run and restore the previous handlers; ``request()`` lets
  tests and the fault injector preempt without a real signal.
  """

  def __init__(self, signals=(signal.SIGTERM,)):
    self.signals = tuple(signals)
    self.requested = threading.Event()
    self._previous: dict = {}

  def request(self) -> None:
    self.requested.set()

  def install(self) -> "PreemptionGuard":
    for sig in self.signals:
      try:
        self._previous[sig] = signal.signal(sig, self._on_signal)
      except (ValueError, OSError):  # non-main thread / unsupported
        pass
    return self

  def uninstall(self) -> None:
    for sig, handler in self._previous.items():
      try:
        signal.signal(sig, handler)
      except (ValueError, OSError):  # pragma: no cover
        pass
    self._previous.clear()

  def _on_signal(self, signum, frame):  # noqa: ARG002 - stdlib signature
    self.requested.set()

  def __enter__(self) -> "PreemptionGuard":
    return self.install()

  def __exit__(self, *exc) -> None:
    self.uninstall()
