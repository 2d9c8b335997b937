"""Resilience layer for the serving path: classify, retry, break, watch.

The device is the serving layer's single point of failure: a card can
drop off the bus, run out of memory or hang a launch. This module gives the
scheduler the four behaviors that keep the service up through that
outage class:

  * **classification** — ``classify_error`` splits failures into
    *transient* (device/tunnel trouble: retry, count against the
    breaker) and *permanent* (bad input: fail fast, never retry —
    retrying a malformed pose just burns device time).
  * **retry** — ``RetryPolicy``: per-batch exponential backoff with
    deterministic jitter, always bounded by the batch's remaining
    request deadline (a retry the caller will never see is dead work).
  * **circuit breaker** — ``CircuitBreaker``: N consecutive primary
    failures open the circuit; while open, callers fast-fail (HTTP 503
    + Retry-After); after a cooldown one half-open probe decides
    re-close vs re-open. Work never moves off the card.
  * **watchdog** — ``call_with_watchdog``: a dispatch that exceeds its
    deadline fails (``DispatchTimeoutError``) instead of wedging the
    scheduler's only dispatcher thread; the hung call is abandoned on a
    daemon thread whose eventual result is discarded.

``ResilientExecutor`` composes all four around one callable and is what
``scheduler.MicroBatcher`` dispatches through. Everything here is
engine-agnostic and injectable (clock, sleep, seed) so the whole state
machine is testable on the CPU with fake clocks and injected faults.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time


class TransientDeviceError(RuntimeError):
  """A retryable device-side failure (UNAVAILABLE-style).

  Raised by fault injection and usable by engines to mark an error as
  transient explicitly; ``classify_error`` also recognizes the usual
  runtime signatures (UNAVAILABLE/DEADLINE_EXCEEDED, connection
  drops) without this type.
  """


class DispatchTimeoutError(TransientDeviceError):
  """A dispatch exceeded its watchdog deadline and was abandoned."""


class CircuitOpenError(RuntimeError):
  """Fast-fail: the circuit is open.

  ``retry_after_s`` is the cooldown remaining until the next half-open
  probe — the HTTP layer maps it to a 503 with a Retry-After header.
  """

  def __init__(self, retry_after_s: float):
    self.retry_after_s = max(float(retry_after_s), 0.0)
    super().__init__(
        f"circuit breaker open; retry after {self.retry_after_s:.1f}s")


# Status keywords runtime errors carry in their message when the
# device or its tunnel (not the program) is at fault, matched
# case-insensitively ("Socket closed" and "UNAVAILABLE" both appear in
# the wild). INTERNAL is deliberately absent: runtimes tag genuine program
# bugs INTERNAL too, and retrying those would loop a permanent failure
# through the breaker.
_TRANSIENT_MARKERS = (
    "unavailable",
    "deadline_exceeded",
    "resource_exhausted",
    "aborted",
    "socket closed",
    "connection reset",
    "tunnel",
)


def classify_error(exc: BaseException) -> str:
  """``"transient"`` (device trouble: retry) or ``"permanent"`` (don't).

  Bad-input types (ValueError/TypeError/KeyError) are permanent even if
  their message happens to contain a transient marker — a request that
  failed validation fails identically on every retry.
  """
  if isinstance(exc, (TransientDeviceError, CircuitOpenError)):
    return "transient"  # an open circuit heals; retry later, not never
  if isinstance(exc, (ValueError, TypeError, KeyError)):
    return "permanent"
  if isinstance(exc, (ConnectionError, TimeoutError)):
    return "transient"
  msg = str(exc).lower()
  if any(marker in msg for marker in _TRANSIENT_MARKERS):
    return "transient"
  return "permanent"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
  """Exponential backoff with deterministic jitter.

  ``max_retries`` is *additional* attempts after the first (so 2 means
  up to 3 dispatches). Jitter is a symmetric fraction of the backoff,
  drawn from a caller-owned ``random.Random`` so schedules replay
  exactly under a fixed seed.
  """

  max_retries: int = 2
  backoff_base_s: float = 0.05
  backoff_mult: float = 2.0
  backoff_max_s: float = 2.0
  jitter: float = 0.1

  def backoff_s(self, attempt: int, rng: random.Random) -> float:
    """Sleep before retry number ``attempt`` (1-based)."""
    base = min(self.backoff_base_s * self.backoff_mult ** (attempt - 1),
               self.backoff_max_s)
    return max(base * (1.0 + self.jitter * rng.uniform(-1.0, 1.0)), 0.0)


class CircuitBreaker:
  """CLOSED -> OPEN -> HALF_OPEN consecutive-failure circuit breaker.

  Tracks the *primary* engine only. ``failure_threshold`` consecutive
  failures open the circuit for ``reset_after_s``; the first
  ``allow_primary()`` after the cooldown claims the single half-open
  probe slot, and that probe's outcome re-closes or re-opens the
  circuit. Thread-safe; the clock is injectable for tests.
  """

  CLOSED = "closed"
  OPEN = "open"
  HALF_OPEN = "half_open"

  def __init__(self, failure_threshold: int = 5, reset_after_s: float = 30.0,
               clock=time.monotonic, on_transition=None):
    if failure_threshold < 1:
      raise ValueError(
          f"failure_threshold must be >= 1, got {failure_threshold}")
    self.failure_threshold = failure_threshold
    self.reset_after_s = float(reset_after_s)
    self._clock = clock
    self._on_transition = on_transition
    self._lock = threading.Lock()
    self._state = self.CLOSED
    self._consecutive_failures = 0
    self._opened_at = 0.0
    self._probe_in_flight = False
    self.opens = 0

  def _transition_locked(self, new_state: str) -> None:
    old, self._state = self._state, new_state
    if new_state == self.OPEN:
      self.opens += 1
      self._opened_at = self._clock()
    if self._on_transition is not None and old != new_state:
      self._on_transition(old, new_state)

  @property
  def state(self) -> str:
    with self._lock:
      return self._state

  def allow_primary(self) -> bool:
    """May the caller dispatch to the primary engine right now?

    Claims the half-open probe slot when the cooldown has elapsed, so a
    True return during OPEN/HALF_OPEN *is* the probe — the caller must
    report back via ``record_success``/``record_failure``.
    """
    with self._lock:
      if self._state == self.CLOSED:
        return True
      if self._state == self.OPEN:
        if self._clock() - self._opened_at < self.reset_after_s:
          return False
        self._transition_locked(self.HALF_OPEN)
        self._probe_in_flight = True
        return True
      # HALF_OPEN: one probe at a time.
      if self._probe_in_flight:
        return False
      self._probe_in_flight = True
      return True

  def would_allow(self) -> bool:
    """Non-mutating peek (submit-time fast-fail check): does a dispatch
    stand any chance of reaching the primary? Never claims the probe."""
    with self._lock:
      if self._state == self.CLOSED:
        return True
      if self._state == self.OPEN:
        return self._clock() - self._opened_at >= self.reset_after_s
      return True  # HALF_OPEN: a probe is deciding; let requests queue

  def release_probe(self) -> None:
    """Release a claimed half-open probe slot without judging the device.

    For probe dispatches whose outcome says nothing about device health
    (bad-input error, caller-deadline trip): the slot must free so the
    NEXT dispatch can probe — otherwise the breaker wedges in HALF_OPEN
    with the slot held forever.
    """
    with self._lock:
      self._probe_in_flight = False

  def record_success(self) -> None:
    with self._lock:
      self._consecutive_failures = 0
      self._probe_in_flight = False
      if self._state != self.CLOSED:
        self._transition_locked(self.CLOSED)

  def record_failure(self) -> None:
    with self._lock:
      self._consecutive_failures += 1
      self._probe_in_flight = False
      if self._state == self.HALF_OPEN:
        self._transition_locked(self.OPEN)
      elif (self._state == self.CLOSED
            and self._consecutive_failures >= self.failure_threshold):
        self._transition_locked(self.OPEN)

  def retry_after_s(self) -> float:
    """Cooldown remaining until the next probe (0 unless OPEN)."""
    with self._lock:
      if self._state != self.OPEN:
        return 0.0
      return max(self.reset_after_s - (self._clock() - self._opened_at), 0.0)

  def snapshot(self) -> dict:
    with self._lock:
      out = {
          "state": self._state,
          "consecutive_failures": self._consecutive_failures,
          "failure_threshold": self.failure_threshold,
          "opens": self.opens,
      }
      if self._state == self.OPEN:
        out["retry_after_s"] = round(
            max(self.reset_after_s - (self._clock() - self._opened_at), 0.0),
            3)
      return out


def call_with_watchdog(fn, timeout_s: float | None):
  """Run ``fn()`` bounded by ``timeout_s``; on overrun, abandon and raise.

  The call runs on a fresh daemon thread; if it does not finish within
  the deadline a ``DispatchTimeoutError`` is raised and the thread is
  abandoned — whatever it eventually produces (result or exception) is
  discarded. ``timeout_s=None`` calls inline (no thread, no guard);
  ``timeout_s <= 0`` fails without dispatching at all.
  """
  if timeout_s is None:
    return fn()
  if timeout_s <= 0:
    raise DispatchTimeoutError("deadline exhausted before dispatch")
  box: dict = {}
  done = threading.Event()

  def _run():
    try:
      box["result"] = fn()
    except BaseException as e:  # noqa: BLE001 - re-raised on the caller
      box["error"] = e
    done.set()

  thread = threading.Thread(target=_run, name="mpi-serve-render-watchdog",
                            daemon=True)
  thread.start()
  if not done.wait(timeout_s):
    raise DispatchTimeoutError(
        f"dispatch exceeded its {timeout_s:.3f}s deadline; abandoned")
  if "error" in box:
    raise box["error"]
  return box["result"]


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
  """Knobs for ``ResilientExecutor`` (the CLI's ``serve`` flags map 1:1).

  ``watchdog_s`` is the per-dispatch hang guard when a batch carries no
  request deadline (with deadlines, the guard is the tighter of the two);
  None disables the watchdog thread entirely. ``seed`` fixes the jitter
  stream so failure schedules replay deterministically in tests.
  """

  max_retries: int = 2
  backoff_base_s: float = 0.05
  backoff_mult: float = 2.0
  backoff_max_s: float = 2.0
  jitter: float = 0.1
  breaker_threshold: int = 5
  breaker_reset_s: float = 30.0
  watchdog_s: float | None = 30.0
  seed: int = 0

  def retry_policy(self) -> RetryPolicy:
    return RetryPolicy(max_retries=self.max_retries,
                       backoff_base_s=self.backoff_base_s,
                       backoff_mult=self.backoff_mult,
                       backoff_max_s=self.backoff_max_s,
                       jitter=self.jitter)


class ResilientExecutor:
  """Retry + breaker + watchdog around one dispatch callable.

  ``run(primary_fn, deadline)`` executes ``primary_fn`` under the
  watchdog, retrying transient failures with backoff while the deadline
  allows, counting outcomes into the breaker. Once the breaker refuses the
  device, ``CircuitOpenError`` fast-fails the batch. Permanent errors raise
  immediately, uncounted — a bad request must not open the circuit on a
  healthy device.

  Single logical caller per flight; the breaker itself is thread-safe so
  ``check_fastfail`` may race from submitters.
  """

  def __init__(self, config: ResilienceConfig | None = None,
               metrics=None, clock=time.monotonic, sleep=time.sleep):
    self.config = config if config is not None else ResilienceConfig()
    self.metrics = metrics
    self._clock = clock
    self._sleep = sleep
    self._policy = self.config.retry_policy()
    self._rng = random.Random(self.config.seed)
    self.breaker = CircuitBreaker(
        failure_threshold=self.config.breaker_threshold,
        reset_after_s=self.config.breaker_reset_s, clock=clock,
        on_transition=self._on_breaker_transition)

  def _on_breaker_transition(self, old: str, new: str) -> None:
    if self.metrics is not None and new == CircuitBreaker.OPEN:
      self.metrics.record_breaker_open()

  def _fastfail(self) -> CircuitOpenError:
    if self.metrics is not None:
      self.metrics.record_breaker_fastfail()
    return CircuitOpenError(self.breaker.retry_after_s())

  def check_fastfail(self) -> None:
    """Submit-time guard: raise ``CircuitOpenError`` when a request could
    only ever meet an open breaker."""
    if not self.breaker.would_allow():
      raise self._fastfail()

  def _watchdog_timeout(self, deadline: float | None) -> float | None:
    if self.config.watchdog_s is None:
      return None  # watchdog OFF means off: no guard thread, ever
    if deadline is None:
      return self.config.watchdog_s
    return min(self.config.watchdog_s, deadline - self._clock())

  def run(self, primary_fn, deadline: float | None = None, recorder=None):
    """One resilient dispatch. ``deadline`` is absolute (clock units).

    ``recorder`` is an optional ``obs.trace.SpanRecorder``: every attempt
    becomes an ``attempt`` span group (errors recorded on it, spans made
    inside the attempt closure nest under it) and every retry backoff a
    ``backoff`` span — the trace-tree view of the retry machinery. None
    (the tracing-disabled default) records nothing.
    """
    attempt = 0
    while True:
      if not self.breaker.allow_primary():
        raise self._fastfail()
      # A True from a non-CLOSED breaker IS the half-open probe; this
      # attempt must report back (or release) whatever happens, or the
      # slot leaks and the breaker wedges in HALF_OPEN forever.
      holds_probe = self.breaker.state == CircuitBreaker.HALF_OPEN
      timeout = self._watchdog_timeout(deadline)
      span = (recorder.begin("attempt", attempt=attempt)
              if recorder is not None else None)
      try:
        out = call_with_watchdog(primary_fn, timeout)
        if span is not None:
          recorder.end(span)
        self.breaker.record_success()
        return out
      except Exception as e:  # noqa: BLE001 - classified below
        if span is not None:
          recorder.end(span, error=repr(e))
        if classify_error(e) == "permanent":
          if holds_probe:
            self.breaker.release_probe()  # outcome says nothing re: device
          raise
        # A trip whose limit came from the CALLER's deadline (tighter
        # than watchdog_s) says nothing about device health — counting
        # it would let an overloaded-but-healthy queue open the circuit
        # and turn backlog into a fake outage.
        deadline_capped = (
            isinstance(e, DispatchTimeoutError)
            and timeout is not None
            and timeout < self.config.watchdog_s)
        if deadline_capped:
          e.deadline_capped = True  # upper layers label it overload (504)
        if isinstance(e, DispatchTimeoutError) and self.metrics is not None:
          self.metrics.record_watchdog_trip()
        if not deadline_capped:
          self.breaker.record_failure()
        elif holds_probe:
          self.breaker.release_probe()
        attempt += 1
        if attempt > self._policy.max_retries:
          raise
        backoff = self._policy.backoff_s(attempt, self._rng)
        if deadline is not None and (
            self._clock() + backoff >= deadline):
          raise  # the caller's deadline lands inside the backoff: dead work
        if self.metrics is not None:
          self.metrics.record_retry()
        if backoff > 0:
          if recorder is not None:
            b = recorder.begin("backoff", attempt=attempt)
            self._sleep(backoff)
            recorder.end(b)
          else:
            self._sleep(backoff)
