"""Deterministic fault injection for the serving engine.

A copy of ``mpi_vision_tpu/serve/faultinject.py`` with its imports
rewritten and the port's engine surface proxied. ``FaultyEngine`` wraps an
engine exposing ``render_batch`` (and the streaming ``submit``/``poll``/
``wait``/``abandon``) and injects scheduled failures *between* the
scheduler and the device, which is exactly where real outages land (a
card that drops off the bus mid-run). Three fault kinds cover the outage classes the
resilience layer must survive:

  * ``error`` — raise immediately (``TransientDeviceError`` by default,
    ``ValueError`` with ``transient=False`` for bad-input testing).
  * ``hang`` — block up to ``seconds`` (or until ``release`` is set),
    then raise transient; the watchdog must abandon it first.
  * ``slow`` — sleep ``seconds`` then dispatch normally (deadline and
    backoff-budget pressure without failing).

Faults come from an explicit queue (``inject``: next-N-dispatches, the
unit-test mode) and/or a ``schedule`` callable ``dispatch_index ->
Fault | None`` (a chaos-mode generator).
Both are deterministic: dispatch indices are assigned under a lock in
dispatch order, and a seeded schedule replays exactly. Everything runs
on the CPU, so every resilience behavior is testable without a card.

Cache-bake faults (``inject_bake`` / ``bake_schedule``) cover the other
half of the request path: the scene provider consults ``check_bake``
before baking, so a cold scene can fail exactly where a dead device
would fail it — inside the resilient dispatch, where it must retry,
count toward the breaker, and land on the trace's bake span.
"""

from __future__ import annotations

import dataclasses
import threading
import time

from mpi_vision_tpu_torch.serve.resilience import TransientDeviceError

_KINDS = ("error", "hang", "slow")


@dataclasses.dataclass(frozen=True)
class Fault:
  """One scheduled failure. ``seconds`` bounds hangs and slow sleeps."""

  kind: str = "error"
  seconds: float = 60.0
  transient: bool = True
  message: str = ""

  def __post_init__(self):
    if self.kind not in _KINDS:
      raise ValueError(f"fault kind must be one of {_KINDS}, got {self.kind}")


class FaultyEngine:
  """An engine wrapper that fails on schedule instead of by accident.

  Args:
    inner: the wrapped engine (``RenderEngine`` or compatible).
    schedule: optional ``dispatch_index -> Fault | None`` callable
      consulted when the explicit queue is empty.

  ``release`` frees any in-flight hang early (tests set it in teardown
  so abandoned watchdog threads exit instead of idling out their full
  hold time).
  """

  def __init__(self, inner, schedule=None, bake_schedule=None):
    self.inner = inner
    self.schedule = schedule
    self.bake_schedule = bake_schedule
    self.release = threading.Event()
    self._lock = threading.Lock()
    self._queue: list[Fault] = []
    self._bake_queue: list[Fault] = []
    self._index = 0
    self._bake_index = 0
    self.injected = {"error": 0, "hang": 0, "slow": 0, "bake": 0}

  # -- scheduling ---------------------------------------------------------

  def inject(self, *faults: Fault) -> None:
    """Queue faults for the next dispatches (one fault per dispatch)."""
    with self._lock:
      self._queue.extend(faults)

  def fail_next(self, n: int = 1, transient: bool = True) -> None:
    """Shorthand: the next ``n`` dispatches raise an error fault."""
    self.inject(*(Fault("error", transient=transient) for _ in range(n)))

  def inject_bake(self, *faults: Fault) -> None:
    """Queue faults for the next cache bakes (one fault per bake)."""
    with self._lock:
      self._bake_queue.extend(faults)

  def fail_next_bake(self, n: int = 1, transient: bool = True) -> None:
    """Shorthand: the next ``n`` scene bakes raise an error fault."""
    self.inject_bake(*(Fault("error", transient=transient)
                       for _ in range(n)))

  def clear(self) -> None:
    with self._lock:
      self._queue.clear()
      self._bake_queue.clear()

  def _next_fault(self) -> Fault | None:
    with self._lock:
      idx, self._index = self._index, self._index + 1
      if self._queue:
        return self._queue.pop(0)
    return self.schedule(idx) if self.schedule is not None else None

  def _next_bake_fault(self) -> Fault | None:
    with self._lock:
      idx, self._bake_index = self._bake_index, self._bake_index + 1
      if self._bake_queue:
        return self._bake_queue.pop(0)
    return (self.bake_schedule(idx)
            if self.bake_schedule is not None else None)

  def check_bake(self, scene_id: str) -> None:
    """Scene-provider hook: fail this bake if a bake fault is scheduled.

    ``RenderService`` consults this (when the engine exposes it) inside
    the cache-miss bake path — so the fault fires only on real bakes
    (cached scenes never reach it), rides the resilient dispatch like a
    failed render, and is recorded on the trace's bake span.
    """
    fault = self._next_bake_fault()
    if fault is None:
      return
    with self._lock:
      self.injected["bake"] += 1
    if fault.kind == "slow":
      time.sleep(fault.seconds)
      return
    if fault.kind == "hang":
      self.release.wait(fault.seconds)
    self._raise(fault, f"injected bake fault for {scene_id!r}")

  # -- engine surface -----------------------------------------------------

  def _apply_dispatch_fault(self) -> None:
    """Consume and fire the next scheduled dispatch fault (if any).

    Runs at the dispatch point — ``render_batch`` on the blocking
    surface, ``submit`` on the streaming one — so one fault fires per
    attempt either way, and hangs/slows land on the attempt thread where
    the watchdog can abandon them.
    """
    fault = self._next_fault()
    if fault is None:
      return
    with self._lock:
      self.injected[fault.kind] += 1
    if fault.kind == "error":
      self._raise(fault, "injected fault")
    elif fault.kind == "hang":
      # Simulates a dispatch that never returns (tunnel gone mid-call):
      # hold until released or the bounded hold elapses, then raise —
      # by then the watchdog abandoned this thread and the result is
      # discarded either way.
      self.release.wait(fault.seconds)
      self._raise(fault, "injected hang released")
    else:  # slow
      time.sleep(fault.seconds)

  def render_batch(self, scene, poses):
    self._apply_dispatch_fault()
    return self.inner.render_batch(scene, poses)

  # Streaming surface (scheduler pipeline): the fault fires at submit —
  # the dispatch point — then everything delegates to the wrapped
  # engine, so an un-faulted batch rides the real async pipeline.

  def submit(self, scene, poses):
    self._apply_dispatch_fault()
    return self.inner.submit(scene, poses)

  def poll(self, handle) -> bool:
    return self.inner.poll(handle)

  def wait(self, handle):
    return self.inner.wait(handle)

  def abandon(self, handle) -> None:
    self.inner.abandon(handle)

  @property
  def max_inflight(self):
    return self.inner.max_inflight

  @property
  def inflight(self):
    return self.inner.inflight

  def _raise(self, fault: Fault, default_msg: str):
    msg = fault.message or f"{default_msg} (UNAVAILABLE: device injected)"
    if fault.transient:
      raise TransientDeviceError(msg)
    raise ValueError(fault.message or "injected permanent fault (bad input)")

  def render_one(self, scene, pose):
    import numpy as np

    return self.render_batch(scene, np.asarray(pose, np.float32)[None])[0]

  def batch_bucket(self, v: int) -> int:
    return self.inner.batch_bucket(v)

  @property
  def devices(self):
    return self.inner.devices

  @property
  def method(self):
    return self.inner.method

  @property
  def convention(self):
    return self.inner.convention

  @property
  def use_mesh(self):
    return self.inner.use_mesh

  @property
  def device(self):
    return self.inner.device

  @property
  def dispatches(self):
    return self.inner.dispatches

  @property
  def platform(self):
    return self.inner.platform

  def cpu_fallback(self):
    return self.inner.cpu_fallback()

  def describe(self) -> dict:
    out = dict(self.inner.describe())
    out["fault_injection"] = dict(self.injected)
    return out
