"""Live checkpoint watching: poll a store, fire on a newly published step.

PyTorch-package copy of ``mpi_vision_tpu/ckpt/watch.py`` (host-only; the
two differ in this docstring alone). ``serve --ckpt`` bakes once at
startup, so a deployment serving a model that is still training goes
stale until restarted. ``CheckpointWatcher`` closes the loop — it polls
``CheckpointStore.latest_step()`` (listing a directory: cheap, safe
against a concurrently-writing trainer because publishes are atomic
renames) and invokes a callback exactly once per newly observed step. The
callback does the expensive part (restore, forward pass,
``RenderService.swap_scenes``) on the watcher thread, so serving threads
never block on a reload.

Polling, not inotify: the store may sit on NFS/FUSE in real deployments,
where watch APIs are unreliable; a seconds-scale poll of one ``listdir``
is the robust version, and the clock and sleep are injectable.

Callback failures are counted and logged, never fatal: a checkpoint that
fails to bake (mid-GC disappearance, corrupt manifest quarantined by the
restore) must leave the previous scenes serving. The failed step is NOT
marked seen, so the next poll retries it until a newer step supersedes.

The poll loop itself (daemon thread, injectable sleep, interruptible
stop) is ``PollWatcher``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class PollWatcher:
  """Reusable poll loop: a daemon thread calling ``check_once()`` every
  ``poll_s`` seconds.

  Subclasses implement ``check_once()`` (one complete poll; must never
  raise — failures are the subclass's accounting). ``start()``/
  ``stop()``/context management are shared. ``sleep`` is injectable for
  deterministic tests; the real-time path waits on an event so
  ``stop()`` never blocks a full poll interval.
  """

  thread_name = "mpi-poll-watch"

  def __init__(self, poll_s: float, sleep=None):
    if poll_s <= 0:
      raise ValueError(f"poll_s must be > 0, got {poll_s}")
    self.poll_s = float(poll_s)
    self._sleep = sleep
    self._stop = threading.Event()
    self._thread: threading.Thread | None = None

  def check_once(self):
    raise NotImplementedError

  def start(self):
    if self._thread is not None:
      raise RuntimeError(f"{type(self).__name__} already started")
    self._stop.clear()
    self._thread = threading.Thread(target=self._loop,
                                    name=self.thread_name, daemon=True)
    self._thread.start()
    return self

  def _loop(self) -> None:
    while not self._stop.is_set():
      self.check_once()
      if self._sleep is not None:
        self._sleep(self.poll_s)  # injected sleep (deterministic tests)
        if self._stop.is_set():
          return
      elif self._stop.wait(self.poll_s):  # interruptible real-time wait
        return

  def stop(self, timeout: float = 10.0) -> None:
    self._stop.set()
    thread = self._thread
    if thread is not None:
      thread.join(timeout)
      self._thread = None

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.stop()


class CheckpointWatcher(PollWatcher):
  """Fire ``on_new_step(step)`` when the store publishes a newer step.

  Args:
    store: a ``CheckpointStore`` (anything with ``latest_step()``).
    on_new_step: callback invoked with the newly observed step number.
      Runs on the watcher thread (or the ``check_once`` caller).
    poll_s: seconds between polls of the monitor thread.
    initial_step: steps <= this are considered already served (the
      startup bake); None treats whatever is currently published as new.
    clock / sleep: injectable time sources (tier-1 determinism; the
      monitor thread waits on an event, so ``stop()`` never blocks a
      full poll interval).
    log: diagnostics sink (reload failures are reported here).
  """

  thread_name = "mpi-ckpt-watch"

  def __init__(self, store, on_new_step: Callable[[int], None],
               poll_s: float = 2.0, initial_step: int | None = None,
               clock=time.monotonic, sleep=None,
               log: Callable[[str], None] | None = None):
    super().__init__(poll_s, sleep=sleep)
    self.store = store
    self.on_new_step = on_new_step
    self._clock = clock
    self._log = log if log is not None else (lambda msg: None)
    self._seen_step = initial_step
    # Two locks on purpose: _poll_lock serializes whole polls (the
    # monitor thread vs. a test driving check_once by hand) and is held
    # across the expensive reload callback; _lock guards only the small
    # state/counters, so snapshot()/seen_step — including the serve
    # CLI's SIGTERM-time summary — never block behind a minutes-long
    # restore + re-bake.
    self._poll_lock = threading.Lock()
    self._lock = threading.Lock()
    self.polls = 0
    self.reloads = 0
    self.reload_errors = 0
    self.last_error: str | None = None

  def check_once(self) -> int | None:
    """One poll: fire the callback if a newer step is published.

    Returns the newly served step, or None when nothing changed (or the
    reload failed — counted, retried next poll). Thread-safe; the
    monitor thread and a test driving polls by hand never double-fire.
    """
    with self._poll_lock:
      with self._lock:
        self.polls += 1
        seen = self._seen_step
      try:
        latest = self.store.latest_step()
      except OSError as e:  # store dir briefly unlistable (NFS hiccup)
        with self._lock:
          self.reload_errors += 1
          self.last_error = repr(e)
        self._log(f"ckpt-watch: store poll failed: {e!r}")
        return None
      if latest is None:
        return None
      if seen is not None and latest <= seen:
        return None
      try:
        self.on_new_step(latest)
      except Exception as e:  # noqa: BLE001 - serving must outlive a bad ckpt
        # Previous scenes keep serving; the step stays unseen so the next
        # poll retries (a newer publish supersedes it naturally).
        with self._lock:
          self.reload_errors += 1
          self.last_error = repr(e)
        self._log(f"ckpt-watch: reload of step {latest} failed: {e!r}")
        return None
      with self._lock:
        self._seen_step = latest
        self.reloads += 1
        self.last_error = None
      return latest

  @property
  def seen_step(self) -> int | None:
    with self._lock:
      return self._seen_step

  def snapshot(self) -> dict:
    with self._lock:
      return {
          "seen_step": self._seen_step,
          "polls": self.polls,
          "reloads": self.reloads,
          "reload_errors": self.reload_errors,
          "last_error": self.last_error,
      }
