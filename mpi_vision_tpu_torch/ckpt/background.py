"""Background-thread checkpoint serialization.

``CheckpointStore.save`` is crash-atomic but synchronous: flatten,
hash, serialize, fsync, rename — for big train states that is hundreds
of milliseconds the step loop spends stalled every save. The step loop
only has to wait for a snapshot: PyTorch's Adam updates parameters and
moments in place (and ``.numpy()`` of a CPU tensor shares its storage),
so ``save`` copies every leaf to an owned host array
(``store.flatten_arrays``) before it returns, and the hashing and disk
work run on a worker thread while the device keeps training.

``BackgroundSaver`` wraps a ``CheckpointStore`` with exactly that
contract, keeping **at most one save in flight** (a second ``save``
first joins the previous one, so memory stays bounded at one snapshot
and publishes stay ordered). It exposes the store surface
``fit_resumable`` consumes — ``save`` / ``restore`` / ``steps`` /
``latest_step`` / ``clear`` / ``quarantine`` / ``saves`` /
``quarantined`` — with the read paths **flushing first**: a rollback
must be able to restore the checkpoint that was still being written a
moment ago, and ``clear`` must not race a late publish.

Failure surfacing: a background save that raises parks its exception
and re-raises it at the next interaction (``save``, ``flush``, or any
read path). That is the same blast radius as a failing synchronous
save — the run aborts — just one save later.

Watchdog semantics are preserved for free: the step loop's
``wd_quiet()`` bracket in ``fit_resumable`` wraps ``save`` (which now
only joins a previous worker, the one remaining potentially-long wait)
and the loop's ``finally`` flush, so a save longer than the stall
timeout still cannot page "device hang".
"""

from __future__ import annotations

import threading

from mpi_vision_tpu_torch.ckpt.store import flatten_arrays


class BackgroundSaver:
  """At-most-one-in-flight asynchronous writer over a ``CheckpointStore``.

  Args:
    store: the wrapped ``ckpt.store.CheckpointStore``.
    log: optional ``str -> None`` diagnostics sink.
  """

  def __init__(self, store, log=None):
    self.store = store
    self._log = log if log is not None else (lambda _msg: None)
    self._lock = threading.Lock()
    self._thread: threading.Thread | None = None
    self._error: BaseException | None = None
    self._pending_step: int | None = None

  # -- write path ---------------------------------------------------------

  def save(self, step: int, tree, meta: dict | None = None) -> None:
    """Enqueue an atomic save of ``tree`` as checkpoint ``step``.

    Returns as soon as the previous save (if any) has landed, every leaf
    of ``tree`` is copied to the host, and the worker for THIS save is
    running: the caller may update the tensors in place right away.
    """
    self.flush()  # one in flight: join the previous, surface its error
    step = int(step)
    meta = dict(meta or {})
    t_save = self.store.clock()
    arrays = flatten_arrays(tree)
    with self._lock:
      self._pending_step = step

    def _worker():
      try:
        self.store.save_arrays(step, arrays, meta, t_save)
      except BaseException as e:  # noqa: BLE001 - re-raised at next touch
        with self._lock:
          self._error = e
      finally:
        with self._lock:
          self._pending_step = None

    thread = threading.Thread(target=_worker, name="mpi-ckpt-bg-save",
                              daemon=True)
    with self._lock:
      self._thread = thread
    thread.start()

  def flush(self) -> None:
    """Wait for the in-flight save (if any); re-raise a parked failure."""
    with self._lock:
      thread = self._thread
    if thread is not None:
      thread.join()
      with self._lock:
        if self._thread is thread:
          self._thread = None
    with self._lock:
      error, self._error = self._error, None
    if error is not None:
      raise error

  # -- read paths (flush-first: reads must see every enqueued save) -------

  def restore(self, *args, **kwargs):
    self.flush()
    return self.store.restore(*args, **kwargs)

  def steps(self):
    self.flush()
    return self.store.steps()

  def clear(self):
    self.flush()
    return self.store.clear()

  def quarantine(self, *args, **kwargs):
    self.flush()
    return self.store.quarantine(*args, **kwargs)

  def gc(self):
    self.flush()
    return self.store.gc()

  def latest_step(self):
    """The newest step, counting the one still being written.

    Deliberately does NOT flush: ``fit_resumable`` consults this at
    every epoch boundary to dedupe saves, and blocking there would
    reintroduce the stall this class removes. Optimistic about the
    pending save — if it later fails, the parked error aborts the run
    at the next touch anyway, exactly like a failed synchronous save.
    """
    with self._lock:
      pending = self._pending_step
    published = self.store.latest_step()
    candidates = [s for s in (pending, published) if s is not None]
    return max(candidates) if candidates else None

  # -- delegated accounting ----------------------------------------------

  @property
  def root(self):
    return self.store.root

  @property
  def saves(self):
    return self.store.saves

  @property
  def quarantined(self):
    return self.store.quarantined

  @property
  def last_save_s(self):
    """Cost of the newest PUBLISHED save. Deliberately not flushed: the
    step-loop telemetry reads this every save, and with background
    serialization it reports the previous completed save's cost — the
    honest async number (the loop never waited on the current one)."""
    return self.store.last_save_s

  @property
  def last_save_bytes(self):
    return self.store.last_save_bytes
