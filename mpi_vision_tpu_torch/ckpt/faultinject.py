"""Deterministic fault injection for the training loop.

``TrainFaultSource`` schedules faults by *global step index* and *save
index* — the two clocks a training run actually advances — so a crash
"at step 7" or a corrupted write "on save 2" replays exactly, in-process
or across a SIGKILL'd subprocess. Every fault fires exactly once (a
rolled-back step that replays index 7 does NOT re-fire the fault; the
NaN-guard convergence test depends on that).

Step faults (consulted by ``fit_resumable`` before each step):

  * ``crash``   — die here. ``hard=True`` SIGKILLs the process (the
    kill-and-resume acceptance test), ``hard=False`` raises
    ``SimulatedCrash`` (the in-process tier-1 variant).
  * ``nan``     — poison the batch (float leaves -> NaN): the loss goes
    non-finite exactly where a bad batch or overflow would take it.
  * ``preempt`` — set the preemption flag (SIGTERM without a signal).
  * ``hang``    — sleep ``seconds`` before the step (stall-watchdog
    food).

Save faults (wired into ``CheckpointStore``'s ``fault_hook`` stages):

  * ``crash`` at ``stage="pre_rename"``  — die after the staging dir is
    fully written but before the atomic publish: the checkpoint must
    NOT exist afterwards (atomicity pin).
  * ``crash`` at ``stage="post_rename"`` — die right after publishing.
  * ``corrupt``                          — after publishing, truncate or
    garble a file in the published dir (simulated bit rot / torn disk):
    restore must quarantine it and fall back.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time

import numpy as np
import torch

_STEP_KINDS = ("crash", "nan", "preempt", "hang")
_SAVE_KINDS = ("crash", "corrupt")


class SimulatedCrash(BaseException):
  """In-process stand-in for a hard process death.

  Derives from ``BaseException`` so ordinary ``except Exception``
  cleanup code cannot accidentally 'survive' a crash the test meant to
  be fatal — exactly like a real SIGKILL would not be caught.
  """


@dataclasses.dataclass(frozen=True)
class TrainFault:
  """One scheduled training fault.

  ``stage`` selects the save hook point for save faults; ``target`` and
  ``mode`` shape corruption (which file, truncate vs garble); ``hard``
  selects SIGKILL vs ``SimulatedCrash`` for crashes; ``seconds`` bounds
  hangs.
  """

  kind: str = "crash"
  hard: bool = False
  stage: str = "pre_rename"
  target: str = "arrays.npz"
  mode: str = "truncate"
  seconds: float = 0.05

  def __post_init__(self):
    if self.kind not in set(_STEP_KINDS) | set(_SAVE_KINDS):
      raise ValueError(f"unknown fault kind {self.kind!r}")
    if self.stage not in ("pre_rename", "post_rename"):
      raise ValueError(f"unknown save stage {self.stage!r}")
    if self.mode not in ("truncate", "garble"):
      raise ValueError(f"unknown corrupt mode {self.mode!r}")


class TrainFaultSource:
  """Faults keyed by step / save index, consumed once each.

  The loop asks ``on_step(global_step)`` before every optimizer update;
  ``CheckpointStore`` calls the bound ``store_hook`` at both save
  stages. ``injected`` counts what actually fired, by kind.
  """

  def __init__(self):
    self._lock = threading.Lock()
    self._step_faults: dict[int, TrainFault] = {}
    self._save_faults: dict[int, TrainFault] = {}
    self._save_index = 0
    self.injected = {k: 0 for k in set(_STEP_KINDS) | set(_SAVE_KINDS)}

  # -- scheduling ---------------------------------------------------------

  def at_step(self, step: int, fault: TrainFault) -> "TrainFaultSource":
    if fault.kind not in _STEP_KINDS:
      raise ValueError(f"{fault.kind!r} is not a step fault")
    with self._lock:
      self._step_faults[int(step)] = fault
    return self

  def at_save(self, save_index: int, fault: TrainFault) -> "TrainFaultSource":
    if fault.kind not in _SAVE_KINDS:
      raise ValueError(f"{fault.kind!r} is not a save fault")
    with self._lock:
      self._save_faults[int(save_index)] = fault
    return self

  # -- step side ----------------------------------------------------------

  def on_step(self, step: int) -> TrainFault | None:
    """The fault scheduled for this global step, consumed (fires once)."""
    with self._lock:
      return self._step_faults.pop(int(step), None)

  def fire_step(self, fault: TrainFault, preempt=None) -> bool:
    """Execute a step fault's side effects.

    Returns True when the *caller* must act on the fault (``nan``:
    poison the batch; the loop uses ``poison_batch``). ``preempt`` is
    the ``PreemptionGuard`` (or any object with ``request()``).
    """
    with self._lock:
      self.injected[fault.kind] += 1
    if fault.kind == "crash":
      self._crash(fault)
    elif fault.kind == "preempt":
      if preempt is None:
        raise ValueError("preempt fault fired with no PreemptionGuard")
      preempt.request()
    elif fault.kind == "hang":
      time.sleep(fault.seconds)
    return fault.kind == "nan"

  @staticmethod
  def poison_batch(batch):
    """Floating tensors and arrays -> NaN on their own device (integer
    and bool leaves pass through): the deterministic stand-in for a
    corrupt input batch."""

    def bad(a):
      if isinstance(a, torch.Tensor):
        return torch.full_like(a, float("nan")) if a.is_floating_point() \
            else a
      a = np.asarray(a)
      if a.dtype.kind == "f":
        return np.full_like(a, np.nan)
      return a

    return {k: bad(v) for k, v in batch.items()}

  # -- save side ----------------------------------------------------------

  @property
  def store_hook(self):
    """The ``fault_hook`` to hand to ``CheckpointStore``."""
    return self._on_save_stage

  def _on_save_stage(self, stage: str, path: str) -> None:
    with self._lock:
      if stage == "pre_rename":
        index, self._save_index = self._save_index, self._save_index + 1
      else:
        index = self._save_index - 1
      fault = self._save_faults.get(index)
      if fault is None:
        return
      if fault.kind == "crash" and fault.stage == stage:
        self._save_faults.pop(index)
        self.injected["crash"] += 1
      elif fault.kind == "corrupt" and stage == "post_rename":
        self._save_faults.pop(index)
        self.injected["corrupt"] += 1
      else:
        return
    if fault.kind == "crash":
      self._crash(fault)
    else:
      self._corrupt(os.path.join(path, fault.target), fault.mode)

  @staticmethod
  def _crash(fault: TrainFault) -> None:
    if fault.hard:
      # A real mid-epoch death: no atexit, no finally, no flushing —
      # exactly what a preempted VM or OOM-killed container does.
      os.kill(os.getpid(), signal.SIGKILL)
      time.sleep(10)  # pragma: no cover - the signal lands first
    raise SimulatedCrash(f"injected crash ({fault.stage})")

  @staticmethod
  def _corrupt(path: str, mode: str) -> None:
    size = os.path.getsize(path)
    if mode == "truncate":
      with open(path, "r+b") as fh:
        fh.truncate(max(size // 2, 1))
    else:  # garble: flip bytes mid-file, size unchanged
      with open(path, "r+b") as fh:
        fh.seek(max(size // 2 - 8, 0))
        fh.write(b"\xde\xad\xbe\xef" * 4)

  def describe(self) -> dict:
    with self._lock:
      return {"injected": dict(self.injected),
              "pending_step_faults": sorted(self._step_faults),
              "pending_save_faults": sorted(self._save_faults)}
