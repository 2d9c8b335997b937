"""Checkpoint lifecycle: atomic manifest'd stores, guards, fault injection.

PyTorch counterpart of ``mpi_vision_tpu/ckpt/`` (the reference trains
open-loop, ``Learner.fit(20, lr=2e-4)``, with no checkpointing at all):

  * ``store``       — ``CheckpointStore``: write-tmp -> fsync -> rename
    atomic saves, per-array content hashes in a JSON manifest,
    keep-last-K GC, corrupted/truncated checkpoints quarantined with
    automatic rollback to the last good one. The format
    (``mpi-ckpt-v1``) and its array keys are the JAX package's, so each
    package's store reads the other's flat checkpoints.
  * ``guards``      — ``NanGuard`` (non-finite loss -> rollback + LR
    cut), ``StallWatchdog`` (injectable-clock hang detector),
    ``PreemptionGuard`` (SIGTERM -> save-and-exit).
  * ``faultinject`` — ``TrainFaultSource``: scheduled crash /
    corrupt-write / NaN-batch / preempt / hang faults so every behavior
    above is testable on the CPU.
  * ``background``  — ``BackgroundSaver``: the same atomic saves on a
    worker thread (at most one in flight) once every leaf is copied to
    the host (``train --async-save``).
"""

from mpi_vision_tpu_torch.ckpt.background import BackgroundSaver
from mpi_vision_tpu_torch.ckpt.faultinject import (
    SimulatedCrash,
    TrainFault,
    TrainFaultSource,
)
from mpi_vision_tpu_torch.ckpt.guards import (
    NanGuard,
    NonFiniteLossError,
    PreemptionGuard,
    StallWatchdog,
)
from mpi_vision_tpu_torch.ckpt.store import (
    CheckpointStore,
    CorruptCheckpointError,
    Restored,
    flatten_arrays,
    unflatten_arrays,
)

__all__ = [
    "BackgroundSaver",
    "CheckpointStore",
    "CorruptCheckpointError",
    "NanGuard",
    "NonFiniteLossError",
    "PreemptionGuard",
    "Restored",
    "SimulatedCrash",
    "StallWatchdog",
    "TrainFault",
    "TrainFaultSource",
    "flatten_arrays",
    "unflatten_arrays",
]
