"""Crash-safe training smoke: kill / corrupt / resume a tiny run, prove
bit-exact recovery.

The port's counterpart of the JAX package's ``bench/train_resume.py``.
Drives ``train.loop.fit_resumable`` + ``ckpt.CheckpointStore`` over a
procedurally generated batch stream (a pure function of (seed, epoch,
index) — the bit-exact-resume contract) with a tiny L2-loss model that
renders through ``method="fused_pallas"`` (the CUDA kernels on the card,
their plain versions on the CPU), and prints ONE JSON line (stdout;
diagnostics on stderr)::

  {"metric": "train_resume", "value": <final_step>, "unit": "steps",
   "digest": <sha256 of the final checkpoint's arrays>,
   "resumed_from": ..., "preempted": ..., "nan_rollbacks": ...,
   "quarantined": ..., "saves": ..., "device": ...}

``digest`` hashes the final SAVED checkpoint (model + Adam state + LR +
step, read back from disk): two runs that print the same digest walked
bit-identical parameter streams AND round-tripped them through the store.

Scheduled faults make it a crash-test victim:

  --crash-at N        hard-SIGKILL the process (from inside the fault
                      source) before global step N; rerunning with the
                      same --dir resumes from the newest good checkpoint.
  --soft-crash-at N   ``SimulatedCrash`` instead (nonzero rc, atexit
                      still runs).
  --corrupt-save N    corrupt (truncate) the checkpoint published by save
                      index N after it lands: resume must quarantine it,
                      fall back to the previous good one, and STILL reach
                      the bit-identical digest.
  --nan-at N          poison the batch at step N (NaN guard rollback + LR
                      cut).
  --preempt-at N      set the preemption flag at step N (SIGTERM
                      semantics without a signal).

``--selftest`` runs the whole story in ONE process — fresh run, soft
crash, resume, digest comparison. ``--device`` is ``cuda`` unless the
caller asks for ``cpu``; without a card ``cuda`` raises.

Usage: python -m mpi_vision_tpu_torch.tools.train_resume --selftest --device cpu
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile

import numpy as np
import torch


def _log(msg: str) -> None:
  print(msg, file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--dir", default="",
                  help="checkpoint store root (required unless --selftest)")
  ap.add_argument("--epochs", type=int, default=3)
  ap.add_argument("--batches", type=int, default=4,
                  help="batches per epoch")
  ap.add_argument("--save-every", type=int, default=2)
  ap.add_argument("--keep", type=int, default=8)
  ap.add_argument("--img-size", type=int, default=16)
  ap.add_argument("--planes", type=int, default=2)
  ap.add_argument("--lr", type=float, default=1e-3)
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                  help="training device; cuda fails without a card")
  ap.add_argument("--fresh", action="store_true",
                  help="ignore existing checkpoints (resume='never')")
  ap.add_argument("--crash-at", type=int, default=-1)
  ap.add_argument("--soft-crash-at", type=int, default=-1)
  ap.add_argument("--corrupt-save", type=int, default=-1)
  ap.add_argument("--nan-at", type=int, default=-1)
  ap.add_argument("--preempt-at", type=int, default=-1)
  ap.add_argument("--selftest", action="store_true",
                  help="one-process crash+resume bit-exactness check")
  return ap


def make_batch(seed: int, epoch: int, index: int, hw: int, planes: int,
               device) -> dict[str, torch.Tensor]:
  """One synthetic batch, a pure function of (seed, epoch, index)."""
  rng = np.random.default_rng([seed, epoch, index])
  pose = np.eye(4, dtype=np.float32)
  pose[0, 3] = 0.04
  half = np.float32(hw / 2)
  k = np.array([[half, 0, half], [0, half, half], [0, 0, 1]], np.float32)
  batch = {
      "net_input": rng.uniform(
          -1, 1, (1, hw, hw, 3 + 3 * planes)).astype(np.float32),
      "ref_img": rng.uniform(-1, 1, (1, hw, hw, 3)).astype(np.float32),
      "tgt_img": rng.uniform(-1, 1, (1, hw, hw, 3)).astype(np.float32),
      "tgt_img_cfw": np.stack([pose]),
      "ref_img_wfc": np.stack([np.eye(4, dtype=np.float32)]),
      "intrinsics": np.stack([k]),
      "mpi_planes": np.linspace(1.0, 0.01, planes, dtype=np.float32),
  }
  return {key: torch.from_numpy(v).to(device) for key, v in batch.items()}


def store_digest(store) -> str:
  """sha256 over the newest checkpoint's arrays (read back from disk)."""
  restored = store.restore()
  if restored is None:
    return ""
  h = hashlib.sha256()
  for key in sorted(restored.arrays):
    arr = np.asarray(restored.arrays[key], order="C")
    h.update(key.encode())
    h.update(str(arr.dtype).encode())
    h.update(arr.tobytes())
  return h.hexdigest()


def run(args, ckpt_dir: str, resume: str) -> dict:
  from mpi_vision_tpu_torch.ckpt import (
      CheckpointStore,
      NanGuard,
      PreemptionGuard,
      TrainFault,
      TrainFaultSource,
  )
  from mpi_vision_tpu_torch.device import resolve_device
  from mpi_vision_tpu_torch.train import loop as train_loop

  device = resolve_device(args.device)
  if device.type == "cuda":
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
  faults = TrainFaultSource()
  if args.crash_at >= 0:
    faults.at_step(args.crash_at, TrainFault("crash", hard=True))
  if args.soft_crash_at >= 0:
    faults.at_step(args.soft_crash_at, TrainFault("crash", hard=False))
  if args.nan_at >= 0:
    faults.at_step(args.nan_at, TrainFault("nan"))
  if args.preempt_at >= 0:
    faults.at_step(args.preempt_at, TrainFault("preempt"))
  if args.corrupt_save >= 0:
    faults.at_save(args.corrupt_save, TrainFault("corrupt"))

  store = CheckpointStore(ckpt_dir, keep=args.keep,
                          fault_hook=faults.store_hook)
  state = train_loop.create_train_state(
      args.seed, num_planes=args.planes, learning_rate=args.lr, norm=None,
      device=device)
  step = train_loop.make_train_step(None, method="fused_pallas")

  def make_batches(epoch: int):
    return [make_batch(args.seed, epoch, i, args.img_size, args.planes,
                       device) for i in range(args.batches)]

  with PreemptionGuard() as preemption:
    state, report = train_loop.fit_resumable(
        state, args.epochs, make_batches, store, step=step,
        save_every=args.save_every, resume=resume,
        nan_guard=NanGuard(), preemption=preemption,
        fault_source=faults, log=_log,
        meta={"model": {"num_planes": args.planes,
                        "img_size": args.img_size, "norm": None}})
  # Digest the artifact a consumer would restore, not the in-memory
  # state: equality across runs proves store round-trip AND bit-exact
  # training in one check.
  digest = store_digest(CheckpointStore(ckpt_dir, keep=args.keep))
  return {
      "metric": "train_resume",
      "value": report["final_step"],
      "unit": "steps",
      "digest": digest,
      "resumed_from": report["resumed_from"],
      "preempted": report["preempted"],
      "nan_rollbacks": report["nan_rollbacks"],
      "quarantined": report["quarantined"],
      "saves": report["saves"],
      "losses": len(report["losses"]),
      "injected": faults.injected,
      "device": str(device),
  }


def selftest(args) -> dict:
  """Fresh / soft-crash / resume in one process; digests must agree."""
  from mpi_vision_tpu_torch.ckpt import SimulatedCrash

  base = argparse.Namespace(**vars(args))
  for field in ("crash_at", "soft_crash_at", "corrupt_save", "nan_at",
                "preempt_at"):
    setattr(base, field, -1)

  with tempfile.TemporaryDirectory(prefix="mpi_resume_self_") as root:
    clean = run(base, os.path.join(root, "clean"), resume="never")
    crash_dir = os.path.join(root, "crashed")
    crash_args = argparse.Namespace(**vars(base))
    crash_args.soft_crash_at = args.epochs * args.batches // 2
    try:
      run(crash_args, crash_dir, resume="never")
      raise SystemExit("selftest: scheduled crash never fired")
    except SimulatedCrash:
      _log(f"selftest: crashed at step {crash_args.soft_crash_at} as "
           "scheduled")
    resumed = run(base, crash_dir, resume="auto")
  ok = (clean["digest"] == resumed["digest"] and clean["digest"]
        and resumed["resumed_from"] is not None)
  if not ok:
    raise SystemExit(
        f"selftest: resumed digest {resumed['digest'][:12]} != clean "
        f"{clean['digest'][:12]} (resumed_from={resumed['resumed_from']})")
  return {
      "metric": "train_resume_selftest",
      "value": 1,
      "unit": "ok",
      "bit_exact": True,
      "final_step": clean["value"],
      "resumed_from": resumed["resumed_from"],
      "digest": clean["digest"],
      "device": clean["device"],
  }


def main(argv=None) -> int:
  args = build_parser().parse_args(argv)
  if args.selftest:
    print(json.dumps(selftest(args)))
    return 0
  if not args.dir:
    raise SystemExit("--dir is required (or pass --selftest)")
  out = run(args, os.path.abspath(args.dir),
            resume="never" if args.fresh else "auto")
  print(json.dumps(out))
  return 0


if __name__ == "__main__":
  sys.exit(main())
