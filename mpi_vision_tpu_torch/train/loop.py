"""Training loop: the Adam train step and a minimal epoch driver.

PyTorch counterpart of the single-device part of
``mpi_vision_tpu/train/loop.py``. There the step is a pure jitted
``(state, batch) -> (state, metrics)``; here ``TrainState`` holds the model
and a ``torch.optim.Adam`` whose defaults are optax's (b1 0.9, b2 0.999,
eps 1e-8), and the step updates it in place and returns it, so callers
read the same shape of code.

  * ``make_loss_fn`` — VGG-perceptual loss (or L2) with the render inside;
    ``method="fused_pallas"`` renders through the CUDA kernels, forward and
    backward, ``"fused"`` through the plain per-plane loop.
  * ``make_train_step`` / ``make_eval_step`` / ``evaluate`` / ``fit``.
  * ``lr_find`` — the reference's learning-rate sweep (cell 14).
  * ``fit_resumable`` — the crash-safe epoch driver over a
    ``ckpt.CheckpointStore``: atomic periodic saves, SIGTERM preemption
    saves, NaN rollback with an LR cut, stall watchdog, and bit-exact
    resume (the model, Adam's moments and step counts, the LR, the step
    and the data cursor), through ``checkpoint_tree`` and
    ``load_checkpoint_tree``; ``save_checkpoint`` / ``restore_checkpoint``
    write and read one such tree in a directory.

The LR lives in ``optimizer.param_groups``, so it is always adjustable
(the JAX package needs ``mutable_lr=True`` for that) and rides in every
checkpoint as a float64 leaf.

Not ported yet: the sharded steps.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import inspect
import math
import os
import sys
from typing import Callable, Iterable, Mapping

import numpy as np
import torch

from mpi_vision_tpu_torch.device import resolve_device
from mpi_vision_tpu_torch.models.stereo_mag import StereoMagnificationModel
from mpi_vision_tpu_torch.train import loss as loss_lib
from mpi_vision_tpu_torch.train import vgg as vgg_lib

Batch = Mapping[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
  """The model, its Adam state, and the count of optimizer steps taken."""

  model: StereoMagnificationModel
  optimizer: torch.optim.Adam
  step: int = 0


def create_train_state(seed: int = 0, num_planes: int = 10,
                       learning_rate: float = 2e-4,
                       norm: str | None = "instance",
                       device: "str | torch.device | None" = None,
                       dtype: torch.dtype | None = None) -> TrainState:
  """A fresh model (PyTorch's default init drawn under ``seed``, leaving
  the global generator as it was) and Adam at ``learning_rate``, on
  ``device`` (default the card; raises without one unless ``"cpu"``).
  ``dtype`` is the U-Net's conv computation dtype (None = f32); its
  parameters are f32 either way."""
  device = resolve_device(device)
  with torch.random.fork_rng(devices=[]):
    torch.manual_seed(seed)
    model = StereoMagnificationModel(num_planes=num_planes, norm=norm,
                                     dtype=dtype)
  model.to(device)
  return TrainState(model=model, optimizer=_adam(model, learning_rate))


def _adam(model: torch.nn.Module, learning_rate: float) -> torch.optim.Adam:
  """Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
  return torch.optim.Adam(model.parameters(), lr=learning_rate,
                          betas=(0.9, 0.999), eps=1e-8)


def current_learning_rate(state: TrainState) -> float:
  """The learning rate of the optimizer's next update."""
  lrs = {float(group["lr"]) for group in state.optimizer.param_groups}
  if len(lrs) != 1:
    raise ValueError(f"param groups disagree on the learning rate: {lrs}")
  return lrs.pop()


def set_learning_rate(state: TrainState, learning_rate: float) -> TrainState:
  """Make the NEXT update use ``learning_rate`` (in place; returns
  ``state``, as the JAX package returns the new state)."""
  for group in state.optimizer.param_groups:
    group["lr"] = float(learning_rate)
  return state


def make_loss_fn(vgg: vgg_lib.VGG16Features | None,
                 resize: int | None = 224,
                 method: str = "fused") -> Callable[[torch.nn.Module, Batch],
                                                    torch.Tensor]:
  """``(model, batch) -> loss``: VGG-perceptual when ``vgg`` is given,
  else L2."""

  def loss_fn(model, batch):
    mpi_pred = model(batch["net_input"])
    if vgg is None:
      return loss_lib.l2_render_loss(mpi_pred, batch, method=method)
    return loss_lib.vgg_perceptual_loss(mpi_pred, batch, vgg, resize,
                                        method=method)

  return loss_fn


def make_train_step(vgg: vgg_lib.VGG16Features | None = None,
                    resize: int | None = 224, method: str = "fused"):
  """A ``(state, batch) -> (state, {"loss": tensor})`` Adam step. The loss
  stays a device tensor (no synchronise); ``state`` is updated in place."""
  loss_fn = make_loss_fn(vgg, resize, method)

  def step(state: TrainState, batch: Batch):
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(state.model, batch)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return state, {"loss": loss.detach()}

  return step


def make_eval_step(vgg: vgg_lib.VGG16Features | None = None,
                   resize: int | None = 224, method: str = "fused"):
  """A loss-only ``(state, batch) -> loss`` step on the same loss surface
  as ``make_train_step``, without gradients."""
  loss_fn = make_loss_fn(vgg, resize, method)

  def step(state: TrainState, batch: Batch) -> torch.Tensor:
    with torch.no_grad():
      return loss_fn(state.model, batch)

  return step


def evaluate(state: TrainState, batches: Iterable[Batch],
             eval_step=None) -> float:
  """Mean loss over ``batches`` (losses stay on the device during the loop;
  one fetch at the end)."""
  eval_step = eval_step or make_eval_step()
  losses = [eval_step(state, batch) for batch in batches]
  if not losses:
    raise ValueError("evaluate: no batches")
  return float(torch.stack(losses).mean())


def fit(state: TrainState, batches: Iterable[Batch], step=None):
  """Minimal epoch driver: returns ``(state, per-step losses)``. Losses stay
  on the device during the loop and are fetched once at the end."""
  step = step or make_train_step()
  losses = []
  for batch in batches:
    state, metrics = step(state, batch)
    losses.append(metrics["loss"])
  if not losses:
    return state, []
  return state, torch.stack(losses).cpu().tolist()


def lr_find(state: TrainState, batches,
            vgg: vgg_lib.VGG16Features | None = None,
            resize: int | None = 224,
            method: str = "fused",
            lr_start: float = 1e-7,
            lr_end: float = 10.0,
            num_steps: int = 100,
            divergence_factor: float = 4.0,
            beta: float = 0.98) -> dict:
  """Exponential learning-rate sweep (the notebook's ``learn.lr_find()``,
  cell 14; cell 15 picks 2e-4 off the resulting curve).

  Runs up to ``num_steps`` Adam updates on a deep copy of ``state``'s
  model with a fresh Adam, stepping the learning rate geometrically from
  ``lr_start`` to ``lr_end`` and recording the loss, and stops early once
  the smoothed loss exceeds ``divergence_factor`` x the best seen
  (divergence) or turns non-finite. ``state`` is left untouched.

  Returns ``{"lrs", "losses", "smoothed", "suggestion"}`` where
  ``suggestion`` is the lr at the steepest descent of the smoothed curve
  (fastai's default heuristic), clipped away from the divergence tail.
  """
  if num_steps < 2:
    raise ValueError(f"lr_find needs num_steps >= 2, got {num_steps}")
  batch_list = list(batches) if not hasattr(batches, "__getitem__") \
      else batches
  if not len(batch_list):
    raise ValueError("lr_find needs at least one batch")
  model = copy.deepcopy(state.model)
  sweep = TrainState(model=model, optimizer=_adam(model, lr_start))
  step = make_train_step(vgg, resize, method)
  lrs = np.geomspace(lr_start, lr_end, num_steps)
  losses, smoothed, used = [], [], []
  avg, best = 0.0, float("inf")
  for i, lr in enumerate(lrs):
    set_learning_rate(sweep, float(lr))
    _, metrics = step(sweep, batch_list[i % len(batch_list)])
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
      break
    avg = beta * avg + (1 - beta) * loss
    smooth = avg / (1 - beta ** (i + 1))           # bias-corrected EMA
    losses.append(loss)
    smoothed.append(smooth)
    used.append(float(lr))
    best = min(best, smooth)
    if smooth > divergence_factor * best:
      break
  if len(used) < 2:
    raise ValueError(
        "lr_find diverged immediately: loss became non-finite at "
        f"lr={lrs[len(losses)]:.2e}; lower lr_start")
  # Steepest descent of the smoothed curve over log(lr), ignoring the
  # final climb into divergence (last ~10% of recorded points).
  tail = max(2, int(len(used) * 0.9))
  slopes = np.gradient(np.asarray(smoothed[:tail]),
                       np.log(np.asarray(used[:tail])))
  suggestion = float(used[int(np.argmin(slopes))])
  return {"lrs": used, "losses": losses, "smoothed": smoothed,
          "suggestion": suggestion}


# --- Crash-safe training (ckpt/ lifecycle) ---------------------------------


def _adam_state(optimizer: torch.optim.Optimizer) -> list[dict]:
  """Each parameter's Adam state, in ``param_groups`` order. A parameter
  that has not been stepped yet gets the state torch's Adam creates on
  its first step (a CPU float scalar ``step``, zero moments), so the
  anchor saved before the first step has the keys of every later save and
  restores into a fresh optimizer."""
  out = []
  for group in optimizer.param_groups:
    if group.get("amsgrad") or group.get("capturable") or group.get("fused"):
      raise ValueError("checkpoints cover Adam without amsgrad, capturable "
                       "or fused")
    for p in group["params"]:
      state = optimizer.state[p]
      if not state:
        state["step"] = torch.tensor(0.0)
        state["exp_avg"] = torch.zeros_like(
            p, memory_format=torch.preserve_format)
        state["exp_avg_sq"] = torch.zeros_like(
            p, memory_format=torch.preserve_format)
      out.append(state)
  return out


def checkpoint_tree(state: TrainState) -> dict:
  """Everything a bit-exact resume needs, as a nested dict of the live
  tensors (``CheckpointStore.save`` copies them): the model's state dict,
  Adam's ``exp_avg`` / ``exp_avg_sq`` / ``step`` per parameter in
  ``param_groups`` order, the LR (float64) and ``TrainState.step``."""
  return {
      "model": dict(state.model.state_dict()),
      "adam": [{key: s[key] for key in ("exp_avg", "exp_avg_sq", "step")}
               for s in _adam_state(state.optimizer)],
      "learning_rate": np.float64(current_learning_rate(state)),
      "step": np.int64(state.step),
  }


def _copy_into(dst: torch.Tensor, src: np.ndarray, what: str) -> None:
  src_t = torch.from_numpy(np.asarray(src))
  if src_t.shape != dst.shape or src_t.dtype != dst.dtype:
    raise ValueError(f"checkpoint {what} is {src_t.dtype}{list(src_t.shape)}"
                     f", the state holds {dst.dtype}{list(dst.shape)}")
  dst.copy_(src_t)


def load_checkpoint_tree(state: TrainState, tree: Mapping) -> TrainState:
  """The inverse of ``checkpoint_tree``: copy a restored tree of host
  arrays (``Restored.tree(checkpoint_tree(state))``) into ``state`` in
  place — every tensor keeps its dtype and device, Adam's ``step``
  included — and set its LR and step. Returns ``state``."""
  live = checkpoint_tree(state)
  if len(tree["adam"]) != len(live["adam"]):
    raise ValueError(f"checkpoint holds Adam state for {len(tree['adam'])} "
                     f"parameters, the optimizer has {len(live['adam'])}")
  with torch.no_grad():
    for name, tensor in live["model"].items():
      _copy_into(tensor, tree["model"][name], f"model {name!r}")
    for i, (dst, src) in enumerate(zip(live["adam"], tree["adam"])):
      for key, tensor in dst.items():
        _copy_into(tensor, src[key], f"adam[{i}] {key!r}")
  set_learning_rate(state, float(tree["learning_rate"]))
  state.step = int(tree["step"])
  return state


def _close_iter(it) -> None:
  """Close an abandoned batch iterator (generators stop their prefetch
  workers in their ``finally``); plain iterables are left alone."""
  close = getattr(it, "close", None)
  if close is not None:
    close()


def _batch_examples(batch) -> int:
  """Examples in one batch (the first tensor's leading dim; 1 when
  unknowable) — feeds the telemetry's examples/s gauge, never
  correctness."""
  leaf = batch
  while isinstance(leaf, (dict, list, tuple)) and leaf:
    leaf = next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
  shape = getattr(leaf, "shape", None)
  return int(shape[0]) if shape else 1


def _supports_skip(make_batches) -> bool:
  """Does ``make_batches`` accept an explicit ``skip`` keyword?

  Only a NAMED parameter counts — a bare ``**kwargs`` that silently
  swallows ``skip`` would yield the wrong stream (no seek happened) and
  break the bit-exact resume contract, so it routes to the replay path.
  """
  try:
    params = inspect.signature(make_batches).parameters
  except (TypeError, ValueError):  # builtins / C callables: no signature
    return False
  p = params.get("skip")
  return p is not None and p.kind in (
      inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.KEYWORD_ONLY)


def fit_resumable(state: TrainState, epochs: int, make_batches, store, *,
                  step=None, save_every: int = 0, meta: Mapping | None = None,
                  resume: str = "auto", nan_guard=None, watchdog=None,
                  preemption=None, fault_source=None, on_epoch=None,
                  telemetry=None, events=None, log=None):
  """Crash-safe epoch driver: periodic atomic checkpoints, bit-exact
  resume, NaN rollback, stall watchdog, preemption saves.

  The contract that makes resume BIT-EXACT: ``make_batches(epoch)``
  must be a pure function of its epoch index (seed per-epoch RNGs with
  the epoch number), and the step deterministic (no atomics; cuDNN in
  deterministic mode on the card). The loop records a data cursor —
  (epoch, batches consumed) — in every manifest, and a resumed run
  replays (or, with ``skip``, seeks) the current epoch's stream up to the
  cursor before continuing, so interrupted-then-resumed training walks
  the exact parameter stream of an uninterrupted run. Everything else
  that shapes the stream lives in the checkpoint (``checkpoint_tree``).

  Guard rails around the step:

    * non-finite loss -> restore last-good checkpoint, cut the LR by
      ``nan_guard.lr_cut``, re-walk from its cursor. The step has already
      updated the model in place when its loss is read, so every
      rollback restores from the store; the stepped tensors are never
      kept. The guard's rollback budget bounds the retries; with
      ``nan_guard=None`` a non-finite loss raises ``NonFiniteLossError``
      immediately.
    * ``watchdog`` (``ckpt.StallWatchdog``) is beaten after every step
      (and through restore + cursor replay, which are host work, not
      hangs) and its monitor thread is started/stopped around the loop.
      The first step's kernel build counts toward the idle window.
    * ``preemption`` (``ckpt.PreemptionGuard``) — when its flag is set
      (SIGTERM, or a scheduled ``preempt`` fault) the loop saves a
      checkpoint tagged ``"preempt"`` at the next step boundary and
      returns early with ``report["preempted"] = True``.
    * ``fault_source`` (``ckpt.TrainFaultSource``) injects scheduled
      crash / NaN-batch / preempt / hang faults; pass its ``store_hook``
      to the ``CheckpointStore`` to also fault saves.

  Checkpoints land at every epoch boundary (deduped when a periodic
  save already covered that exact step), every ``save_every`` steps
  (0 = boundaries only), on preemption, and once up front when the
  store is empty (the rollback anchor). Losses are fetched per step:
  the NaN check needs the value on the host.

  Args:
    state: initial ``TrainState`` (overwritten in place when a
      checkpoint is restored; its structure must match).
    epochs: total epoch count (the resume cursor counts toward it).
    make_batches: ``epoch -> iterable of batches`` (pure per epoch).
      May additionally accept an explicit ``skip`` keyword — then a
      resume seeks straight to its data cursor (``make_batches(e,
      skip=b)`` must yield exactly the stream ``make_batches(e)`` yields
      after ``b`` batches) instead of replaying ``b`` dead batches.
    store: a ``ckpt.CheckpointStore`` (or ``ckpt.BackgroundSaver`` for
      background-thread serialization; the loop flushes it on exit).
    step: the ``(state, batch) -> (state, metrics)`` step; default
      ``make_train_step()``.
    save_every: additional save cadence in optimizer steps.
    meta: extra manifest metadata (the model config).
    resume: "auto" (restore newest good checkpoint if any), "never"
      (fresh start; published checkpoints from earlier runs are cleared
      so rollback can never land on a stale one), or "must" (raise if
      nothing restorable).
    nan_guard / watchdog / preemption / fault_source: see above.
    on_epoch: optional ``(state, epoch, epoch_losses) -> None`` called
      after each epoch-boundary save, at most once per epoch — a NaN
      rollback that re-finishes a reported epoch does not re-fire it.
    telemetry: optional ``train.telemetry.TrainMetrics`` — the loop
      records every step (wall time from before the step to the loss
      read, which synchronises with the card), save, restore, rollback,
      preemption and epoch into it.
    events: optional ``obs.events.EventLog`` for loop-level lifecycle
      events (``nan_rollback``, ``preempt``); the store emits its own
      save / restore / quarantine events when built with one.
    log: optional ``str -> None`` diagnostics sink.

  Returns:
    ``(state, report)`` — report keys: ``losses`` (this invocation's
    per-step losses), ``final_step``, ``resumed_from`` (step or None),
    ``preempted``, ``nan_rollbacks``, ``nan_rollback_steps``, ``saves``,
    ``quarantined``.
  """
  from mpi_vision_tpu_torch.ckpt.guards import (
      NonFiniteLossError,
      PreemptionGuard,
  )

  if resume not in ("auto", "never", "must"):
    raise ValueError(f"resume must be auto/never/must, got {resume!r}")
  if save_every < 0:
    # A negative cadence would "work" via negative modulo (saving every
    # |n| steps), silently masking a caller bug.
    raise ValueError(f"save_every must be >= 0, got {save_every}")
  step = step or make_train_step()
  preempt = preemption if preemption is not None else PreemptionGuard()
  say = log if log is not None else (lambda _msg: None)
  # The live tree: its keys are the restore template, and restores copy
  # into its tensors in place.
  template = checkpoint_tree(state)
  user_meta = dict(meta or {})

  def restore_latest():
    return store.restore(
        template=template,
        on_quarantine=lambda s, r: say(
            f"ckpt: quarantined step {s} ({r}); falling back"))

  resumed_from = None
  e, b = 0, 0
  if resume == "never":
    # Fresh start over a used store: clear published history so the NaN
    # rollback can never "restore" a stale checkpoint from a previous
    # run (quarantined evidence is kept).
    cleared = store.clear()
    if cleared:
      say(f"ckpt: resume='never' cleared {len(cleared)} old checkpoint(s)")
  else:
    restored = restore_latest()
    if restored is None:
      if resume == "must":
        raise FileNotFoundError(
            f"resume='must' but no restorable checkpoint under {store.root}")
    else:
      load_checkpoint_tree(state, restored.tree(template))
      cursor = restored.meta.get("cursor", {})
      e, b = int(cursor.get("epoch", 0)), int(cursor.get("batch", 0))
      resumed_from = restored.step
      if telemetry is not None:
        telemetry.record_restore(restored.step)
      say(f"ckpt: resumed from step {restored.step} "
          f"(epoch {e}, batch {b})")

  # losses[0] is the loss of the step that advanced state.step past
  # losses_base; a rollback below it (quarantined anchor) moves the base.
  losses_base = state.step
  losses: list[float] = []
  rollback_steps: list[int] = []

  def wd_quiet():
    # Host-side checkpoint I/O (save, rollback restore + re-hash) is not
    # a device hang: suspend the monitor for its whole duration (a beat
    # could not survive work longer than the timeout); re-arms on exit.
    return (watchdog.suspended() if watchdog is not None
            else contextlib.nullcontext())

  def finish_report(preempted: bool):
    # A BackgroundSaver may still be writing the save this report must
    # count (preempt save, final epoch save): join it BEFORE reading the
    # store's accounting. The finally-block flush stays as the
    # exception-path net.
    flush = getattr(store, "flush", None)
    if flush is not None:
      with wd_quiet():
        flush()
    return {
        "losses": list(losses),
        "final_step": state.step,
        "resumed_from": resumed_from,
        "preempted": preempted,
        "nan_rollbacks": 0 if nan_guard is None else nan_guard.rollbacks,
        "nan_rollback_steps": list(rollback_steps),
        "saves": store.saves,
        "quarantined": store.quarantined,
    }

  def save(reason: str) -> None:
    cur_meta = {"cursor": {"epoch": e, "batch": b}, "reason": reason,
                "learning_rate": current_learning_rate(state), **user_meta}
    with wd_quiet():
      store.save(state.step, checkpoint_tree(state), meta=cur_meta)
    if telemetry is not None:
      # The store stamps the published save's cost; a BackgroundSaver
      # reports the previously completed one (this loop never waited on
      # the current write).
      telemetry.record_save(state.step,
                            getattr(store, "last_save_s", 0.0),
                            getattr(store, "last_save_bytes", 0),
                            reason=reason)

  if store.latest_step() is None:
    save("initial")  # the rollback anchor for fresh runs

  if watchdog is not None:
    if not watchdog.running:
      watchdog.start()
    # Arm fresh: restore + per-array re-hashing happen before any step
    # completes, and must not count as device idle time.
    watchdog.beat()
  # Where each epoch's retained losses begin in ``losses`` — survives
  # intra-epoch NaN rollbacks (setdefault keeps the original start), so
  # on_epoch sees the WHOLE epoch's retained stream.
  epoch_loss_start: dict[int, int] = {}
  last_reported = -1  # highest epoch already handed to on_epoch
  try:
    while e < epochs:
      epoch_loss_start.setdefault(e, len(losses))
      # Skip-ahead cursor seek: a make_batches that takes ``skip`` (e.g.
      # over data/realestate.iterate_batches) jumps straight to the
      # cursor instead of materializing b dead batches. A cursor past the
      # stream's end simply yields an empty epoch, the same close-out the
      # replay path's StopIteration handler does.
      skip_ahead = b > 0 and _supports_skip(make_batches)
      with wd_quiet():
        # Building the epoch's data pipeline is host work between beats,
        # same family as checkpoint I/O.
        it = iter(make_batches(e, skip=b) if skip_ahead
                  else make_batches(e))
      if skip_ahead:
        say(f"ckpt: skip-ahead to cursor batch {b} of epoch {e}")
      try:
        if not skip_ahead:
          for _ in range(b):  # replay the data stream up to the cursor
            next(it)
            if watchdog is not None:
              watchdog.beat()  # host-side replay progress, not a hang
      except StopIteration:
        # The epoch is shorter than the cursor (dataset shrank between
        # runs): close the epoch out rather than crash on the skip.
        say(f"ckpt: cursor batch {b} beyond epoch {e}'s stream; "
            "advancing to the next epoch")
        it = iter(())
      rolled = False
      for batch in it:
        fault = (fault_source.on_step(state.step)
                 if fault_source is not None else None)
        if fault is not None and fault_source.fire_step(fault, preempt):
          batch = fault_source.poison_batch(batch)
        if preempt.requested.is_set():
          save("preempt")
          if telemetry is not None:
            telemetry.record_preemption(state.step)
          if events is not None:
            events.emit("preempt", step=state.step)
          say(f"ckpt: preempted at step {state.step}; saved")
          _close_iter(it)
          return state, finish_report(preempted=True)
        at = state.step
        t_step = telemetry.clock() if telemetry is not None else 0.0
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
          if nan_guard is None:
            raise NonFiniteLossError(at, loss)
          nan_guard.note_rollback(at, loss)
          with wd_quiet():
            restored = restore_latest()
          if (restored is not None and restored.step == at
              and any(s < restored.step for s in store.steps())):
            # The newest checkpoint IS the state that just produced the
            # NaN (save landed right before the bad batch): restoring it
            # replays the identical (params, batch) pair — the LR cut
            # only changes FUTURE updates. Quarantine it (evidence, and
            # it must not stay published: a later rollback from an
            # earlier step would jump FORWARD into the known-bad state)
            # and fall back to the next-newest good checkpoint.
            store.quarantine(restored.step, "nan-replay-anchor")
            with wd_quiet():
              restored = restore_latest()
          # (With no earlier checkpoint the same state replays as-is —
          # correct for TRANSIENT NaNs; the rollback budget bounds the
          # deterministic-NaN case.)
          if restored is None:
            raise NonFiniteLossError(
                at, loss, "no checkpoint left to roll back to")
          rollback_steps.append(restored.step)
          if telemetry is not None:
            telemetry.record_rollback(restored.step)
          if events is not None:
            events.emit("nan_rollback", to_step=restored.step,
                        at_step=at, loss=repr(loss))
          with wd_quiet():
            load_checkpoint_tree(state, restored.tree(template))
          old_lr = current_learning_rate(state)
          set_learning_rate(state, old_lr * nan_guard.lr_cut)
          say(f"ckpt: non-finite loss at step {restored.step}+; rolled "
              f"back, lr {old_lr:.3g} -> {old_lr * nan_guard.lr_cut:.3g}")
          cursor = restored.meta.get("cursor", {})
          e, b = int(cursor.get("epoch", 0)), int(cursor.get("batch", 0))
          del losses[max(0, restored.step - losses_base):]
          losses_base = min(losses_base, restored.step)
          # Entries for epochs past the restore point (or pointing past
          # the truncated list) are stale passes; drop them so re-entry
          # records a fresh start index.
          epoch_loss_start = {ep: i for ep, i in epoch_loss_start.items()
                              if ep <= e and i <= len(losses)}
          # Persist the cut (overwrite the restored step): if the replay
          # NaNs again before any new save, the next rollback restores
          # the ALREADY-cut LR and cuts again — the cut compounds instead
          # of retrying the same LR forever.
          save("nan-rollback")
          rolled = True
          break
        losses.append(loss)
        b += 1
        if telemetry is not None:
          # The loss read above synchronised with the card, so the window
          # [t_step, now] covers the launches and the device work.
          telemetry.record_step(state.step, loss,
                                telemetry.clock() - t_step,
                                examples=_batch_examples(batch),
                                lr=current_learning_rate(state))
        if watchdog is not None:
          watchdog.beat()
        if save_every and state.step % save_every == 0:
          save("periodic")
      if rolled:
        # Abandoning the iterator mid-epoch: shut its machinery down
        # (prefetch threads) BEFORE the next make_batches call, so a
        # lingering worker cannot keep consuming shared RNG state while
        # the replay stream is being rebuilt.
        _close_iter(it)
        continue
      finished = e
      e, b = e + 1, 0
      if telemetry is not None:
        telemetry.record_epoch(finished)
      if store.latest_step() != state.step:
        # Skipped when a periodic save already landed on this exact
        # step: the re-save would rewrite identical arrays (the two
        # cursors differ but resume identically).
        save("epoch")
      start = epoch_loss_start.pop(finished, len(losses))
      if on_epoch is not None and finished > last_reported:
        # Exactly once per epoch: a NaN rollback that re-enters an
        # already-reported epoch re-finishes it with only the re-walked
        # tail in memory.
        last_reported = finished
        with wd_quiet():
          # A validation pass hangs off on_epoch; like checkpoint I/O it
          # runs between beats.
          on_epoch(state, finished, losses[start:])
  finally:
    flush = getattr(store, "flush", None)
    if flush is not None:
      # A BackgroundSaver may still be writing (preempt save, final
      # epoch save): the caller must find every save published on
      # return. During an exception unwind a flush failure is logged,
      # not raised — it must not mask the original error.
      unwinding = sys.exc_info()[1] is not None
      try:
        with wd_quiet():
          flush()
      except BaseException as fe:  # noqa: BLE001 - see above
        if not unwinding:
          raise
        say(f"ckpt: background save failed during unwind: {fe!r}")
    if watchdog is not None:
      watchdog.stop()
  return state, finish_report(preempted=False)


# --- One checkpoint in a directory -------------------------------------------


def save_checkpoint(path: str, state: TrainState,
                    overwrite: bool = False) -> str:
  """Write ``checkpoint_tree(state)`` to the directory ``path`` as one
  ``mpi-ckpt-v1`` checkpoint; returns its dir. ``overwrite=False`` (the
  default) refuses an existing ``path``; True replaces what it holds."""
  from mpi_vision_tpu_torch.ckpt.store import CheckpointStore

  if os.path.exists(path) and not overwrite:
    raise FileExistsError(
        f"{path} exists; pass overwrite=True to replace it")
  store = CheckpointStore(path, keep=1)
  store.clear()
  return store.save(state.step, checkpoint_tree(state),
                    meta={"learning_rate": current_learning_rate(state)})


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
  """Load the checkpoint ``save_checkpoint`` wrote to ``path`` into
  ``state`` in place (same model and optimizer); returns ``state``."""
  from mpi_vision_tpu_torch.ckpt.store import CheckpointStore

  if not os.path.isdir(path):
    raise FileNotFoundError(f"no checkpoint directory at {path}")
  template = checkpoint_tree(state)
  restored = CheckpointStore(path).restore(template=template)
  if restored is None:
    raise FileNotFoundError(f"no restorable checkpoint under {path}")
  return load_checkpoint_tree(state, restored.tree(template))
