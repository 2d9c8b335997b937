"""Command-line entry point: ``python -m mpi_vision_tpu_torch <command>``.

  * ``train`` — train the stereo-magnification U-Net (train/) on a
    RealEstate10K-layout dataset or the procedural ``--synthetic`` one, with
    the VGG-perceptual loss rendered through the CUDA kernels forward and
    backward (``--planned-render``, the default), on the card
    (``--device cuda``, the default) or, when asked, the CPU. ``--lr-find``
    sweeps the learning rate first; with ``--ckpt`` the run is crash-safe
    (ckpt/: atomic checkpoints, NaN rollback, preemption saves, bit-exact
    ``--resume``).
  * ``serve`` — run the batched render-serving subsystem (serve/): scene
    cache + micro-batching scheduler + HTTP front end (``/render``,
    ``/healthz``, ``/stats``, ``/debug/traces``) over synthetic scenes, on
    the card (``--device cuda``, the default) or, when asked, the CPU;
    ``--tiled`` serves tile-granular scenes (serve/tiles.py) through the
    warp and the CUDA compose kernel (``--method pallas``).

Prints a one-line JSON summary on stdout (diagnostics on stderr).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _log(msg: str) -> None:
  print(msg, file=sys.stderr, flush=True)


def _write_port_file(path: str, port: int) -> None:
  """Atomic write (tmp + rename): a supervisor polling the file must
  never read a half-written port number."""
  tmp_path = path + ".tmp"
  with open(tmp_path, "w") as fh:
    fh.write(str(port))
  os.replace(tmp_path, path)


class _MethodAction(argparse.Action):
  """Stores ``--method`` and notes that it was given: ``--tiled`` without
  it renders with 'pallas', the method that takes tile crops."""

  def __call__(self, parser, namespace, values, option_string=None):
    setattr(namespace, self.dest, values)
    namespace.method_given = True


def cmd_train(args: argparse.Namespace) -> dict:
  import atexit
  import itertools
  import tempfile

  import numpy as np
  import torch

  from mpi_vision_tpu_torch import config
  from mpi_vision_tpu_torch.data import realestate
  from mpi_vision_tpu_torch.device import resolve_device
  from mpi_vision_tpu_torch.train import loop as train_loop

  if args.save_every < 0:
    raise SystemExit(f"--save-every must be >= 0, got {args.save_every}")
  if args.keep is not None and args.keep < 1:
    raise SystemExit(f"--keep must be >= 1, got {args.keep}")
  if not args.ckpt:
    # These flags only act through the checkpoint path; silently taking
    # the open-loop branch would drop the crash safety the user asked
    # for (no checkpoints would ever be written).
    wants_ckpt = [flag for flag, on in (
        ("--resume", args.resume),
        ("--save-every", args.save_every > 0),
        ("--keep", args.keep is not None),
        ("--nan-guard/--no-nan-guard", args.nan_guard is not None),
        ("--async-save", args.async_save),
        ("--stall-timeout-s", args.stall_timeout_s > 0),
        ("--inject-fault", bool(args.inject_fault))) if on]
    if wants_ckpt:
      raise SystemExit(
          f"{', '.join(wants_ckpt)} require(s) --ckpt <dir>")
  fault_source = None
  if args.inject_fault:
    # Parse at the door: a typo'd fault spec must fail the invocation,
    # not silently arm nothing (the drill would then "pass").
    from mpi_vision_tpu_torch.train import faultinject as fault_lib

    try:
      fault_source = fault_lib.build_source(args.inject_fault)
    except fault_lib.FaultSpecError as e:
      raise SystemExit(str(e)) from None

  device = resolve_device(args.device)
  root = args.dataset
  if args.synthetic:
    if root is None:
      # No explicit destination: a temp dir removed at exit.
      tmp_holder = tempfile.TemporaryDirectory(prefix="mpi_synth_")
      atexit.register(tmp_holder.cleanup)
      root = tmp_holder.name
    realestate.synthesize_dataset(
        root, num_scenes=args.synthetic_scenes, frames=4,
        img_size=args.img_size, seed=0)
    _log(f"synthesized dataset at {root}")
  elif root is None:
    raise SystemExit("--dataset is required (or pass --synthetic)")

  cfg = config.TrainConfig(
      data=config.DataConfig(dataset_path=root, img_size=args.img_size,
                             num_planes=args.num_planes),
      learning_rate=args.lr, epochs=args.epochs,
      vgg_resize=args.vgg_resize if args.vgg_resize > 0 else None)
  cfg.set_precision()
  if args.ckpt and device.type == "cuda":
    # Bit-exact resume needs a step whose bits do not depend on the run:
    # cuDNN's deterministic algorithms, chosen without benchmarking.
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
  state = cfg.make_train_state(args.seed, device)
  # The VGG weights are resolved once (MPI_VISION_VGG16_CKPT may name a
  # checkpoint on disk) and shared by the sweep, the step and the eval.
  vgg = cfg.make_vgg(device) if args.vgg_loss else None
  method = "fused_pallas" if args.planned_render else "fused"
  _log(f"train: {cfg.data.img_size}px x {cfg.data.num_planes} planes on "
       f"{device}, render method {method}, cuDNN TF32 "
       f"{torch.backends.cudnn.allow_tf32}, cuDNN deterministic "
       f"{torch.backends.cudnn.deterministic}")
  dataset = None

  def the_dataset():
    # Lazy: the --ckpt path never reads this object (make_batches builds
    # a fresh per-epoch dataset).
    nonlocal dataset
    if dataset is None:
      dataset = cfg.data.make_dataset(rng=np.random.default_rng(args.seed),
                                      device=device)
    return dataset

  lr_found = None
  if args.lr_find:
    # Sweep the SAME loss surface training will use (VGG vs L2, resize,
    # render method), on at most num_steps batches (the sweep cycles
    # them), from the state training starts from.
    sweep_batches = list(itertools.islice(
        realestate.iterate_batches(
            the_dataset(), batch_size=cfg.data.batch_size,
            rng=np.random.default_rng(args.seed + 2)),
        args.lr_find_steps))
    found = train_loop.lr_find(
        state, sweep_batches, vgg, resize=cfg.vgg_resize, method=method,
        num_steps=args.lr_find_steps)
    lr_found = found["suggestion"]
    _log(f"lr_find: suggestion {lr_found:.2e} over {len(found['lrs'])} "
         f"steps (smoothed loss {found['smoothed'][0]:.4f} -> "
         f"{min(found['smoothed']):.4f})")
    train_loop.set_learning_rate(state, lr_found)  # lr_find trained a copy
  step = cfg.make_train_step(vgg, method)

  # Per-epoch validation on the test split's fixed triplets (the
  # reference reports train and valid loss each epoch).
  valid_batches, eval_step = [], None
  if args.valid:
    valid_ds = cfg.data.make_dataset(is_valid=True, device=device)
    if len(valid_ds):
      valid_batches = list(realestate.iterate_batches(
          valid_ds, batch_size=cfg.data.batch_size, shuffle=False))
      eval_step = cfg.make_eval_step(vgg, method)
    else:
      _log("valid: test split empty; skipping per-epoch validation")

  t0 = time.time()
  all_losses, valid_losses = [], []
  ckpt_report = None

  def log_epoch(epoch_state, epoch, losses):
    if not losses:
      return
    msg = f"epoch {epoch}: train loss {np.mean(losses):.4f}"
    if valid_batches:
      valid_losses.append(train_loop.evaluate(epoch_state, valid_batches,
                                              eval_step))
      msg += f" valid loss {valid_losses[-1]:.4f}"
    _log(msg + f" ({time.time() - t0:.0f}s elapsed)")

  if args.ckpt:
    # Crash-safe path: atomic manifest'd checkpoints, SIGTERM preemption
    # saves, NaN rollback + LR cut, bit-exact resume (ckpt/ and the
    # fit_resumable contract: the batch stream is a pure function of the
    # epoch index, so the data cursor in each manifest replays exactly).
    from mpi_vision_tpu_torch.ckpt import (
        BackgroundSaver,
        CheckpointStore,
        NanGuard,
        PreemptionGuard,
        StallWatchdog,
    )

    scene_list = None  # the load_scenes walk, shared across epochs

    def make_batches(epoch: int, skip: int = 0):
      # A FRESH dataset object per call (not a reseed of a shared one): a
      # prefetch worker from an abandoned iterator (NaN rollback) may
      # still be drawing triplets, and sharing one RNG with it would make
      # the replayed stream nondeterministic. The scene list is a
      # deterministic function of the path, so the directory walk
      # happens once. ``skip`` is fit_resumable's cursor seek.
      nonlocal scene_list
      epoch_ds = cfg.data.make_dataset(
          rng=np.random.default_rng([args.seed, 101, epoch]),
          scenes=scene_list, device=device)
      scene_list = epoch_ds.scenes
      return realestate.prefetch_batches(realestate.iterate_batches(
          epoch_ds, batch_size=cfg.data.batch_size,
          rng=np.random.default_rng([args.seed, 202, epoch]), skip=skip))

    store = CheckpointStore(
        os.path.abspath(args.ckpt),
        keep=args.keep if args.keep is not None else 3,
        fault_hook=(fault_source.store_hook
                    if fault_source is not None else None))
    if args.async_save:
      # Background-thread serialization: the step loop keeps training
      # while the previous state hashes/serializes/fsyncs; the loop
      # flushes on exit so every save is published by the time the
      # summary prints.
      store = BackgroundSaver(store, log=_log)

    def on_stall(idle):
      _log(f"train: WATCHDOG no step completed in {idle:.0f}s "
           "(device hang?)")

    watchdog = (StallWatchdog(args.stall_timeout_s, on_stall=on_stall)
                if args.stall_timeout_s > 0 else None)
    with PreemptionGuard() as preemption:
      state, ckpt_report = train_loop.fit_resumable(
          state, cfg.epochs, make_batches, store, step=step,
          save_every=args.save_every,
          meta={"model": cfg.model_meta(), "seed": args.seed},
          resume="auto" if args.resume else "never",
          nan_guard=None if args.nan_guard is False else NanGuard(),
          watchdog=watchdog, preemption=preemption,
          fault_source=fault_source, on_epoch=log_epoch, log=_log)
    if args.resume and ckpt_report["resumed_from"] is not None:
      # Bit-exact resume restored the WHOLE optimizer state, including
      # the checkpointed learning rate — an explicit --lr only seeds
      # fresh runs. Said only after an ACTUAL restore: over an empty (or
      # all-corrupt) store --resume starts fresh and --lr IS used.
      _log("train: --resume keeps the checkpointed optimizer state "
           "(including its learning rate); --lr applies to fresh runs "
           "only")
    all_losses = ckpt_report["losses"]
    _log(f"checkpoint store at {args.ckpt} "
         f"(final step {ckpt_report['final_step']}, "
         f"{ckpt_report['saves']} saves"
         + (", PREEMPTED" if ckpt_report["preempted"] else "") + ")")
  else:
    order = np.random.default_rng(args.seed + 1)
    for epoch in range(cfg.epochs):
      state, losses = train_loop.fit(
          state, realestate.prefetch_batches(realestate.iterate_batches(
              the_dataset(), batch_size=cfg.data.batch_size, rng=order)),
          step=step)
      all_losses.extend(losses)
      log_epoch(state, epoch, losses)
  if not all_losses and not (ckpt_report is not None
                             and (ckpt_report["resumed_from"] is not None
                                  or ckpt_report["preempted"])):
    raise SystemExit(
        "no training steps ran: check --epochs and that the dataset has at "
        "least batch_size scenes")
  return {
      "command": "train",
      **({"lr_found": lr_found} if lr_found is not None else {}),
      "epochs": cfg.epochs,
      "steps": len(all_losses),
      **({"first_loss": round(all_losses[0], 5),
          "final_loss": round(all_losses[-1], 5)} if all_losses else {}),
      "nonfinite_losses": int(np.sum(~np.isfinite(all_losses))),
      **({"first_valid_loss": round(valid_losses[0], 5),
          "final_valid_loss": round(valid_losses[-1], 5)}
         if valid_losses else {}),
      **({"ckpt": {
          "final_step": ckpt_report["final_step"],
          "resumed_from": ckpt_report["resumed_from"],
          "preempted": ckpt_report["preempted"],
          "saves": ckpt_report["saves"],
          "nan_rollbacks": ckpt_report["nan_rollbacks"],
          "quarantined": ckpt_report["quarantined"],
      }} if ckpt_report is not None else {}),
      "device": str(device),
      "seconds": round(time.time() - t0, 1),
  }


def cmd_serve(args: argparse.Namespace) -> dict:
  import signal
  import threading

  from mpi_vision_tpu_torch.core.sampling import Convention
  from mpi_vision_tpu_torch.serve import RenderService, make_http_server

  if args.max_inflight == "auto":
    max_inflight: int | str = "auto"
  else:
    try:
      max_inflight = int(args.max_inflight)
    except ValueError:
      raise SystemExit(
          f"--max-inflight must be an integer or 'auto', "
          f"got {args.max_inflight!r}") from None
  if not args.tiled and args.tile_size is not None:
    # The tile size only acts through the tiled registry; silently serving
    # monolithic scenes would drop the frustum culling asked for.
    raise SystemExit("--tile-size require(s) --tiled")
  tile_size: int | str | None = None
  if args.tile_size is not None:
    if args.tile_size == "auto":
      tile_size = "auto"
    else:
      try:
        tile_size = int(args.tile_size)
      except ValueError:
        raise SystemExit(
            f"--tile-size must be an integer or 'auto', "
            f"got {args.tile_size!r}") from None
      if tile_size < 8:
        raise SystemExit(f"--tile-size must be >= 8, got {tile_size}")
  convention = Convention.EXACT if args.convention == "exact" else None
  try:
    svc = RenderService(
        cache_bytes=args.cache_mb << 20, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, max_inflight=max_inflight,
        method=(args.method if args.method_given or not args.tiled
                else "pallas"),
        tile=((tile_size if tile_size is not None else 64)
              if args.tiled else None),
        convention=convention, device=args.device, max_queue=args.max_queue)
  except ValueError as e:  # a method that cannot render tile crops
    raise SystemExit(str(e)) from None
  ids = svc.add_synthetic_scenes(
      args.scenes, height=args.img_size, width=args.img_size,
      planes=args.num_planes)
  _log(f"serve: {len(ids)} synthetic scenes "
       f"[{args.img_size}x{args.img_size}x{args.num_planes}] on "
       f"{svc.engine.device}, method {svc.engine.method}, tile {svc.tile}")
  if args.warmup:
    # Build the kernel and allocate the pinned buffers before traffic.
    svc.warmup()
    _log("serve: warm-up done (every batch bucket rendered once)")

  httpd = make_http_server(svc, host=args.host, port=args.port)
  port = httpd.server_address[1]
  if args.port_file:
    _write_port_file(args.port_file, port)

  # Graceful shutdown: the handlers only set an event; teardown runs on
  # the main thread below. Installed before the "listening" line: once a
  # supervisor sees the address it may signal at any moment.
  stop_event = threading.Event()

  def _on_signal(signum, frame):  # noqa: ARG001 - stdlib signature
    stop_event.set()

  previous_handlers = {}
  for sig in (signal.SIGTERM, signal.SIGINT):
    try:
      previous_handlers[sig] = signal.signal(sig, _on_signal)
    except (ValueError, OSError):  # non-main thread / unsupported platform
      pass

  thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  thread.start()
  _log(f"serve: listening on http://{args.host}:{port} "
       f"(/render, /healthz, /stats, /debug/traces); "
       f"engine {svc.engine.describe()}")

  t0 = time.time()
  try:
    stop_event.wait(args.duration if args.duration > 0 else None)
  finally:
    httpd.shutdown()  # stop accepting; in-flight handler threads finish
    httpd.server_close()
    stats = svc.stats()
    health = svc.healthz()
    svc.close()  # drain the scheduler, fail leftovers with a clear message
    for sig, handler in previous_handlers.items():
      signal.signal(sig, handler)
    _log("serve: drained and closed")
  return {
      "command": "serve",
      "host": args.host,
      "port": port,
      "scenes": len(svc.scene_ids()),
      "seconds": round(time.time() - t0, 1),
      "requests": stats["requests"],
      "renders_per_sec": stats["renders_per_sec"],
      "latency_ms": stats["latency_ms"],
      "mean_batch_size": stats["mean_batch_size"],
      "cache_hit_rate": stats["cache"]["hit_rate"],
      "platform": stats["engine"]["platform"],
      "device": stats["engine"]["device"],
      "method": stats["engine"]["method"],
      "tile": svc.tile,
      "tiles": stats["tiles"],
      "health": health["status"],
      "errors": stats["errors"],
      "rejected": stats["rejected"],
      "pipeline": stats["pipeline"],
  }


def build_parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(prog="mpi_vision_tpu_torch",
                               description=__doc__.splitlines()[0])
  sub = ap.add_subparsers(dest="command", required=True)

  t = sub.add_parser("train", help="train the stereo-magnification model")
  t.add_argument("--dataset", default=None,
                 help="RealEstate10K-layout root (see data/realestate.py); "
                      "with --synthetic, where to write the procedural "
                      "scenes (default: a temp dir removed at exit)")
  t.add_argument("--synthetic", action="store_true",
                 help="train on the procedural dataset instead")
  t.add_argument("--synthetic-scenes", type=int, default=4)
  t.add_argument("--img-size", type=int, default=224)
  t.add_argument("--num-planes", type=int, default=10)
  t.add_argument("--epochs", type=int, default=20)
  t.add_argument("--lr", type=float, default=2e-4)
  t.add_argument("--lr-find", action="store_true",
                 help="run the exponential LR sweep first (cell 14) and "
                      "train at its suggestion instead of --lr")
  t.add_argument("--lr-find-steps", type=int, default=60,
                 help="max sweep steps for --lr-find")
  t.add_argument("--vgg-loss", action=argparse.BooleanOptionalAction,
                 default=True, help="VGG-perceptual loss (reference) or L2")
  t.add_argument("--vgg-resize", type=int, default=224,
                 help="loss resize; <= 0 disables")
  t.add_argument("--planned-render", action=argparse.BooleanOptionalAction,
                 default=True,
                 help="render the loss through the CUDA kernels, forward "
                      "and backward (method fused_pallas); "
                      "--no-planned-render uses the plain per-plane loop "
                      "(method fused). On by default, unlike the JAX CLI: "
                      "the kernels need no per-batch plan")
  t.add_argument("--valid", action=argparse.BooleanOptionalAction,
                 default=True,
                 help="evaluate the test split's fixed triplets each epoch")
  t.add_argument("--seed", type=int, default=0)
  t.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                 help="training device; cuda fails without a card rather "
                      "than falling back to the CPU")
  t.add_argument("--ckpt", default="",
                 help="checkpoint store directory (ckpt/: atomic "
                      "manifest'd saves, NaN rollback, SIGTERM "
                      "preemption saves, bit-exact --resume; on the card "
                      "it also puts cuDNN in deterministic mode)")
  t.add_argument("--save-every", type=int, default=0,
                 help="extra checkpoint cadence in steps (0 = epoch "
                      "boundaries only); requires --ckpt")
  t.add_argument("--keep", type=int, default=None,
                 help="checkpoints retained by GC (default 3; quarantine "
                      "excluded); requires --ckpt")
  t.add_argument("--resume", action="store_true",
                 help="resume from the newest good checkpoint in --ckpt "
                      "(bit-exact: model, optimizer state, LR, step, data "
                      "cursor); default starts fresh; requires --ckpt")
  t.add_argument("--nan-guard", action=argparse.BooleanOptionalAction,
                 default=None,
                 help="on a non-finite loss, roll back to the last good "
                      "checkpoint and halve the learning rate (default on; "
                      "requires --ckpt; --no-nan-guard fails fast instead)")
  t.add_argument("--async-save", action="store_true",
                 help="serialize checkpoints on a background thread "
                      "(ckpt.BackgroundSaver: at most one save in flight, "
                      "flushed at exit; the state is copied to the host "
                      "before the step loop goes on); requires --ckpt")
  t.add_argument("--stall-timeout-s", type=float, default=0.0,
                 help="warn when no step completes for this long "
                      "(<= 0 disables the stall watchdog); requires --ckpt")
  t.add_argument("--inject-fault", action="append", default=[],
                 metavar="SPEC",
                 help="arm one scheduled fault (repeatable): "
                      "crash@step=N[,hard] / nan@step=N / preempt@step=N "
                      "/ hang@step=N,seconds=S / crash@save=I,stage=... / "
                      "corrupt@save=I; requires --ckpt")
  t.set_defaults(fn=cmd_train)

  s = sub.add_parser(
      "serve", help="run the batched MPI render-serving subsystem")
  s.add_argument("--host", default="127.0.0.1")
  s.add_argument("--port", type=int, default=8080,
                 help="HTTP port (0 = ephemeral; logged on stderr)")
  s.add_argument("--port-file", default="",
                 help="write the bound port here (atomic tmp+rename) once "
                      "listening")
  s.add_argument("--duration", type=float, default=0.0,
                 help="seconds to serve; <= 0 runs until interrupted")
  s.add_argument("--scenes", type=int, default=4,
                 help="synthetic scene count")
  s.add_argument("--img-size", type=int, default=256)
  s.add_argument("--num-planes", type=int, default=16)
  s.add_argument("--max-batch", type=int, default=8,
                 help="micro-batch cap per device dispatch")
  s.add_argument("--max-wait-ms", type=float, default=3.0,
                 help="straggler window before a partial batch dispatches")
  s.add_argument("--max-inflight", default="4",
                 help="streaming-pipeline window: concurrent in-flight "
                      "batches; 1 = blocking dispatch; 'auto' starts at 2 "
                      "and grows while the dispatch gap keeps shrinking")
  s.add_argument("--cache-mb", type=int, default=2048,
                 help="baked-scene cache byte budget")
  s.add_argument("--max-queue", type=int, default=1024,
                 help="pending-request cap; beyond it /render sheds "
                      "load with 503")
  s.add_argument("--method", default="fused_pallas", action=_MethodAction,
                 choices=("fused_pallas", "pallas", "fused", "scan",
                          "assoc"),
                 help="per-view render method (core/render.py): "
                      "fused_pallas is the fused CUDA kernel (the default "
                      "untiled), pallas the warp then the CUDA compose "
                      "kernel (the default with --tiled: the fused kernel "
                      "cannot render tile crops)")
  s.add_argument("--tiled", action=argparse.BooleanOptionalAction,
                 default=False,
                 help="tile-granular scenes (serve/tiles.py): split every "
                      "scene into a fixed tile grid, render only the "
                      "frustum-touched crop with content-free planes "
                      "culled (bit-exact to the monolithic render), and "
                      "cache baked data per tile")
  s.add_argument("--tile-size", default=None,
                 help="tile edge in pixels (default 64), or 'auto' to "
                      "derive a per-scene edge targeting ~64 tiles "
                      "(serve/tiles.py auto_tile); requires --tiled")
  s.add_argument("--convention", default="ref", choices=("ref", "exact"),
                 help="sampling convention: 'ref' reproduces the "
                      "reference exactly (its axis swap is benign on "
                      "square frames only); 'exact' is correct for "
                      "non-square scenes")
  s.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                 help="render device; cuda fails without a card rather "
                      "than falling back to the CPU")
  s.add_argument("--warmup", action=argparse.BooleanOptionalAction,
                 default=True,
                 help="build the kernel and render each batch bucket once "
                      "before serving traffic")
  s.set_defaults(fn=cmd_serve, method_given=False)
  return ap


def main(argv=None) -> int:
  args = build_parser().parse_args(argv)
  summary = args.fn(args)
  print(json.dumps(summary))
  return 0


if __name__ == "__main__":
  sys.exit(main())
