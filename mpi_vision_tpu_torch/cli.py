"""Command-line entry point: ``python -m mpi_vision_tpu_torch <command>``.

  * ``train`` — train the stereo-magnification U-Net (train/) on a
    RealEstate10K-layout dataset or the procedural ``--synthetic`` one, with
    the VGG-perceptual loss rendered through the CUDA kernels forward and
    backward (``--planned-render``, the default), on the card
    (``--device cuda``, the default) or, when asked, the CPU. ``--lr-find``
    sweeps the learning rate first; with ``--ckpt`` the run is crash-safe
    (ckpt/: atomic checkpoints, NaN rollback, preemption saves, bit-exact
    ``--resume``); ``--bf16`` runs the U-Net and VGG convs in bfloat16;
    ``--export-html`` writes the viewer of a validation MPI;
    ``--metrics-port`` serves the run's ``mpi_train_*`` telemetry over
    HTTP, ``--metrics-log`` and ``--event-log`` append JSONL (all with
    ``--ckpt``).
  * ``export-viewer`` — bake a PNG MPI directory (e.g. the repo's
    ``tests/fixtures/scene_009``) into the self-contained HTML viewer.
  * ``serve`` — run the batched render-serving subsystem (serve/): scene
    cache + micro-batching scheduler + HTTP front end (``/render``,
    ``/healthz``, ``/stats``, ``/debug/traces``) over synthetic scenes, a
    baked PNG MPI directory (``--mpi-dir``), or MPIs predicted by a trained
    checkpoint (``--ckpt``, the train -> serve bridge; ``--reload-ckpt-s``
    swaps in newer checkpoints live), on the card (``--device cuda``, the
    default) or, when asked, the CPU; ``--tiled`` serves tile-granular
    scenes (serve/tiles.py) through the warp and the CUDA compose kernel
    (``--method pallas``). Degraded modes: ``--cpu-fallback`` (a CPU
    engine while the breaker refuses the card), ``--edge-cache`` (view-cell
    frame reuse with ETags), ``--slo`` (on by default) and ``--brownout``
    (the degradation ladder; picks ``--method pallas``), ``--event-log``,
    ``--profile-dir`` (``/debug/profile``). The flight recorder:
    ``/metrics`` always, ``--slo-quantile``/``--slo-per-scene``,
    ``--alert-hook``, ``--tsdb-interval-s`` (``/debug/tsdb``),
    ``--ship-url`` (off-host shipping with a disk spool), ``--attrib``
    (``/debug/attrib``), ``--incident-dir`` (``/debug/incidents``).
  * ``ship-sink`` — the telemetry collector a ``serve --ship-url`` posts
    to: each delivered batch lands as one JSON file in ``--dir``.

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
  """Stores ``--method`` and notes that it was given: ``--tiled`` or
  ``--brownout`` without it renders with 'pallas', the method that takes
  tile crops and reduced-resolution targets."""

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
        ("--metrics-port", args.metrics_port is not None),
        ("--metrics-log", bool(args.metrics_log)),
        ("--event-log", bool(args.event_log)),
        ("--inject-fault", bool(args.inject_fault))) if on]
    if wants_ckpt:
      raise SystemExit(
          f"{', '.join(wants_ckpt)} require(s) --ckpt <dir>")
  if args.metrics_port is not None and args.metrics_port < 0:
    raise SystemExit(
        f"--metrics-port must be >= 0 (0 = ephemeral), got "
        f"{args.metrics_port}")
  if args.metrics_port_file and args.metrics_port is None:
    # The port file is only ever written by the metrics listener; a
    # supervisor waiting on it would hang forever.
    raise SystemExit("--metrics-port-file requires --metrics-port")
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
  if args.export_html:
    # Fail before the training, not after: the export needs a non-empty
    # test split.
    test_dir = os.path.join(root, "RealEstate10K", "test")
    if not (os.path.isdir(test_dir) and os.listdir(test_dir)):
      raise SystemExit(
          f"--export-html needs a non-empty test split at {test_dir}")

  cfg = config.TrainConfig(
      data=config.DataConfig(dataset_path=root, img_size=args.img_size,
                             num_planes=args.num_planes),
      learning_rate=args.lr, epochs=args.epochs,
      vgg_resize=args.vgg_resize if args.vgg_resize > 0 else None,
      compute_dtype="bfloat16" if args.bf16 else None)
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
       f"{device}, render method {method}, convs in "
       f"{cfg.compute_dtype or 'float32'}, cuDNN TF32 "
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
  telemetry = None
  metrics_port = None

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

    # Training telemetry: the run exports mpi_train_* like a serve
    # backend — a stdlib /metrics listener plus an optional JSONL sink —
    # and lifecycle events (saves, restores, quarantines, rollbacks,
    # preemptions, stalls) land in a bounded event log served at
    # /debug/events and optionally appended to --event-log.
    ev, metrics_httpd = None, None
    if args.metrics_port is not None or args.metrics_log:
      from mpi_vision_tpu_torch.train import telemetry as telemetry_mod

      telemetry = telemetry_mod.TrainMetrics(
          sink=(telemetry_mod.file_metrics_sink(args.metrics_log)
                if args.metrics_log else None))
    if args.event_log or args.metrics_port is not None:
      from mpi_vision_tpu_torch.obs import events as events_mod

      ev = events_mod.EventLog(
          sink=events_mod.file_sink(args.event_log)
          if args.event_log else None)
    store = CheckpointStore(
        os.path.abspath(args.ckpt),
        keep=args.keep if args.keep is not None else 3,
        fault_hook=(fault_source.store_hook
                    if fault_source is not None else None),
        events=ev)
    if args.async_save:
      # Background-thread serialization: the step loop keeps training
      # while the previous state hashes/serializes/fsyncs; the loop
      # flushes on exit so every save is published by the time the
      # summary prints.
      store = BackgroundSaver(store, log=_log)

    def on_stall(idle):
      _log(f"train: WATCHDOG no step completed in {idle:.0f}s "
           "(device hang?)")
      if ev is not None:
        ev.emit("stall", idle_s=round(idle, 3))

    watchdog = (StallWatchdog(args.stall_timeout_s, on_stall=on_stall)
                if args.stall_timeout_s > 0 else None)
    if args.metrics_port is not None:
      import threading

      from mpi_vision_tpu_torch.train.telemetry import (
          make_train_metrics_server,
      )

      metrics_httpd = make_train_metrics_server(
          telemetry, events=ev, host="127.0.0.1", port=args.metrics_port)
      metrics_port = metrics_httpd.server_address[1]
      if args.metrics_port_file:
        _write_port_file(args.metrics_port_file, metrics_port)
      threading.Thread(target=metrics_httpd.serve_forever,
                       daemon=True).start()
      _log(f"train: metrics on http://127.0.0.1:{metrics_port} "
           "(/metrics, /stats, /healthz, /debug/events)")
    try:
      with PreemptionGuard() as preemption:
        state, ckpt_report = train_loop.fit_resumable(
            state, cfg.epochs, make_batches, store, step=step,
            save_every=args.save_every,
            meta={"model": cfg.model_meta(), "seed": args.seed},
            resume="auto" if args.resume else "never",
            nan_guard=None if args.nan_guard is False else NanGuard(),
            watchdog=watchdog, preemption=preemption,
            fault_source=fault_source, on_epoch=log_epoch,
            telemetry=telemetry, events=ev, log=_log)
    finally:
      if metrics_httpd is not None:
        metrics_httpd.shutdown()
        metrics_httpd.server_close()
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

  if args.export_html:
    from mpi_vision_tpu_torch.models.stereo_mag import mpi_from_net_output
    from mpi_vision_tpu_torch.viewer import export

    example = cfg.data.make_dataset(is_valid=True, device=device)[0]
    with torch.no_grad():
      pred = state.model(example["net_input"][None])
      rgba = mpi_from_net_output(pred, example["ref_img"][None])
    export.export_viewer_html(
        rgba[0].cpu().numpy(), args.export_html,
        near=cfg.data.depth_near, far=cfg.data.depth_far)
    _log(f"viewer exported to {args.export_html}")

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
      **({"telemetry": {
          "steps": telemetry.snapshot()["steps"],
          "examples_per_sec": telemetry.snapshot()["examples_per_sec"],
          **({"metrics_port": metrics_port}
             if metrics_port is not None else {}),
      }} if telemetry is not None else {}),
      "device": str(device),
      "seconds": round(time.time() - t0, 1),
  }


def cmd_export_viewer(args: argparse.Namespace) -> dict:
  from mpi_vision_tpu_torch.viewer import export

  mpi = export.load_fixture_mpi(args.mpi_dir, prefix=args.prefix)
  out = export.export_viewer_html(
      mpi, args.out, near=args.near, far=args.far, fov_deg=args.fov)
  return {
      "command": "export-viewer",
      "layers": int(mpi.shape[2]),
      "size": [int(mpi.shape[0]), int(mpi.shape[1])],
      "out": out,
  }


def mpi_dir_scene(mpi_dir: str, prefix: str = "rgba_", near: float = 1.0,
                  far: float = 100.0, fov: float = 60.0) -> tuple:
  """``serve --mpi-dir``'s scene: the PNG stack as ``(scene_id, rgba [H,
  W, P, 4], depths [P], intrinsics [3, 3])``, named after the directory,
  with planes at ``inv_depths(near, far, P)`` and a pinhole of horizontal
  field of view ``fov`` degrees (``fx = fy = 0.5 W / tan(fov / 2)``)."""
  import numpy as np

  from mpi_vision_tpu_torch.core.camera import intrinsics_matrix, inv_depths
  from mpi_vision_tpu_torch.viewer import export

  mpi = export.load_fixture_mpi(mpi_dir, prefix=prefix)
  h, w, p = mpi.shape[0], mpi.shape[1], mpi.shape[2]
  fx = 0.5 * w / np.tan(np.radians(fov) / 2.0)
  k = intrinsics_matrix(fx, fx, w / 2.0, h / 2.0).numpy()
  return (os.path.basename(os.path.normpath(mpi_dir)), mpi,
          inv_depths(near, far, p).numpy(), k)


def cmd_serve(args: argparse.Namespace) -> dict:
  import signal
  import threading

  from mpi_vision_tpu_torch.core.sampling import Convention
  from mpi_vision_tpu_torch.serve import RenderService, make_http_server

  if not args.ckpt:
    # These flags only act through the checkpoint bridge; silently
    # serving synthetic scenes instead would drop the trained MPIs asked
    # for.
    wants_ckpt = [flag for flag, on in (
        ("--ckpt-scenes", args.ckpt_scenes is not None),
        ("--ckpt-dataset", bool(args.ckpt_dataset)),
        ("--reload-ckpt-s", args.reload_ckpt_s > 0)) if on]
    if wants_ckpt:
      raise SystemExit(f"{', '.join(wants_ckpt)} require(s) --ckpt <dir>")
  if args.ckpt_scenes is not None and args.ckpt_scenes < 1:
    # 0 would come up healthy serving no checkpoint scene at all.
    raise SystemExit(f"--ckpt-scenes must be >= 1, got {args.ckpt_scenes}")
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
  degraded = _degraded_mode_kwargs(args)
  try:
    svc = RenderService(
        cache_bytes=args.cache_mb << 20, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, max_inflight=max_inflight,
        method=(args.method
                if args.method_given or not (args.tiled or args.brownout)
                else "pallas"),
        tile=((tile_size if tile_size is not None else 64)
              if args.tiled else None),
        convention=convention, device=args.device, max_queue=args.max_queue,
        **degraded)
  except ValueError as e:  # a method that cannot render crops/targets
    raise SystemExit(str(e)) from None
  if args.mpi_dir:
    scene_id, mpi, depths, k = mpi_dir_scene(
        args.mpi_dir, args.prefix, args.near, args.far, args.fov)
    svc.add_scene(scene_id, mpi, depths, k)
    _log(f"serve: loaded MPI scene {scene_id!r} "
         f"[{mpi.shape[0]}x{mpi.shape[1]}x{mpi.shape[2]}]")
  watcher = None
  if args.ckpt:
    # The train -> serve bridge: restore the checkpoint, run the forward
    # pass on the serving device, bake the predicted MPIs as scenes. With
    # --reload-ckpt-s the ids are stable across steps, so later reloads
    # swap scenes in place under the ids clients already hold.
    from mpi_vision_tpu_torch.ckpt.export import scenes_from_checkpoint

    ckpt_dir = os.path.abspath(args.ckpt)
    live_reload = args.reload_ckpt_s > 0
    n_ckpt_scenes = args.ckpt_scenes if args.ckpt_scenes is not None else 2

    def bake():
      return scenes_from_checkpoint(
          ckpt_dir, dataset_path=args.ckpt_dataset or None,
          scenes=n_ckpt_scenes, stable_ids=live_reload, log=_log,
          device=svc.engine.device)

    try:
      ckpt_scenes, ckpt_info = bake()
    except FileNotFoundError as e:
      svc.close()
      raise SystemExit(str(e)) from None
    for sid, rgba, depths, k in ckpt_scenes:
      svc.add_scene(sid, rgba, depths, k)
    _log(f"serve: {len(ckpt_scenes)} scene(s) from checkpoint step "
         f"{ckpt_info['step']} (params {ckpt_info['params_digest'][:8]})")
    if live_reload:
      # Watch the store, re-bake, swap in place: in-flight requests finish
      # on the scenes they hold (ckpt/watch.py, RenderService.swap_scenes).
      # A failed reload is logged and retried; the old scenes keep serving.
      from mpi_vision_tpu_torch.ckpt import CheckpointStore, CheckpointWatcher

      def reload(step: int) -> None:
        new_scenes, new_info = bake()
        swapped = svc.swap_scenes(
            {sid: (rgba, depths, k) for sid, rgba, depths, k in new_scenes},
            prebake=True)
        _log(f"serve: live-reloaded {len(swapped)} scene(s) from "
             f"checkpoint step {new_info['step']} "
             f"(params {new_info['params_digest'][:8]})")

      watcher = CheckpointWatcher(
          CheckpointStore(ckpt_dir), reload, poll_s=args.reload_ckpt_s,
          initial_step=ckpt_info["step"], log=_log).start()
      _log(f"serve: watching {args.ckpt} for new checkpoints every "
           f"{args.reload_ckpt_s:g}s")
  if not args.mpi_dir and not args.ckpt:
    ids = svc.add_synthetic_scenes(
        args.scenes, height=args.img_size, width=args.img_size,
        planes=args.num_planes)
    _log(f"serve: {len(ids)} synthetic scenes "
         f"[{args.img_size}x{args.img_size}x{args.num_planes}]")
  _log(f"serve: {len(svc.scene_ids())} scene(s) on {svc.engine.device}, "
       f"method {svc.engine.method}, tile {svc.tile}")
  if args.warmup:
    # Build the kernel and allocate the pinned buffers before traffic.
    svc.warmup()
    _log("serve: warm-up done (every batch bucket rendered once)")
  if args.prebake_fallback > 0:
    warm = svc.prebake_fallback(args.prebake_fallback)
    if warm:
      _log(f"serve: pre-baked {len(warm)} fallback scene(s) on the CPU")
    else:
      _log("serve: --prebake-fallback ignored (no fallback engine; see "
           "--cpu-fallback)")

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
       f"(/render, /healthz, /stats, /metrics, /debug/traces, "
       f"/debug/events, /debug/profile, /debug/tsdb, /debug/attrib, "
       f"/debug/incidents); "
       f"engine {svc.engine.describe()}")

  t0 = time.time()
  try:
    stop_event.wait(args.duration if args.duration > 0 else None)
  finally:
    if watcher is not None:
      watcher.stop()  # no reload may start while the service drains
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
      "fallback_renders": stats["resilience"]["fallback_renders"],
      **({"edge": stats["edge"]} if "edge" in stats else {}),
      **({"slo": stats["slo"]["alerts_firing"]} if "slo" in stats else {}),
      **({"brownout": stats["brownout"]} if svc.brownout is not None
         else {}),
      **({"ckpt_reload": watcher.snapshot()} if watcher is not None else {}),
      **({"ship": stats["ship"]} if "ship" in stats else {}),
      **({"incidents": stats["incidents"]} if "incidents" in stats
         else {}),
  }


def cmd_ship_sink(args: argparse.Namespace) -> dict:
  import signal
  import threading

  from mpi_vision_tpu_torch.obs.ship import make_sink_server

  if args.port < 0:
    raise SystemExit(f"--port must be >= 0 (0 = ephemeral), got {args.port}")
  server, sink = make_sink_server(os.path.abspath(args.dir),
                                  host="127.0.0.1", port=args.port)
  port = server.server_address[1]
  if args.port_file:
    _write_port_file(args.port_file, port)
  threading.Thread(target=server.serve_forever, name="ship-sink",
                   daemon=True).start()
  _log(f"ship-sink: collecting on http://127.0.0.1:{port} -> {args.dir} "
       "(POST batches; /healthz /stats)")
  stop_event = threading.Event()

  def _on_signal(signum, frame):  # noqa: ARG001 - stdlib signature
    stop_event.set()

  previous_handlers = {}
  for sig in (signal.SIGTERM, signal.SIGINT):
    try:
      previous_handlers[sig] = signal.signal(sig, _on_signal)
    except (ValueError, OSError):  # non-main thread
      pass
  t0 = time.time()
  try:
    stop_event.wait(args.duration if args.duration > 0 else None)
  finally:
    server.shutdown()
    server.server_close()
    for sig, handler in previous_handlers.items():
      signal.signal(sig, handler)
    _log("ship-sink: stopped")
  return {
      "command": "ship-sink",
      "port": port,
      "seconds": round(time.time() - t0, 1),
      **sink.stats(),
  }


def _require(args, gate: str, on: bool, flags) -> None:
  """Refuse knobs that only act through a mode that is off: a silently
  inert flag drops what the operator asked for."""
  given = [flag for flag, set_ in flags if set_]
  if given and not on:
    raise SystemExit(f"{', '.join(given)} require(s) {gate}")


def _degraded_mode_kwargs(args: argparse.Namespace) -> dict:
  """``RenderService`` kwargs of the degraded-mode and flight-recorder
  flags: CPU fallback, event log, edge cache, SLO tracking (with its
  quantile objective and alert hook), brownout, the profiler, the tsdb
  ring, shipping, attribution, incidents and the ``/metrics`` TTL."""
  import shlex
  import subprocess

  from mpi_vision_tpu_torch.obs import SloConfig, TsdbConfig
  from mpi_vision_tpu_torch.obs import attrib as attrib_lib
  from mpi_vision_tpu_torch.obs import events as events_mod
  from mpi_vision_tpu_torch.obs import incident as incident_lib
  from mpi_vision_tpu_torch.obs import ship as ship_lib
  from mpi_vision_tpu_torch.serve.brownout import BrownoutConfig
  from mpi_vision_tpu_torch.serve.edge import EdgeConfig

  _require(args, "--profile-dir", bool(args.profile_dir),
           [("--profile-hook", bool(args.profile_hook)),
            ("--incident-profile", args.incident_profile is not None)])
  _require(args, "--event-log", bool(args.event_log),
           [("--event-log-max-bytes", args.event_log_max_bytes > 0)])
  _require(args, "SLO tracking (drop --no-slo)", args.slo,
           [("--alert-hook", bool(args.alert_hook)),
            ("--slo-quantile", args.slo_quantile is not None),
            ("--slo-per-scene", args.slo_per_scene),
            ("--incident-dir", bool(args.incident_dir))])
  _require(args, "--slo-quantile", args.slo_quantile is not None,
           [("--slo-per-scene", args.slo_per_scene)])
  tsdb_flags = {"--tsdb-points": args.tsdb_points,
                "--tsdb-max-series": args.tsdb_max_series,
                "--tsdb-compact-after-s": args.tsdb_compact_after_s,
                "--tsdb-compact-stride": args.tsdb_compact_stride}
  _require(args, "--tsdb-interval-s > 0", args.tsdb_interval_s > 0,
           [(f, v is not None) for f, v in tsdb_flags.items()])
  _require(args, "--tsdb-compact-after-s",
           args.tsdb_compact_after_s is not None,
           [("--tsdb-compact-stride", args.tsdb_compact_stride is not None)])
  ship_flags = {"--ship-interval-s": args.ship_interval_s,
                "--ship-timeout-s": args.ship_timeout_s,
                "--ship-spool-dir": args.ship_spool_dir or None,
                "--ship-spool-mb": args.ship_spool_mb}
  _require(args, "--ship-url", bool(args.ship_url),
           [(f, v is not None) for f, v in ship_flags.items()])
  _require(args, "--attrib", args.attrib,
           [("--attrib-scenes", args.attrib_scenes is not None)])
  if args.attrib_scenes is not None and args.attrib_scenes < 1:
    raise SystemExit(
        f"--attrib-scenes must be >= 1, got {args.attrib_scenes}")
  inc_flags = {"--incident-keep": args.incident_keep,
               "--incident-window-s": args.incident_window_s,
               "--incident-top-cells": args.incident_top_cells,
               "--incident-profile": args.incident_profile}
  _require(args, "--incident-dir", bool(args.incident_dir),
           [(f, v is not None) for f, v in inc_flags.items()])
  edge_flags = {"--edge-cache-mb": args.edge_cache_mb,
                "--edge-trans-cell": args.edge_trans_cell,
                "--edge-rot-bucket-deg": args.edge_rot_bucket_deg,
                "--edge-warp-trans": args.edge_warp_trans,
                "--edge-warp-rot-deg": args.edge_warp_rot_deg,
                "--edge-max-age-s": args.edge_max_age_s,
                "--edge-negative-ttl-s": args.edge_negative_ttl_s}
  _require(args, "--edge-cache", args.edge_cache,
           [(f, v is not None) for f, v in edge_flags.items()])
  bo_flags = {"--brownout-burn-high": args.brownout_burn_high,
              "--brownout-queue-high": args.brownout_queue_high,
              "--brownout-recover-burn": args.brownout_recover_burn,
              "--brownout-recover-queue": args.brownout_recover_queue,
              "--brownout-step-dwell-s": args.brownout_step_dwell_s,
              "--brownout-recover-dwell-s": args.brownout_recover_dwell_s,
              "--brownout-plane-keep": args.brownout_plane_keep,
              "--brownout-warp-scale": args.brownout_warp_scale,
              "--brownout-max-level": args.brownout_max_level}
  _require(args, "--brownout", args.brownout,
           [(f, v is not None) for f, v in bo_flags.items()])
  if args.brownout and not args.slo:
    # The ladder is DRIVEN by the SLO burn rate; without the tracker it
    # would be a queue-only controller pretending to watch the SLO.
    raise SystemExit("--brownout requires SLO tracking (drop --no-slo)")
  out: dict = {"cpu_fallback": args.cpu_fallback}
  if args.event_log:
    out["events"] = events_mod.EventLog(sink=events_mod.file_sink(
        args.event_log,
        max_bytes=(args.event_log_max_bytes
                   if args.event_log_max_bytes > 0 else None),
        keep=args.event_log_keep))
  if args.edge_cache:
    # Unset knobs are not passed: the dataclass defaults stay the single
    # source of truth.
    names = {"--edge-cache-mb": "byte_budget",
             "--edge-trans-cell": "trans_cell",
             "--edge-rot-bucket-deg": "rot_bucket_deg",
             "--edge-warp-trans": "warp_max_trans",
             "--edge-warp-rot-deg": "warp_max_rot_deg",
             "--edge-max-age-s": "max_age_s",
             "--edge-negative-ttl-s": "negative_ttl_s"}
    kw = {names[f]: (v << 20 if f == "--edge-cache-mb" else v)
          for f, v in edge_flags.items() if v is not None}
    try:
      out["edge"] = EdgeConfig(**kw)
    except ValueError as e:
      raise SystemExit(f"bad edge cache config: {e}") from None
  out["slo"] = None
  if args.slo:
    try:
      out["slo"] = SloConfig(
          availability_target=args.slo_availability,
          latency_threshold_s=args.slo_latency_ms / 1e3,
          latency_target=args.slo_latency_target,
          fast_window_s=args.slo_fast_window_s,
          slow_window_s=args.slo_slow_window_s,
          burn_threshold=args.slo_burn_threshold,
          quantile=args.slo_quantile,
          per_scene=args.slo_per_scene)
    except ValueError as e:
      raise SystemExit(f"bad SLO config: {e}") from None
  if args.brownout:
    names = {"--brownout-burn-high": "burn_high",
             "--brownout-queue-high": "queue_high",
             "--brownout-recover-burn": "recover_burn",
             "--brownout-recover-queue": "recover_queue",
             "--brownout-step-dwell-s": "step_dwell_s",
             "--brownout-recover-dwell-s": "recover_dwell_s",
             "--brownout-plane-keep": "plane_keep",
             "--brownout-warp-scale": "l3_warp_scale",
             "--brownout-max-level": "max_level"}
    try:
      out["brownout"] = BrownoutConfig(**{
          names[f]: v for f, v in bo_flags.items() if v is not None})
    except ValueError as e:
      # BrownoutConfig's own validation (hysteresis-band ordering,
      # plane-keep range, ...) speaks in flag terms already.
      raise SystemExit(f"bad brownout config: {e}") from None
  if args.profile_dir:
    out["profile_dir"] = args.profile_dir
  if args.profile_hook:
    hook_argv = shlex.split(args.profile_hook)

    def profile_hook(capture_dir, _argv=hook_argv):
      # The finished capture dir rides as the last argv element; any
      # failure surfaces as a counted, non-fatal hook error.
      subprocess.run([*_argv, capture_dir], check=True, timeout=600)

    out["profile_hook"] = profile_hook
  if args.alert_hook:
    alert_argv = shlex.split(args.alert_hook)

    def alert_hook(record, _argv=alert_argv):
      # The slo_alert event rides as one JSON argv element (fire AND
      # clear edges); failures are counted by the service, never fatal.
      subprocess.run([*_argv, json.dumps(record)], check=True, timeout=60)

    out["alert_hook"] = alert_hook
  if args.tsdb_interval_s > 0:
    names = {"--tsdb-points": "max_points",
             "--tsdb-max-series": "max_series",
             "--tsdb-compact-after-s": "compact_after_s",
             "--tsdb-compact-stride": "compact_stride"}
    try:
      out["tsdb"] = TsdbConfig(interval_s=args.tsdb_interval_s, **{
          names[f]: v for f, v in tsdb_flags.items() if v is not None})
    except ValueError as e:
      raise SystemExit(f"bad tsdb config: {e}") from None
  if args.ship_url:
    names = {"--ship-interval-s": "interval_s",
             "--ship-timeout-s": "timeout_s",
             "--ship-spool-mb": "spool_budget_bytes"}
    kw = {names[f]: (v << 20 if f == "--ship-spool-mb" else v)
          for f, v in ship_flags.items() if f in names and v is not None}
    try:
      out["ship"] = ship_lib.ShipConfig(
          url=args.ship_url, spool_dir=args.ship_spool_dir or None,
          events_path=args.event_log or None,
          events_keep=args.event_log_keep, **kw)
    except ValueError as e:
      raise SystemExit(f"bad ship config: {e}") from None
  if args.attrib:
    out["attrib"] = attrib_lib.AttribConfig(
        scene_cap=(args.attrib_scenes if args.attrib_scenes is not None
                   else attrib_lib.SCENE_CAP))
  if args.incident_dir:
    names = {"--incident-keep": "keep",
             "--incident-window-s": "tsdb_window_s",
             "--incident-top-cells": "top_k_cells",
             "--incident-profile": "profile_seconds"}
    try:
      out["incidents"] = incident_lib.IncidentConfig(
          dir=args.incident_dir,
          **{names[f]: v for f, v in inc_flags.items() if v is not None})
    except ValueError as e:
      raise SystemExit(f"bad incident config: {e}") from None
  out["metrics_ttl_s"] = args.metrics_ttl_ms / 1e3
  return out


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
  t.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                 default=False,
                 help="run the U-Net and VGG-loss convs in bfloat16 "
                      "(parameters, optimizer state, render and loss stay "
                      "f32)")
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
  t.add_argument("--metrics-port", type=int, default=None,
                 help="export live training telemetry on this HTTP port "
                      "(0 = ephemeral, logged on stderr): /metrics "
                      "(mpi_train_* Prometheus families), /stats, "
                      "/healthz, /debug/events; requires --ckpt")
  t.add_argument("--metrics-port-file", default="",
                 help="write the bound metrics port here (atomic "
                      "tmp+rename) once listening")
  t.add_argument("--metrics-log", default="",
                 help="append one JSON line per training step and "
                      "checkpoint save to this file; requires --ckpt")
  t.add_argument("--event-log", default="",
                 help="append one JSON line per lifecycle event (saves, "
                      "restores, quarantines, NaN rollbacks, preemption, "
                      "stalls) to this file; requires --ckpt")
  t.add_argument("--export-html", default="",
                 help="after training, write a viewer HTML of the first "
                      "validation MPI here")
  t.set_defaults(fn=cmd_train)

  e = sub.add_parser("export-viewer",
                     help="bake a PNG MPI directory into the HTML viewer")
  e.add_argument("--mpi-dir", required=True)
  e.add_argument("--prefix", default="rgba_")
  e.add_argument("--out", required=True)
  e.add_argument("--near", type=float, default=1.0)
  e.add_argument("--far", type=float, default=100.0)
  e.add_argument("--fov", type=float, default=60.0)
  e.set_defaults(fn=cmd_export_viewer)

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
                 help="synthetic scene count (ignored with --mpi-dir or "
                      "--ckpt)")
  s.add_argument("--img-size", type=int, default=256)
  s.add_argument("--num-planes", type=int, default=16)
  s.add_argument("--mpi-dir", default="",
                 help="serve a baked PNG MPI directory (scene id = its "
                      "name)")
  s.add_argument("--ckpt", default="",
                 help="serve MPIs predicted by a trained checkpoint (a "
                      "train --ckpt store of either package): restores the "
                      "params, runs the forward pass on the serving device "
                      "and bakes the predictions as scenes (combinable "
                      "with --mpi-dir)")
  s.add_argument("--ckpt-scenes", type=int, default=None,
                 help="examples to bake from the --ckpt forward pass "
                      "(default 2); requires --ckpt")
  s.add_argument("--ckpt-dataset", default="",
                 help="RealEstate10K-layout root feeding the --ckpt "
                      "forward pass (default: procedural synthetic); "
                      "requires --ckpt")
  s.add_argument("--reload-ckpt-s", type=float, default=0.0,
                 help="poll --ckpt for a newly published step every this "
                      "many seconds and swap the baked scenes in place "
                      "without dropping in-flight requests (stable scene "
                      "ids; <= 0 disables; requires --ckpt)")
  s.add_argument("--prefix", default="rgba_",
                 help="--mpi-dir layer file prefix")
  s.add_argument("--near", type=float, default=1.0,
                 help="--mpi-dir nearest plane depth")
  s.add_argument("--far", type=float, default=100.0,
                 help="--mpi-dir farthest plane depth")
  s.add_argument("--fov", type=float, default=60.0,
                 help="--mpi-dir horizontal field of view, degrees")
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
  s.add_argument("--cpu-fallback", default="off",
                 choices=("auto", "on", "off"),
                 help="degraded-mode CPU engine while the circuit breaker "
                      "refuses the card (off, the default: fast-fail with "
                      "503; auto: only when the primary is not the CPU); "
                      "only transient device errors and watchdog trips "
                      "open the breaker, so a kernel build or launch "
                      "failure fails its request instead")
  s.add_argument("--prebake-fallback", type=int, default=0,
                 help="pre-bake this many scenes onto the CPU fallback at "
                      "startup so the first breaker-open render does not "
                      "pay a cold bake (0 = bake lazily)")
  s.add_argument("--profile-dir", default="",
                 help="enable /debug/profile?seconds=N captures "
                      "(torch.profiler, Chrome trace) into this directory")
  s.add_argument("--profile-hook", default="",
                 help="run this command with each finished capture's "
                      "directory appended to its argv; failures are "
                      "counted and reported, never fatal; requires "
                      "--profile-dir")
  s.add_argument("--event-log", default="",
                 help="append one JSON line per lifecycle event (breaker "
                      "transitions, scene swaps, SLO alert edges, brownout "
                      "levels) to this file; /debug/events serves the "
                      "bounded ring either way")
  s.add_argument("--event-log-max-bytes", type=int, default=0,
                 help="rotate the --event-log file past this many bytes "
                      "(FILE -> FILE.1 -> ... -> FILE.<keep>); <= 0 "
                      "disables rotation; requires --event-log")
  s.add_argument("--event-log-keep", type=int, default=3,
                 help="rotated --event-log files retained")
  s.add_argument("--edge-cache", action=argparse.BooleanOptionalAction,
                 default=False,
                 help="pose-quantized edge frame cache (serve/edge/): "
                      "serve exact view-cell hits from memory and near "
                      "misses by warping the nearest cached frame on the "
                      "card; /render gains strong ETags, If-None-Match -> "
                      "304, Cache-Control and X-Edge-Cache")
  s.add_argument("--edge-cache-mb", type=int, default=None,
                 help="edge frame-cache byte budget (default 512)")
  s.add_argument("--edge-trans-cell", type=float, default=None,
                 help="view-cell translation pitch in scene units "
                      "(default 0.05)")
  s.add_argument("--edge-rot-bucket-deg", type=float, default=None,
                 help="view-cell rotation pitch in degrees (default 2.0)")
  s.add_argument("--edge-warp-trans", type=float, default=None,
                 help="max translation error a near miss may be from a "
                      "cached frame and still be warped (default 0.1)")
  s.add_argument("--edge-warp-rot-deg", type=float, default=None,
                 help="max rotation error for warp serving, degrees "
                      "(default 4.0)")
  s.add_argument("--edge-max-age-s", type=int, default=None,
                 help="Cache-Control: max-age on /render responses "
                      "(default 5)")
  s.add_argument("--edge-negative-ttl-s", type=float, default=None,
                 help="negative-cache TTL (default 0 = off): a render shed "
                      "queue-full makes repeats of its view cell fail fast "
                      "with 503 + Retry-After")
  s.add_argument("--slo", action=argparse.BooleanOptionalAction,
                 default=True,
                 help="track availability + latency SLOs with multi-window "
                      "burn-rate alerting (obs/slo.py): an slo block in "
                      "/stats; a firing alert reads degraded in /healthz")
  s.add_argument("--slo-availability", type=float, default=0.99,
                 help="availability objective (good-request fraction)")
  s.add_argument("--slo-latency-ms", type=float, default=1000.0,
                 help="latency objective: a completed request is good "
                      "when it finishes under this")
  s.add_argument("--slo-latency-target", type=float, default=0.95,
                 help="fraction of completed requests that must beat "
                      "--slo-latency-ms")
  s.add_argument("--slo-fast-window-s", type=float, default=60.0,
                 help="fast burn-rate window")
  s.add_argument("--slo-slow-window-s", type=float, default=600.0,
                 help="slow burn-rate window")
  s.add_argument("--slo-burn-threshold", type=float, default=10.0,
                 help="error-budget burn rate at which the alert fires")
  s.add_argument("--slo-quantile", type=float, default=None,
                 help="add a histogram-quantile objective (e.g. 0.99: "
                      "'p99 latency under --slo-latency-ms'), judged "
                      "from the native latency histogram pooled over "
                      "the window; requires SLO tracking")
  s.add_argument("--slo-per-scene", action="store_true",
                 help="judge the quantile objective per scene too "
                      "(bounded per-scene table; alerts named like "
                      "latency_p99:scene_007); requires --slo-quantile")
  s.add_argument("--alert-hook", default="",
                 help="run this command on every SLO alert fire/clear "
                      "edge with the slo_alert event appended to its "
                      "argv as one JSON element; runs off the request "
                      "path, failures are counted, never fatal; requires "
                      "SLO tracking (the --slo default)")
  s.add_argument("--brownout", action=argparse.BooleanOptionalAction,
                 default=False,
                 help="degrade, don't die: an SLO-burn/queue-depth driven "
                      "ladder (L1 thinned planes, L2 half resolution, L3 "
                      "widened edge warps, L4 shed) with priority "
                      "admission by X-Request-Class; picks --method "
                      "pallas (the fused kernel cannot render half-"
                      "resolution targets); requires SLO tracking")
  s.add_argument("--brownout-burn-high", type=float, default=None,
                 help="fast-window burn rate at which the ladder steps "
                      "down (default 2.0)")
  s.add_argument("--brownout-queue-high", type=float, default=None,
                 help="queue fraction at which the ladder steps down "
                      "(default 0.5)")
  s.add_argument("--brownout-recover-burn", type=float, default=None,
                 help="burn rate under which a level recovers (default "
                      "1.0; < --brownout-burn-high)")
  s.add_argument("--brownout-recover-queue", type=float, default=None,
                 help="queue fraction under which a level recovers "
                      "(default 0.25; < --brownout-queue-high)")
  s.add_argument("--brownout-step-dwell-s", type=float, default=None,
                 help="seconds between consecutive downward steps "
                      "(default 2.0)")
  s.add_argument("--brownout-recover-dwell-s", type=float, default=None,
                 help="healthy seconds per upward step (default 5.0)")
  s.add_argument("--brownout-plane-keep", type=float, default=None,
                 help="fraction of the culled plane set L1+ keeps "
                      "(default 0.5)")
  s.add_argument("--brownout-warp-scale", type=float, default=None,
                 help="L3 multiplier on the edge warp tolerances "
                      "(default 3.0)")
  s.add_argument("--brownout-max-level", type=int, default=None,
                 help="ladder ceiling 1-4 (default 4)")
  s.add_argument("--tsdb-interval-s", type=float, default=0.0,
                 help="sample every /metrics family into the on-box "
                      "time-series ring this often and serve windowed "
                      "history at GET /debug/tsdb (<= 0 disables)")
  s.add_argument("--tsdb-points", type=int, default=None,
                 help="points retained per series (default 512); "
                      "requires --tsdb-interval-s")
  s.add_argument("--tsdb-max-series", type=int, default=None,
                 help="series cap for the whole ring (default 4096; "
                      "overflow counted, never fatal); requires "
                      "--tsdb-interval-s")
  s.add_argument("--tsdb-compact-after-s", type=float, default=None,
                 help="thin ring points older than this to a coarser "
                      "stride instead of evicting them; requires "
                      "--tsdb-interval-s")
  s.add_argument("--tsdb-compact-stride", type=int, default=None,
                 help="keep ~one old point per stride sampling "
                      "intervals (default 8); requires "
                      "--tsdb-compact-after-s")
  s.add_argument("--ship-url", default="",
                 help="POST telemetry batches (rotated event-log "
                      "segments, SLO alert edges, incremental tsdb "
                      "snapshots, incident bundles) to this HTTP sink "
                      "(e.g. a ship-sink) on a daemon thread; failures "
                      "are counted (mpi_obs_ship_*), retried, spooled — "
                      "never fatal, never on the request path")
  s.add_argument("--ship-interval-s", type=float, default=None,
                 help="shipping cadence (default 10); requires --ship-url")
  s.add_argument("--ship-timeout-s", type=float, default=None,
                 help="per-POST sink timeout (default 5); requires "
                      "--ship-url")
  s.add_argument("--ship-spool-dir", default="",
                 help="spool undeliverable batches to this directory and "
                      "drain them oldest-first when the sink recovers "
                      "(unset: failed batches drop, counted); requires "
                      "--ship-url")
  s.add_argument("--ship-spool-mb", type=int, default=None,
                 help="spool byte budget (default 64; oldest dropped "
                      "past it); requires --ship-url")
  s.add_argument("--attrib", action="store_true",
                 help="resource-attribution ledger: account every "
                      "completed request's device phase-seconds (timed "
                      "on the card), queue wait, bytes and edge serves "
                      "into bounded (scene x class x brownout-level) "
                      "cells at GET /debug/attrib, /stats and the "
                      "mpi_serve_attrib_* families")
  s.add_argument("--attrib-scenes", type=int, default=None,
                 help="distinct scenes tracked before folding into "
                      "_other (default 32); requires --attrib")
  s.add_argument("--incident-dir", default="",
                 help="capture an incident bundle (alert + burn numbers, "
                      "slowest traces, tsdb window, events, brownout "
                      "state, top attribution cells) into this directory "
                      "on every SLO alert FIRE edge (deduplicated until "
                      "the clear), served at GET /debug/incidents and "
                      "shipped through --ship-url's spool; requires SLO "
                      "tracking")
  s.add_argument("--incident-keep", type=int, default=None,
                 help="bundles retained on disk, oldest pruned (default "
                      "8); requires --incident-dir")
  s.add_argument("--incident-window-s", type=float, default=None,
                 help="tsdb history frozen into each bundle (default "
                      "300); requires --incident-dir")
  s.add_argument("--incident-top-cells", type=int, default=None,
                 help="attribution cells frozen into each bundle "
                      "(default 8); requires --incident-dir")
  s.add_argument("--incident-profile", type=float, default=None,
                 help="also wrap a torch.profiler capture of this many "
                      "seconds into each bundle (busy while "
                      "/debug/profile captures); requires --incident-dir "
                      "and --profile-dir")
  s.add_argument("--metrics-ttl-ms", type=float, default=250.0,
                 help="memoize the /metrics exposition string this long "
                      "(<= 0 renders per scrape)")
  s.set_defaults(fn=cmd_serve, method_given=False)

  k = sub.add_parser(
      "ship-sink",
      help="run the telemetry collector (obs/ship.py's receiver): a "
           "stdlib HTTP listener accepting the shipper's POSTed JSON "
           "batches and writing each durably into a directory; point a "
           "serve --ship-url at it")
  k.add_argument("--dir", required=True,
                 help="batch directory (one batch-NNNNNNNN.json per "
                      "delivered batch, atomic rename; numbering resumes "
                      "over an existing directory)")
  k.add_argument("--port", type=int, default=0,
                 help="listen port (0 = ephemeral — see --port-file)")
  k.add_argument("--port-file", default="",
                 help="write the bound port here (atomic rename)")
  k.add_argument("--duration", type=float, default=0.0,
                 help="seconds to run; <= 0 runs until interrupted")
  k.set_defaults(fn=cmd_ship_sink)
  return ap


def main(argv=None) -> int:
  args = build_parser().parse_args(argv)
  summary = args.fn(args)
  print(json.dumps(summary))
  return 0


if __name__ == "__main__":
  sys.exit(main())
