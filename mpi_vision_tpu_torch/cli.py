"""Command-line entry point: ``python -m mpi_vision_tpu_torch <command>``.

  * ``train`` — train the stereo-magnification U-Net (train/) on a
    RealEstate10K-layout dataset or the procedural ``--synthetic`` one, with
    the VGG-perceptual loss rendered through the CUDA kernels forward and
    backward (``--planned-render``, the default), on the card
    (``--device cuda``, the default) or, when asked, the CPU.
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
  import tempfile

  import numpy as np
  import torch

  from mpi_vision_tpu_torch import config
  from mpi_vision_tpu_torch.data import realestate
  from mpi_vision_tpu_torch.device import resolve_device
  from mpi_vision_tpu_torch.train import loop as train_loop

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
  state = cfg.make_train_state(args.seed, device)
  vgg = cfg.make_vgg(device) if args.vgg_loss else None
  method = "fused_pallas" if args.planned_render else "fused"
  step = cfg.make_train_step(vgg, method)
  _log(f"train: {cfg.data.img_size}px x {cfg.data.num_planes} planes on "
       f"{device}, render method {method}, cuDNN TF32 "
       f"{torch.backends.cudnn.allow_tf32}")

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

  dataset = cfg.data.make_dataset(rng=np.random.default_rng(args.seed),
                                  device=device)
  order = np.random.default_rng(args.seed + 1)
  t0 = time.time()
  all_losses, valid_losses = [], []
  for epoch in range(cfg.epochs):
    state, losses = train_loop.fit(
        state, realestate.prefetch_batches(realestate.iterate_batches(
            dataset, batch_size=cfg.data.batch_size, rng=order)),
        step=step)
    all_losses.extend(losses)
    if not losses:
      continue
    msg = f"epoch {epoch}: train loss {np.mean(losses):.4f}"
    if valid_batches:
      valid_losses.append(train_loop.evaluate(state, valid_batches,
                                              eval_step))
      msg += f" valid loss {valid_losses[-1]:.4f}"
    _log(msg + f" ({time.time() - t0:.0f}s elapsed)")
  if not all_losses:
    raise SystemExit(
        "no training steps ran: check --epochs and that the dataset has at "
        "least batch_size scenes")
  return {
      "command": "train",
      "epochs": cfg.epochs,
      "steps": len(all_losses),
      "first_loss": round(all_losses[0], 5),
      "final_loss": round(all_losses[-1], 5),
      "nonfinite_losses": int(np.sum(~np.isfinite(all_losses))),
      **({"first_valid_loss": round(valid_losses[0], 5),
          "final_valid_loss": round(valid_losses[-1], 5)}
         if valid_losses else {}),
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
