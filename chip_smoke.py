#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mpi_vision_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and ``nvidia-smi``, and exits non-zero — printing no
result — when PyTorch sees no card or the package is not beside it. Every
check raises on failure; nothing is caught and passed over.

Phases:
  1. device: the card's name and power limit (``nvidia-smi``), PyTorch and
     CUDA versions.
  2. build: every kernel under ``mpi_vision_tpu_torch/kernels/csrc/``, one
     ``nvcc`` per source, all started together.
  3. kernel vs plain version at 1080p x 32 planes for five pose classes
     (translation + dolly, 1, 10 and 20 degree pans, a 30 degree pan past
     the TPU kernels' banded tier), which cover separable and general
     homographies: max |kernel - plain| <= 1e-4; a batch
     of all five equals the single-view renders bit for bit, and so does
     every view of 9- and 16-view batches (several view chunks); one scene
     per view (the view-stride path) at a small size.
  4. serve (the main path): ``RenderService`` on the card with
     ``Convention.EXACT`` and two 1080p x 32-plane synthetic scenes, warmed
     up, behind ``make_http_server``; 8 concurrent and 3 sequential
     ``POST /render`` (octet-stream) and three 32-request in-process
     bursts, the last under ``torch.profiler`` for the device's busy share.
     Launch counts are zeroed just before and read just after. Every
     frame is [1080, 1920, 3], finite and bit-identical to a direct
     single-view kernel render; one agrees with the plain version;
     ``/stats`` shows a batch >= 2 on a CUDA engine; the kernel launched
     and the plain version ran nowhere on the path.
  5. times: kernel ms (CUDA events, median of 20) at V = 1 (the identity
     and a 10 degree pan) and V = 8, the
     plain version's ms, the bound, the 8-view frame readback into pinned
     memory (CUDA events), the scheduler's per-frame host copies of one
     8-view flight (host clock), renders/s through the service, and the
     engine's own batch time (host clock) beside the kernel's.
  6. backward kernels vs plain versions at 1080p x 32 planes on the five
     pose classes, with a seeded gradient: kernel A (re-warp + composite
     VJP) equal to its plain version (max_abs_err 0) and kernel B (warp
     transpose) within 1e-4 of its; kernel A also at 1, 10 and 16 planes
     (records in registers), 17, 32 and 33 (shared memory) and one count
     past the cap (parked in dwarped), each for one scene under 2 views and
     one scene per view at a small size, max_abs_err 0, the path read from
     the built kernel; ``rewarp_launch_shape`` equal to the kernel's own
     launch at every plane count; two backward runs bit-identical; the
     gradient through
     ``render_mpi_fused``'s autograd Function equal to the kernels' and
     nonzero; one scene under 3 views (view stride 0) against the sum of
     three single-view backwards (540p); one scene per view at a small
     size; planes that cross the camera's plane counted, and a pose whose
     planes do (65 degree pan) and a magnifying dolly whose tile preimages
     take several shared-memory chunks checked at small sizes (kernel B
     max_abs_err 0).
  7. train (the slice's main path): ``python -m mpi_vision_tpu_torch
     train``'s code path in process at ``TrainConfig()`` (224 px, 10
     planes, the full-width U-Net, VGG loss) on the card, one epoch over 8
     synthetic scenes, launch counts zeroed just before and read just
     after: every loss finite, each step launched the forward kernel and
     both backward kernels, no plain version ran. Then, on one batch, the
     step's loss and its gradients with the kernel backward against the
     plain backward (planes within 1e-4 of max |grad|, conv weights under
     ``cudnn.deterministic``), and times: the backward kernels at 1080p x
     32 (V = 1 under the identity and a 10 degree pan, V = 8) beside their
     plain versions, the library call and the bound; kernel A also at
     1080p x 10 planes (V = 1 and 8) and 480 x 480 x 33, each beside its
     bound and with the path it took; the train step and its split (the
     profiler's busy time of the U-Net, render forward, kernels A and B,
     VGG loss, optimizer) and the card's busy share over steps.
  8. the compose kernel (``kernels/compose_over.py``) vs its plain version
     at 1080p x 32 planes, V = 1 and V = 8, f32 and bf16, with alphas of
     exactly 0 and 1 and a one-plane stack: f32 within 1e-4 (the design
     gives 0), bf16 within one bf16 ulp; the gradient through its autograd
     Function equal to the plain scan's; times by CUDA events (median of
     20; the plain version 3 runs) beside the bound.
  9. tiled serving (the slice's main path): ``RenderService(method=
     "pallas", tile="auto", convention=EXACT)`` on a 1080 x 1920 x 32
     depth-stratified scene (``synthetic_tiled_scene``) with a narrow-FOV
     camera, behind ``make_http_server``; concurrent and sequential
     ``POST /render`` and a profiled in-process burst, launch counts zeroed
     just before and read just after. Every frame [1080, 1920, 3] and
     finite; every frame, full coverage or culled, bit-identical to an
     untiled ``method="pallas"`` service's (a crop renders through its
     window of the scene with the full render's taps), one frame within
     1e-4 of the fused kernel's render; ``/stats`` shows
     culled tiles and a request with fewer than 32 planes; the compose
     kernel launched, no plain version ran. Then renders/s, latency, the
     warp vs composite split of a flight, crop assembly and the busy share.
 10. crash-safe training (the slice's main path): ``cli.cmd_train`` in
     process at ``TrainConfig()`` with ``--ckpt D0 --save-every 2`` over 6
     synthetic scenes for 2 epochs (12 steps, no validation), then two
     subprocesses of ``python -m mpi_vision_tpu_torch train`` with the same
     arguments, one with ``--inject-fault crash@step=7,hard`` and one that
     also corrupts save 3: each must die by SIGKILL (rc -9) leaving a
     published ``step_*`` directory. Both resume in process with
     ``--resume``: from step 6 (clean kill) and from step 4 with one
     quarantine (corrupt), and both final checkpoints' digests equal D0's.
     Around every in-process run the launch counts are zeroed and read: the
     forward kernel, A and B launched once per step, no plain version ran.
     One ``nan@step=3`` run rolls back once and checkpoints the halved LR;
     ``--lr-find --lr-find-steps 20`` suggests a finite LR inside the sweep
     with every sweep step on the kernels. A step at ``TrainConfig()`` and
     a 256 px step (the loss resizes to 224) run under
     ``torch.use_deterministic_algorithms(True)``, the latter's gradients
     bit-identical twice. Then times: the step with cuDNN deterministic off
     and on in turns, one checkpoint's save (foreground, and
     ``BackgroundSaver``: until ``save`` returns, then the flush) and bytes,
     and its hash-verified restore and the copy into the state.
 11. train -> serve -> viewer (the slice's main path), over phase 10's
     uninterrupted store at ``TrainConfig()``: ``ckpt.export`` restores
     only the params (timed, bytes read against the checkpoint's) and
     bakes 2 scenes on the card, ids in the step-and-digest form, each
     ``rgba`` within 1e-4 of the U-Net's plain CPU forward with the same
     weights. A ``RenderService(method="fused_pallas", convention=EXACT)``
     behind ``make_http_server`` serves them under stable ids, every frame
     bit-identical to a direct kernel render. Every frame this phase
     serves is also held to ``plain_render`` on the same baked planes and
     homographies (TOL), between the counted windows. Live reload: a
     ``CheckpointWatcher`` (``serve --reload-ckpt-s``'s callback) watches
     the store while 4 clients stream ``POST /render``; ``cmd_train
     --resume`` publishes step 14 (2 steps, kernels A and B once each); the
     watcher fires once, no request fails, every frame is the old bake's or
     the new one's, and every request started after the swap renders the
     new bake. A one-tile change swapped into a ``tile="auto"`` service
     re-bakes one tile and its renders launch the compose kernel. A step-0
     checkpoint of ``TrainConfig.scaled_480()`` bakes and serves one
     480 x 480 x 33 scene, and ``tests/fixtures/scene_009`` is served
     through ``cli.mpi_dir_scene``, both bit-identical to direct kernel
     renders; ``export-viewer`` writes an HTML page that parses and embeds
     10 PNG layers; two ``train --bf16`` steps at ``TrainConfig()`` run the
     kernels with finite losses and leave an f32 checkpoint whose meta
     says ``bfloat16``. Every window zeroes the launch counts just before
     and reads them just after; no plain version runs in any. Then times:
     restore, bake (224 x 10 and 480 x 33), renders/s before, during the
     training and during the reload, swap -> first new frame, export-viewer
     and the step in f32 and bf16 in turns.
 12. serving under faults and overload (the slice's main path), 1080p x 32,
     ``Convention.EXACT``, behind ``make_http_server``; every window zeroes
     the launch counts and the plain versions' counts (by device) just
     before and reads them just after, and no plain version runs on the
     card in any. (a) Fault drill: a ``FaultyEngine``-wrapped
     ``fused_pallas`` service with ``cpu_fallback="on"`` and a watchdog of
     twice a CPU frame (timed first): injected transient errors open the
     breaker, at most 4 requests are served by the CPU fallback, each
     within 1e-4 of a direct kernel render, while ``/healthz`` reads
     ``degraded``; after ``breaker_reset_s`` the probe goes to the card,
     the breaker closes and frames are bit-identical to direct kernel
     renders again; a hang is abandoned by the watchdog and retried on the
     card; a bake fault on a cold scene is retried. No request fails; the
     events hold the breaker transitions; ``plain_render`` ran on the CPU
     exactly once per fallback dispatch. (d) ``GET /debug/profile
     ?seconds=1`` during a burst writes a Chrome trace naming the render
     kernel and the ``render/*`` ranges; a second capture at the same time
     gets 409. (b) Edge cache: a miss launches the kernel, repeats are
     hits, ``If-None-Match`` -> 304, a near pose is warped on the card
     (within 1e-4 of the CPU warp) with no render, far poses miss; kernel
     launches equal misses; p50 latency of each kind and the warp's device
     time. (c) Brownout on phase 9's tiled scene, with a ladder clock the
     phase drives: L0 -> L4 and back; L0 frames bit-identical to the
     untiled ``pallas`` service's, L1 to a direct render of the thinned
     planes, L2 and L3 to a direct half-resolution render of them followed
     by ``upsample_nearest``; at L4 interactive and background requests
     get 503 with ``Retry-After``; the compose kernel launches; renders/s
     at L0, L1 and L2.
 13. the reference's helper surface, config 5's tiny U-Net and the serving
     flight recorder (the slice's main paths), each window with the launch
     counts zeroed just before and read just after and no plain version
     run in it. (a) ``compat.mpi_render_view_torch`` renders
     ``tests/fixtures/scene_009`` (640 x 400 x 10) and a 1080p x 32 MPI,
     ``compat.over_composite`` a 32-plane 1080p list and its stack,
     ``plane_sweep_torch`` and ``format_network_input_torch`` run at 224 px
     x 10 planes: the renders launch ``render_fused`` once each, the
     composites the compose kernel, and each is 0.0 from ``plain_render``
     / ``plain_composite`` on the same planes and homographies; compat's
     1080p render ms beside the kernel's alone. (b) BASELINE config 5:
     ``TinyPlaneUNet`` on one synthetic 64 x 64 x 8 scene, Adam at 1e-3,
     150 steps of the L2 render loss through ``method="fused_pallas"``:
     the loss falls, every step launches the forward kernel, A and B once,
     one step's gradients with the kernel backward within 1e-4 of the
     plain backward's; train seconds and inference frames/s (20 calls).
     (c) ``RenderService`` on phase 12's 1080p x 32 scene over HTTP with
     the ``serve`` CLI's ``--slo-quantile 0.99 --tsdb-interval-s 0.25
     --attrib --incident-dir --incident-profile 0.5 --ship-url`` (an
     in-process ``ShipSink``): 3 clients stream ``POST /render`` while
     ``/metrics`` is scraped at ~4 Hz and parsed; slow dispatches from
     ``serve/faultinject.py`` fire the quantile SLO and exactly one
     incident bundle follows, whose profile names ``render_fused_kernel``;
     the sink stops (batches spool) and restarts (the spool drains in
     order, the bundle arrives); every request answers 200, ``/metrics``'
     render counters equal ``/stats``, the attribution ledger's cells
     reconcile with the metrics' totals, ``/debug/tsdb`` has points;
     renders/s with the recorder off and on, scrape p50, capture ms,
     shipped bytes. (d) ``TRAIN_STEPS`` steps at ``TrainConfig()`` with
     ``--ckpt --metrics-port 0``: a scrape mid-run shows the
     ``mpi_train_*`` families and the steps run; the step ms beside phase
     7's.
Then the ``{"kernels": [...]}`` line (each row with its launches in
phase 11's, phase 12's and phase 13's windows), the ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import base64
import concurrent.futures
import hashlib
import html.parser
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HEIGHT, WIDTH, PLANES = 1080, 1920, 32
TOL = 1e-4
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# Each CUDA kernel and the TPU kernels (file:line of the Pallas kernel
# function) it replaces, the first named as "replaces".
REPLACES = {
    "render_fused": ["mpi_vision_tpu/kernels/render_pallas.py:271",
                     "mpi_vision_tpu/kernels/render_pallas.py:426",
                     "mpi_vision_tpu/kernels/render_pallas.py:847"],
    "rewarp_composite_vjp": ["mpi_vision_tpu/kernels/render_pallas_bwd.py:61",
                             "mpi_vision_tpu/kernels/render_pallas_bwd.py:120"],
    "adjoint_warp": ["mpi_vision_tpu/kernels/render_pallas_bwd.py:263",
                     "mpi_vision_tpu/kernels/render_pallas_bwd.py:529"],
    "over_composite": ["mpi_vision_tpu/kernels/compose_pallas.py:41"],
}
SOURCES = {
    "render_fused": "mpi_vision_tpu_torch/kernels/csrc/render_fused.cu",
    "rewarp_composite_vjp":
        "mpi_vision_tpu_torch/kernels/csrc/render_fused_bwd.cu",
    "adjoint_warp": "mpi_vision_tpu_torch/kernels/csrc/render_fused_bwd.cu",
    "over_composite": "mpi_vision_tpu_torch/kernels/csrc/compose_over.cu",
}
# Phase 7: one epoch over this many synthetic scenes is this many steps.
TRAIN_STEPS = 8


class SmokeError(RuntimeError):
  pass


def check(cond, msg: str) -> None:
  if not cond:
    raise SmokeError(msg)


def log(msg: str) -> None:
  print(msg, flush=True)


def card_line() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"],
      capture_output=True, text=True, timeout=60, check=True)
  return out.stdout.strip().splitlines()[0]


def pan_pose(deg: float, tx: float = 0.05, tz: float = 0.0) -> np.ndarray:
  pose = np.eye(4, dtype=np.float32)
  c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
  pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
  pose[0, 3], pose[2, 3] = tx, tz
  return pose


def pose_classes() -> dict[str, np.ndarray]:
  truck = np.eye(4, dtype=np.float32)
  truck[0, 3], truck[2, 3] = 0.08, -0.05  # translation + dolly
  return {"translation_dolly": truck,
          "pan_1deg": pan_pose(1.0, 0.05, -0.03),
          "pan_10deg": pan_pose(10.0),
          "pan_20deg": pan_pose(20.0),
          "pan_30deg": pan_pose(30.0)}


def cuda_ms(torch, fn, reps: int, warm: int = 2) -> float:
  """Median device time of ``fn()`` in ms, CUDA events around each call."""
  for _ in range(warm):
    fn()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


def host_ms(fn, reps: int) -> float:
  """Median host-clock time of ``fn()`` in ms, after one warm call."""
  fn()
  times = []
  for _ in range(reps):
    t0 = time.perf_counter()
    fn()
    times.append((time.perf_counter() - t0) * 1e3)
  return statistics.median(times)


def least_ms(nbytes: float, ops: float) -> tuple[float, str]:
  """The larger of bytes over the HBM rate and f32 operations over the f32
  peak, in ms, and which of the two it is."""
  t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
  return (max(t_bytes, t_ops) * 1e3,
          "bytes" if t_bytes >= t_ops else "operations")


def bound(views: int) -> tuple[float, str]:
  """Least time (ms) for ``views`` renders of one resident scene: every
  input byte read once, every output byte written once, against the
  kernel's f32 operations at the f32 peak."""
  from mpi_vision_tpu_torch.kernels import render_fused

  nbytes = (PLANES * HEIGHT * WIDTH * 16 + views * PLANES * 9 * 4
            + views * HEIGHT * WIDTH * 3 * 4)
  return least_ms(nbytes,
                  views * HEIGHT * WIDTH * PLANES * render_fused.FLOPS_PER_SAMPLE)


def bwd_bounds(views: int, planes: int = PLANES, height: int = HEIGHT,
               width: int = WIDTH) -> dict:
  """Least times (ms) of the two backward kernels for ``views`` views of
  one scene. A: read the scene, the homographies and g once, write
  dwarped. B: read dwarped and the homographies, write d planes (one
  scene). Operations: ``FLOPS_A`` / ``FLOPS_B`` per target pixel, plane
  and view."""
  from mpi_vision_tpu_torch.kernels import render_fused_bwd as rb

  scene = planes * height * width * 16
  homs = views * planes * 9 * 4
  samples = views * planes * height * width
  a = least_ms(scene + homs + views * height * width * 12 + views * scene,
               samples * rb.FLOPS_A)
  b = least_ms(views * scene + homs + scene, samples * rb.FLOPS_B)
  return {"rewarp_composite_vjp": a, "adjoint_warp": b,
          "pair_ms": least_ms(scene + homs + views * height * width * 12
                              + 2 * views * scene + scene,
                              samples * (rb.FLOPS_A + rb.FLOPS_B))[0]}


def homs_at(torch, dev, poses: np.ndarray, planes: int, height: int,
            width: int):
  """``[V, P, 3, 3]`` pixel homographies of ``poses`` for a 1080p-shaped
  camera (focal 0.5 W) at ``height`` x ``width``, EXACT convention."""
  from mpi_vision_tpu_torch.core.camera import intrinsics_matrix, inv_depths
  from mpi_vision_tpu_torch.core.sampling import Convention
  from mpi_vision_tpu_torch.kernels import render_fused

  k = intrinsics_matrix(0.5 * width, 0.5 * width, width / 2.0, height / 2.0,
                        device=dev)
  pt = torch.from_numpy(np.ascontiguousarray(poses)).to(dev)
  return render_fused.pixel_homographies(
      pt, inv_depths(1.0, 100.0, planes, device=dev),
      k.expand(len(poses), 3, 3), height, width,
      Convention.EXACT).transpose(0, 1).contiguous()


SERVE_KINDS = (("kernel_s", "render_fused"), ("d2h_s", "DtoH"),
               ("h2d_s", "HtoD"))
TRAIN_KINDS = (("render_fused_s", "render_fused_kernel"),
               ("rewarp_composite_vjp_s", "rewarp_composite_vjp_kernel"),
               ("adjoint_warp_s", "adjoint_warp_kernel"),
               ("h2d_s", "HtoD"), ("d2h_s", "DtoH"))


def device_activity(torch, fn, kinds=SERVE_KINDS) -> dict:
  """Run ``fn()`` under ``torch.profiler`` (CUDA activity only) and split
  the card's busy time: the union of every device interval, and the summed
  durations of the events whose names hold each of ``kinds``' substrings
  (first match wins) and of everything else. ``busy_share`` is the union
  over the host-clock wall time of ``fn()``; None where the profiler saw no
  device activity."""
  from torch.profiler import ProfilerActivity, profile

  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  spans = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
  split = {kind: 0.0 for kind, _ in kinds}
  split["other_s"] = 0.0
  for start, end, name in spans:
    kind = next((k for k, sub in kinds if sub in name), "other_s")
    split[kind] += (end - start) * 1e-6
  busy_s = union_us(spans) * 1e-6
  return {"wall_s": wall, "events": len(spans),
          "busy_s": busy_s if spans else None,
          "busy_share": busy_s / wall if spans else None, **split}


def union_us(spans) -> float:
  """Length of the union of ``(start, end, ...)`` intervals (µs)."""
  busy, cur_start, cur_end = 0.0, None, None
  for start, end, *_ in sorted(spans):
    if cur_end is None or start > cur_end:
      if cur_end is not None:
        busy += cur_end - cur_start
      cur_start, cur_end = start, end
    else:
      cur_end = max(cur_end, end)
  if cur_end is not None:
    busy += cur_end - cur_start
  return busy


def device_busy_by_piece(torch, pieces: dict) -> dict:
  """Run each of ``pieces`` once, in turn, under one ``torch.profiler``
  session (CPU and CUDA activity), each inside a ``record_function`` range
  that ends after a synchronise; the card's busy time (ms) of each piece is
  the union of the device intervals that start inside its range. None
  where the profiler saw none."""
  from torch.profiler import ProfilerActivity, profile, record_function

  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for name, fn in pieces.items():
      with record_function(f"piece:{name}"):
        fn()
        torch.cuda.synchronize()
  ranges, spans = {}, []
  for e in prof.events():
    if e.name.startswith("piece:"):
      # The GPU-side copy of a range annotation is not device work.
      if e.device_type == torch.autograd.DeviceType.CPU:
        ranges[e.name[len("piece:"):]] = (e.time_range.start,
                                          e.time_range.end)
    elif e.device_type == torch.autograd.DeviceType.CUDA:
      spans.append((e.time_range.start, e.time_range.end))
  busy = {}
  for name in pieces:
    lo, hi = ranges.get(name, (0.0, -1.0))
    inside = [span for span in spans if lo <= span[0] <= hi]
    busy[name] = union_us(inside) * 1e-3 if inside else None
  return busy


def phase6_backward(torch, dev, planes, classes) -> dict:
  """Backward kernels vs their plain versions (see the module docstring).
  Returns the largest error of each kernel."""
  from mpi_vision_tpu_torch.kernels import render_fused
  from mpi_vision_tpu_torch.kernels import render_fused_bwd as rb

  gen = torch.Generator(device=dev).manual_seed(6)
  errs = {"rewarp_composite_vjp": 0.0, "adjoint_warp": 0.0}

  def held(name, got, want):
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite gradient")
    check(err <= TOL, f"{name}: kernel disagrees with its plain version by "
          f"{err} > {TOL}")
    return err

  def held_exact(name, got, want):
    err = held(name, got, want)
    check(err == 0.0, f"{name}: max_abs_err {err}, not 0")
    return err

  crossing = {}
  for name, pose in classes.items():
    homs = homs_at(torch, dev, pose[None], PLANES, HEIGHT, WIDTH)
    g = torch.randn((1, HEIGHT, WIDTH, 3), generator=gen, device=dev)
    dwarped = rb.rewarp_composite_vjp(planes, homs, g)
    err_a = held_exact(f"A [{name}]", dwarped,
                       rb.plain_rewarp_composite_vjp(planes, homs, g))
    dplanes = rb.adjoint_warp(dwarped, homs, shared=True)
    err_b = held(f"B [{name}]", dplanes,
                 rb.plain_adjoint_warp(dwarped, homs, shared=True))
    errs["rewarp_composite_vjp"] = max(errs["rewarp_composite_vjp"], err_a)
    errs["adjoint_warp"] = max(errs["adjoint_warp"], err_b)
    crossing[name] = rb.sign_changing_planes(homs, HEIGHT, WIDTH)
    log(f"backward vs plain [{name}]: A max_abs_err {err_a:.3e}, B "
        f"max_abs_err {err_b:.3e}, max |d planes| "
        f"{float(dplanes.abs().max()):.3e}, planes crossing the camera "
        f"plane {crossing[name]}")
    if name == "pan_30deg":
      check(torch.equal(dplanes, rb.backward_planes(planes, homs, g)),
            "two backward runs differ")
      leaf = planes.clone().requires_grad_(True)
      (render_fused.render_mpi_fused(leaf, homs) * g).sum().backward()
      check(torch.equal(leaf.grad, dplanes),
            "the autograd Function's gradient is not the kernels'")
      check(float(leaf.grad.abs().max()) > 0, "zero gradient to the planes")
      log("backward: two runs bit-identical; render_mpi_fused's autograd "
          "gradient == kernels A + B, nonzero")
      del leaf
    del dwarped, dplanes
  log(f"backward: planes crossing the camera plane per pose class "
      f"{json.dumps(crossing)}")

  # One scene under three views (view stride 0) vs three single views.
  p5, h5, w5 = PLANES, HEIGHT // 2, WIDTH // 2
  scene = torch.rand((p5, h5, w5, 4), generator=gen, device=dev)
  poses3 = np.stack([classes[n] for n in ("translation_dolly", "pan_10deg",
                                          "pan_30deg")])
  homs3 = homs_at(torch, dev, poses3, p5, h5, w5)
  g3 = torch.randn((3, h5, w5, 3), generator=gen, device=dev)
  shared = rb.backward_planes(scene, homs3, g3)
  summed = sum(rb.backward_planes(scene, homs3[v:v + 1].contiguous(),
                                  g3[v:v + 1].contiguous()) for v in range(3))
  err_shared = float((shared - summed).abs().max())
  log(f"backward: 3 views of one scene vs the sum of 3 single views "
      f"({h5}x{w5}x{p5}): max_abs_err {err_shared:.3e}")
  check(err_shared <= TOL, f"shared-scene backward: {err_shared}")
  del scene, shared, summed

  # One scene per view (view stride != 0), planes crossing the camera
  # plane (the whole-image scan) and a magnifying dolly whose near planes'
  # tile preimages take several shared-memory chunks, at small sizes.
  zoom = np.eye(4, dtype=np.float32)
  zoom[2, 3] = -0.8
  for label, poses, (sp, sh, sw) in (
      ("one scene per view", np.stack([classes["pan_1deg"],
                                       classes["pan_10deg"]]), (8, 256, 384)),
      ("65 degree pan", pan_pose(65.0)[None], (4, 48, 64)),
      ("dolly 0.8", zoom[None], (4, 96, 640))):
    homs = homs_at(torch, dev, poses, sp, sh, sw)
    views = len(poses)
    scenes = torch.rand(((views, sp, sh, sw, 4) if views > 1
                         else (sp, sh, sw, 4)), generator=gen, device=dev)
    g = torch.randn((views, sh, sw, 3), generator=gen, device=dev)
    dwarped = rb.rewarp_composite_vjp(scenes, homs, g)
    err_a = held_exact(f"A [{label}]", dwarped,
                       rb.plain_rewarp_composite_vjp(scenes, homs, g))
    err_b = held(f"B [{label}]",
                 rb.adjoint_warp(dwarped, homs, shared=views == 1),
                 rb.plain_adjoint_warp(dwarped, homs, shared=views == 1))
    n_cross = rb.sign_changing_planes(homs, sh, sw)
    boxes = [box for hom in homs[0].cpu()
             for box in torch.stack(rb.tile_boxes(hom, sh, sw)[:4],
                                    1).tolist()]
    chunks = max(len(rb.tile_chunks(box)) for box in boxes)
    widest = max(box[3] - box[2] + 1 for box in boxes)
    log(f"backward vs plain [{label}, {sh}x{sw}x{sp}]: A {err_a:.3e}, B "
        f"{err_b:.3e}, planes crossing the camera plane {n_cross}, most "
        f"chunks a tile's preimage takes {chunks}, widest preimage "
        f"{widest} columns")
    if label != "one scene per view":
      check(err_b == 0.0, f"B [{label}]: max_abs_err {err_b}, not 0")
    if label == "65 degree pan":
      check(n_cross > 0, "the crossing pose crosses no plane")
    if label == "dolly 0.8":
      check(chunks > 1 and widest > rb.SEG_MAX,
            "the dolly's preimages fit one chunk or one segment a row")
    errs["rewarp_composite_vjp"] = max(errs["rewarp_composite_vjp"], err_a)
    errs["adjoint_warp"] = max(errs["adjoint_warp"], err_b)

  # Kernel A on each of its paths: records in registers, in shared memory,
  # and past the cap parked in dwarped.
  sh, sw = 72, 136
  poses = np.stack([classes["pan_10deg"], classes["translation_dolly"]])
  paths = {}
  for sp in (1, 10, 16, 17, 32, 33, rb.SMEM_PLANES + 1):
    homs = homs_at(torch, dev, poses, max(sp, 2), sh, sw)[:, :sp].contiguous()
    g = torch.randn((2, sh, sw, 3), generator=gen, device=dev)
    path = rb.kernel_rewarp_launch_shape(2, sp, sh, sw)["path"]
    paths.setdefault(path, []).append(sp)
    for shape in ((sp, sh, sw, 4), (2, sp, sh, sw, 4)):
      scenes = torch.rand(shape, generator=gen, device=dev)
      kind = "one scene" if len(shape) == 4 else "one scene per view"
      err_a = held_exact(f"A [{sp} planes, {path} path, {kind}]",
                         rb.rewarp_composite_vjp(scenes, homs, g),
                         rb.plain_rewarp_composite_vjp(scenes, homs, g))
      errs["rewarp_composite_vjp"] = max(errs["rewarp_composite_vjp"], err_a)
  log(f"backward: kernel A equals its plain version (max_abs_err 0) at "
      f"{sh}x{sw}, 2 views, one scene and one per view, on each path "
      f"{json.dumps(paths)}")
  check(set(paths) == {"registers", "shared", "global"},
        f"kernel A's paths not all taken: {paths}")
  # The Python mirror of kernel A's launch equals the built kernel's at
  # every plane count it takes, on the main path's and edge shapes.
  for views, sh, sw in ((1, 224, 224), (8, HEIGHT, WIDTH), (3, 1, 1),
                        (5, 37, 1001)):
    for sp in range(1, rb.MAX_PLANES + 1):
      want = rb.kernel_rewarp_launch_shape(views, sp, sh, sw)
      got = rb.rewarp_launch_shape(views, sp, sh, sw)
      check(got == want, f"rewarp_launch_shape({views}, {sp}, {sh}, {sw}) "
            f"= {got}, the kernel launches {want}")
  log(f"backward: rewarp_launch_shape equals the kernel's launch at 1.."
      f"{rb.MAX_PLANES} planes")
  return errs


def phase7_train(torch, dev, workdir: str) -> dict:
  """The slice's main path, then the step's gradient check and its times
  (see the module docstring)."""
  import PIL

  from mpi_vision_tpu_torch import cli, config
  from mpi_vision_tpu_torch.core import geometry
  from mpi_vision_tpu_torch.core.sampling import Convention
  from mpi_vision_tpu_torch.data import realestate
  from mpi_vision_tpu_torch.kernels import render_fused
  from mpi_vision_tpu_torch.kernels import render_fused_bwd as rb
  from mpi_vision_tpu_torch.models.stereo_mag import mpi_from_net_output
  from mpi_vision_tpu_torch.train import loop as train_loop
  from mpi_vision_tpu_torch.train import loss as loss_lib

  root = os.path.join(workdir, "re10k")
  args = cli.build_parser().parse_args(
      ["train", "--synthetic", "--synthetic-scenes", str(TRAIN_STEPS),
       "--epochs", "1", "--dataset", root, "--device", "cuda"])
  cfg = config.TrainConfig()
  check((args.img_size, args.num_planes, args.lr, args.vgg_resize)
        == (cfg.data.img_size, cfg.data.num_planes, cfg.learning_rate,
            cfg.vgg_resize) and args.vgg_loss and args.planned_render,
        "the train CLI's defaults are not TrainConfig()")
  log(f"train: data route synthesize_dataset -> RealEstateDataset "
      f"(Pillow {PIL.__version__}), {TRAIN_STEPS} scenes at "
      f"{args.img_size}px, {args.num_planes} planes")
  counters = (render_fused.render_mpi_fused, rb.rewarp_composite_vjp,
              rb.adjoint_warp)
  plains = (render_fused.plain_render, rb.plain_rewarp_composite_vjp,
            rb.plain_adjoint_warp)
  for fn in counters:
    fn.launches = 0
  for fn in plains:
    fn.calls = 0
  t0 = time.perf_counter()
  summary = cli.cmd_train(args)
  torch.cuda.synchronize()
  train_s = time.perf_counter() - t0
  launches = {fn.__name__: fn.launches for fn in counters}
  plain_calls = {fn.__name__: fn.calls for fn in plains}
  log(f"train: summary {json.dumps(summary)} in {train_s:.2f}s; launches "
      f"{json.dumps(launches)}; plain versions {json.dumps(plain_calls)}; "
      f"cuDNN TF32 {torch.backends.cudnn.allow_tf32}")
  steps = summary["steps"]
  check(steps == TRAIN_STEPS, f"{steps} train steps, not {TRAIN_STEPS}")
  check(summary["nonfinite_losses"] == 0
        and np.isfinite([summary["first_loss"], summary["final_loss"],
                         summary["final_valid_loss"]]).all(),
        f"non-finite losses: {summary}")
  check(launches["rewarp_composite_vjp"] == steps
        and launches["adjoint_warp"] == steps,
        f"a step did not launch both backward kernels: {launches}")
  # The forward kernel renders every train step and every valid example.
  check(launches["render_mpi_fused"] == steps + TRAIN_STEPS,
        f"the forward kernel did not render every step: {launches}")
  check(not any(plain_calls.values()),
        f"a plain version ran on the train path: {plain_calls}")
  check(not torch.backends.cudnn.allow_tf32, "the trainer left TF32 on")

  # One batch at TrainConfig(), the loss split at the render's input.
  cfg = config.TrainConfig(data=config.DataConfig(dataset_path=root))
  state = cfg.make_train_state(0, dev)
  vgg = cfg.make_vgg(dev)
  batch = next(realestate.iterate_batches(
      cfg.data.make_dataset(rng=np.random.default_rng(0), device=dev),
      rng=np.random.default_rng(1)))
  size = cfg.data.img_size
  rel = geometry.matmul_small(batch["tgt_img_cfw"], batch["ref_img_wfc"])
  homs = render_fused.pixel_homographies(
      rel, batch["mpi_planes"][0], batch["intrinsics"], size, size,
      Convention.REF_HOMOGRAPHY).transpose(0, 1).contiguous()
  params = list(state.model.parameters())

  def net_planes():
    pred = state.model(batch["net_input"])
    rgba = mpi_from_net_output(pred, batch["ref_img"])    # [1,H,W,P,4]
    return pred, rgba[0].movedim(2, 0).contiguous()        # [P,H,W,4]

  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    _, planes = net_planes()
    grads, losses = {}, {}
    for route in ("kernel", "plain"):
      leaf = planes.detach().requires_grad_(True)
      out = (render_fused.render_mpi_fused(leaf, homs) if route == "kernel"
             else render_fused.plain_render(leaf.detach(), homs))
      out = out.detach().requires_grad_(True)
      loss = loss_lib.perceptual_loss(out, batch["tgt_img"], vgg,
                                      cfg.vgg_resize)
      loss.backward()
      g = out.grad.contiguous()
      dplanes = (rb.backward_planes(leaf.detach(), homs, g)
                 if route == "kernel" else rb.plain_adjoint_warp(
                     rb.plain_rewarp_composite_vjp(leaf.detach(), homs, g),
                     homs, shared=True))
      weights = torch.autograd.grad(planes, params, dplanes,
                                    retain_graph=True)
      grads[route], losses[route] = (dplanes, weights), loss.item()
    with torch.no_grad():
      full = float(train_loop.make_loss_fn(vgg, cfg.vgg_resize,
                                           "fused_pallas")(state.model, batch))
  finally:
    torch.backends.cudnn.deterministic = deterministic
  scale = float(grads["plain"][0].abs().max())
  err_planes = float((grads["kernel"][0] - grads["plain"][0]).abs().max())
  err_weights = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                    for a, b in zip(grads["kernel"][1], grads["plain"][1]))
  log(f"train: one step's loss kernel {losses['kernel']!r} plain "
      f"{losses['plain']!r}; d planes max_abs_err {err_planes:.3e} of max "
      f"{scale:.3e}; conv-weight gradients (cudnn.deterministic) max "
      f"relative err {err_weights:.3e}")
  check(losses["kernel"] == losses["plain"] == full,
        f"the losses differ: split {losses}, the train step's own {full!r}")
  check(scale > 0, "no gradient reaches the planes")
  check(err_planes <= 1e-4 * scale, f"d planes differ by {err_planes}")
  check(err_weights <= 1e-4, f"conv-weight gradients differ: {err_weights}")
  return {"launches": launches, "summary": summary, "train_s": train_s,
          "state": state, "vgg": vgg, "batch": batch, "homs": homs,
          "net_planes": net_planes, "cfg": cfg}


def train_times(torch, step_run) -> dict:
  """The train step at TrainConfig() and its split (see the docstring)."""
  from mpi_vision_tpu_torch.kernels import render_fused
  from mpi_vision_tpu_torch.kernels import render_fused_bwd as rb
  from mpi_vision_tpu_torch.train import loss as loss_lib

  state, vgg, batch, homs = (step_run[k] for k in ("state", "vgg", "batch",
                                                    "homs"))
  cfg = step_run["cfg"]
  step = cfg.make_train_step(vgg)

  def one_step():
    step(state, batch)
    torch.cuda.synchronize()

  step_ms = host_ms(one_step, 10)
  pred, planes = step_run["net_planes"]()
  pred_grad = torch.randn_like(pred)

  def unet():
    state.model(batch["net_input"]).backward(pred_grad)

  planes = planes.detach()
  out = render_fused.render_mpi_fused(planes, homs)
  g = torch.randn_like(out)
  dwarped = rb.rewarp_composite_vjp(planes, homs, g)
  leaf = out.detach().requires_grad_(True)

  def vgg_loss():
    loss_lib.perceptual_loss(leaf, batch["tgt_img"], vgg,
                             cfg.vgg_resize).backward()

  pieces = {
      "unet_fwd_bwd": unet,
      "render_fwd": lambda: render_fused.render_mpi_fused(planes, homs),
      "render_bwd_a": lambda: rb.rewarp_composite_vjp(planes, homs, g),
      "render_bwd_b": lambda: rb.adjoint_warp(dwarped, homs, shared=True),
      "vgg_fwd_bwd": vgg_loss,
      "optimizer": state.optimizer.step,
  }
  for fn in pieces.values():  # warm: cuDNN plans, allocator, Adam state
    fn()
  # The profiler's busy time of one run of each piece; CUDA events around
  # a piece would also count the card's idle gaps while the host enqueues.
  busy = device_busy_by_piece(torch, pieces)
  activity = device_activity(
      torch, lambda: [step(state, batch) for _ in range(5)], TRAIN_KINDS)
  return {"step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
          "split_device_busy_ms": busy,
          "profiled_5_steps": activity}


def backward_times(torch, dev, planes) -> dict:
  """Kernels A and B at 1080p x 32 (CUDA events) at V = 1 under the
  identity and a 10 degree pan and at V = 8, their plain versions, the
  library call and the bounds."""
  from mpi_vision_tpu_torch.kernels import render_fused
  from mpi_vision_tpu_torch.kernels import render_fused_bwd as rb

  gen = torch.Generator(device=dev).manual_seed(5)
  grid, scale = render_fused.pixel_grid(HEIGHT, WIDTH, dev)
  out = {}
  for label, poses in (
      ("v1", pan_pose(0.0, 0.0, 0.0)[None]),
      ("v1_pan10", pan_pose(10.0)[None]),
      ("v8", np.stack([pan_pose(1.0 * i, 0.01 * i, -0.01 * i)
                       for i in range(8)]))):
    views = len(poses)
    homs = homs_at(torch, dev, poses, PLANES, HEIGHT, WIDTH)
    g = torch.randn((views, HEIGHT, WIDTH, 3), generator=gen, device=dev)
    dwarped = rb.rewarp_composite_vjp(planes, homs, g)
    row = {
        "a_ms": cuda_ms(torch, lambda: rb.rewarp_composite_vjp(
            planes, homs, g), 10, warm=2),
        "b_ms": cuda_ms(torch, lambda: rb.adjoint_warp(
            dwarped, homs, shared=True), 10, warm=2),
        "plain_a_ms": cuda_ms(torch, lambda: rb.plain_rewarp_composite_vjp(
            planes, homs, g), 1, warm=0),
        "plain_b_ms": cuda_ms(torch, lambda: rb.plain_adjoint_warp(
            dwarped, homs, shared=True), 1, warm=0),
    }
    dplanes = rb.adjoint_warp(dwarped, homs, shared=True)
    # The library yardstick: grid_sample's input gradient at the same
    # shapes (one image per view and plane, NCHW; atomic scatter).
    grad_out = dwarped.reshape(views * PLANES, HEIGHT, WIDTH, 4).permute(
        0, 3, 1, 2).contiguous()
    del dwarped
    images = planes.permute(0, 3, 1, 2).repeat(views, 1, 1, 1)
    coords = torch.stack([render_fused.sample_coords(homs[v], grid, scale)
                          for v in range(views)]).reshape(
                              views * PLANES, HEIGHT, WIDTH, 2)
    grid_n = coords * 2.0 - 1.0
    del coords

    def library():
      return torch.ops.aten.grid_sampler_2d_backward(
          grad_out, images, grid_n, 0, 0, False, [True, False])[0]

    row["library_ms"] = cuda_ms(torch, library, 5, warm=1)
    log(f"backward times [{label}]: A {row['a_ms']:.3f} ms, B "
        f"{row['b_ms']:.3f} ms, library {row['library_ms']:.3f} ms (B "
        f"{row['library_ms'] / row['b_ms']:.2f}x faster)")
    lib = library().reshape(views, PLANES, 4, HEIGHT, WIDTH).sum(0)
    row["library_vs_kernel_max_abs"] = float(
        (lib.permute(0, 2, 3, 1) - dplanes).abs().max())
    del grad_out, images, grid_n, lib, dplanes
    bounds = bwd_bounds(views)
    for name, key in (("rewarp_composite_vjp", "a"), ("adjoint_warp", "b")):
      row[f"bound_{key}_ms"], row[f"bound_{key}_by"] = bounds[name]
    row["bound_pair_ms"] = bounds["pair_ms"]
    row["path_a"] = rb.kernel_rewarp_launch_shape(views, PLANES, HEIGHT,
                                                  WIDTH)["path"]
    out[label] = row
    torch.cuda.empty_cache()
  # Kernel A on its other paths' shapes: the training plane count at 1080p
  # (records in registers) and scaled_480's 480 x 480 x 33.
  for label, (sp, sh, sw), poses in (
      ("a_p10_v1", (10, HEIGHT, WIDTH), pan_pose(0.0, 0.0, 0.0)[None]),
      ("a_p10_v8", (10, HEIGHT, WIDTH), np.stack([
          pan_pose(1.0 * i, 0.01 * i, -0.01 * i) for i in range(8)])),
      ("a_480_p33_v1", (33, 480, 480), pan_pose(0.0, 0.0, 0.0)[None])):
    views = len(poses)
    scene = torch.rand((sp, sh, sw, 4), generator=gen, device=dev)
    homs = homs_at(torch, dev, poses, sp, sh, sw)
    g = torch.randn((views, sh, sw, 3), generator=gen, device=dev)
    row = {"a_ms": cuda_ms(torch, lambda: rb.rewarp_composite_vjp(
               scene, homs, g), 10, warm=2),
           "plain_a_ms": cuda_ms(
               torch, lambda: rb.plain_rewarp_composite_vjp(scene, homs, g),
               1, warm=0),
           "path_a": rb.kernel_rewarp_launch_shape(views, sp, sh,
                                                   sw)["path"]}
    row["bound_a_ms"], row["bound_a_by"] = bwd_bounds(
        views, sp, sh, sw)["rewarp_composite_vjp"]
    log(f"backward times [{label}]: A {row['a_ms']:.3f} ms ({row['path_a']}"
        f" path), bound {row['bound_a_ms']:.3f} ms")
    out[label] = row
    del scene, g
    torch.cuda.empty_cache()
  return out


def compose_bound(views: int, itemsize: int) -> tuple[float, str]:
  """Least time (ms) of the compose kernel over a ``views``-view stack:
  every plane read once, the frame written once, against its f32
  operations."""
  from mpi_vision_tpu_torch.kernels import compose_over

  pixels = views * HEIGHT * WIDTH
  return least_ms(PLANES * pixels * 4 * itemsize + pixels * 3 * itemsize,
                  PLANES * pixels * compose_over.FLOPS_PER_SAMPLE)


def bf16_ulps(torch, got, want) -> int:
  """Largest distance in bf16 steps between two non-negative bf16
  tensors (their bit patterns order like their values)."""
  return int((got.view(torch.int16).to(torch.int32)
              - want.view(torch.int16).to(torch.int32)).abs().max())


def phase8_compose(torch, dev) -> dict:
  """The compose kernel vs its plain version (see the module docstring)."""
  from mpi_vision_tpu_torch.kernels import compose_over as co

  gen = torch.Generator(device=dev).manual_seed(8)
  out = {"max_abs_err": 0.0, "bf16_max_ulps": 0}
  for views in (1, 8):
    rgba = torch.rand((PLANES, views, HEIGHT, WIDTH, 4), generator=gen,
                      device=dev)
    rgba[3, :, :HEIGHT // 4, :, 3] = 0.0   # exact pass-through
    rgba[7, :, HEIGHT // 2:, :, 3] = 1.0   # exact replace
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
      x = rgba.to(dtype)
      got = co.over_composite_pallas(x)
      want = co.plain_composite(x)
      torch.cuda.synchronize()
      check(got.shape == (views, HEIGHT, WIDTH, 3) and got.dtype == dtype,
            f"compose {name} V={views}: {got.shape} {got.dtype}")
      check(bool(torch.isfinite(got).all()), f"compose {name}: non-finite")
      err = float((got.float() - want.float()).abs().max())
      if dtype == torch.bfloat16:
        ulps = bf16_ulps(torch, got, want)
        out["bf16_max_ulps"] = max(out["bf16_max_ulps"], ulps)
        check(ulps <= 1, f"compose bf16 V={views}: {ulps} ulps")
      check(err <= TOL, f"compose {name} V={views}: max_abs_err {err}")
      out["max_abs_err"] = max(out["max_abs_err"], err)
      # Plane 7's alpha of 1 leaves the lower half to planes 7.. alone.
      check(torch.equal(got[:, HEIGHT // 2:], co.plain_composite(
          x[7:, :, HEIGHT // 2:].contiguous())),
            f"compose {name}: alpha 1 did not replace what lies behind")
      del want
      ms = cuda_ms(torch, lambda: co.over_composite_pallas(x), 20, warm=3)
      plain_ms = cuda_ms(torch, lambda: co.plain_composite(x), 3, warm=1)
      b_ms, b_by = compose_bound(views, x.element_size())
      out[f"{name}_v{views}"] = {"ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": b_ms, "bound_by": b_by,
                                 "max_abs_err": err,
                                 "ms_over_bound": ms / b_ms}
      log(f"compose vs plain [{name}, V={views}]: max_abs_err {err:.3e}; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} "
          f"ms ({b_by})")
      del got, x
    if views == 1:
      one = rgba[:1]
      check(torch.equal(co.over_composite_pallas(one), one[0, ..., :3]),
            "a one-plane stack is not its rgb")
      g = torch.randn((1, HEIGHT, WIDTH, 3), generator=gen, device=dev)
      leaf = rgba.clone().requires_grad_(True)
      (co.over_composite_pallas(leaf) * g).sum().backward()
      ref = rgba.clone().requires_grad_(True)
      from mpi_vision_tpu_torch.core import compose

      (compose.over_composite_scan(ref) * g).sum().backward()
      check(torch.equal(leaf.grad, ref.grad),
            "the autograd Function's gradient is not the plain scan's")
      check(float(leaf.grad.abs().max()) > 0, "zero composite gradient")
      log("compose: one plane == its rgb; the autograd gradient == the "
          "plain scan's, nonzero")
      del leaf, ref, g
    del rgba
    torch.cuda.empty_cache()
  return out


TILED_KINDS = (("compose_s", "compose_over"), ("gather_s", "gather"),
               ("d2h_s", "DtoH"), ("h2d_s", "HtoD"))


def tiled_scene():
  """Phase 9's 1080 x 1920 x 32 scene and narrow-FOV camera (host numpy,
  ~20 s: ``main`` makes it on a thread while phases 3-4 run)."""
  from mpi_vision_tpu_torch.core.camera import intrinsics_matrix
  from mpi_vision_tpu_torch.serve import synthetic_tiled_scene

  # Four depth slabs left to right (planes 0-7, 8-15, 16-23, 24-31): every
  # plane holds content somewhere, so full coverage keeps all 32.
  layers, depths, _ = synthetic_tiled_scene("tiled_000", HEIGHT, WIDTH,
                                            PLANES, regions=4, seed=0)
  # Narrow FOV (fx = 2 W): a pan of a few tenths of a radian leaves tile
  # columns, and their slabs, out of the frustum.
  k = intrinsics_matrix(2.0 * WIDTH, 2.0 * WIDTH, WIDTH / 2.0,
                        HEIGHT / 2.0).numpy()
  return layers, depths, k


def phase9_tiled(torch, dev, scene) -> dict:
  """Tiled serving, the slice's main path (see the module docstring).
  ``scene`` is ``tiled_scene()``'s."""
  from mpi_vision_tpu_torch.core import render
  from mpi_vision_tpu_torch.core.sampling import Convention
  from mpi_vision_tpu_torch.kernels import compose_over as co
  from mpi_vision_tpu_torch.kernels import render_fused
  from mpi_vision_tpu_torch.serve import RenderService, make_http_server

  kw = dict(device="cuda", method="pallas", convention=Convention.EXACT,
            max_batch=8, max_wait_ms=20.0, max_inflight=4)
  tiled = RenderService(tile="auto", cache_bytes=8 << 30, **kw)
  mono = RenderService(cache_bytes=4 << 30, **kw)
  httpd = None
  try:
    t0 = time.perf_counter()
    for svc in (tiled, mono):
      svc.add_scene("tiled_000", *scene)
    tiled.warmup()
    meta = tiled.tile_meta("tiled_000")
    log(f"tiled: scene {HEIGHT}x{WIDTH}x{PLANES} published, baked and "
        f"warmed in {time.perf_counter() - t0:.2f}s; grid "
        f"{meta.grid.rows}x{meta.grid.cols} of {meta.grid.tile} px")
    httpd = make_http_server(tiled, port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def post(pose):
      body = json.dumps({"scene_id": "tiled_000",
                         "pose": pose.tolist()}).encode()
      req = urllib.request.Request(
          f"http://127.0.0.1:{port}/render", data=body,
          headers={"Content-Type": "application/json",
                   "Accept": "application/octet-stream"})
      with urllib.request.urlopen(req, timeout=300) as resp:
        check(resp.status == 200, f"/render answered {resp.status}")
        shape = tuple(int(x) for x in resp.headers["X-Image-Shape"].split(","))
        return np.frombuffer(resp.read(), "<f4").reshape(shape)

    truck = np.eye(4, dtype=np.float32)
    truck[0, 3], truck[2, 3] = 0.01, -0.01
    conc = [np.eye(4, dtype=np.float32), truck, pan_pose(-0.35 * 57.3, 0.0),
            pan_pose(0.35 * 57.3, 0.0), pan_pose(-0.2 * 57.3, 0.0),
            pan_pose(0.2 * 57.3, 0.0), pan_pose(-0.35 * 57.3, 0.0),
            pan_pose(0.1 * 57.3, 0.0)]
    seq = [pan_pose(-0.3 * 57.3, 0.0), np.eye(4, dtype=np.float32),
           pan_pose(0.25 * 57.3, 0.0)]
    frames: list = [None] * len(conc)
    errors: list = []

    def fire(i):
      try:
        frames[i] = post(conc[i])
      except Exception as e:  # noqa: BLE001 - re-raised on the main thread
        errors.append(e)

    burst = [pan_pose(0.04 * 57.3 * (i - 8), 0.0) for i in range(16)]

    def run_burst():
      futs = [tiled.render_async("tiled_000", p) for p in burst]
      for f in futs:
        f.result(300)

    co.over_composite_pallas.launches = 0
    co.plain_composite.calls = 0
    render_fused.plain_render.calls = 0
    t0 = time.perf_counter()
    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(conc))]
    for t in threads:
      t.start()
    for t in threads:
      t.join(300)
    http_s = time.perf_counter() - t0
    check(not errors, f"concurrent tiled /render failed: {errors[:1]}")
    check(all(f is not None for f in frames), "a tiled /render hung")
    frames += [post(p) for p in seq]
    t0 = time.perf_counter()
    run_burst()
    burst_rps = len(burst) / (time.perf_counter() - t0)
    activity = device_activity(torch, run_burst, TILED_KINDS)
    launches = co.over_composite_pallas.launches
    plain = {"plain_composite": co.plain_composite.calls,
             "plain_render": render_fused.plain_render.calls}
    stats = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/stats", timeout=60).read())
    log(f"tiled: main path launched the compose kernel {launches} times; "
        f"plain versions {json.dumps(plain)}; {len(conc)} concurrent HTTP "
        f"renders in {http_s:.3f}s; burst {burst_rps:.2f} renders/s; "
        f"profiled burst {json.dumps(activity)}")
    log(f"tiled: /stats tiles {json.dumps(stats['tiles'])}; tile_cache "
        f"{json.dumps(stats['tile_cache'])}; latency_ms "
        f"{stats['latency_ms']}; batch sizes {stats['batch_size_hist']}")
    check(launches > 0, "the tiled path never launched the compose kernel")
    check(not any(plain.values()), f"a plain version ran: {plain}")
    check(stats["engine"]["platform"] == "cuda"
          and stats["engine"]["method"] == "pallas", "engine not pallas/cuda")
    check(stats["tiles"]["culled_total"] > 0, "no tile was culled")
    check(min(int(n) for n in stats["tiles"]["planes_hist"]) < PLANES,
          "no request culled a plane")

    # Every frame against the untiled service's render of its pose.
    n_full, worst_culled = 0, 0.0
    for pose, frame in zip(conc + seq, frames):
      check(frame.shape == (HEIGHT, WIDTH, 3), f"frame shape {frame.shape}")
      check(bool(np.isfinite(frame).all()), "non-finite tiled pixels")
      want = mono.render("tiled_000", pose, timeout=300)
      sig = meta.plan(pose[None], Convention.EXACT)
      full = sig.crop == (0, HEIGHT, 0, WIDTH) and len(sig.planes) == PLANES
      err = float(np.abs(frame - want).max())
      if not full:
        worst_culled = max(worst_culled, err)
      n_full += full
      check(np.array_equal(frame, want), f"a {'full' if full else 'culled'} "
            f"tiled frame differs from the untiled one by {err}")
    check(n_full > 0 and n_full < len(frames), "no full or no culled frame")
    scene = mono.cache.get("tiled_000")
    fused = render.render_views(
        scene.rgba_layers, torch.from_numpy(conc[2][None]).to(dev),
        scene.depths, scene.intrinsics, convention=Convention.EXACT,
        method="fused_pallas")[0].cpu().numpy()
    fused_err = float(np.abs(frames[2] - fused).max())
    log(f"tiled: {n_full} full-coverage and {len(frames) - n_full} culled "
        f"frames bit-identical to the untiled service (culled max_abs_err "
        f"{worst_culled:.3e}); a culled frame vs the fused kernel "
        f"{fused_err:.3e}")
    check(fused_err <= TOL, f"tiled frame vs fused kernel {fused_err}")

    # One flight's split: warp (plain torch) vs composite (the kernel) at
    # V = 8, full coverage and the widest pan's crop; crop assembly on a
    # memo miss (host clock, ends in a synchronise).
    split = {}
    for label, pose in (("full", np.eye(4, dtype=np.float32)),
                        ("pan_0.35rad", conc[2])):
      key, _ = tiled._tile_batch_key("tiled_000", pose)
      with tiled._crop_lock:
        tiled._crop_memo.clear()
        tiled._crop_memo_bytes = 0
      t0 = time.perf_counter()
      crop = tiled._get_scene(key)
      assemble_ms = (time.perf_counter() - t0) * 1e3
      poses8 = torch.from_numpy(np.repeat(pose[None], 8, 0)).to(dev)
      planes = crop.rgba_layers.unsqueeze(0).expand(
          (8,) + tuple(crop.rgba_layers.shape)).movedim(3, 0)
      homs = render.plane_homographies(
          poses8, crop.depths, crop.intrinsics.expand(8, 3, 3))
      stack = render.warp_stack(planes, homs, HEIGHT, WIDTH,
                                Convention.EXACT, crop.src_window)
      warp_ms = cuda_ms(torch, lambda: render.warp_stack(
          planes, homs, HEIGHT, WIDTH, Convention.EXACT, crop.src_window),
          1, warm=0)
      comp_ms = cuda_ms(torch, lambda: co.over_composite_pallas(stack), 10)
      split[label] = {"planes": int(crop.planes.shape[0]),
                      "crop_hw": list(crop.planes.shape[1:3]),
                      "warp_ms_v8": warp_ms, "composite_ms_v8": comp_ms,
                      "assemble_ms": assemble_ms}
      del stack, planes, homs, crop
      torch.cuda.empty_cache()
    log(f"tiled: flight split {json.dumps(split)}")
  finally:
    if httpd is not None:
      httpd.shutdown()
      httpd.server_close()
    tiled.close()
    mono.close()
  return {"launches": launches, "renders_per_s": burst_rps,
          "http_concurrent_s": http_s, "latency_ms": stats["latency_ms"],
          "tiles": stats["tiles"], "burst_device": activity,
          "flight_split": split, "culled_max_abs_err": worst_culled,
          "fused_max_abs_err": fused_err, "full_frames": n_full,
          "frames": len(frames)}


# Phase 10: two epochs over this many synthetic scenes, 12 steps, on the
# device its training runs name (a rehearsal on a host sets "cpu").
CKPT_SCENES = 6
TRAIN_DEVICE = "cuda"


def phase10_resilience(torch, dev, workdir: str) -> dict:
  """Crash-safe training at TrainConfig() (see the module docstring)."""
  from mpi_vision_tpu_torch import cli, config
  from mpi_vision_tpu_torch.ckpt import BackgroundSaver, CheckpointStore
  from mpi_vision_tpu_torch.data import realestate
  from mpi_vision_tpu_torch.kernels import render_fused
  from mpi_vision_tpu_torch.kernels import render_fused_bwd as rb
  from mpi_vision_tpu_torch.tools.train_resume import store_digest
  from mpi_vision_tpu_torch.train import loop as train_loop

  counters = (render_fused.render_mpi_fused, rb.rewarp_composite_vjp,
              rb.adjoint_warp)
  plains = (render_fused.plain_render, rb.plain_rewarp_composite_vjp,
            rb.plain_adjoint_warp)

  def argv(name, *extra, epochs=2):
    return ["train", "--synthetic", "--synthetic-scenes", str(CKPT_SCENES),
            "--epochs", str(epochs), "--no-valid", "--device", TRAIN_DEVICE,
            "--dataset", os.path.join(workdir, f"data_{name}"),
            "--ckpt", os.path.join(workdir, name), "--save-every", "2",
            *extra]

  def counted(tag, args, ran_steps=None):
    """``cli.cmd_train`` in process with the counts zeroed just before
    and read just after; every step (``ran_steps``, default the summary's)
    launched the forward kernel, A and B, and no plain version ran."""
    for fn in counters:
      fn.launches = 0
    for fn in plains:
      fn.calls = 0
    t0 = time.perf_counter()
    summary = cli.cmd_train(cli.build_parser().parse_args(args))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    plain_calls = {fn.__name__: fn.calls for fn in plains}
    steps = summary["steps"] if ran_steps is None else ran_steps(summary)
    log(f"resilience [{tag}]: summary {json.dumps(summary)} in "
        f"{seconds:.2f}s; launches {json.dumps(launches)}; plain versions "
        f"{json.dumps(plain_calls)}")
    check(summary["nonfinite_losses"] == 0, f"{tag}: non-finite losses")
    check(steps > 0 and all(n == steps for n in launches.values()),
          f"{tag}: {steps} steps but launches {launches}")
    check(not any(plain_calls.values()),
          f"{tag}: a plain version ran: {plain_calls}")
    return summary, launches, seconds

  def digest(name):
    return store_digest(CheckpointStore(os.path.join(workdir, name)))

  def victim(name, *faults):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_vision_tpu_torch",
         *argv(name, *[a for f in faults for a in ("--inject-fault", f)])],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    published = sorted(n for n in os.listdir(os.path.join(workdir, name))
                       if n.startswith("step_"))
    log(f"resilience [victim {name}]: rc {proc.returncode} after "
        f"{time.perf_counter() - t0:.2f}s; published {published}")
    check(proc.returncode == -9,
          f"victim {name} did not die by SIGKILL: rc {proc.returncode}\n"
          f"{proc.stderr[-3000:]}")
    check(published, f"victim {name} left no published checkpoint")

  flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
  try:
    # The uninterrupted run, then the victims, each resumed in process.
    clean, clean_launches, clean_s = counted("uninterrupted", argv("clean"))
    check(clean["ckpt"]["final_step"] == 2 * CKPT_SCENES
          and clean["ckpt"]["resumed_from"] is None,
          f"uninterrupted run: {clean['ckpt']}")
    check(torch.backends.cudnn.deterministic
          and not torch.backends.cudnn.benchmark,
          "--ckpt on the card did not make cuDNN deterministic")
    d0 = digest("clean")
    victim("kill", "crash@step=7,hard")
    victim("rot", "crash@step=7,hard", "corrupt@save=3")
    resumed, resumed_launches, resumed_s = counted(
        "resumed after SIGKILL", argv("kill", "--resume"))
    rot, _, _ = counted("resumed after corrupt + SIGKILL",
                        argv("rot", "--resume"))
    digests = {"uninterrupted": d0, "kill": digest("kill"),
               "corrupt_kill": digest("rot")}
    log(f"resilience: digests {json.dumps(digests)}")
    check(resumed["ckpt"]["resumed_from"] == 6
          and resumed["ckpt"]["quarantined"] == 0
          and resumed["ckpt"]["final_step"] == 2 * CKPT_SCENES,
          f"SIGKILL resume: {resumed['ckpt']}")
    check(rot["ckpt"]["resumed_from"] == 4 and rot["ckpt"]["quarantined"] == 1
          and rot["ckpt"]["final_step"] == 2 * CKPT_SCENES,
          f"corrupt + SIGKILL resume: {rot['ckpt']}")
    check(d0 and digests["kill"] == d0,
          "the SIGKILLed run resumed to another final checkpoint")
    check(digests["corrupt_kill"] == d0,
          "the corrupted-then-SIGKILLed run resumed to another checkpoint")

    # The NaN guard: one poisoned batch, one rollback to the step-2
    # checkpoint, the halved LR in the checkpoint. Eight steps ran the
    # kernels: the six kept, the poisoned one and the re-walked step 2.
    nan, _, _ = counted("nan@step=3", argv("nan", "--inject-fault",
                                          "nan@step=3", epochs=1),
                        ran_steps=lambda sm: sm["steps"] + 2)
    cfg = config.TrainConfig()
    restored = CheckpointStore(os.path.join(workdir, "nan")).restore()
    lr = float(restored.arrays["['learning_rate']"])
    check(nan["ckpt"]["nan_rollbacks"] == 1
          and nan["ckpt"]["final_step"] == CKPT_SCENES,
          f"NaN guard: {nan['ckpt']}")
    check(lr == cfg.learning_rate * 0.5
          and restored.meta["learning_rate"] == lr,
          f"the checkpointed LR {lr} is not the cut "
          f"{cfg.learning_rate * 0.5}")

    # lr_find at TrainConfig(): 20 sweep steps then one epoch at the
    # suggestion, every step through the kernels.
    found, found_launches, _ = counted(
        "lr_find", ["train", "--synthetic", "--synthetic-scenes", "2",
                    "--epochs", "1", "--no-valid", "--device", TRAIN_DEVICE,
                    "--dataset", os.path.join(workdir, "data_lr"),
                    "--lr-find", "--lr-find-steps", "20"],
        ran_steps=lambda sm: render_fused.render_mpi_fused.launches)
    check(np.isfinite(found["lr_found"])
          and 1e-7 <= found["lr_found"] <= 10.0,
          f"lr_find suggestion {found['lr_found']} outside the sweep")
    check(found_launches["adjoint_warp"] > found["steps"],
          f"the sweep launched no kernel: {found_launches}")

    # No op of the step is refused under torch's deterministic mode, at
    # TrainConfig() and with the loss's resize (256 px -> 224).
    cfg = config.TrainConfig(data=config.DataConfig(
        dataset_path=os.path.join(workdir, "data_clean")))
    state = cfg.make_train_state(0, dev)
    vgg = cfg.make_vgg(dev)
    step = cfg.make_train_step(vgg)
    batch = next(realestate.iterate_batches(
        cfg.data.make_dataset(rng=np.random.default_rng(0), device=dev),
        rng=np.random.default_rng(1)))
    root256 = os.path.join(workdir, "data_256")
    realestate.synthesize_dataset(root256, num_scenes=1, img_size=256)
    cfg256 = config.TrainConfig(data=config.DataConfig(
        dataset_path=root256, img_size=256))
    batch256 = next(realestate.iterate_batches(
        cfg256.data.make_dataset(rng=np.random.default_rng(0), device=dev),
        shuffle=False))
    state256 = cfg256.make_train_state(0, dev)
    loss256 = train_loop.make_loss_fn(vgg, cfg256.vgg_resize, "fused_pallas")

    def grads256():
      state256.model.zero_grad(set_to_none=True)
      loss256(state256.model, batch256).backward()
      return [p.grad.clone() for p in state256.model.parameters()]

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    try:
      step(state, batch)
      first = grads256()
      again = grads256()
      torch.cuda.synchronize()
      # What the loss's resize replaced: F.interpolate's bilinear backward.
      leaf = torch.rand((1, 3, 256, 256), device=dev, requires_grad=True)
      try:
        torch.nn.functional.interpolate(
            leaf, (224, 224), mode="bilinear",
            align_corners=False).sum().backward()
        interpolate = "allowed"
      except RuntimeError as e:
        interpolate = f"refused ({str(e).splitlines()[0][:160]})"
    finally:
      torch.use_deterministic_algorithms(False)
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "two backward passes with the resize differ")
    log("resilience: a TrainConfig() step and a 256 px step (resize to "
        "224) run under torch.use_deterministic_algorithms(True); the "
        "256 px gradients are bit-identical twice; F.interpolate's "
        f"bilinear backward there: {interpolate}")

    # Times: the step with cuDNN deterministic off and on, in turns.
    def one_step():
      step(state, batch)
      torch.cuda.synchronize()

    step_ms = {"off": [], "on": []}
    for deterministic in (False, True, True, False):
      torch.backends.cudnn.deterministic = deterministic
      for _ in range(3):
        one_step()
      step_ms["on" if deterministic else "off"].append(host_ms(one_step, 10))
    torch.backends.cudnn.deterministic = True

    # Save (foreground, background) and restore of one checkpoint.
    tree = train_loop.checkpoint_tree(state)
    fg = CheckpointStore(os.path.join(workdir, "times_fg"))
    save_ms = []
    for i in range(3):
      t0 = time.perf_counter()
      fg.save(i, tree)
      save_ms.append((time.perf_counter() - t0) * 1e3)
    bg = BackgroundSaver(CheckpointStore(os.path.join(workdir, "times_bg")))
    async_return_ms, async_flush_ms = [], []
    for i in range(3):
      t0 = time.perf_counter()
      bg.save(i, tree)
      t1 = time.perf_counter()
      bg.flush()
      async_return_ms.append((t1 - t0) * 1e3)
      async_flush_ms.append((time.perf_counter() - t1) * 1e3)
    check(bg.store.last_save_bytes == fg.last_save_bytes > 0,
          "the background and foreground saves wrote other bytes")
    restore_ms, load_ms = [], []
    for _ in range(3):
      t0 = time.perf_counter()
      back = fg.restore(template=tree)
      t1 = time.perf_counter()
      train_loop.load_checkpoint_tree(state, back.tree(tree))
      torch.cuda.synchronize()
      restore_ms.append((t1 - t0) * 1e3)
      load_ms.append((time.perf_counter() - t1) * 1e3)
  finally:
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = flags
  return {
      "digest": d0,
      "launches": {"uninterrupted": clean_launches,
                   "resumed": resumed_launches, "lr_find": found_launches},
      "lr_found": found["lr_found"],
      "nan_rollback_lr": lr,
      "uninterrupted_s": clean_s, "resumed_s": resumed_s,
      "step_ms_cudnn_deterministic": step_ms,
      "checkpoint_bytes": fg.last_save_bytes,
      "save_ms": save_ms,
      "async_save_return_ms": async_return_ms,
      "async_save_flush_ms": async_flush_ms,
      "restore_verify_ms": restore_ms,
      "load_into_state_ms": load_ms,
  }


# Phase 11: the live reload's request stream runs this many HTTP clients.
RELOAD_CLIENTS = 4


def phase11_bridge(torch, dev, workdir: str) -> dict:
  """Train -> serve -> viewer at TrainConfig() (see the module docstring).
  ``workdir`` holds phase 10's uninterrupted ``--ckpt`` store (``clean``,
  final step 12) and its dataset (``data_clean``)."""
  from mpi_vision_tpu_torch import cli, config
  from mpi_vision_tpu_torch.ckpt import CheckpointStore, CheckpointWatcher
  from mpi_vision_tpu_torch.ckpt import export
  from mpi_vision_tpu_torch.core import render
  from mpi_vision_tpu_torch.core.sampling import Convention
  from mpi_vision_tpu_torch.data import realestate
  from mpi_vision_tpu_torch.kernels import compose_over as co
  from mpi_vision_tpu_torch.kernels import render_fused
  from mpi_vision_tpu_torch.kernels import render_fused_bwd as rb
  from mpi_vision_tpu_torch.models.stereo_mag import mpi_from_net_output
  from mpi_vision_tpu_torch.serve import RenderService, make_http_server
  from mpi_vision_tpu_torch.serve.cache import bake_scene
  from mpi_vision_tpu_torch.train import loop as train_loop

  kernels = (render_fused.render_mpi_fused, rb.rewarp_composite_vjp,
             rb.adjoint_warp, co.over_composite_pallas)
  plains = (render_fused.plain_render, rb.plain_rewarp_composite_vjp,
            rb.plain_adjoint_warp, co.plain_composite)
  launches: dict = {}

  def zero():
    for fn in kernels:
      fn.launches = 0
    for fn in plains:
      fn.calls = 0

  def read(name: str) -> dict:
    """The counts since ``zero()`` as window ``name``; no plain version
    may have run in it."""
    counts = {fn.__name__: fn.launches for fn in kernels}
    plain = {fn.__name__: fn.calls for fn in plains}
    launches[name] = counts
    log(f"bridge [{name}]: launches {json.dumps(counts)}; plain versions "
        f"{json.dumps(plain)}")
    check(not any(plain.values()), f"{name}: a plain version ran: {plain}")
    return counts

  def direct(scene, pose, method="fused_pallas"):
    """A direct render of one pose of a host scene, through ``method``."""
    baked = bake_scene("direct", *scene, device=dev)
    return render.render_views(
        baked.rgba_layers, torch.from_numpy(pose[None]).to(dev),
        baked.depths, baked.intrinsics, convention=Convention.EXACT,
        method=method)[0].cpu().numpy()

  plain_errs: dict = {}

  def hold_plain(name, frame, scene, pose):
    """Hold a frame to ``plain_render`` of the same scene, baked on the
    card, at the same pose's homographies (TOL). Runs between the counted
    windows, so those still see no plain version."""
    baked = bake_scene("plain", *scene, device=dev)
    h, w = baked.planes.shape[1:3]
    homs = render_fused.pixel_homographies(
        torch.from_numpy(pose[None]).to(dev), baked.depths,
        baked.intrinsics[None], h, w,
        Convention.EXACT).transpose(0, 1).contiguous()
    want = render_fused.plain_render(baked.planes, homs)[0].cpu().numpy()
    err = float(np.abs(frame - want).max())
    plain_errs[name] = max(plain_errs.get(name, 0.0), err)
    check(err <= TOL, f"{name}: a frame differs from the plain version by "
          f"{err} > {TOL}")

  ckpt = os.path.join(workdir, "clean")
  data = os.path.join(workdir, "data_clean")
  cfg = config.TrainConfig()
  flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
  svc = tsvc = httpd = watcher = None
  try:
    # -- bake: params-only restore, then the forward pass on the card ---
    step_dir = os.path.join(ckpt, sorted(
        n for n in os.listdir(ckpt) if n.startswith("step_"))[-1])
    with open(os.path.join(step_dir, "manifest.json")) as fh:
      manifest = json.load(fh)

    def nbytes(entry):
      return int(np.prod(entry["shape"])) * np.dtype(entry["dtype"]).itemsize

    params_bytes = sum(nbytes(e) for k, e in manifest["arrays"].items()
                       if k.startswith("['model']"))
    ckpt_bytes = sum(nbytes(e) for e in manifest["arrays"].values())
    restore_ms = []
    for _ in range(3):
      t0 = time.perf_counter()
      model, meta, step = export.restore_params(ckpt, device=dev)
      torch.cuda.synchronize()
      restore_ms.append((time.perf_counter() - t0) * 1e3)
    digest = hashlib.sha256()
    for key, entry in sorted(manifest["arrays"].items()):
      if key.startswith("['model']"):
        digest.update(key.encode())
        digest.update(entry["sha256"].encode())
    digest = digest.hexdigest()
    check(step == 2 * CKPT_SCENES and meta["params_digest"] == digest
          and meta["compute_dtype"] is None,
          f"restore_params: step {step}, meta {meta}")
    check(next(model.parameters()).device == dev, "model not on the card")
    t0 = time.perf_counter()
    scenes, info = export.scenes_from_checkpoint(ckpt, dataset_path=data,
                                                 scenes=2, device=dev)
    bake_ms = (time.perf_counter() - t0) * 1e3 / len(scenes)
    ids = [sid for sid, *_ in scenes]
    check(ids == [f"ckpt_{step}_{digest[:8]}_{i:03d}" for i in range(2)],
          f"scene ids {ids}")
    # The same bake through the U-Net's plain CPU forward, same weights.
    cpu_model, _, _ = export.restore_params(ckpt, device="cpu")
    valid = realestate.RealEstateDataset(
        data, is_valid=True, img_size=cfg.data.img_size,
        num_planes=cfg.data.num_planes, device=dev)
    bake_err = 0.0
    for i, (_, rgba, _, _) in enumerate(scenes):
      example = valid[i]
      with torch.no_grad():
        pred = cpu_model(example["net_input"][None].cpu())
        want = mpi_from_net_output(pred, example["ref_img"][None].cpu())
      bake_err = max(bake_err, float(np.abs(rgba - want[0].numpy()).max()))
    log(f"bridge: restored step {step} ({params_bytes} of {ckpt_bytes} "
        f"bytes) in {restore_ms} ms; baked {ids} at "
        f"{bake_ms:.1f} ms a scene; card vs CPU forward max_abs_err "
        f"{bake_err:.3e}")
    check(bake_err <= TOL, f"bake on the card vs CPU forward: {bake_err}")
    del cpu_model, model

    # -- serve the baked scenes (stable ids, as --reload-ckpt-s does) -----
    old = {f"ckpt_{i:03d}": s[1:] for i, s in enumerate(scenes)}
    svc = RenderService(device=dev, method="fused_pallas",
                        convention=Convention.EXACT, max_batch=8,
                        max_wait_ms=5.0, max_inflight=4)
    for sid, scene in old.items():
      svc.add_scene(sid, *scene)
    svc.warmup()
    httpd = make_http_server(svc, port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def post(scene_id, pose):
      body = json.dumps({"scene_id": scene_id,
                         "pose": pose.tolist()}).encode()
      req = urllib.request.Request(
          f"http://127.0.0.1:{port}/render", data=body,
          headers={"Content-Type": "application/json",
                   "Accept": "application/octet-stream"})
      with urllib.request.urlopen(req, timeout=120) as resp:
        check(resp.status == 200, f"/render answered {resp.status}")
        shape = tuple(int(x) for x in resp.headers["X-Image-Shape"].split(","))
        return np.frombuffer(resp.read(), "<f4").reshape(shape)

    poses = [pan_pose(4.0 * i - 6.0, 0.02 * i, -0.01 * i) for i in range(4)]
    zero()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
      served = list(pool.map(lambda a: post(*a), [
          (sid, p) for sid in old for p in poses]))
    counts = read("serve")
    check(counts["render_mpi_fused"] > 0, "serving launched no kernel")
    for (sid, p), frame in zip([(s, p) for s in old for p in poses], served):
      check(frame.shape == (cfg.data.img_size, cfg.data.img_size, 3)
            and bool(np.isfinite(frame).all()), "bad served frame")
      check(np.array_equal(frame, direct(old[sid], p)),
            f"served frame of {sid} differs from a direct kernel render")
      hold_plain("serve_224_x10", frame, old[sid], p)
    log(f"bridge: {len(served)} served frames of the baked scenes "
        "bit-identical to direct kernel renders; vs plain max_abs_err "
        f"{plain_errs['serve_224_x10']:.3e}")

    # -- live reload: publish a newer step while requests stream --------
    old_hash = {(sid, j): hashlib.sha1(direct(old[sid], p).tobytes())
                .hexdigest() for sid in old for j, p in enumerate(poses)}
    reload_at: dict = {}
    new: dict = {}

    def reload_cb(new_step: int) -> None:
      reload_at["start"] = time.perf_counter()
      reload_at["published_ago_s"] = time.time() - os.path.getmtime(
          os.path.join(ckpt, f"step_{new_step:010d}"))
      fresh, fresh_info = export.scenes_from_checkpoint(
          ckpt, dataset_path=data, scenes=2, stable_ids=True, device=dev)
      new.update({sid: s for sid, *s in fresh})
      reload_at["swap"] = time.perf_counter()
      svc.swap_scenes(new, prebake=True)
      reload_at["end"] = time.perf_counter()
      reload_at["step"] = fresh_info["step"]

    records: list = []
    failures: list = []
    stop = threading.Event()

    def client(c):
      i = c
      while not stop.is_set():
        sid, j = f"ckpt_{i % 2:03d}", (i // 2) % len(poses)
        i += 1
        t_start = time.perf_counter()
        try:
          frame = post(sid, poses[j])
        except Exception as e:  # noqa: BLE001 - every failure is counted
          failures.append(repr(e))
          continue
        records.append((t_start, time.perf_counter(), sid, j,
                        hashlib.sha1(frame.tobytes()).hexdigest()))

    watcher = CheckpointWatcher(CheckpointStore(ckpt), reload_cb,
                                poll_s=0.1, initial_step=step,
                                log=log).start()
    clients = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(RELOAD_CLIENTS)]
    t_stream = time.perf_counter()
    for t in clients:
      t.start()
    time.sleep(2.0)
    zero()
    t_train = time.perf_counter()
    resumed = cli.cmd_train(cli.build_parser().parse_args([
        "train", "--synthetic", "--synthetic-scenes", "2", "--epochs", "3",
        "--no-valid", "--device", TRAIN_DEVICE, "--resume", "--save-every", "2",
        "--dataset", os.path.join(workdir, "data_two"), "--ckpt", ckpt]))
    torch.cuda.synchronize()
    t_trained = time.perf_counter()
    deadline = time.perf_counter() + 120
    while "end" not in reload_at and time.perf_counter() < deadline:
      time.sleep(0.05)
    time.sleep(1.0)
    stop.set()
    for t in clients:
      t.join(60)
    counts = read("reload")
    snap = watcher.snapshot()
    watcher.stop()
    watcher = None
    log(f"bridge: resumed {json.dumps(resumed['ckpt'])}; watcher "
        f"{json.dumps(snap)}; {len(records)} requests, "
        f"{len(failures)} failed")
    check(resumed["ckpt"]["resumed_from"] == step
          and resumed["ckpt"]["final_step"] == step + 2,
          f"resume for the reload: {resumed['ckpt']}")
    check(counts["rewarp_composite_vjp"] == counts["adjoint_warp"] == 2,
          f"the 2 resumed steps launched A/B {counts}")
    check(snap["reloads"] == 1 and snap["reload_errors"] == 0
          and snap["seen_step"] == step + 2 == reload_at.get("step"),
          f"the watcher did not fire once on step {step + 2}: {snap}")
    check(not failures, f"requests failed during the reload: {failures[:3]}")
    new_hash = {(sid, j): hashlib.sha1(direct(new[sid], p).tobytes())
                .hexdigest() for sid in new for j, p in enumerate(poses)}
    check(all(new_hash[k] != old_hash[k] for k in old_hash),
          "the new bake renders the old frames")
    for sid in new:
      for p in poses:
        hold_plain("reload_224_x10", direct(new[sid], p), new[sid], p)
    n_new = 0
    for t_start, _, sid, j, h in records:
      check(h in (old_hash[sid, j], new_hash[sid, j]),
            f"a frame of {sid} is neither the old nor the new bake's")
      if t_start > reload_at["end"]:
        check(h == new_hash[sid, j],
              f"a request after the swap rendered the old {sid}")
      n_new += h == new_hash[sid, j]
    check(n_new > 0, "no frame of the new bake was served")
    first_new = min(t_end for _, t_end, sid, j, h in records
                    if h == new_hash[sid, j])

    def rate(lo, hi):
      n = sum(1 for _, t_end, *_ in records if lo <= t_end < hi)
      return n / (hi - lo) if hi > lo else None

    reload_times = {
        "renders_per_s_before": rate(t_stream + 0.5, t_train),
        "renders_per_s_training": rate(t_train, t_trained),
        "renders_per_s_reload": rate(reload_at["start"], reload_at["end"]),
        "reload_ms": (reload_at["end"] - reload_at["start"]) * 1e3,
        "bake_in_reload_ms": (reload_at["swap"] - reload_at["start"]) * 1e3,
        "swap_prebake_ms": (reload_at["end"] - reload_at["swap"]) * 1e3,
        "swap_to_first_new_frame_ms": (first_new - reload_at["swap"]) * 1e3,
        "publish_to_reload_start_ms": reload_at["published_ago_s"] * 1e3,
        "requests": len(records), "new_frames": n_new,
        "train_resume_s": t_trained - t_train}
    log(f"bridge: live reload {json.dumps(reload_times)}")

    # -- tiled swap: only the changed tiles re-bake ---------------------
    tsvc = RenderService(device=dev, method="pallas", tile="auto",
                         convention=Convention.EXACT, max_batch=8,
                         max_wait_ms=5.0)
    tsvc.add_scene("ckpt_000", *old["ckpt_000"])
    for p in poses:
      tsvc.render("ckpt_000", p, timeout=120)
    grid = tsvc.tile_meta("ckpt_000").grid
    patched = old["ckpt_000"][0].copy()
    y0, y1, x0, x1 = grid.rect(0, 0)
    patched[y0:y1, x0:x1] = new["ckpt_000"][0][y0:y1, x0:x1]
    swapped = (patched,) + tuple(old["ckpt_000"][1:])
    before = tsvc.stats()["tile_cache"]
    zero()
    tsvc.swap_scenes({"ckpt_000": swapped}, prebake=True)
    tiled_frames = [tsvc.render("ckpt_000", p, timeout=120) for p in poses]
    counts = read("tiled_swap")
    after = tsvc.stats()["tile_cache"]
    log(f"bridge: tiled swap on a {grid.rows}x{grid.cols} grid of "
        f"{grid.tile} px: tile cache {json.dumps(before)} -> "
        f"{json.dumps(after)}")
    check(counts["over_composite_pallas"] > 0,
          "the tiled swap's renders launched no compose kernel")
    check(after["misses"] - before["misses"] == 1
          and after["invalidations"] - before["invalidations"] == 1,
          "a one-tile swap did not re-bake exactly one tile")
    for p, frame in zip(poses, tiled_frames):
      check(np.array_equal(frame, direct(swapped, p, "pallas")),
            "a tiled frame after the swap differs from a direct render")
      hold_plain("tiled_swap_224_x10", frame, swapped, p)
    log(f"bridge: reloaded and tiled frames vs plain max_abs_err "
        f"{plain_errs['reload_224_x10']:.3e} and "
        f"{plain_errs['tiled_swap_224_x10']:.3e}")
    tsvc.close()
    tsvc = None

    # -- 480 px x 33 planes from a step-0 checkpoint -------------------
    cfg480 = config.TrainConfig.scaled_480()
    state480 = cfg480.make_train_state(0, dev)
    t0 = time.perf_counter()
    CheckpointStore(os.path.join(workdir, "ckpt480")).save(
        0, train_loop.checkpoint_tree(state480),
        meta={"model": cfg480.model_meta()})
    save480_ms = (time.perf_counter() - t0) * 1e3
    del state480
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, meta480, _ = export.restore_params(os.path.join(workdir, "ckpt480"),
                                          device=dev)
    torch.cuda.synchronize()
    restore480_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    (scene480,), _ = export.scenes_from_checkpoint(
        os.path.join(workdir, "ckpt480"), scenes=1, prefix="ckpt480",
        device=dev)
    bake480_ms = (time.perf_counter() - t0) * 1e3
    check(scene480[1].shape == (480, 480, 33, 4), f"{scene480[1].shape}")

    # -- --mpi-dir: the repo's baked PNG stack ---------------------------
    mpi_scene = cli.mpi_dir_scene(
        os.path.join(ROOT, "tests", "fixtures", "scene_009"))
    check(mpi_scene[0] == "scene_009" and mpi_scene[1].shape[2] == 10,
          f"--mpi-dir loaded {mpi_scene[0]} {mpi_scene[1].shape}")
    for sid, *scene in (scene480, mpi_scene):
      svc.add_scene(sid, *scene)
    zero()
    extra = {(sid, j): post(sid, p) for sid in (scene480[0], "scene_009")
             for j, p in enumerate(poses[:2])}
    counts = read("serve_480_and_mpi_dir")
    check(counts["render_mpi_fused"] > 0, "no kernel launch")
    for (sid, j), frame in extra.items():
      scene = scene480[1:] if sid == scene480[0] else mpi_scene[1:]
      check(bool(np.isfinite(frame).all())
            and np.array_equal(frame, direct(scene, poses[j])),
            f"served {sid} differs from a direct kernel render")
      hold_plain("serve_480_x33" if sid == scene480[0]
                 else "serve_scene_009", frame, scene, poses[j])
    log(f"bridge: 480 px x 33 planes (step-0 checkpoint of "
        f"{meta480['num_planes']} planes: save {save480_ms:.1f} ms, "
        f"params-only restore {restore480_ms:.1f} ms, bake "
        f"{bake480_ms:.1f} ms) and scene_009 {mpi_scene[1].shape} served "
        "bit-identical to direct kernel renders; vs plain max_abs_err "
        f"{plain_errs['serve_480_x33']:.3e} and "
        f"{plain_errs['serve_scene_009']:.3e}")

    # -- the viewer --------------------------------------------------------
    out = os.path.join(workdir, "viewer.html")
    t0 = time.perf_counter()
    summary = cli.cmd_export_viewer(cli.build_parser().parse_args([
        "export-viewer", "--mpi-dir",
        os.path.join(ROOT, "tests", "fixtures", "scene_009"),
        "--out", out]))
    viewer_ms = (time.perf_counter() - t0) * 1e3
    with open(out) as fh:
      page = fh.read()
    parser = html.parser.HTMLParser()
    parser.feed(page)
    parser.close()
    start = page.index("const embeddedSources = ") + len(
        "const embeddedSources = ")
    sources = json.loads(page[start:page.index("\n", start)].rstrip(";"))
    check(summary["layers"] == 10 and len(sources) == 10 and all(
        base64.b64decode(s.split(",", 1)[1])[:8] == b"\x89PNG\r\n\x1a\n"
        for s in sources), "the viewer does not embed 10 PNG layers")
    viewer_bytes = os.path.getsize(out)
    log(f"bridge: export-viewer {json.dumps(summary)} in {viewer_ms:.1f} "
        f"ms, {viewer_bytes} bytes")

    # -- --bf16 -------------------------------------------------------------
    zero()
    bf16 = cli.cmd_train(cli.build_parser().parse_args([
        "train", "--synthetic", "--synthetic-scenes", "2", "--epochs", "1",
        "--no-valid", "--device", TRAIN_DEVICE, "--bf16",
        "--dataset", os.path.join(workdir, "data_two"),
        "--ckpt", os.path.join(workdir, "bf16")]))
    torch.cuda.synchronize()
    counts = read("bf16_train")
    bf16_store = CheckpointStore(os.path.join(workdir, "bf16"))
    bf16_ckpt = bf16_store.restore()
    check(bf16["steps"] == 2 and bf16["nonfinite_losses"] == 0,
          f"--bf16 run: {bf16}")
    check(counts["render_mpi_fused"] == counts["rewarp_composite_vjp"]
          == counts["adjoint_warp"] == 2, f"--bf16 steps' launches {counts}")
    check(bf16_ckpt.meta["model"]["compute_dtype"] == "bfloat16"
          and all(a.dtype == np.float32 for k, a in bf16_ckpt.arrays.items()
                  if k.startswith("['model']")),
          "the --bf16 checkpoint's meta or params")
    # The step's time, f32 and bf16 in turns (cuDNN as without --ckpt).
    torch.backends.cudnn.deterministic = False
    batch = next(realestate.iterate_batches(
        config.DataConfig(dataset_path=os.path.join(
            workdir, "data_two")).make_dataset(
                rng=np.random.default_rng(0), device=dev),
        rng=np.random.default_rng(1)))
    steps = {}
    for name in ("float32", "bfloat16"):
      c = config.TrainConfig(
          compute_dtype=None if name == "float32" else name)
      st = c.make_train_state(0, dev)
      fn = c.make_train_step(c.make_vgg(dev))
      steps[name] = (st, fn)
    step_ms = {"float32": [], "bfloat16": []}
    for name in ("float32", "bfloat16", "bfloat16", "float32"):
      st, fn = steps[name]

      def one_step():
        fn(st, batch)
        torch.cuda.synchronize()

      for _ in range(3):
        one_step()
      step_ms[name].append(host_ms(one_step, 10))
    log(f"bridge: --bf16 run {json.dumps(bf16)}; step ms f32 and bf16 in "
        f"turns {json.dumps(step_ms)}")
  finally:
    if watcher is not None:
      watcher.stop()
    if httpd is not None:
      httpd.shutdown()
      httpd.server_close()
    for s in (svc, tsvc):
      if s is not None:
        s.close()
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = flags
  return {
      "launches": launches,
      "frames_vs_plain_max_abs_err": plain_errs,
      "params_restore_ms": restore_ms,
      "params_bytes_read": params_bytes, "checkpoint_bytes": ckpt_bytes,
      "bake_ms_per_scene_224_x10": bake_ms,
      "bake_max_abs_err_vs_cpu": bake_err,
      "live_reload": reload_times,
      "tiled_grid": [grid.rows, grid.cols, grid.tile],
      "save_ms_480_x33": save480_ms,
      "params_restore_ms_480_x33": restore480_ms,
      "bake_ms_480_x33": bake480_ms,
      "viewer_ms": viewer_ms, "viewer_bytes": viewer_bytes,
      "train_step_ms": step_ms,
  }


# Phase 12: breaker reset between the drill's probes (s), and the edge
# cache's lattice at 1080p (scene units and degrees).
DRILL_RESET_S = 1.0
EDGE = dict(trans_cell=0.02, rot_bucket_deg=2.0, warp_max_trans=0.06,
            warp_max_rot_deg=4.0, byte_budget=1 << 30)


def drill_scene():
  """Phase 12's 1080 x 1920 x 32 ``synthetic_scene`` (host numpy, made on
  ``main``'s scene thread while earlier phases run)."""
  from mpi_vision_tpu_torch.serve import synthetic_scene

  return synthetic_scene("drill_000", HEIGHT, WIDTH, PLANES, seed=12)


def fetch(port: int, scene_id: str, pose, headers=None):
  """``POST /render`` (octet-stream) -> ``(status, headers, frame)``; the
  frame is None for an answer without pixels (304, 503)."""
  body = json.dumps({"scene_id": scene_id, "pose": pose.tolist()}).encode()
  req = urllib.request.Request(
      f"http://127.0.0.1:{port}/render", data=body,
      headers={"Content-Type": "application/json",
               "Accept": "application/octet-stream", **(headers or {})})
  try:
    with urllib.request.urlopen(req, timeout=300) as resp:
      data = resp.read()
      hdrs = dict(resp.headers.items())
      shape = tuple(int(x) for x in hdrs["X-Image-Shape"].split(","))
      return resp.status, hdrs, np.frombuffer(data, "<f4").reshape(shape)
  except urllib.error.HTTPError as e:
    with e:
      return e.code, dict(e.headers.items()), None


def get_json(port: int, path: str):
  try:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as resp:
      return resp.status, json.loads(resp.read())
  except urllib.error.HTTPError as e:
    with e:
      return e.code, json.loads(e.read() or b"{}")


def phase12_degraded(torch, dev, drill, tscene, workdir: str) -> dict:
  """Serving under faults and overload (see the module docstring).
  ``drill`` is ``drill_scene()``'s, ``tscene`` phase 9's tiled scene."""
  from mpi_vision_tpu_torch.core import render
  from mpi_vision_tpu_torch.core.sampling import Convention
  from mpi_vision_tpu_torch.kernels import compose_over as co
  from mpi_vision_tpu_torch.kernels import render_fused
  from mpi_vision_tpu_torch.kernels import render_fused_bwd as rb
  from mpi_vision_tpu_torch.serve import (
      BrownoutConfig,
      BrownoutController,
      EdgeConfig,
      Fault,
      FaultyEngine,
      RenderEngine,
      RenderService,
      ResilienceConfig,
      make_http_server,
  )
  from mpi_vision_tpu_torch.serve import tiles as tiles_mod
  from mpi_vision_tpu_torch.serve.cache import bake_scene
  from mpi_vision_tpu_torch.serve.edge import warp as edge_warp
  from mpi_vision_tpu_torch.serve.engine import upsample_nearest

  kernels = (render_fused.render_mpi_fused, rb.rewarp_composite_vjp,
             rb.adjoint_warp, co.over_composite_pallas)
  plains = (render_fused.plain_render, co.plain_composite,
            rb.plain_rewarp_composite_vjp, rb.plain_adjoint_warp)
  by_device = (render_fused.plain_render, co.plain_composite)
  launches: dict = {}

  def zero():
    for fn in kernels:
      fn.launches = 0
    for fn in plains:
      fn.calls = 0
    for fn in by_device:
      fn.by_device = {"cpu": 0, "cuda": 0}

  def read(name: str) -> tuple[dict, dict]:
    """The counts since ``zero()`` as window ``name``. No plain version
    may have run on the card; outside the drill none may have run at all
    (the drill's CPU runs are returned for the caller to hold to the
    fallback's dispatches)."""
    counts = {fn.__name__: fn.launches for fn in kernels}
    plain = {fn.__name__: fn.calls for fn in plains}
    cpu = {fn.__name__: fn.by_device["cpu"] for fn in by_device}
    card = {fn.__name__: fn.by_device["cuda"] for fn in by_device}
    launches[name] = counts
    log(f"degraded [{name}]: launches {json.dumps(counts)}; plain versions "
        f"{json.dumps(plain)}, on the CPU {json.dumps(cpu)}")
    check(not any(card.values()), f"{name}: a plain version ran on the "
          f"card: {card}")
    if name != "drill":
      check(not any(plain.values()) and not any(cpu.values()),
            f"{name}: a plain version ran: {plain}, on the CPU {cpu}")
    return plain, cpu

  def direct(baked, pose, method="fused_pallas", **kw):
    """A direct render of one pose of a baked scene on the card."""
    return render.render_views(
        baked.rgba_layers, torch.from_numpy(pose[None]).to(dev),
        baked.depths, baked.intrinsics, convention=Convention.EXACT,
        method=method, **kw)[0].cpu().numpy()

  comp_errs: dict = {}

  def plain_ref(baked, pose, k_t, hw, label):
    """``direct(baked, pose, method="pallas", ...)`` with the compose
    kernel's plain version: the same warp stack composited by
    ``plain_composite``. The kernel is held to it on that stack."""
    homs = render.plane_homographies(
        torch.from_numpy(pose[None]).to(dev), baked.depths,
        baked.intrinsics[None],
        tgt_intrinsics=None if k_t is None else k_t[None])
    warped = render.warp_stack(baked.planes[:, None], homs, *hw,
                               Convention.EXACT)
    want = co.plain_composite(warped)
    err = float((co.over_composite_pallas(warped) - want).abs().max())
    comp_errs[label] = err
    check(err <= TOL, f"{label}: the compose kernel is off its plain "
          f"version by {err} on {tuple(warped.shape)}")
    return want[0].cpu().numpy()

  out: dict = {}
  t_phase = time.perf_counter()
  services, servers = [], []

  def serve(svc):
    services.append(svc)
    httpd = make_http_server(svc, port=0)
    servers.append(httpd)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd.server_address[1]

  try:
    # -- (a) fault drill: the CPU fallback while the breaker is open ------
    # The fallback engine's frame time sets the watchdog: a CPU frame must
    # finish inside it, a hang must not.
    fb_engine = RenderEngine(method="fused_pallas",
                             convention=Convention.EXACT, device="cpu")
    poses = [pan_pose(0.5 * i, 0.004 * i, -0.002 * i) for i in range(6)]
    # A first CPU render pays one-off start-up costs: take them on a tiny
    # scene, then time one full frame.
    fb_engine.render_batch(bake_scene("tiny", *(a[:8, :8] if a.ndim == 4
                                                else a for a in drill),
                                      device="cpu"), poses[1][None])
    cpu_scene = bake_scene("drill_000", *drill, device="cpu")
    t0 = time.perf_counter()
    cpu_frame = fb_engine.render_batch(cpu_scene, poses[1][None])[0]
    cpu_frame_ms = (time.perf_counter() - t0) * 1e3
    del cpu_scene
    watchdog_s = max(2.0 * cpu_frame_ms / 1e3 + 2.0, 6.0)
    eng = FaultyEngine(RenderEngine(method="fused_pallas",
                                    convention=Convention.EXACT,
                                    device="cuda", max_inflight=8))
    svc = RenderService(
        engine=eng, cpu_fallback="on", fallback_engine=fb_engine,
        resilience=ResilienceConfig(
            max_retries=2, backoff_base_s=0.01, breaker_threshold=2,
            breaker_reset_s=DRILL_RESET_S, watchdog_s=watchdog_s),
        max_batch=4, max_wait_ms=5.0, cache_bytes=6 << 30,
        profile_dir=os.path.join(workdir, "profiles"))
    svc.add_scene("drill_000", *drill)
    svc.warmup()
    check(svc.prebake_fallback(1) == ["drill_000"], "fallback prebake")
    port = serve(svc)
    baked = svc.cache.get("drill_000")
    want = [direct(baked, p) for p in poses[:5]]
    card_frame_ms = host_ms(
        lambda: svc.engine.render_batch(baked, poses[1][None]), 5)
    fallback_err = float(np.abs(cpu_frame - want[1]).max())
    log(f"degraded: CPU fallback frame {cpu_frame_ms:.1f} ms vs the card's "
        f"{card_frame_ms:.2f} ms (engine render_batch, host clock); CPU vs "
        f"card max_abs_err {fallback_err:.3e}; watchdog {watchdog_s:.1f} s")
    check(fallback_err <= TOL, f"CPU fallback frame off by {fallback_err}")

    zero()
    t_drill = time.perf_counter()
    status, _, f0 = fetch(port, "drill_000", poses[0])
    check(status == 200 and np.array_equal(f0, want[0]),
          "healthy frame differs from a direct kernel render")
    eng.schedule = lambda idx: Fault("error")  # the card is down
    fb_frames = []
    status, _, f1 = fetch(port, "drill_000", poses[1])
    check(status == 200, f"a request failed during the outage: {status}")
    fb_frames.append(f1)
    _, health = get_json(port, "/healthz")
    check(health["status"] == "degraded" and health["fallback_active"],
          f"healthz during the outage: {health}")
    fb_frames.append(svc.render("drill_000", poses[2], timeout=300))
    fb_renders = svc.metrics.fallback_renders
    eng.schedule = None  # the card is back
    time.sleep(svc.resilient.breaker.retry_after_s() + 0.05)
    status, _, f3 = fetch(port, "drill_000", poses[3])  # the probe
    check(status == 200 and np.array_equal(f3, want[3]),
          "after the outage a frame differs from a direct kernel render")
    _, health = get_json(port, "/healthz")
    check(health["status"] == "ok" and not health["fallback_active"]
          and health["breaker"]["state"] == "closed",
          f"the card did not take the traffic back: {health}")
    t0 = time.perf_counter()
    eng.inject(Fault("hang", seconds=600.0))
    status, _, f4 = fetch(port, "drill_000", poses[4])
    hang_s = time.perf_counter() - t0
    eng.release.set()
    check(status == 200 and np.array_equal(f4, want[4]),
          "the retry after a hang differs from a direct kernel render")
    svc.add_scene("cold_000", *tscene)
    eng.fail_next_bake(1)
    status, _, f5 = fetch(port, "cold_000", poses[5])
    check(status == 200, f"the cold scene's request failed: {status}")
    drill_s = time.perf_counter() - t_drill
    plain, cpu = read("drill")
    check(np.array_equal(f5, direct(svc.cache.get("cold_000"), poses[5])),
          "the cold scene's frame differs from a direct kernel render")
    fb_errs = [float(np.abs(f - w).max()) for f, w in zip(fb_frames,
                                                          want[1:3])]
    stats = svc.stats()
    events = [(e["old"], e["new"]) for e in
              svc.events.snapshot(kind="breaker", recent=64)["events"]]
    log(f"degraded: drill {drill_s:.1f} s, hang cost {hang_s:.1f} s; "
        f"fallback renders {stats['resilience']['fallback_renders']} "
        f"(max_abs_err vs kernel {max(fb_errs):.3e}); injected "
        f"{json.dumps(eng.injected)}; breaker {events}; errors "
        f"{stats['errors']}; watchdog trips "
        f"{stats['resilience']['watchdog_trips']}")
    check(launches["drill"]["render_mpi_fused"] > 0, "drill: no launch")
    check(1 <= fb_renders <= 4 and stats["resilience"]["fallback_renders"]
          == fb_renders, f"fallback renders {fb_renders}")
    check(plain["plain_render"] == cpu["plain_render"] == fb_renders,
          f"plain renders {plain} != fallback dispatches {fb_renders}")
    check(max(fb_errs) <= TOL, f"a fallback frame is off by {max(fb_errs)}")
    check(not any(stats["errors"].values()), f"errors {stats['errors']}")
    check(events[0] == ("closed", "open") and events[-1] == (
        "half_open", "closed"), f"breaker transitions {events}")
    check(stats["resilience"]["watchdog_trips"] >= 1
          and eng.injected["hang"] == 1 and eng.injected["bake"] == 1,
          "the hang or the bake fault did not fire")
    out["drill"] = {"cpu_fallback_frame_ms": cpu_frame_ms,
                    "card_frame_ms": card_frame_ms,
                    "fallback_renders": fb_renders,
                    "fallback_max_abs_err": max(fb_errs),
                    "watchdog_s": watchdog_s, "hang_s": hang_s,
                    "drill_s": drill_s, "breaker": events}

    # -- (d) profiler: a capture during a burst, a second one refused -----
    zero()
    stop = threading.Event()

    def burst(k):
      i = 0
      while not stop.is_set():
        svc.render("drill_000", pan_pose(0.3 * i + k, 0.01), timeout=300)
        i += 1

    workers = [threading.Thread(target=burst, args=(k,)) for k in range(2)]
    for t in workers:
      t.start()
    result: dict = {}
    capture = threading.Thread(target=lambda: result.update(
        zip(("status", "body"), get_json(port, "/debug/profile?seconds=1"))))
    capture.start()
    deadline = time.perf_counter() + 30
    while not svc.profiler.busy and time.perf_counter() < deadline:
      time.sleep(0.01)
    busy_status, _ = get_json(port, "/debug/profile?seconds=1")
    capture.join(120)
    stop.set()
    for t in workers:
      t.join(300)
    read("profile")
    check(busy_status == 409, f"a second capture answered {busy_status}")
    check(result.get("status") == 200, f"profile capture {result}")
    trace_path = os.path.join(result["body"]["logdir"], "trace.json")
    with open(trace_path) as fh:
      names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    ranges = sorted(n for n in names if n.startswith("render/"))
    kernel_names = sorted(n for n in names if "render_fused" in n)
    log(f"degraded: profile {os.path.getsize(trace_path)} bytes; ranges "
        f"{ranges}; kernels {kernel_names}")
    check(kernel_names, "the capture names no render kernel")
    check("render/warp_composite" in ranges, "the capture has no render/*")
    out["profile"] = {"trace_bytes": os.path.getsize(trace_path),
                      "ranges": ranges, "kernels": kernel_names}
    svc.close()

    # -- (b) edge: hits and warps launch nothing, misses launch once ------
    esvc = RenderService(device="cuda", method="fused_pallas",
                         convention=Convention.EXACT, cpu_fallback="off",
                         edge=EdgeConfig(**EDGE), max_batch=4,
                         max_wait_ms=5.0, cache_bytes=2 << 30)
    esvc.add_scene("drill_000", *drill)
    esvc.warmup()
    eport = serve(esvc)
    base, near = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    base[0, 3], near[0, 3] = 0.001, 0.031
    far = []
    for tx in (0.3, 0.5, 0.7):
      p = np.eye(4, dtype=np.float32)
      p[0, 3] = tx
      far.append(p)
    lat: dict = {"hit": [], "warp": [], "miss": []}
    zero()

    def timed(kind, pose, headers=None):
      t0 = time.perf_counter()
      status, hdrs, frame = fetch(eport, "drill_000", pose, headers)
      lat[kind].append((time.perf_counter() - t0) * 1e3)
      return status, hdrs, frame

    status, hdrs, f_miss = timed("miss", base)
    check(status == 200 and hdrs["X-Edge-Cache"] == "miss", "first miss")
    etag = hdrs["ETag"]
    for _ in range(5):
      status, hdrs, f_hit = timed("hit", base)
      check(hdrs["X-Edge-Cache"] == "hit" and hdrs["ETag"] == etag
            and f_hit.tobytes() == f_miss.tobytes(), "a repeat missed")
    status, hdrs, _ = fetch(eport, "drill_000", base,
                            {"If-None-Match": etag})
    check(status == 304 and hdrs["X-Edge-Cache"] == "revalidated",
          f"If-None-Match answered {status}")
    for _ in range(5):
      status, hdrs, f_warp = timed("warp", near)
      check(hdrs["X-Edge-Cache"] == "warp" and "ETag" not in hdrs,
            "a near pose was not warped")
    for p in far:
      status, hdrs, _ = timed("miss", p)
      check(hdrs["X-Edge-Cache"] == "miss", "a far pose did not miss")
    read("edge")
    edge_stats = esvc.stats()["edge"]
    check(launches["edge"]["render_mpi_fused"] == edge_stats["misses"] == 4,
          f"launches {launches['edge']} != misses {edge_stats['misses']}")
    check(np.array_equal(f_miss, direct(esvc.cache.get("drill_000"), base)),
          "an edge miss differs from a direct kernel render")
    _, k, depth, _ = esvc._edge_meta("drill_000")
    warp_cpu = edge_warp.warp_frame(f_miss, base, near, k, depth,
                                    device="cpu")
    warp_err = float(np.abs(f_warp - warp_cpu).max())
    img = torch.from_numpy(np.array(f_miss)).to(dev)
    rel = torch.from_numpy(edge_warp.relative_pose(base, near)).to(dev)
    k_dev = torch.from_numpy(np.asarray(k, np.float32)).to(dev)
    warp_ms = cuda_ms(torch, lambda: edge_warp.warp_tensor(img, rel, k_dev,
                                                           depth), 10)
    p50 = {kind: statistics.median(v) for kind, v in lat.items()}
    log(f"degraded: edge p50 ms {json.dumps(p50)} (HTTP, 24.9 MB bodies); "
        f"warp on the card {warp_ms:.3f} ms (CUDA events), vs the CPU warp "
        f"{warp_err:.3e}; stats {json.dumps(edge_stats)}")
    check(warp_err <= TOL, f"card warp vs CPU warp {warp_err}")
    out["edge"] = {"p50_ms": p50, "warp_device_ms": warp_ms,
                   "warp_max_abs_err_vs_cpu": warp_err,
                   "hit_rate": edge_stats["hit_rate"]}
    esvc.close()
    del img

    # -- (c) brownout on phase 9's tiled scene, a clock the phase drives --
    kw = dict(device="cuda", method="pallas", convention=Convention.EXACT,
              cpu_fallback="off", max_batch=4, max_wait_ms=20.0)
    bsvc = RenderService(tile="auto", cache_bytes=8 << 30,
                         brownout=BrownoutConfig(), **kw)
    mono = RenderService(cache_bytes=4 << 30, **kw)
    services.append(mono)
    for s in (bsvc, mono):
      s.add_scene("tiled_000", *tscene)
    bsvc.warmup()
    bport = serve(bsvc)
    clk = {"t": 0.0}
    sig = {"burn": 0.0}
    bsvc.brownout = BrownoutController(
        BrownoutConfig(step_dwell_s=1.0, recover_dwell_s=2.0,
                       eval_interval_s=0.0),
        burn_fn=lambda: sig["burn"], queue_fn=lambda: 0.0,
        on_transition=bsvc._on_brownout_transition,
        clock=lambda: clk["t"])
    views = {"full": np.eye(4, dtype=np.float32),
             "pan": pan_pose(-0.2 * 57.3, 0.0)}
    ref0 = {n: mono.render("tiled_000", p, timeout=300)
            for n, p in views.items()}
    burst_poses = [pan_pose(-0.2 * 57.3 + 0.3 * i, 0.0) for i in range(8)]
    pool = concurrent.futures.ThreadPoolExecutor(4)

    def step(burn):
      sig["burn"] = burn
      clk["t"] += 1.0
      return bsvc.brownout.tick()

    def rps():
      t0 = time.perf_counter()
      list(pool.map(lambda p: bsvc.render_request("tiled_000", p,
                                                  timeout=300), burst_poses))
      return len(burst_poses) / (time.perf_counter() - t0)

    got: dict = {}
    level_rps: dict = {}
    zero()
    for level in range(4):
      check(bsvc.brownout.level == level, f"ladder at "
            f"{bsvc.brownout.level}, not {level}")
      for name, pose in views.items():
        status, hdrs, frame = fetch(bport, "tiled_000", pose)
        check(status == 200 and hdrs["X-Brownout-Level"] == str(level)
              and (hdrs.get("X-Degraded") == "1") == (level > 0),
              f"L{level} {name}: {status} {hdrs}")
        got[(level, name)] = frame
      if level < 3:
        level_rps[f"L{level}"] = rps()
      step(10.0)
    check(bsvc.brownout.level == 4, "the ladder did not reach L4")
    shed = {cls: fetch(bport, "tiled_000", views["pan"],
                       {"X-Request-Class": cls})[:2]
            for cls in ("interactive", "background")}
    for cls, (status, hdrs) in shed.items():
      check(status == 503 and int(hdrs["Retry-After"]) >= 1
            and hdrs["X-Brownout-Level"] == "4", f"L4 {cls}: {status}")
    step(0.1)
    for _ in range(8):
      clk["t"] += 1.0
      bsvc.brownout.tick()
    check(bsvc.brownout.level == 0, f"the ladder is at "
          f"{bsvc.brownout.level} after recovery")
    status, hdrs, back = fetch(bport, "tiled_000", views["full"])
    read("brownout")
    moves = [(e["old"], e["new"]) for e in bsvc.events.snapshot(
        kind="brownout_level", recent=32)["events"]]
    check(moves == [(0, 1), (1, 2), (2, 3), (3, 4), (4, 3), (3, 2), (2, 1),
                    (1, 0)], f"ladder moves {moves}")
    check(launches["brownout"]["over_composite_pallas"] > 0,
          "brownout: the compose kernel never launched")
    check(status == 200 and np.array_equal(back, ref0["full"]),
          "after recovery an L0 frame differs from the untiled service")
    # The references, outside the counted window.
    full_scene = mono.cache.get("tiled_000")
    meta = bsvc.tile_meta("tiled_000")
    keep = bsvc.brownout.config.plane_keep
    half = torch.tensor([[0.5], [0.5], [1.0]], device=dev)
    for name, pose in views.items():
      check(np.array_equal(got[(0, name)], ref0[name]),
            f"L0 {name} differs from the untiled pallas service")
      planes = tiles_mod.thin_planes(
          meta.plan(pose[None], Convention.EXACT).planes, keep)
      idx = torch.tensor(planes, dtype=torch.long, device=dev)
      thinned = bake_scene("thin", tscene[0][:, :, list(planes)],
                           tscene[1][list(planes)], tscene[2], device=dev)
      check(torch.equal(thinned.planes, full_scene.planes[idx]),
            "thinned bake")
      k_half = thinned.intrinsics * half
      half_hw = (HEIGHT // 2, WIDTH // 2)
      l1 = direct(thinned, pose, method="pallas")
      l2 = upsample_nearest(direct(
          thinned, pose, method="pallas", tgt_intrinsics=k_half,
          out_hw=half_hw), (HEIGHT, WIDTH))
      # The plain references: the same thinned planes and half-resolution
      # homographies, composited by the compose kernel's plain version.
      p1 = plain_ref(thinned, pose, None, (HEIGHT, WIDTH), f"L1 {name}")
      p2 = upsample_nearest(
          plain_ref(thinned, pose, k_half, half_hw, f"L2 {name}"),
          (HEIGHT, WIDTH))
      for level, ref, plain_frame in ((1, l1, p1), (2, l2, p2),
                                      (3, l2, p2)):
        err = float(np.abs(got[(level, name)] - ref).max())
        check(np.array_equal(got[(level, name)], ref),
              f"L{level} {name} differs from its direct render by {err}")
        err = float(np.abs(got[(level, name)] - plain_frame).max())
        comp_errs[f"L{level} {name} served"] = err
        check(err <= TOL, f"L{level} {name} is off the plain render by "
              f"{err}")
      del thinned
    log(f"degraded: brownout renders/s {json.dumps(level_rps)}; ladder "
        f"{moves}; L4 sheds {json.dumps({c: s for c, (s, _) in shed.items()})}"
        f"; every level's frames equal their references; compose kernel "
        f"and served frames vs the plain composite {json.dumps(comp_errs)}")
    pool.shutdown()
    out["brownout"] = {"renders_per_s": level_rps, "moves": moves,
                       "compose_max_abs_err": max(comp_errs.values()),
                       "compose_errs": comp_errs}
  finally:
    for httpd in servers:
      httpd.shutdown()
      httpd.server_close()
    for s in services:
      s.close()
    torch.cuda.empty_cache()
  out["launches"] = launches
  out["phase_s"] = time.perf_counter() - t_phase
  log(f"degraded: phase 12 took {out['phase_s']:.1f} s")
  return out


SCENE_009 = os.path.join(ROOT, "tests", "fixtures", "scene_009")
# Phase 13 (c): the quantile objective the fault must break, and the
# burst that feeds it.
SLO_LATENCY_MS = 500.0
FAULT_SLOW_S = 0.8
RECORDER_CLIENTS = 3
# Phase 13 (b): bench/config5_tiny_unet.py's default step count.
CONFIG5_STEPS = 150


def phase13_flight(torch, dev, drill, workdir: str, step_ms7: float) -> dict:
  """The reference's helper surface, config 5's tiny U-Net and the serving
  flight recorder on the card (see the module docstring). ``drill`` is
  ``drill_scene()``'s 1080p x 32 scene, ``step_ms7`` phase 7's step."""
  from mpi_vision_tpu_torch import cli, compat
  from mpi_vision_tpu_torch.core import render
  from mpi_vision_tpu_torch.core.sampling import Convention
  from mpi_vision_tpu_torch.data import realestate
  from mpi_vision_tpu_torch.kernels import compose_over as co
  from mpi_vision_tpu_torch.kernels import render_fused
  from mpi_vision_tpu_torch.kernels import render_fused_bwd as rb
  from mpi_vision_tpu_torch.models import tiny_unet
  from mpi_vision_tpu_torch.obs import parse_metrics_text
  from mpi_vision_tpu_torch.obs.ship import make_sink_server
  from mpi_vision_tpu_torch.serve import (
      Fault,
      FaultyEngine,
      RenderEngine,
      RenderService,
      make_http_server,
  )

  kernels = (render_fused.render_mpi_fused, rb.rewarp_composite_vjp,
             rb.adjoint_warp, co.over_composite_pallas)
  plains = (render_fused.plain_render, co.plain_composite,
            rb.plain_rewarp_composite_vjp, rb.plain_adjoint_warp)
  launches: dict = {}

  def zero():
    for fn in kernels:
      fn.launches = 0
    for fn in plains:
      fn.calls = 0

  def read(name: str) -> dict:
    """The launches since ``zero()`` as window ``name``; no plain version
    may have run in it."""
    counts = {fn.__name__: fn.launches for fn in kernels}
    plain = {fn.__name__: fn.calls for fn in plains}
    launches[name] = counts
    log(f"flight [{name}]: launches {json.dumps(counts)}; plain versions "
        f"{json.dumps(plain)}")
    check(not any(plain.values()), f"{name}: a plain version ran: {plain}")
    return counts

  out: dict = {}
  t_phase = time.perf_counter()

  # -- (a) the reference's helper surface on the card ----------------------
  _, mpi9, depths9, k9 = cli.mpi_dir_scene(SCENE_009)
  h9, w9, p9 = mpi9.shape[:3]
  pose9 = pan_pose(3.0, 0.04, -0.02)
  gen = torch.Generator(device=dev).manual_seed(13)
  big = torch.rand((1, HEIGHT, WIDTH, PLANES, 4), generator=gen, device=dev)
  depths = torch.from_numpy(
      np.geomspace(100.0, 1.0, PLANES).astype(np.float32)).to(dev)
  k_big = torch.tensor([[[0.6 * WIDTH, 0, WIDTH / 2],
                         [0, 0.6 * WIDTH, HEIGHT / 2], [0, 0, 1]]],
                       device=dev)
  pose_big = torch.from_numpy(pan_pose(5.0, 0.05)[None]).to(dev)
  stack = torch.rand((PLANES, 1, HEIGHT, WIDTH, 4), generator=gen,
                     device=dev)
  planes_list = list(stack.unbind(0))
  size, p10 = 224, 10
  img = torch.rand((1, size, size, 3), generator=gen, device=dev) * 2 - 1
  srcs = torch.rand((2, 1, size, size, 3), generator=gen, device=dev) * 2 - 1
  sweep_pose = torch.from_numpy(pan_pose(1.0, 0.03)[None]).to(dev)
  src_poses = torch.stack([sweep_pose, torch.from_numpy(
      pan_pose(-1.0, -0.02)[None]).to(dev)])
  k224 = torch.tensor([[[0.5 * size, 0, size / 2],
                        [0, 0.5 * size, size / 2], [0, 0, 1]]], device=dev)
  d10 = compat.inv_depths(1.0, 100.0, p10)
  zero()
  f9 = compat.mpi_render_view_torch(mpi9[None], pose9[None], depths9,
                                    k9[None])
  f_big = compat.mpi_render_view_torch(big, pose_big, depths, k_big)
  c_list = compat.over_composite(planes_list)
  c_stack = compat.over_composite(stack)
  psv = compat.plane_sweep_torch(img, d10, sweep_pose, k224)
  net_in = compat.format_network_input_torch(
      img, srcs, torch.eye(4, device=dev)[None], src_poses, d10, k224)
  torch.cuda.synchronize()
  counts = read("compat")
  check(counts["render_mpi_fused"] == 2 and counts["over_composite_pallas"]
        == 2, f"compat did not run the kernels once a call: {counts}")
  check(all(t.device.type == "cuda" for t in (f9, f_big, c_list, psv,
                                              net_in)),
        "a compat result is not on the card")
  check(f9.shape == (1, h9, w9, 3) and f_big.shape == (1, HEIGHT, WIDTH, 3)
        and psv.shape == (1, size, size, 3 * p10)
        and net_in.shape == (1, size, size, 3 + 3 * p10 * 2),
        "compat shapes")
  # Each held to the plain version on the same planes and homographies.
  errs = {}
  for name, mpi, pose, dep, k, frame in (
      ("scene_009", torch.from_numpy(mpi9[None]).to(dev),
       torch.from_numpy(pose9[None]).to(dev),
       torch.from_numpy(depths9).to(dev), torch.from_numpy(k9[None]).to(dev),
       f9),
      ("1080p_x32", big, pose_big, depths, k_big, f_big)):
    hh, ww = mpi.shape[1:3]
    homs = render_fused.pixel_homographies(
        pose, dep, k, hh, ww, Convention.REF_HOMOGRAPHY
    ).transpose(0, 1).contiguous()
    want = render_fused.plain_render(mpi[0].movedim(2, 0).contiguous(), homs)
    errs[name] = float((frame - want).abs().max())
  want_c = co.plain_composite(stack)
  errs["composite_list"] = float((c_list - want_c).abs().max())
  errs["composite_stack"] = float((c_stack - want_c).abs().max())
  cpu_psv = compat.plane_sweep_torch(img.cpu(), d10.cpu(), sweep_pose.cpu(),
                                     k224.cpu(), device="cpu")
  errs["plane_sweep_vs_cpu"] = float((psv.cpu() - cpu_psv).abs().max())
  log(f"flight: compat vs plain max_abs_err {json.dumps(errs)}")
  for name in ("scene_009", "1080p_x32", "composite_list",
               "composite_stack"):
    check(errs[name] == 0.0, f"compat {name} is off its plain version by "
          f"{errs[name]}")
  check(errs["plane_sweep_vs_cpu"] <= 1e-3 and bool(
      torch.isfinite(net_in).all()), f"plane sweep {errs}")
  mpi_big = big[0].movedim(2, 0).contiguous()
  homs_big = render_fused.pixel_homographies(
      pose_big, depths, k_big, HEIGHT, WIDTH, Convention.REF_HOMOGRAPHY
  ).transpose(0, 1).contiguous()
  compat_ms = cuda_ms(torch, lambda: compat.mpi_render_view_torch(
      big, pose_big, depths, k_big), 10)
  direct_ms = cuda_ms(torch, lambda: render_fused.render_mpi_fused(
      mpi_big, homs_big), 10)
  log(f"flight: compat 1080p x 32 render {compat_ms:.3f} ms vs the kernel "
      f"alone {direct_ms:.3f} ms (CUDA events)")
  out["compat"] = {"max_abs_err": errs, "render_ms": compat_ms,
                   "render_fused_ms": direct_ms,
                   "surface_overhead_ms": compat_ms - direct_ms}
  del big, stack, planes_list, c_list, c_stack, want_c, mpi_big, f_big
  torch.cuda.empty_cache()

  # -- (b) BASELINE config 5: the tiny U-Net through the render loss -------
  root = os.path.join(workdir, "config5")
  realestate.synthesize_dataset(root, num_scenes=1, frames=3, img_size=64,
                                seed=0)
  ds = realestate.RealEstateDataset(root, img_size=64, num_planes=8,
                                    is_valid=True, device=dev)
  batch = next(realestate.iterate_batches(ds, shuffle=False))
  torch.manual_seed(0)
  model = tiny_unet.TinyPlaneUNet(8).to(dev)
  psv5 = tiny_unet.psv_from_net_input(batch["net_input"], 8)
  rel = batch["tgt_img_cfw"] @ batch["ref_img_wfc"]

  def render5(mpi):
    return render.render_mpi(mpi, rel, batch["mpi_planes"][0],
                             batch["intrinsics"], method="fused_pallas")

  opt = torch.optim.Adam(model.parameters(), lr=1e-3)
  losses = []
  zero()
  t0 = time.perf_counter()
  for _ in range(CONFIG5_STEPS):
    opt.zero_grad()
    loss = torch.mean((render5(model(psv5)) - batch["tgt_img"]) ** 2)
    loss.backward()
    opt.step()
    losses.append(loss.detach())
  losses = [float(v) for v in torch.stack(losses).cpu()]
  train_s = time.perf_counter() - t0
  counts = read("config5")
  check(counts["render_mpi_fused"] == counts["rewarp_composite_vjp"]
        == counts["adjoint_warp"] == CONFIG5_STEPS,
        f"config 5: a step did not launch the forward, A and B: {counts}")
  check(np.isfinite(losses).all() and losses[-1] < losses[0],
        f"config 5 did not overfit: {losses[0]} -> {losses[-1]}")
  # One step's gradients, the kernel backward against the plain one.
  params = list(model.parameters())
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    mpi5 = model(psv5)
    planes5 = mpi5[0].movedim(2, 0).contiguous()
    homs5 = render_fused.pixel_homographies(
        rel, batch["mpi_planes"][0], batch["intrinsics"], 64, 64,
        Convention.REF_HOMOGRAPHY).transpose(0, 1).contiguous()
    leaf = planes5.detach()
    frame = render_fused.render_mpi_fused(leaf, homs5).detach()
    frame.requires_grad_(True)
    torch.mean((frame - batch["tgt_img"]) ** 2).backward()
    g = frame.grad.contiguous()
    d_kernel = rb.backward_planes(leaf, homs5, g)
    d_plain = rb.plain_adjoint_warp(
        rb.plain_rewarp_composite_vjp(leaf, homs5, g), homs5, shared=True)
    w_kernel = torch.autograd.grad(planes5, params, d_kernel,
                                   retain_graph=True)
    w_plain = torch.autograd.grad(planes5, params, d_plain)
  finally:
    torch.backends.cudnn.deterministic = deterministic
  scale = float(d_plain.abs().max())
  err_planes = float((d_kernel - d_plain).abs().max())
  err_weights = max(float((a - b).abs().max() / b.abs().max().clamp(
      min=1e-30)) for a, b in zip(w_kernel, w_plain))
  check(scale > 0 and err_planes <= 1e-4 * scale and err_weights <= 1e-4,
        f"config 5 gradients: planes {err_planes} of {scale}, weights "
        f"{err_weights}")

  def infer():
    with torch.no_grad():
      return render5(model(psv5))

  infer()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(20):
    infer()
  torch.cuda.synchronize()
  infer_s = (time.perf_counter() - t0) / 20
  log(f"flight: config 5 {CONFIG5_STEPS} steps in {train_s:.2f} s, loss "
      f"{losses[0]:.5f}"
      f" -> {losses[-1]:.5f}; kernel vs plain backward: planes "
      f"{err_planes:.3e} of {scale:.3e}, weights relative {err_weights:.3e};"
      f" inference {infer_s * 1e3:.3f} ms = {1.0 / infer_s:.1f} frames/s "
      f"(target 30)")
  out["config5"] = {"train_s": train_s, "first_loss": losses[0],
                    "final_loss": losses[-1], "grad_err_planes": err_planes,
                    "grad_err_weights_rel": err_weights,
                    "infer_ms": infer_s * 1e3, "frames_per_s": 1.0 / infer_s}
  del model, opt, psv5, batch, ds
  torch.cuda.empty_cache()

  # -- (c) serving under the flight recorder --------------------------------
  sink_dir = os.path.join(workdir, "sink")
  sink_server, sink = make_sink_server(sink_dir, port=0)
  sink_port = sink_server.server_address[1]
  sink_thread = threading.Thread(target=sink_server.serve_forever,
                                 daemon=True)
  sink_thread.start()
  sink_bytes = 0
  flags = ["serve", "--slo-quantile", "0.99", "--slo-latency-ms",
           str(SLO_LATENCY_MS), "--slo-latency-target", "0.5",
           "--slo-fast-window-s", "10", "--slo-slow-window-s", "30",
           "--tsdb-interval-s", "0.25", "--attrib",
           "--incident-dir", os.path.join(workdir, "incidents"),
           "--incident-profile", "0.5",
           "--profile-dir", os.path.join(workdir, "profiles"),
           "--ship-url", f"http://127.0.0.1:{sink_port}/ingest",
           "--ship-interval-s", "0.25",
           "--ship-spool-dir", os.path.join(workdir, "spool")]
  recorder_kw = cli._degraded_mode_kwargs(cli.build_parser().parse_args(
      flags))
  check(recorder_kw["slo"].quantile == 0.99, "the CLI lost --slo-quantile")
  base_kw = dict(max_batch=8, max_wait_ms=20.0, max_inflight=4,
                 cache_bytes=4 << 30)
  burst_poses = [pan_pose(0.5 * i, 0.002 * i) for i in range(32)]

  def burst_rps(svc):
    t0 = time.perf_counter()
    futs = [svc.render_async("drill_000", p) for p in burst_poses]
    for f in futs:
      f.result(300)
    return len(burst_poses) / (time.perf_counter() - t0)

  off = RenderService(device="cuda", convention=Convention.EXACT,
                      slo=None, **base_kw)
  eng = FaultyEngine(RenderEngine(method="fused_pallas",
                                  convention=Convention.EXACT,
                                  device="cuda", max_inflight=16))
  svc = RenderService(engine=eng, **base_kw, **recorder_kw)
  httpd = None
  stop = threading.Event()
  running = threading.Event()  # cleared: the HTTP clients pause
  running.set()
  idle = [threading.Event() for _ in range(RECORDER_CLIENTS)]
  statuses: list = []
  scrape_ms: list = []
  scrape_errors: list = []
  clients: list = []
  try:
    for s in (off, svc):
      s.add_scene("drill_000", *drill)
      s.warmup()
    # The same burst with the recorder off and on, in turns (the first
    # round pays each service's first-use pinned buffers).
    rps_off, rps_on = [], []
    for _ in range(4):
      rps_off.append(burst_rps(off))
      rps_on.append(burst_rps(svc))
    off.close()
    httpd = make_http_server(svc, port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def client(k):
      i = 0
      while not stop.is_set():
        if not running.is_set():
          idle[k].set()
          running.wait()
          idle[k].clear()
          continue
        status, _, frame = fetch(port, "drill_000",
                                 pan_pose(0.2 * i + k, 0.01 * k))
        statuses.append(status)
        i += 1

    def scraper():
      while not stop.is_set():
        t0 = time.perf_counter()
        try:
          with urllib.request.urlopen(
              f"http://127.0.0.1:{port}/metrics", timeout=60) as resp:
            parse_metrics_text(resp.read().decode())
          scrape_ms.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # noqa: BLE001 - reported on the main thread
          scrape_errors.append(repr(e))
        stop.wait(0.25)

    zero()
    clients = [threading.Thread(target=client, args=(k,))
               for k in range(RECORDER_CLIENTS)]
    clients.append(threading.Thread(target=scraper))
    for t in clients:
      t.start()
    time.sleep(4.0)
    check(not svc.slo.alerts_firing(), f"an SLO alert fired before the "
          f"fault: {svc.slo.alerts_firing()}")
    # One slow dispatch of a full batch, the clients held meanwhile, then
    # the card is fast again: the profile the incident captures sees
    # live traffic.
    running.clear()
    for ev in idle:
      check(ev.wait(60), "a client did not pause")
    eng.inject(Fault("slow", seconds=FAULT_SLOW_S))
    slow = [svc.render_async("drill_000", pan_pose(0.1 * i, 0.02))
            for i in range(8)]
    for f in slow:
      f.result(300)
    check(eng.injected["slow"] == 1, f"faults {eng.injected}")
    running.set()
    deadline = time.perf_counter() + 60
    index: list = []
    while time.perf_counter() < deadline:
      _, body = get_json(port, "/debug/incidents")
      index = body["incidents"]
      if index:
        break
      time.sleep(0.1)
    check(index, "no incident bundle after the latency fault")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 2.0 and not sink.stats()["received"]:
      time.sleep(0.05)
    # The sink goes away: batches spool; it comes back: the spool drains.
    received_before = sink.stats()["received"]
    sink_bytes += sink.stats()["bytes_received"]
    sink_server.shutdown()
    sink_server.server_close()
    sink_thread.join(30)
    t0 = time.perf_counter()
    while (svc.shipper.stats()["spool_files"] < 2
           and time.perf_counter() - t0 < 30):
      time.sleep(0.1)
    spooled = svc.shipper.stats()["spool_files"]
    sink_server, sink = make_sink_server(sink_dir, port=sink_port)
    sink_thread = threading.Thread(target=sink_server.serve_forever,
                                   daemon=True)
    sink_thread.start()
    t0 = time.perf_counter()
    while (svc.shipper.stats()["spool_files"] > 0
           and time.perf_counter() - t0 < 60):
      time.sleep(0.1)
    stop.set()
    for t in clients:
      t.join(300)
    counts = read("serve")
    time.sleep(0.4)  # past the exposition cache's TTL
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as resp:
      metrics = parse_metrics_text(resp.read().decode())
    _, stats = get_json(port, "/stats")
    _, attrib = get_json(port, "/debug/attrib")
    _, tsdb = get_json(port, "/debug/tsdb?family=mpi_serve_requests_total")
    _, index_body = get_json(port, "/debug/incidents")
    _, bundle = get_json(port, f"/debug/incidents?id={index[0]['id']}")
    ship_stats = svc.shipper.stats()
  finally:
    stop.set()
    running.set()
    for t in clients:
      t.join(300)
    eng.release.set()
    if httpd is not None:
      httpd.shutdown()
      httpd.server_close()
    off.close()
    svc.close()
    sink_server.shutdown()
    sink_server.server_close()
    sink_thread.join(30)
  sink_bytes += sink.stats()["bytes_received"]

  def value(family, sample=None, labels=()):
    return metrics[family]["samples"][(sample or family, labels)]

  check(counts["render_mpi_fused"] > 0, "serve: the kernel never launched")
  check(statuses and all(s == 200 for s in statuses),
        f"a request failed: {sorted(set(statuses))}")
  check(not any(stats["errors"].values()) and stats["rejected"] == 0,
        f"errors {stats['errors']}, rejected {stats['rejected']}")
  check(not scrape_errors and len(scrape_ms) >= 8,
        f"/metrics scrapes: {len(scrape_ms)} ok, errors {scrape_errors[:2]}")
  check(value("mpi_serve_requests_total") == stats["requests"]
        and value("mpi_serve_batches_total") == stats["batches"],
        "/metrics render counters differ from /stats")
  cons = attrib["conservation"]
  check(cons["ok"] and cons["request_delta"] == 0,
        f"attribution conservation {cons}")
  series = tsdb["series"]
  check(series and sum(len(s["points"]) for s in series) >= 2,
        f"/debug/tsdb returned no points: {tsdb}")
  check(len(index_body["incidents"]) == 1, f"{len(index_body['incidents'])}"
        " incident bundles, not exactly one")
  check(bundle["alert"]["alert"] == "latency_p99", f"bundle {bundle['alert']}")
  prof = bundle.get("profile") or {}
  check("logdir" in prof, f"the bundle carries no profile: {prof}")
  with open(os.path.join(prof["logdir"], "trace.json")) as fh:
    names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
  kernel_names = sorted(n for n in names if "render_fused_kernel" in n)
  check(kernel_names, f"the incident's profile names no "
        f"render_fused_kernel: {len(names)} names, e.g. "
        f"{sorted(names)[:12]}")
  # Every delivered batch, in the sink's order: the spool drained oldest
  # first and nothing was lost.
  batches = []
  for name in sorted(os.listdir(sink_dir)):
    if name.startswith("batch-") and name.endswith(".json"):
      with open(os.path.join(sink_dir, name)) as fh:
        batches.append(json.load(fh))
  sent = [b["sent_at"] for b in batches]
  shipped_incidents = [bd["id"] for b in batches for item in b["items"]
                       if item["kind"] == "incidents"
                       for bd in item["bundles"]]
  check(spooled >= 2 and ship_stats["spooled"] >= spooled
        and ship_stats["spool_files"] == 0 and ship_stats["spool_dropped"]
        == 0, f"spool: {spooled} spooled, stats {ship_stats}")
  check(sent == sorted(sent), "the spool did not drain in order")
  check(shipped_incidents == [index[0]["id"]],
        f"shipped bundles {shipped_incidents}")
  rps = {"recorder_off": rps_off, "recorder_on": rps_on}
  capture_ms = bundle["capture_s"] * 1e3
  log(f"flight: renders/s {json.dumps(rps)}; /metrics scrape p50 "
      f"{statistics.median(scrape_ms):.2f} ms over {len(scrape_ms)}; "
      f"{len(statuses)} requests, all 200; incident {bundle['id']} "
      f"({bundle['alert']['alert']}) captured in {capture_ms:.1f} ms with "
      f"a profile naming {kernel_names}; spool {spooled} batches, "
      f"{received_before} batches before the outage, {len(batches)} "
      f"delivered, {sink_bytes} bytes shipped; attribution {cons}")
  out["serve"] = {"renders_per_s": rps,
                  "metrics_scrape_ms_p50": statistics.median(scrape_ms),
                  "scrapes": len(scrape_ms), "requests": len(statuses),
                  "incident_capture_ms": capture_ms,
                  "profile_kernels": kernel_names,
                  "spooled_batches": spooled,
                  "batches_delivered": len(batches),
                  "shipped_bytes": sink_bytes,
                  "attrib_conservation": cons}

  # -- (d) training telemetry at TrainConfig() -------------------------------
  pf = os.path.join(workdir, "train_metrics_port")
  args = cli.build_parser().parse_args(
      ["train", "--synthetic", "--synthetic-scenes", str(TRAIN_STEPS),
       "--epochs", "1", "--dataset", os.path.join(workdir, "re10k"),
       "--device", "cuda", "--no-valid",
       "--ckpt", os.path.join(workdir, "telemetry_ckpt"), "--save-every",
       "2", "--metrics-port", "0", "--metrics-port-file", pf])
  scrapes: list = []
  done = threading.Event()

  def train_scraper():
    while not done.is_set() and not os.path.exists(pf):
      time.sleep(0.005)
    while not done.is_set():
      try:
        with open(pf) as fh:
          mport = int(fh.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics",
                                    timeout=30) as resp:
          scrapes.append(parse_metrics_text(resp.read().decode()))
      except (OSError, ValueError):
        pass
      time.sleep(0.05)

  scraper_thread = threading.Thread(target=train_scraper)
  scraper_thread.start()
  zero()
  try:
    summary = cli.cmd_train(args)
  finally:
    done.set()
    scraper_thread.join(60)
  torch.cuda.synchronize()
  counts = read("train")
  steps = summary["steps"]
  check(steps == TRAIN_STEPS and counts["render_mpi_fused"] == steps
        and counts["rewarp_composite_vjp"] == steps
        and counts["adjoint_warp"] == steps,
        f"train: {steps} steps, launches {counts}")
  seen = [s["mpi_train_steps_total"]["samples"][
      ("mpi_train_steps_total", ())] for s in scrapes]
  check(seen and any(0 < v <= steps for v in seen),
        f"no mid-run scrape saw a step: {seen[:5]}...")
  last = scrapes[-1]
  families = sorted(f for f in last if f.startswith("mpi_train_"))
  step_s = last["mpi_train_step_seconds_total"]["samples"][
      ("mpi_train_step_seconds_total", ())]
  step_ms = step_s / max(seen[-1], 1) * 1e3
  p50_ms = last["mpi_train_step_quantile_seconds"]["samples"][
      ("mpi_train_step_quantile_seconds", (("q", "0.5"),))] * 1e3
  log(f"flight: train telemetry {len(scrapes)} scrapes, steps seen "
      f"{sorted(set(seen))}; {len(families)} mpi_train_* families; step "
      f"p50 {p50_ms:.2f} ms, mean {step_ms:.2f} ms (telemetry: the loss "
      f"read included; --ckpt runs cuDNN deterministic) vs phase 7's "
      f"{step_ms7:.2f} ms; summary telemetry {summary.get('telemetry')}")
  check("mpi_train_loss" in families and summary["telemetry"]["steps"]
        == steps, f"train telemetry: {families}, {summary.get('telemetry')}")
  out["train"] = {"scrapes": len(scrapes), "steps_seen": sorted(set(seen)),
                  "families": len(families), "step_ms_mean": step_ms,
                  "step_ms_p50": p50_ms,
                  "phase7_step_ms": step_ms7}
  out["launches"] = launches
  out["phase_s"] = time.perf_counter() - t_phase
  log(f"flight: phase 13 took {out['phase_s']:.1f} s")
  return out

def main() -> int:
  # cuBLAS picks a fixed workspace, so phase 10's products (the loss's
  # resize) are allowed under torch's deterministic mode.
  os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
  import torch

  if not torch.cuda.is_available():
    print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
    return 2
  sys.path.insert(0, ROOT)
  try:
    from mpi_vision_tpu_torch.core import render
    from mpi_vision_tpu_torch.core.sampling import Convention
    from mpi_vision_tpu_torch.kernels import _build, render_fused
    from mpi_vision_tpu_torch.serve import RenderService, make_http_server
  except ImportError as e:
    print(f"chip_smoke: the port is not importable here: {e}",
          file=sys.stderr)
    return 2
  t_start = time.perf_counter()
  dev = torch.device("cuda", 0)

  # -- 1. device ---------------------------------------------------------
  card = card_line()
  log(f"card: {card}")
  log(f"torch {torch.__version__} cuda {torch.version.cuda} "
      f"device {torch.cuda.get_device_name(0)} "
      f"count {torch.cuda.device_count()}")
  check(not torch.backends.cuda.matmul.allow_tf32,
        "TF32 matmul is on; the port's f32 contract assumes it off")

  # -- 2. build ----------------------------------------------------------
  t0 = time.perf_counter()
  built = _build.build(_build.sources())
  log(f"build: {json.dumps({k: round(v, 2) for k, v in built.items()})} "
      f"in {time.perf_counter() - t0:.2f}s")
  for name, text in _build.build_logs.items():
    for line in text.splitlines():
      if "registers" in line or "spill" in line:
        log(f"ptxas[{name}]: {line.strip()}")

  # Phase 9's and phase 12's scenes are host numpy; make them while the
  # card works.
  scene_pool = concurrent.futures.ThreadPoolExecutor(1)
  tiled_future = scene_pool.submit(tiled_scene)
  drill_future = scene_pool.submit(drill_scene)

  # -- 3. kernel vs plain version ----------------------------------------
  gen = torch.Generator(device=dev).manual_seed(0)
  planes = torch.rand((PLANES, HEIGHT, WIDTH, 4), generator=gen, device=dev)

  def homs_for(poses: np.ndarray) -> torch.Tensor:
    return homs_at(torch, dev, poses, PLANES, HEIGHT, WIDTH)

  classes = pose_classes()
  errs, singles, separable = {}, [], {}
  launches0 = render_fused.render_mpi_fused.launches
  for name, pose in classes.items():
    homs = homs_for(pose[None])
    separable[name] = render_fused.is_separable(homs)
    got = render_fused.render_mpi_fused(planes, homs)
    want = render_fused.plain_render(planes, homs)
    torch.cuda.synchronize()
    check(got.shape == (1, HEIGHT, WIDTH, 3), f"{name}: shape {got.shape}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite pixels")
    errs[name] = float((got - want).abs().max())
    lit = float((got.abs().sum(-1) > 0).float().mean())
    log(f"kernel vs plain [{name}]: max_abs_err {errs[name]:.3e} "
        f"lit {lit:.3f} separable {separable[name]}")
    check(errs[name] <= TOL, f"{name}: kernel disagrees with its plain "
          f"version by {errs[name]} > {TOL}")
    singles.append(got)
    del want
  check(render_fused.render_mpi_fused.launches > launches0,
        "launch counter did not move")
  # The TPU kernels split these between a separable tier and general ones;
  # the one CUDA kernel must have been held to both kinds.
  check(any(separable.values()) and not all(separable.values()),
        f"pose classes do not cover both homography kinds: {separable}")
  batch = render_fused.render_mpi_fused(
      planes, homs_for(np.stack(list(classes.values()))))
  check(torch.equal(batch, torch.cat(singles)),
        "a batch of views differs from the same views rendered alone")
  log("kernel batch of 5 == 5 single renders, bit for bit")
  del batch, singles
  # More views than one block's chunk: V = 9 and 16 take several chunks.
  for views in (9, 16):
    homs_v = homs_for(np.stack([pan_pose(2.0 * i - 8.0, 0.01 * i)
                                for i in range(views)]))
    batch = render_fused.render_mpi_fused(planes, homs_v)
    chunks = render_fused.launch_shape(views, PLANES, HEIGHT, WIDTH,
                                       True)["grid"][2]
    for i in range(views):
      check(torch.equal(batch[i], render_fused.render_mpi_fused(
          planes, homs_v[i:i + 1].contiguous())[0]),
            f"view {i} of a {views}-view batch differs from its single render")
    log(f"kernel batch of {views} ({chunks} view chunks) == {views} single "
        f"renders, bit for bit")
    del batch
  # One scene per view: the view-stride path, at a small size.
  sp, sh, sw = 8, 256, 384
  scenes = torch.rand((2, sp, sh, sw, 4), generator=gen, device=dev)
  shoms = homs_at(torch, dev, np.stack([classes["pan_1deg"],
                                        classes["pan_10deg"]]), sp, sh, sw)
  err_stride = float((render_fused.render_mpi_fused(scenes, shoms)
                      - render_fused.plain_render(scenes, shoms)).abs().max())
  log(f"kernel vs plain [one scene per view]: max_abs_err {err_stride:.3e}")
  check(err_stride <= TOL, f"view-stride path disagrees: {err_stride}")
  max_err = max(list(errs.values()) + [err_stride])

  # -- 4. serve: the main path -------------------------------------------
  svc = RenderService(device="cuda", convention=Convention.EXACT,
                      max_batch=8, max_wait_ms=20.0, max_inflight=4,
                      cache_bytes=4 << 30)
  httpd = None
  try:
    t0 = time.perf_counter()
    svc.add_synthetic_scenes(2, height=HEIGHT, width=WIDTH, planes=PLANES)
    svc.warmup()
    log(f"serve: 2 scenes {HEIGHT}x{WIDTH}x{PLANES} made, baked and "
        f"warmed in {time.perf_counter() - t0:.2f}s; resident "
        f"{svc.cache.stats()['bytes'] / 1e9:.2f} GB")
    httpd = make_http_server(svc, port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def post(scene_id, pose):
      body = json.dumps({"scene_id": scene_id,
                         "pose": pose.tolist()}).encode()
      req = urllib.request.Request(
          f"http://127.0.0.1:{port}/render", data=body,
          headers={"Content-Type": "application/json",
                   "Accept": "application/octet-stream"})
      with urllib.request.urlopen(req, timeout=120) as resp:
        check(resp.status == 200, f"/render answered {resp.status}")
        shape = tuple(int(x) for x in resp.headers["X-Image-Shape"].split(","))
        return np.frombuffer(resp.read(), "<f4").reshape(shape)

    conc = [("scene_000", pan_pose(2.0 * i, 0.01 * i, -0.01 * i))
            for i in range(8)]
    seq = [("scene_001", pan_pose(-3.0 * i, -0.02 * i)) for i in range(3)]
    frames: list = [None] * len(conc)
    errors: list = []

    def fire(i):
      try:
        frames[i] = post(*conc[i])
      except Exception as e:  # noqa: BLE001 - re-raised on the main thread
        errors.append(e)

    render_fused.render_mpi_fused.launches = 0
    render_fused.plain_render.calls = 0
    t0 = time.perf_counter()
    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(conc))]
    for t in threads:
      t.start()
    for t in threads:
      t.join(300)
    http_burst_s = time.perf_counter() - t0
    check(not errors, f"concurrent /render failed: {errors[:1]}")
    check(all(f is not None for f in frames), "a concurrent /render hung")
    frames += [post(*req) for req in seq]
    # Three bursts: the first also pays first-use pinned host buffers for
    # concurrent flights, the second is the steady state, the third runs
    # under the profiler to split the card's busy time.
    burst = [pan_pose(0.5 * i, 0.002 * i) for i in range(32)]

    def run_burst():
      futs = [svc.render_async("scene_000", p) for p in burst]
      for f in futs:
        f.result(300)

    service_rps = []
    for _ in range(2):
      t0 = time.perf_counter()
      run_burst()
      service_rps.append(len(burst) / (time.perf_counter() - t0))
    activity = device_activity(torch, run_burst)
    log(f"serve: profiled burst {json.dumps(activity)}")
    launches = render_fused.render_mpi_fused.launches
    plain_calls = render_fused.plain_render.calls
    log(f"serve: main path launched the kernel {launches} times, the plain "
        f"version {plain_calls} times; 8 concurrent HTTP renders in "
        f"{http_burst_s:.3f}s; renders/s in-process: first burst "
        f"{service_rps[0]:.2f}, second {service_rps[1]:.2f}")
    check(launches > 0, "the served path never launched the kernel")
    check(plain_calls == 0, "the plain version ran on the served path")
    burst_stats = svc.stats()

    # The engine alone (host clock, ends in its event sync): pose upload,
    # homography math, kernel, readback into pinned memory.
    scene0 = svc.cache.get("scene_000")
    engine_ms = {}
    for v in (1, 8):
      poses_v = np.stack(burst[:v])
      svc.engine.render_batch(scene0, poses_v)
      runs = []
      for _ in range(5):
        t0 = time.perf_counter()
        svc.engine.render_batch(scene0, poses_v)
        runs.append((time.perf_counter() - t0) * 1e3)
      engine_ms[f"v{v}"] = statistics.median(runs)
    log(f"serve: engine render_batch ms {engine_ms}; service latency_ms "
        f"{burst_stats['latency_ms']}; device phase seconds "
        f"{burst_stats['device_phase_seconds']}")

    stats = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/stats", timeout=60).read())
    health = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/healthz", timeout=60).read())
    hist = {int(b): n for b, n in stats["batch_size_hist"].items()}
    log(f"serve: batch sizes {hist}; engine {stats['engine']}; "
        f"health {health['status']}")
    check(any(b >= 2 for b in hist), "no request batch of 2 or more")
    check(stats["engine"]["platform"] == "cuda", "engine is not on CUDA")
    check(health["status"] == "ok", f"health {health}")

    # Every frame against a direct single-view render of its pose.
    for (sid, pose), frame in zip(conc + seq, frames):
      check(frame.shape == (HEIGHT, WIDTH, 3), f"frame shape {frame.shape}")
      check(bool(np.isfinite(frame).all()), "non-finite served pixels")
      scene = svc.cache.get(sid)
      direct = render.render_views(
          scene.rgba_layers, torch.from_numpy(pose[None]).to(dev),
          scene.depths, scene.intrinsics, convention=Convention.EXACT,
          method="fused_pallas")[0].cpu().numpy()
      check(np.array_equal(frame, direct),
            f"served frame of {sid} differs from a direct render")
    scene = svc.cache.get(conc[5][0])
    homs = render_fused.pixel_homographies(
        torch.from_numpy(conc[5][1][None]).to(dev), scene.depths,
        scene.intrinsics[None], HEIGHT, WIDTH,
        Convention.EXACT).transpose(0, 1).contiguous()
    served_err = float(np.abs(
        frames[5] - render_fused.plain_render(scene.planes, homs)[0]
        .cpu().numpy()).max())
    log(f"serve: {len(frames)} frames bit-identical to direct renders; "
        f"served vs plain max_abs_err {served_err:.3e}")
    check(served_err <= TOL, f"served frame vs plain version {served_err}")
  finally:
    if httpd is not None:
      httpd.shutdown()
      httpd.server_close()
    svc.close()

  # -- 5. times ------------------------------------------------------------
  poses8 = np.stack([pan_pose(1.0 * i, 0.01 * i, -0.01 * i)
                     for i in range(8)])
  homs1, homs8 = homs_for(poses8[:1]), homs_for(poses8)
  ms1 = cuda_ms(torch, lambda: render_fused.render_mpi_fused(planes, homs1),
                20, warm=3)
  ms8 = cuda_ms(torch, lambda: render_fused.render_mpi_fused(planes, homs8),
                20, warm=3)
  homs_pan10 = homs_for(pan_pose(10.0)[None])
  ms1_pan10 = cuda_ms(torch, lambda: render_fused.render_mpi_fused(
      planes, homs_pan10), 20, warm=3)
  plain1 = cuda_ms(torch, lambda: render_fused.plain_render(planes, homs1),
                   3, warm=1)
  plain8 = cuda_ms(torch, lambda: render_fused.plain_render(planes, homs8),
                   3, warm=1)
  frames8 = render_fused.render_mpi_fused(planes, homs8)
  host8 = torch.empty(frames8.shape, dtype=torch.float32, pin_memory=True)
  d2h8 = cuda_ms(torch, lambda: host8.copy_(frames8, non_blocking=True), 10)
  # What the scheduler does with a finished 8-view flight on the host:
  # one copy per frame out of the batch's pinned buffer.
  host_frames = host8.numpy()
  frame_copies8 = host_ms(
      lambda: [host_frames[i].copy() for i in range(8)], 5)
  del frames8, host8, host_frames
  b1, by1 = bound(1)
  b8, by8 = bound(8)
  times = {
      "card": card,
      "shape": [HEIGHT, WIDTH, PLANES],
      "kernel_ms": {"v1": ms1, "v1_pan10": ms1_pan10, "v8": ms8,
                    "v8_per_view": ms8 / 8},
      "plain_ms": {"v1": plain1, "v8": plain8},
      "bound_ms": {"v1": b1, "v1_by": by1, "v8": b8, "v8_by": by8},
      "bound_ms_per_view_scene_reread": PLANES * HEIGHT * WIDTH * 16
                                        / PEAK_BYTES_S * 1e3,
      "library_ms": None,
      "library_note": "no single PyTorch call computes warp + bilinear "
                      "sample + over-composite",
      "service_renders_per_s": {"first_burst": service_rps[0],
                                "second_burst": service_rps[1]},
      "engine_render_batch_ms": engine_ms,
      "readback_ms_v8": d2h8,
      "host_frame_copies_ms_v8": frame_copies8,
      "served_burst_device": activity,
      "service_latency_ms": burst_stats["latency_ms"],
      "service_device_phase_s": burst_stats["device_phase_seconds"],
      "http_8_concurrent_s": http_burst_s,
      "seconds_total": time.perf_counter() - t_start,
  }
  log(json.dumps({"times": times}))

  # -- 6. backward kernels vs plain versions -------------------------------
  bwd_errs = phase6_backward(torch, dev, planes, classes)

  # -- 7. train: the slice's main path --------------------------------------
  with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
    run = phase7_train(torch, dev, workdir)
    bwd_times = backward_times(torch, dev, planes)
    step_times = train_times(torch, run)
  train_launches = run["launches"]
  log(json.dumps({"times_train": {
      "card": card,
      "conv_tf32": torch.backends.cudnn.allow_tf32,
      "backward_1080p_x32": bwd_times,
      "train_step_224px_x10": step_times,
      "train_cli_s": run["train_s"],
      "seconds_total": time.perf_counter() - t_start,
  }}))

  # -- 8. the compose kernel vs its plain version ---------------------------
  del planes
  torch.cuda.empty_cache()
  comp = phase8_compose(torch, dev)

  # -- 9. tiled serving: the slice's main path -------------------------------
  tiled = phase9_tiled(torch, dev, tiled_future.result())
  log(json.dumps({"times_tiled": {
      "card": card, "compose_1080p_x32": comp, "tiled_serving": tiled,
      "seconds_total": time.perf_counter() - t_start}}))

  # -- 10. crash-safe training: the slice's main path ------------------------
  # -- 11. train -> serve -> viewer over phase 10's store: the slice's path --
  with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as workdir:
    resil = phase10_resilience(torch, dev, workdir)
    log(json.dumps({"times_resilience": {
        "card": card, **resil,
        "seconds_total": time.perf_counter() - t_start}}))
    t0 = time.perf_counter()
    bridge = phase11_bridge(torch, dev, workdir)
  log(json.dumps({"times_bridge": {
      "card": card, **bridge, "phase_s": time.perf_counter() - t0,
      "seconds_total": time.perf_counter() - t_start}}))

  # -- 12. serving under faults and overload: the slice's main path ---------
  with tempfile.TemporaryDirectory(prefix="chip_smoke_degraded_") as workdir:
    degraded = phase12_degraded(torch, dev, drill_future.result(),
                                tiled_future.result(), workdir)
  log(json.dumps({"times_degraded": {
      "card": card, **degraded,
      "seconds_total": time.perf_counter() - t_start}}))

  # -- 13. the helper surface, config 5 and the flight recorder -------------
  with tempfile.TemporaryDirectory(prefix="chip_smoke_flight_") as workdir:
    flight = phase13_flight(torch, dev, drill_future.result(), workdir,
                            step_times["step_ms"])
  scene_pool.shutdown()
  log(json.dumps({"times_flight": {
      "card": card, **flight,
      "seconds_total": time.perf_counter() - t_start}}))

  # -- result lines --------------------------------------------------------
  v1, v1p, v8 = (bwd_times[k] for k in ("v1", "v1_pan10", "v8"))
  resumed = resil["launches"]["resumed"]
  rows = [{"name": "render_fused", "launches": launches,
           "train_launches": train_launches["render_mpi_fused"],
           "resumed_train_launches": resumed["render_mpi_fused"],
           "max_abs_err": max_err, "views": 8, "ms": ms8,
           "plain_ms": plain8, "bound_ms": b8, "bound_by": by8,
           "library_ms": None, "v1_ms": ms1, "v1_pan10_ms": ms1_pan10}]
  for name, key in (("rewarp_composite_vjp", "a"), ("adjoint_warp", "b")):
    rows.append({"name": name, "launches": train_launches[name],
                 "resumed_train_launches": resumed[name],
                 "max_abs_err": bwd_errs[name], "views": 1,
                 "ms": v1[f"{key}_ms"], "plain_ms": v1[f"plain_{key}_ms"],
                 "bound_ms": v1[f"bound_{key}_ms"],
                 "bound_by": v1[f"bound_{key}_by"],
                 "library_ms": v1["library_ms"] if key == "b" else None,
                 "v1_pan10_ms": v1p[f"{key}_ms"], "v8_ms": v8[f"{key}_ms"],
                 "library_v1_pan10_ms":
                     v1p["library_ms"] if key == "b" else None,
                 "library_v8_ms": v8["library_ms"] if key == "b" else None})
  a_row = rows[1]
  a_row["path"] = v1["path_a"]
  for label in ("a_p10_v1", "a_p10_v8", "a_480_p33_v1"):
    a_row[f"{label[2:]}_ms"] = bwd_times[label]["a_ms"]
    a_row[f"{label[2:]}_bound_ms"] = bwd_times[label]["bound_a_ms"]
    a_row[f"{label[2:]}_path"] = bwd_times[label]["path_a"]
  c8 = comp["f32_v8"]
  rows.append({"name": "over_composite", "launches": tiled["launches"],
               "max_abs_err": comp["max_abs_err"],
               "bf16_max_ulps": comp["bf16_max_ulps"], "views": 8,
               "ms": c8["ms"], "plain_ms": c8["plain_ms"],
               "bound_ms": c8["bound_ms"], "bound_by": c8["bound_by"],
               "library_ms": None})
  counters = {"render_fused": "render_mpi_fused",
              "rewarp_composite_vjp": "rewarp_composite_vjp",
              "adjoint_warp": "adjoint_warp",
              "over_composite": "over_composite_pallas"}
  for row in rows:
    row["phase11_launches"] = {
        window: counts[counters[row["name"]]]
        for window, counts in bridge["launches"].items()}
    row["phase12_launches"] = {
        window: counts[counters[row["name"]]]
        for window, counts in degraded["launches"].items()}
    row["phase13_launches"] = {
        window: counts[counters[row["name"]]]
        for window, counts in flight["launches"].items()}
  # The compose kernel against its plain version at brownout's shapes
  # (thinned planes, 540-row targets).
  comp_row = next(row for row in rows if row["name"] == "over_composite")
  comp_row["phase12_max_abs_err"] = degraded["brownout"][
      "compose_max_abs_err"]
  print(json.dumps({"kernels": [
      {"name": row["name"], "route": "cuda", "source": SOURCES[row["name"]],
       "replaces": REPLACES[row["name"]][0],
       "also_replaces": REPLACES[row["name"]][1:], **row} for row in rows]}),
      flush=True)
  print(card_line(), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
