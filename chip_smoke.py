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
Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
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

  # Phase 9's scene is host numpy; make it while the card works.
  scene_pool = concurrent.futures.ThreadPoolExecutor(1)
  tiled_future = scene_pool.submit(tiled_scene)

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
  scene_pool.shutdown()
  log(json.dumps({"times_tiled": {
      "card": card, "compose_1080p_x32": comp, "tiled_serving": tiled,
      "seconds_total": time.perf_counter() - t_start}}))

  # -- 10. crash-safe training: the slice's main path ------------------------
  with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as workdir:
    resil = phase10_resilience(torch, dev, workdir)
  log(json.dumps({"times_resilience": {
      "card": card, **resil,
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
