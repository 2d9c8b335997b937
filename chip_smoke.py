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
     of all five equals the single-view renders bit for bit; one scene
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
  5. times: kernel ms (CUDA events, median of 20) at V = 1 and V = 8, the
     plain version's ms, the bound, the 8-view frame readback into pinned
     memory (CUDA events), the scheduler's per-frame host copies of one
     8-view flight (host clock), renders/s through the service, and the
     engine's own batch time (host clock) beside the kernel's.
Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

HEIGHT, WIDTH, PLANES = 1080, 1920, 32
TOL = 1e-4
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
REPLACES = "mpi_vision_tpu/kernels/render_pallas.py:271"
ALSO_REPLACES = ["mpi_vision_tpu/kernels/render_pallas.py:426",
                 "mpi_vision_tpu/kernels/render_pallas.py:847"]


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


def bound(views: int) -> tuple[float, str]:
  """Least time (ms) for ``views`` renders of one resident scene: every
  input byte read once, every output byte written once, against the
  kernel's f32 operations at the f32 peak."""
  from mpi_vision_tpu_torch.kernels import render_fused

  nbytes = (PLANES * HEIGHT * WIDTH * 16 + views * PLANES * 9 * 4
            + views * HEIGHT * WIDTH * 3 * 4)
  ops = views * HEIGHT * WIDTH * PLANES * render_fused.FLOPS_PER_SAMPLE
  t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
  return (max(t_bytes, t_ops) * 1e3,
          "bytes" if t_bytes >= t_ops else "operations")


def device_activity(torch, fn) -> dict:
  """Run ``fn()`` under ``torch.profiler`` (CUDA activity only) and split
  the card's busy time: the union of every device interval, and the summed
  durations of the render kernel, device-to-host and host-to-device copies
  and everything else. ``busy_share`` is the union over the host-clock wall
  time of ``fn()``; None where the profiler saw no device activity."""
  from torch.profiler import ProfilerActivity, profile

  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  spans = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
  kinds = {"kernel_s": 0.0, "d2h_s": 0.0, "h2d_s": 0.0, "other_s": 0.0}
  for start, end, name in spans:
    kind = ("kernel_s" if "render_fused" in name
            else "d2h_s" if "DtoH" in name
            else "h2d_s" if "HtoD" in name else "other_s")
    kinds[kind] += (end - start) * 1e-6
  busy, cur_start, cur_end = 0.0, None, None
  for start, end, _ in sorted(spans):
    if cur_end is None or start > cur_end:
      if cur_end is not None:
        busy += cur_end - cur_start
      cur_start, cur_end = start, end
    else:
      cur_end = max(cur_end, end)
  if cur_end is not None:
    busy += cur_end - cur_start
  busy_s = busy * 1e-6
  return {"wall_s": wall, "events": len(spans),
          "busy_s": busy_s if spans else None,
          "busy_share": busy_s / wall if spans else None, **kinds}


def main() -> int:
  import torch

  if not torch.cuda.is_available():
    print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
    return 2
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  try:
    from mpi_vision_tpu_torch.core import render
    from mpi_vision_tpu_torch.core.camera import intrinsics_matrix, inv_depths
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

  # -- 3. kernel vs plain version ----------------------------------------
  gen = torch.Generator(device=dev).manual_seed(0)
  planes = torch.rand((PLANES, HEIGHT, WIDTH, 4), generator=gen, device=dev)
  depths = inv_depths(1.0, 100.0, PLANES, device=dev)
  k = intrinsics_matrix(0.5 * WIDTH, 0.5 * WIDTH, WIDTH / 2.0, HEIGHT / 2.0,
                        device=dev)

  def homs_for(poses: np.ndarray) -> torch.Tensor:
    pt = torch.from_numpy(np.ascontiguousarray(poses)).to(dev)
    h = render_fused.pixel_homographies(
        pt, depths, k.expand(len(poses), 3, 3), HEIGHT, WIDTH,
        Convention.EXACT)
    return h.transpose(0, 1).contiguous()               # [V, P, 3, 3]

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
  # One scene per view: the view-stride path, at a small size.
  sp, sh, sw = 8, 256, 384
  scenes = torch.rand((2, sp, sh, sw, 4), generator=gen, device=dev)
  sk = intrinsics_matrix(0.5 * sw, 0.5 * sw, sw / 2.0, sh / 2.0, device=dev)
  spose = torch.from_numpy(np.stack([classes["pan_1deg"],
                                     classes["pan_10deg"]])).to(dev)
  shoms = render_fused.pixel_homographies(
      spose, inv_depths(1.0, 100.0, sp, device=dev), sk.expand(2, 3, 3),
      sh, sw, Convention.EXACT).transpose(0, 1).contiguous()
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
      "kernel_ms": {"v1": ms1, "v8": ms8, "v8_per_view": ms8 / 8},
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

  # -- result lines --------------------------------------------------------
  print(json.dumps({"kernels": [{
      "name": "render_fused",
      "route": "cuda",
      "source": "mpi_vision_tpu_torch/kernels/csrc/render_fused.cu",
      "replaces": REPLACES,
      "also_replaces": ALSO_REPLACES,
      "launches": launches,
      "max_abs_err": max_err,
      "views": 8,
      "ms": ms8,
      "plain_ms": plain8,
      "bound_ms": b8,
      "bound_by": by8,
      "library_ms": None,
  }]}), flush=True)
  print(card_line(), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
