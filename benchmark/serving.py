"""The serving cells' common parts: scenes made from the seed, the service
built as the ``serve`` CLI builds it, its counters, and the frame check.

The service is the port's ``RenderService``; the check holds frames that
the timed path served against ``reference/render.py``.
"""

from __future__ import annotations

import dataclasses
import gc

import numpy as np

from benchmark import inputs
from benchmark.reference import render as ref_render


def scene_id(index: int) -> str:
  return f"scene_{index:03d}"


@dataclasses.dataclass
class Served:
  """A prepared service and what it was given."""

  svc: object
  scene_ids: list
  depths: np.ndarray
  k: np.ndarray
  server: object = None
  server_thread: object = None

  def close(self, torch, devices) -> None:
    if self.server is not None:
      self.server.shutdown()
      self.server.server_close()
      self.server_thread.join(30)
    self.svc.close()
    self.svc = None
    gc.collect()
    for d in devices:
      if torch.device(d).type == "cuda":
        with torch.cuda.device(d):
          torch.cuda.empty_cache()


def build_kernels(ctx, names) -> None:
  """Build (first run in a checkout) or find the port's kernel libraries
  in its fixed build directory inside the checkout."""
  if ctx.on_cpu:
    return
  from mpi_vision_tpu_torch.kernels import _build

  with ctx.setup.part("kernel_build"):
    built = _build.build(names)
  if built:
    ctx.log(f"kernels built: {built}")


def prepare(ctx, n_scenes: int) -> Served:
  """Scenes on the card from the seed, registered with a service built as
  ``serve`` builds it (the config's batching knobs, EXACT convention), each
  baked by one request, and every batch bucket rendered once."""
  torch, cfg = ctx.torch, ctx.config
  h, w, p = cfg["height"], cfg["width"], cfg["planes"]
  build_kernels(ctx, ["render_fused"])
  from mpi_vision_tpu_torch.core.sampling import Convention
  from mpi_vision_tpu_torch.obs.trace import Tracer
  from mpi_vision_tpu_torch.serve.server import RenderService

  hosts = []
  for i in range(n_scenes):
    with ctx.setup.part("scene_make"):
      planes = inputs.scene(ctx.seed, i, h, w, p, cfg["content_scale_px"],
                            ctx.devices[0])
      if ctx.options.get("control"):
        planes = planes.to(torch.bfloat16).to(torch.float32)
      ctx.sync()
    with ctx.setup.part("scene_to_host"):
      hosts.append(inputs.scene_hwp4(planes))
    del planes
  scene_bytes = h * w * p * 16
  devices = ctx.devices
  with ctx.setup.part("service"):
    svc = RenderService(
        cache_bytes=int(n_scenes * scene_bytes * 1.25) + (64 << 20),
        max_batch=cfg["max_batch"], max_wait_ms=cfg["max_wait_ms"],
        max_inflight=cfg["max_inflight"],
        convention=Convention(cfg["convention"]), device=devices[0],
        devices=devices if len(devices) > 1 else None,
        use_mesh=cfg["sharded"],
        tracer=Tracer(ring=1 << 16) if ctx.trace else None)
  depths = inputs.inv_depths(cfg["depth_near"], cfg["depth_far"], p)
  k = inputs.intrinsics(h, w, cfg["focal_over_width"])
  ids = [scene_id(i) for i in range(n_scenes)]
  with ctx.setup.part("register"):
    for sid, host in zip(ids, hosts):
      svc.add_scene(sid, host, depths, k)
  del hosts
  eye = np.eye(4, dtype=np.float32)
  with ctx.setup.part("bake"):
    for sid in ids:
      svc.render(sid, eye, timeout=600)
  with ctx.setup.part("bucket_warmup"):
    svc.warmup(ids)
  return Served(svc, ids, depths, k)


def counters(svc) -> dict:
  """The program's own counters that the per-layer metrics read."""
  m = svc.metrics
  snap = m.snapshot()
  return {"requests": m.requests, "batches": m.batches,
          "batch_size_hist": {int(s): n for s, n in
                              snap["batch_size_hist"].items()},
          "phase_s": dict(m.phase_seconds),
          "latency_p50_s": (snap["latency_ms"]["p50"] / 1e3
                            if snap["latency_ms"] else None)}


def flights(svc, hist: dict) -> list[dict]:
  """Each batch size the window dispatched, as the launches it made: the
  engine pads a batch to its bucket and splits it over its shards."""
  eng = svc.engine
  shards = len(eng.devices) if eng.use_mesh else 1
  out = []
  for live, count in sorted(hist.items()):
    bucket = eng.batch_bucket(live)
    out.append({"live": live, "count": count, "bucket": bucket,
                "launches": shards, "views_per_launch": bucket // shards})
  return out


def window_data(ctx, served: Served, after: dict, trace_summary,
                window_s: float) -> dict:
  """What the per-layer metric readers read: the service's counters over
  the window (reset as it opened), the flights, spans and trace."""
  waits = [s["duration_ms"] / 1e3
           for rec in served.svc.tracer.snapshot(recent=1 << 16)["recent"]
           for s in rec["spans"] if s["name"] == "queue_wait"]
  return {"window_s": window_s, "chips": len(ctx.devices),
          "config": ctx.config, "service": after,
          "flights": flights(served.svc, after["batch_size_hist"]),
          "queue_wait_s": waits, "trace": trace_summary}


def memory_peak(ctx) -> int:
  torch = ctx.torch
  if ctx.on_cpu:
    return 0
  return max(torch.cuda.max_memory_allocated(d) for d in ctx.devices)


def check_frames(ctx, served_depths, served_k, samples: list) -> list:
  """Hold sampled served frames against the reference: ``samples`` are
  ``(scene index, pose, frame)``. Returns the check readings: frames
  compared, the worst frame's largest and mean absolute error."""
  torch, cfg = ctx.torch, ctx.config
  h, w, p = cfg["height"], cfg["width"], cfg["planes"]
  dev = ctx.devices[0]
  worst_max, worst_mean, checked, bad_shape = 0.0, 0.0, 0, 0
  for index in sorted({s[0] for s in samples}):
    planes = inputs.scene(ctx.seed, index, h, w, p, cfg["content_scale_px"],
                          dev).permute(0, 2, 3, 1)
    for _, pose, frame in (s for s in samples if s[0] == index):
      if frame.shape != (h, w, 3):
        bad_shape += 1
        continue
      ref = ref_render.render(planes, pose, served_depths, served_k,
                              cfg["convention"])
      err = (torch.from_numpy(np.array(frame)).to(dev, torch.float64)
             - ref).abs()
      worst_max = max(worst_max, float(err.max()))
      worst_mean = max(worst_mean, float(err.mean()))
      checked += 1
    del planes
  limits = ctx.traffic["limits"]
  return [
      {"name": "frames_checked", "value": checked,
       "limit": limits["min_frames"], "ok": checked >= limits["min_frames"]
       and bad_shape == 0},
      {"name": "frame_max_abs", "value": worst_max,
       "limit": limits["frame_max_abs"],
       "ok": worst_max <= limits["frame_max_abs"]},
      {"name": "frame_mean_abs", "value": worst_mean,
       "limit": limits["frame_mean_abs"],
       "ok": worst_mean <= limits["frame_mean_abs"]},
  ]


def sampled(seed: int, every: int):
  """Which request indices keep their frame for the check: every
  ``every``-th, from an offset drawn from the seed."""
  offset = np.random.default_rng(inputs.sub_seed(seed, "check")).integers(
      every)
  return lambda i: i % every == offset
