"""Traffic kind ``open_loop_http``: independent viewers over HTTP.

The service runs behind the port's ``make_http_server``; a load generator
in a child process (``traffic/loadgen.py``) sends ``POST /render`` with
``Accept: application/octet-stream`` (the raw f32 frame) on a fixed
schedule: ``rate_per_s`` Poisson arrivals over the traffic file's scenes
with Zipf(``zipf_s``) popularity. Every seed gets the same multiset of
gaps (the exponential distribution's quantiles) and of scene counts, in
an order the seed shuffles, so seeds differ in order and poses, not in
load. Latency runs from each request's due time, so a stall also charges
the requests queued behind it. A warm-up of the same traffic runs first
and counts as set-up.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from benchmark import common, inputs, serving

ROOT = Path(__file__).resolve().parents[3]


def schedule(seed: int, rate: float, seconds: float, n_scenes: int,
             zipf_s: float, poses: np.ndarray, tag: str) -> list:
  """``[(due_s, scene index, pose)]`` of one window."""
  n = max(int(round(rate * seconds)), 1)
  rng = np.random.default_rng(inputs.sub_seed(seed, tag))
  gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
  rng.shuffle(gaps)
  due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) * seconds / gaps.sum()
  share = 1.0 / np.arange(1, n_scenes + 1) ** zipf_s
  share = share / share.sum() * n
  counts = np.floor(share).astype(int)
  for i in np.argsort(-(share - counts))[:n - counts.sum()]:
    counts[i] += 1
  scenes = np.repeat(np.arange(n_scenes), counts)
  rng.shuffle(scenes)
  picks = rng.permutation(n) % len(poses)
  return [(float(due[i]), int(scenes[i]), poses[picks[i]]) for i in range(n)]


class LoadGen:
  """One window of the child load generator: started and handed its
  schedule at construction, released by ``go``."""

  def __init__(self, port: int, plan: list, keep, ids, workers: int,
               timeout_s: float = 120.0):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    self.proc = subprocess.Popen(
        [sys.executable, "-m", "benchmark.traffic.loadgen"], cwd=ROOT,
        env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    self.keep = [i for i in range(len(plan)) if keep is not None and keep(i)]
    spec = {"port": port, "timeout_s": timeout_s, "keep": self.keep,
            "workers": workers,
            "requests": [[due, ids[s], pose.tolist()]
                         for due, s, pose in plan]}
    self.proc.stdin.write(json.dumps(spec).encode() + b"\n")
    self.proc.stdin.flush()
    if self.proc.stdout.readline().strip() != b"ready":
      self.close()
      raise RuntimeError("load generator did not start")

  def go(self) -> list:
    """Start the schedule; returns the records once every request ended."""
    self.proc.stdin.write(b"go\n")
    self.proc.stdin.flush()
    line = self.proc.stdout.readline()
    if not line:
      self.close()
      raise RuntimeError("load generator died during the window")
    return json.loads(line)

  def frames(self) -> dict:
    out = {}
    while True:
      head = self.proc.stdout.readline().split()
      if not head or head[0] == b"end":
        break
      out[int(head[1])] = self.proc.stdout.read(int(head[2]))
    self.close()
    return out

  def close(self) -> None:
    self.proc.stdin.close()
    try:
      self.proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
      self.proc.kill()
      self.proc.wait()
    self.proc.stdout.close()


def serve_http(served: serving.Served) -> int:
  """Put the service behind ``make_http_server`` on an ephemeral port."""
  from mpi_vision_tpu_torch.serve.server import make_http_server

  server = make_http_server(served.svc, "127.0.0.1", 0)
  thread = threading.Thread(target=server.serve_forever, daemon=True)
  thread.start()
  served.server, served.server_thread = server, thread
  return server.server_address[1]


def window(ctx, served, port, poses, rate: float, seconds: float, seed: int,
           keep=None, tag: str = "window", trace: bool = False) -> dict:
  """One open-loop window at ``rate``; the service's counters are reset
  first. Returns the records, the counters and the trace."""
  tr = ctx.traffic
  plan = schedule(seed, rate, seconds, tr["scenes"], tr["zipf_s"], poses,
                  tag)
  gen = LoadGen(port, plan, keep, served.scene_ids, tr["workers"])
  svc = served.svc
  svc.metrics.reset()
  svc.tracer.reset()
  with common.DeviceTrace(ctx.torch, ctx.devices, trace) as dt:
    records = gen.go()
  after = serving.counters(svc)
  frames = gen.frames()
  return {"plan": plan, "records": records, "frames": frames,
          "after": after, "trace": dt.summary(),
          "window_s": dt.window_s, "seconds": seconds}


def reduce(w: dict) -> dict:
  """Rate, latency from due time, lateness and failures of a window."""
  recs, plan, seconds = w["records"], w["plan"], w["seconds"]
  ok = [(p[0], r) for p, r in zip(plan, recs) if r and r[2] == 200]
  late = [r[0] - p[0] for p, r in zip(plan, recs) if r]
  half = len(late) // 2
  return {
      "offered": len(plan), "completed": len(ok),
      "completed_in_window": sum(r[1] <= seconds for _, r in ok),
      "failed": len(plan) - len(ok),
      "latency_due_s": [r[1] - due for due, r in ok],
      "latency_send_s": [r[1] - r[0] for _, r in ok],
      "lateness_p50_first_half_s": common.quantile(late[:half], 0.5),
      "lateness_p50_second_half_s": common.quantile(late[half:], 0.5),
      "lateness_max_s": max(late, default=None),
      "mean_batch": (w["after"]["requests"] / w["after"]["batches"]
                     if w["after"]["batches"] else None)}


def run(ctx) -> dict:
  tr, cfg = ctx.traffic, ctx.config
  served = serving.prepare(ctx, tr["scenes"])
  pose = tr["pose"]
  poses = inputs.poses(ctx.seed, tr["pose_count"], pose["yaw_deg"],
                       pose["trans"], pose["separable_share"])
  port = serve_http(served)
  with ctx.setup.part("warm_traffic"):
    window(ctx, served, port, poses, tr["rate_per_s"], tr["warmup_s"],
           ctx.seed, tag="warmup")
  setup_s = ctx.setup.close()
  w = window(ctx, served, port, poses, tr["rate_per_s"], ctx.seconds,
             ctx.seed, keep=serving.sampled(ctx.seed, tr["check_every"]),
             trace=ctx.profiled)
  peak = serving.memory_peak(ctx)
  data = serving.window_data(ctx, served, w["after"], w["trace"],
                             w["window_s"])
  served.close(ctx.torch, ctx.devices)
  red = reduce(w)
  data["client"] = red
  shape = (cfg["height"], cfg["width"], 3)
  samples = [(w["plan"][i][1], w["plan"][i][2],
              np.frombuffer(body, "<f4").reshape(shape)
              if len(body) == 4 * np.prod(shape) else np.zeros(0))
             for i, body in sorted(w["frames"].items())]
  checks = serving.check_frames(ctx, served.depths, served.k, samples)
  common.log(f"open loop: offered {red['offered']}, completed "
             f"{red['completed']}, lateness p50 "
             f"{red['lateness_p50_first_half_s']} -> "
             f"{red['lateness_p50_second_half_s']} s, max "
             f"{red['lateness_max_s']} s, mean batch {red['mean_batch']}")
  return {
      "attempted": red["offered"], "failed": red["failed"],
      "e2e": {"setup_s": setup_s,
              "renders_per_s": red["completed_in_window"] / ctx.seconds,
              "latency_p95_ms": common.quantile_ms(red["latency_due_s"],
                                                   0.95)},
      "checks": checks, "memory_peak_bytes": peak, "data": data}
