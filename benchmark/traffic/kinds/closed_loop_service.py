"""Traffic kind ``closed_loop_service``: in-process clients in a closed loop.

``clients`` threads each send one ``RenderService.render_async`` request,
wait for the whole frame, and send the next, on the traffic file's scenes
and on poses drawn from the seed. A warm-up of the same traffic runs
first and counts as set-up. Latency runs from the send to the frame in
the client's hands; the rate counts frames completed inside the window.
Where the window is traced, ``device_ms_per_render`` is the cards' busy
time (the union of their device intervals) over every frame it served.
"""

from __future__ import annotations

import itertools
import math
import threading
import time

from benchmark import common, inputs, serving


def closed_loop(svc, ids, poses, clients: int, seconds: float, keep,
                shape, timeout: float = 120.0) -> tuple:
  """Run ``clients`` closed-loop clients for ``seconds``; returns the start
  time, one ``(index, t_send, t_done, ok)`` a request, and the kept
  ``(scene index, pose, frame)`` of requests ``keep(index)`` selects."""
  counter, lock = itertools.count(), threading.Lock()
  records, kept = [], []
  go, box = threading.Event(), {}

  def client():
    go.wait()
    while True:
      with lock:
        i = next(counter)
      t_send = time.perf_counter()
      if t_send >= box["end"]:
        return
      scene, pose = i % len(ids), poses[i % len(poses)]
      try:
        img = svc.render_async(ids[scene], pose).result(timeout=timeout)
        ok = img.shape == shape
      except Exception as e:  # noqa: BLE001 - a failed request is counted
        common.log(f"request {i} failed: {e!r}")
        img, ok = None, False
      records.append((i, t_send, time.perf_counter(), ok))
      if ok and keep is not None and keep(i):
        kept.append((scene, pose, img))

  threads = [threading.Thread(target=client, daemon=True)
             for _ in range(clients)]
  for t in threads:
    t.start()
  t0 = time.perf_counter()
  box["end"] = t0 + seconds
  go.set()
  for t in threads:
    t.join(seconds + timeout + 60)
  return t0, records, kept


def run(ctx) -> dict:
  tr, cfg = ctx.traffic, ctx.config
  served = serving.prepare(ctx, tr["scenes"])
  svc = served.svc
  pose = tr["pose"]
  poses = inputs.poses(ctx.seed, tr["pose_count"], pose["yaw_deg"],
                       pose["trans"], pose["separable_share"])
  shape = (cfg["height"], cfg["width"], 3)
  with ctx.setup.part("warm_traffic"):
    closed_loop(svc, served.scene_ids, poses[::-1], tr["clients"],
                tr["warmup_s"], None, shape)
  setup_s = ctx.setup.close()
  svc.metrics.reset()
  svc.tracer.reset()
  with common.DeviceTrace(ctx.torch, ctx.devices, ctx.profiled) as dt, \
      common.HostWindow():
    t0, records, kept = closed_loop(
        svc, served.scene_ids, poses, tr["clients"], ctx.seconds,
        serving.sampled(ctx.seed, tr["check_every"]), shape)
  after = serving.counters(svc)
  peak = serving.memory_peak(ctx)
  data = serving.window_data(ctx, served, after, dt.summary(), dt.window_s)
  served.close(ctx.torch, ctx.devices)
  end = t0 + ctx.seconds
  done = [r for r in records if r[3]]
  latencies = [r[2] - r[1] for r in done]
  per_s = [0] * max(1, math.ceil(ctx.seconds))
  for r in done:
    if t0 <= r[2] <= end:
      per_s[min(int(r[2] - t0), len(per_s) - 1)] += 1
  common.log(f"frames completed a second of the window: {per_s}")
  checks = serving.check_frames(ctx, served.depths, served.k, kept)
  e2e = {"setup_s": setup_s,
         "renders_per_s": sum(r[2] <= end for r in done) / ctx.seconds,
         "latency_p95_ms": common.quantile_ms(latencies, 0.95)}
  trace = data["trace"]
  if trace and done and sum(trace["busy_s"]) > 0:
    # The traced window holds every request sent, from before the first
    # send to the last answer: the cards' busy time over all of them.
    e2e["device_ms_per_render"] = 1e3 * sum(trace["busy_s"]) / len(done)
  data["e2e"] = e2e
  return {
      "attempted": len(records), "failed": len(records) - len(done),
      "e2e": e2e, "checks": checks, "memory_peak_bytes": peak, "data": data}
