#!/usr/bin/env python3
"""Find the knee of an open-loop HTTP cell once, by a sweep on the card.

    python benchmark/sweep.py --workload mpi1080p32.http_paced_8scenes \\
        --seed <n> --rates 40,48,56 --seconds 10 --out chiprun_out/knee.jsonl

Each offered rate runs in a fresh process, as the cell's own runs do: the
cell's set-up (its scenes, the service behind the HTTP server), its
warm-up at that rate, then one window. The knee is the highest rate at
which at least 98% of the offered requests complete inside the window,
none fail, and the generator's lateness does not grow from the window's
first half to its second. One JSON line a rate.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def one_rate(args) -> dict:
  """Set the cell up and run one window at ``args.rate``."""
  sys.path.insert(0, str(ROOT))
  from benchmark import run

  for key, rel in run.CACHE_ENV.items():
    os.environ[key] = str(ROOT / rel)
  import torch

  from benchmark import common, inputs, serving
  from benchmark.traffic.kinds import open_loop_http as olh

  bench = run.load_benchmark()
  cell, config, traffic = run.resolve(bench, args.workload)
  ctx = run.Context(torch, [f"cuda:{i}" for i in range(cell["chips"])],
                    config, traffic, args.seed, args.seconds, False,
                    common.Setup())
  served = serving.prepare(ctx, traffic["scenes"])
  pose = traffic["pose"]
  poses = inputs.poses(args.seed, traffic["pose_count"], pose["yaw_deg"],
                       pose["trans"], pose["separable_share"])
  port = olh.serve_http(served)
  olh.window(ctx, served, port, poses, args.rate, traffic["warmup_s"],
             args.seed, tag="warmup")
  red = olh.reduce(olh.window(ctx, served, port, poses, args.rate,
                              args.seconds, args.seed))
  served.close(torch, ctx.devices)
  share = red["completed_in_window"] / red["offered"]
  first = red["lateness_p50_first_half_s"] or 0.0
  second = red["lateness_p50_second_half_s"] or 0.0
  return {"rate": args.rate, "seed": args.seed, "seconds": args.seconds,
          "offered": red["offered"], "completed": red["completed"],
          "completed_in_window_share": share, "failed": red["failed"],
          "lateness_p50_halves_s": [first, second],
          "lateness_max_s": red["lateness_max_s"],
          "latency_due_p50_ms": common.quantile_ms(red["latency_due_s"], 0.5),
          "latency_due_p95_ms": common.quantile_ms(red["latency_due_s"],
                                                   0.95),
          "mean_batch": red["mean_batch"],
          "sustained": (share >= 0.98 and red["failed"] == 0
                        and second <= max(2 * first, first + 0.005)),
          "card": torch.cuda.get_device_name(0)}


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, required=True)
  ap.add_argument("--rates", default="")
  ap.add_argument("--rate", type=float, default=None,
                  help="run one rate in this process and print its line")
  ap.add_argument("--seconds", type=float, default=10.0)
  ap.add_argument("--out", default=None)
  args = ap.parse_args()
  if args.rate is not None:
    print(json.dumps(one_rate(args)), flush=True)
    return 0
  Path(args.out).parent.mkdir(parents=True, exist_ok=True)
  with open(args.out, "a") as f:
    for i, rate in enumerate(args.rates.split(",")):
      proc = subprocess.run(
          [sys.executable, __file__, "--workload", args.workload, "--seed",
           str(args.seed + i), "--rate", rate, "--seconds",
           str(args.seconds)], cwd=ROOT, stdout=subprocess.PIPE, text=True,
          timeout=600)
      lines = proc.stdout.strip().splitlines()
      line = lines[-1] if proc.returncode == 0 and lines else json.dumps(
          {"rate": float(rate), "rc": proc.returncode})
      f.write(line + "\n")
      f.flush()
      print(line, file=sys.stderr, flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
