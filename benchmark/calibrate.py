#!/usr/bin/env python3
"""Read a cell's check numbers on many seeds, for its program, its control
and planted faults, in one process on the card: the readings that the
check's limits are set from.

    python benchmark/calibrate.py --workload <cell> --seeds 12 \\
        --control-seeds 3 [--faults altered_answer,...] [--fault-seeds 3] \\
        --seconds 3 --out chiprun_out/calib_<cell>.jsonl

Each run is a whole run of the cell (set-up, a short window, the check)
with the limits lifted, so every reading is printed whatever it is. One
JSON line a run: seed, mode, the check readings, the end-to-end metrics
and the set-up split.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(count: int, base: int) -> list[int]:
  """Large seeds, past 32 signed bits, as the checks use."""
  return [base + 104729 * i for i in range(count)]


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seeds", type=int, default=12)
  ap.add_argument("--control-seeds", type=int, default=3)
  ap.add_argument("--faults", default="")
  ap.add_argument("--fault-seeds", type=int, default=3)
  ap.add_argument("--seconds", type=float, default=3.0)
  ap.add_argument("--check-every", type=int, default=None,
                  help="keep every n-th frame for the check (serving)")
  ap.add_argument("--out", required=True)
  args = ap.parse_args()
  sys.path.insert(0, str(ROOT))
  from benchmark import run

  for key, rel in run.CACHE_ENV.items():
    os.environ[key] = str(ROOT / rel)
  import torch

  from benchmark import common, faults

  bench = run.load_benchmark()
  cell, config, traffic = run.resolve(bench, args.workload)
  devices = [f"cuda:{i}" for i in range(cell["chips"])]
  lifted = {**traffic, "limits": {k: (v if k == "min_frames" else 1e30)
                                  for k, v in traffic["limits"].items()}}
  if args.check_every:
    lifted["check_every"] = args.check_every
  plan = [(s, "program") for s in seeds(args.seeds, 2**31 + 17)]
  plan += [(s, "control") for s in seeds(args.control_seeds, 2**31 + 5003)]
  for name in filter(None, args.faults.split(",")):
    plan += [(s, name) for s in seeds(args.fault_seeds, 2**31 + 90001)]
  Path(args.out).parent.mkdir(parents=True, exist_ok=True)
  with open(args.out, "a") as f:
    for seed, mode in plan:
      ctx = run.Context(torch, devices, config, lifted, seed, args.seconds,
                        False, common.Setup(),
                        {"control": True} if mode == "control" else {})
      fault = faults.FAULTS[mode]() if mode in faults.FAULTS else None
      try:
        if fault is not None:
          fault.__enter__()
        out = run.run_cell(ctx, cell, bench)
      finally:
        if fault is not None:
          fault.__exit__(None, None, None)
      line = {"workload": args.workload, "seed": seed, "mode": mode,
              "checks": {c["name"]: c["value"] for c in out["checks"]},
              "metrics": {k: v["value"] for k, v in out["metrics"].items()},
              "attempted": out["attempted"], "failed": out["failed"],
              "setup": ctx.setup.parts,
              "card": torch.cuda.get_device_name(0)}
      f.write(json.dumps(line) + "\n")
      f.flush()
      common.log(json.dumps(line))
  return 0


if __name__ == "__main__":
  sys.exit(main())
