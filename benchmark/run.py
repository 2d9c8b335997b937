#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card this process sees.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the port (``mpi_vision_tpu_torch``).
The cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<mix>.json``), whose ``kind`` names the generator module
(``traffic/kinds/<kind>.py``). With ``--trace 0`` the last line of standard
output is the result with the cell's end-to-end metrics; with ``--trace 1``
the window runs under the profiler (as it does with ``--trace 0`` where
an end-to-end metric comes from the device trace) and the line carries
the cell's per-layer metrics, each read by ``metrics/<name>.py``, and the
breakdown.
The checks that decide ``correct`` end standard error and the line.

Exits non-zero, printing no result, when PyTorch sees no card or fewer
cards than the cell asks for, when the port cannot be imported, or when
JAX, flax or the JAX package were loaded by the end of the run.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# Caches of anything that builds or compiles, at fixed paths in the
# checkout, so a cell's later runs in it find them.
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions",
             "TRITON_CACHE_DIR": ".bench_cache/triton",
             "CUDA_CACHE_PATH": ".bench_cache/cuda"}


@dataclasses.dataclass
class Context:
  """What a traffic kind is given for one run."""

  torch: object
  devices: list
  config: dict
  traffic: dict
  seed: int
  seconds: float
  trace: bool
  setup: object
  options: dict = dataclasses.field(default_factory=dict)
  # The cell has an end-to-end metric read from the device trace, so its
  # window runs under the profiler with --trace 0 too.
  e2e_trace: bool = False

  @property
  def profiled(self) -> bool:
    return self.trace or self.e2e_trace

  @property
  def on_cpu(self) -> bool:
    return self.torch.device(self.devices[0]).type == "cpu"

  def sync(self) -> None:
    from benchmark import common

    common.sync(self.torch, self.devices)

  @staticmethod
  def log(*parts) -> None:
    from benchmark import common

    common.log(*parts)


def load_benchmark(root: Path = ROOT) -> dict:
  with open(root / "BENCHMARK.json") as f:
    return json.load(f)


def resolve(bench: dict, workload: str, root: Path = ROOT) -> tuple:
  """The cell's entry, configuration and traffic mix, by name."""
  cells = {w["name"]: w for w in bench["workloads"]}
  if workload not in cells:
    raise SystemExit(f"unknown workload {workload!r}; one of {sorted(cells)}")
  cell = cells[workload]
  conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
  with open(root / conf["file"]) as f:
    config = json.load(f)
  with open(HERE / "traffic" / f"{cell['traffic']}.json") as f:
    traffic = json.load(f)
  return cell, config, traffic


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list[dict]:
  """The metrics the cell reports: end-to-end with ``--trace 0``,
  per-layer with ``--trace 1``."""
  name = cell["name"]
  e2e = [m for m in bench["end_to_end"]
         if name in m.get("workloads", [name])]
  if not trace:
    return e2e
  moved = {m["name"] for m in e2e}
  return [m for m in bench["per_layer"]
          if name in m.get("workloads", [name] if m["moves"] in moved
                           else [])]


def read_metric(name: str, data: dict):
  """``metrics/<name>.py``'s ``read(data)``: a number, or None where the
  run gave it nothing to read."""
  spec = importlib.util.spec_from_file_location(
      f"benchmark_metric_{name.replace('.', '_')}", HERE / "metrics" /
      f"{name}.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod.read(data)


def run_cell(ctx: Context, cell: dict, bench: dict) -> dict:
  """One run of the cell: the traffic kind's run, then the metrics."""
  kind = importlib.import_module(
      f"benchmark.traffic.kinds.{ctx.traffic['kind']}")
  out = kind.run(ctx)
  metrics = {}
  for m in cell_metrics(bench, cell, ctx.trace):
    value = (out["e2e"].get(m["name"]) if not ctx.trace
             else read_metric(m["name"], out["data"]))
    if value is not None:
      metrics[m["name"]] = {"value": value, "unit": m["unit"]}
  out["metrics"] = metrics
  out["correct"] = (all(c["ok"] for c in out["checks"])
                    and out["failed"] == 0)
  return out


def device_info(torch, devices, out: dict, trace: bool) -> dict:
  info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
          "count": len(devices), "memory_peak_bytes": out["memory_peak_bytes"]}
  summary = out["data"].get("trace")
  if trace and summary:
    info["busy_s"] = sum(summary["busy_s"]) / len(summary["busy_s"])
    info["window_s"] = summary["window_s"]
  return info


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, required=True)
  ap.add_argument("--seconds", type=float, required=True)
  ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)
  for key, rel in CACHE_ENV.items():
    os.environ[key] = str(ROOT / rel)
  sys.path.insert(0, str(ROOT))
  from benchmark import common

  setup = common.Setup()
  bench = load_benchmark()
  cell, config, traffic = resolve(bench, args.workload)
  with setup.part("import"):
    import torch

    import mpi_vision_tpu_torch  # noqa: F401 - fails where the port is absent
  if not torch.cuda.is_available():
    common.log("no CUDA device: PyTorch sees no card")
    return 2
  if torch.cuda.device_count() < cell["chips"]:
    common.log(f"{cell['name']} needs {cell['chips']} cards, PyTorch sees "
               f"{torch.cuda.device_count()}")
    return 2
  devices = [f"cuda:{i}" for i in range(cell["chips"])]
  ctx = Context(torch, devices, config, traffic, args.seed, args.seconds,
                bool(args.trace), setup,
                e2e_trace=any(m["source"] == "device_trace"
                              for m in cell_metrics(bench, cell, False)))
  out = run_cell(ctx, cell, bench)
  common.log("setup_s parts: " + json.dumps(
      {k: round(v, 3) for k, v in setup.parts.items()}))
  loaded = common.forbidden_modules()
  if loaded:
    common.log(f"refusing to report: the run loaded {loaded}")
    return 3
  line = result_line(out, device_info(torch, devices, out, ctx.trace),
                     ctx.trace)
  for c in out["checks"]:
    common.log(f"check {c['name']}: {c['value']} (limit {c['limit']}) "
               f"{'ok' if c['ok'] else 'FAILED'}")
  print(json.dumps(line), flush=True)
  return 0


def result_line(out: dict, device: dict, trace: bool) -> dict:
  """The last line: ``correct``, ``attempted``, ``failed``, ``metrics``,
  ``device``, the breakdown of a traced run, and the checks last."""
  line = {"correct": out["correct"], "attempted": out["attempted"],
          "failed": out["failed"], "metrics": out["metrics"],
          "device": device}
  summary = out["data"].get("trace")
  if trace and summary:
    line["breakdown"] = summary["breakdown"]
  line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                    for c in out["checks"]}
  return line


if __name__ == "__main__":
  sys.exit(main())
