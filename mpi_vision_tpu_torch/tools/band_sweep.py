"""Sweep the serving engine's row-band count on a card.

For each frame size, flight size V and band count B, renders flights of a
32-plane scene through ``RenderEngine`` with its band plan replaced by B
bands (``serve.engine.split_rows``), and reports, from the flight's own
CUDA events (medians over the flights):

  * ``span_ms``: the flight's card time alone, from the pose upload to the
    last band copy's end, one flight at a time (what a host-paced flight
    costs the card);
  * ``compute_ms``, ``readback_ms``, ``hidden_ms``: the engine's phase split;
  * ``submit_ms``: host milliseconds in ``submit``;
  * ``piped_ms``: wall milliseconds a flight with four flights in the air
    (the card's throughput when the host keeps up).

Prints a table, and with ``--out`` writes every row there as a JSON line.
Needs a card::

  python3 -m mpi_vision_tpu_torch.tools.band_sweep [--flights 20] \
      [--out sweep.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from mpi_vision_tpu_torch.core import camera
from mpi_vision_tpu_torch.serve import engine as engine_mod
from mpi_vision_tpu_torch.serve.cache import BakedScene

PLANES = 32
SIZES = ((1080, 1920), (540, 960))
VIEWS = (1, 4, 8)
BANDS = (1, 2, 4, 8)


def scene_on(dev, height: int, width: int) -> BakedScene:
  gen = torch.Generator(device=dev).manual_seed(0)
  planes = torch.rand((PLANES, height, width, 4), generator=gen, device=dev)
  depths = camera.inv_depths(1.0, 100.0, PLANES).to(dev)
  fx = 0.5 * width
  k = camera.intrinsics_matrix(fx, fx, width / 2.0, height / 2.0).to(dev)
  return BakedScene("sweep", planes, depths, k, planes.numel() * 4)


def poses(views: int) -> np.ndarray:
  out = np.tile(np.eye(4, dtype=np.float32), (views, 1, 1))
  yaw = np.linspace(-0.1, 0.1, views)
  out[:, 0, 0] = out[:, 2, 2] = np.cos(yaw)
  out[:, 0, 2] = np.sin(yaw)
  out[:, 2, 0] = -np.sin(yaw)
  out[:, 0, 3] = 0.03
  return out


def flights(eng, scene, p, n: int) -> dict:
  """n flights one at a time, then n with four in the air."""
  rows = {k: [] for k in ("span_ms", "compute_ms", "readback_ms",
                          "hidden_ms", "submit_ms")}
  for _ in range(n):
    t0 = time.perf_counter()
    h = eng.submit(scene, p)
    rows["submit_ms"].append(1e3 * (time.perf_counter() - t0))
    eng.wait(h)
    t = h.timings
    rows["span_ms"].append(h.marks[0].elapsed_time(h.marks[3]))
    rows["compute_ms"].append(1e3 * t["compute_s"])
    rows["readback_ms"].append(1e3 * t["readback_s"])
    rows["hidden_ms"].append(1e3 * t["readback_hidden_s"])
  out = {k: statistics.median(v) for k, v in rows.items()}
  window = []
  t0 = time.perf_counter()
  for _ in range(n):
    if len(window) == 4:
      eng.wait(window.pop(0))
    window.append(eng.submit(scene, p))
  for h in window:
    eng.wait(h)
  out["piped_ms"] = 1e3 * (time.perf_counter() - t0) / n
  return out


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--flights", type=int, default=20)
  ap.add_argument("--out", help="JSON lines of every row")
  args = ap.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit("band_sweep: needs an NVIDIA card")
  dev = torch.device("cuda", 0)
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True).stdout.strip()
  print(f"card: {card}")
  plan = engine_mod.row_bands
  with open(args.out or os.devnull, "w") as log:
    print("  H    W  V  B  span   compute readback hidden submit piped (ms)")
    for height, width in SIZES:
      scene = scene_on(dev, height, width)
      eng = engine_mod.RenderEngine(device=dev, use_mesh=False)
      for views in VIEWS:
        p = poses(views)
        for bands in BANDS:
          engine_mod.row_bands = (
              lambda h, w, m, n=bands: engine_mod.split_rows(h, n))
          try:
            flights(eng, scene, p, 3)  # warm: kernel build, pinned pool
            row = flights(eng, scene, p, args.flights)
          finally:
            engine_mod.row_bands = plan
          row.update(card=card, height=height, width=width, views=views,
                     bands=bands, planned=len(plan(height, width,
                                                   eng.method)))
          log.write(json.dumps(row) + "\n")
          print(f"{height:4d} {width:4d} {views:2d} {bands:2d} "
                f"{row['span_ms']:6.3f} {row['compute_ms']:6.3f} "
                f"{row['readback_ms']:6.3f} {row['hidden_ms']:6.3f} "
                f"{row['submit_ms']:6.3f} {row['piped_ms']:6.3f}")
      del scene, eng
      torch.cuda.empty_cache()
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
