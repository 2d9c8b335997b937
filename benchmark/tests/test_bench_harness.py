"""The harness driven end to end on the CPU at small sizes: each cell's
run, with its look for a card skipped, comes out correct; its control
(the lower precision in the program's place) and each fault the cell can
have, planted under the timed path, come out not correct."""

import math

import pytest
import torch

from benchmark import common, faults, run

SMALL_SERVE = {"height": 24, "width": 40, "planes": 4, "content_scale_px": 4}
SMALL_TRAIN = {"img_size": 32, "num_planes": 4, "vgg_resize": 32,
               "content_scale_px": 4}
# Cells whose files stay in the benchmark for a later PR to declare
# (PERF.md, Open questions); the tests drive them as those cells.
UNDECLARED = {
    "mpi1080p32.http_paced_8scenes": ("mpi1080p32", "http_paced_8scenes"),
    "stereo_mag_224x10.train_b1": ("stereo_mag_224x10", "train_b1"),
    "mpi1080p32_dp4.burst_4cards": ("mpi1080p32_dp4", "burst_4cards"),
}


def small_cell(workload, seed=11, seconds=0.6, options=None,
               devices=("cpu",), **traffic):
  bench = run.load_benchmark()
  if workload in UNDECLARED:
    config, traffic_name = UNDECLARED[workload]
    bench = {**bench, "workloads": bench["workloads"] + [
        {"name": workload, "config": config, "traffic": traffic_name,
         "chips": 1, "why": "-"}], "configs": bench["configs"] + [
             {"name": config, "file": f"benchmark/configs/{config}.json"}]}
  cell, config, tr = run.resolve(bench, workload)
  if "img_size" in config:
    config = {**config, **SMALL_TRAIN}
    tr = {**tr, "pool": 4, "warmup_steps": 1}
  else:
    config = {**config, **SMALL_SERVE, "max_batch": min(config["max_batch"],
                                                       8)}
    tr = {**tr, "clients": 4, "warmup_s": 0.2, "check_every": 2,
          "limits": {**tr["limits"], "min_frames": 2}}
  tr.update(traffic)
  ctx = run.Context(torch, list(devices), config, tr, seed, seconds, False,
                    common.Setup(), dict(options or {}))
  return ctx, cell, bench


def run_small(workload, fault=None, **kw):
  ctx, cell, bench = small_cell(workload, **kw)
  if fault is None:
    return run.run_cell(ctx, cell, bench)
  with faults.FAULTS[fault]():
    return run.run_cell(ctx, cell, bench)


def test_burst_cell_is_correct_and_reports_its_metrics():
  out = run_small("mpi1080p32.burst_1scene")
  assert out["correct"], out["checks"]
  assert out["failed"] == 0 and out["attempted"] > 0
  # The CPU has no device trace: device_ms_per_render is not read.
  assert set(out["metrics"]) == {"setup_s"}
  assert all(m["value"] > 0 for m in out["metrics"].values())
  assert out["e2e"]["renders_per_s"] > 0 and out["e2e"]["latency_p95_ms"] > 0


@pytest.mark.parametrize("fault", [None, "altered_answer", "half_batch"])
def test_burst_control_and_faults_are_not_correct(fault):
  out = run_small("mpi1080p32.burst_1scene", fault=fault,
                  options={} if fault else {"control": True})
  assert not out["correct"], out["checks"]


class _BusyTrace(common.DeviceTrace):
  """The device trace as a card would give it: half a second busy."""

  def summary(self, top=10):
    return {"busy_s": [0.5], "window_s": self.window_s, "kernel_s": {},
            "kernel_n": {}, "breakdown": {"device_ops": [], "idle_gaps": []}}


def test_burst_device_ms_per_render_is_busy_time_over_every_frame(
    monkeypatch):
  monkeypatch.setattr(common, "DeviceTrace", _BusyTrace)
  ctx, cell, bench = small_cell("mpi1080p32.burst_1scene")
  ctx.e2e_trace = True
  out = run.run_cell(ctx, cell, bench)
  assert out["correct"], out["checks"]
  done = out["attempted"] - out["failed"]
  assert set(out["metrics"]) == {"setup_s", "device_ms_per_render"}
  assert math.isclose(out["metrics"]["device_ms_per_render"]["value"],
                      500.0 / done)


def test_burst_traced_run_reads_the_counters():
  ctx, cell, bench = small_cell("mpi1080p32.burst_1scene")
  ctx.trace = True
  out = run.run_cell(ctx, cell, bench)
  assert out["correct"], out["checks"]
  # The CPU has no device trace: only the program's counters read.
  assert set(out["metrics"]) == {"batch_size.burst", "readback_ms.burst",
                                 "mfu.serve", "renders_per_s.burst",
                                 "latency_p95_ms.burst"}
  assert out["metrics"]["batch_size.burst"]["value"] >= 1


@pytest.mark.parametrize("fault", [None, "exchange_left_out",
                                   "altered_answer"])
def test_sharded_burst_on_a_two_device_cpu_mesh(fault):
  out = run_small("mpi1080p32_dp4.burst_4cards", fault=fault,
                  devices=("cpu", "cpu:0"))
  assert out["correct"] == (fault is None), out["checks"]


@pytest.mark.parametrize("fault", [None, "altered_answer"])
def test_paced_http_cell(fault):
  out = run_small("mpi1080p32.http_paced_8scenes", fault=fault,
                  seconds=1.5, rate_per_s=12.0, scenes=2, warmup_s=0.5)
  assert out["correct"] == (fault is None), out["checks"]
  if fault is None:
    assert out["failed"] == 0 and out["attempted"] == 18
    assert out["e2e"]["latency_p95_ms"] > 0


def test_paced_http_control_is_not_correct():
  out = run_small("mpi1080p32.http_paced_8scenes", seconds=1.0,
                  rate_per_s=12.0, scenes=2, warmup_s=0.3,
                  options={"control": True})
  assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [None, "state_unchanged",
                                   "altered_answer"])
def test_train_cell(fault):
  out = run_small("stereo_mag_224x10.train_b1", fault=fault, seconds=0.5)
  assert out["correct"] == (fault is None), out["checks"]
  if fault is None:
    assert out["e2e"]["train_steps_per_s"] > 0
  readings = {c["name"]: c["value"] for c in out["checks"]}
  if fault == "state_unchanged":
    assert math.isclose(readings["change_gap"], 1.0)


@pytest.mark.card
def test_train_control_is_not_correct(card):
  out = run_small("stereo_mag_224x10.train_b1", seconds=0.5,
                  devices=(str(card),), options={"control": True})
  assert not out["correct"], out["checks"]
