"""The port's training telemetry against the JAX package's.

``train/telemetry.py`` is a copy of the JAX module: one scripted
fake-clock sequence of steps, saves, restores, rollbacks and preemptions
gives JAX's snapshot, ``mpi_train_*`` exposition and JSONL lines. The
port's ``fit_resumable`` records into it (and the checkpoint store emits
its lifecycle events) as the JAX loop does; ``/metrics`` scraped while the
loop is parked mid-epoch shows the steps run so far; the ``train
--metrics-port/--metrics-port-file/--metrics-log/--event-log`` flags run
end to end on the CPU and keep the JAX CLI's guards.
"""

import json
import threading
import urllib.request

import pytest
import torch

from mpi_vision_tpu.train import telemetry as jtel
from mpi_vision_tpu_torch import cli
from mpi_vision_tpu_torch.ckpt import (
    CheckpointStore,
    NanGuard,
    PreemptionGuard,
)
from mpi_vision_tpu_torch.obs import parse_metrics_text
from mpi_vision_tpu_torch.obs.events import EventLog
from mpi_vision_tpu_torch.train import loop as tloop
from mpi_vision_tpu_torch.train import telemetry as ttel


class FakeClock:

  def __init__(self, t=100.0):
    self.t = t

  def __call__(self):
    return self.t

  def advance(self, dt):
    self.t += dt
    return self.t


def _script(mod):
  clock = FakeClock()
  lines = []
  tm = mod.TrainMetrics(clock=clock, sink=lines.append)
  tm.record_restore(4)
  for step in range(5, 17):
    clock.advance(0.02 + 0.001 * step)
    tm.record_step(step, loss=1.0 / step, wall_s=0.02 + 0.001 * step,
                   examples=2, lr=2e-4 if step < 10 else 1e-4)
    if step % 4 == 0:
      tm.record_save(step, seconds=0.1 * step, nbytes=1000 * step,
                     reason="periodic")
    if step == 9:
      tm.record_rollback(8)
    if step % 6 == 0:
      tm.record_epoch(step // 6)
  tm.record_preemption(16)
  return tm.snapshot(), tm.metrics_text(), lines, \
      parse_metrics_text(tm.metrics_text())


def test_train_metrics_trace_equals_jax():
  got = _script(ttel)
  want = _script(jtel)
  assert got == want
  snap, text, lines, parsed = got
  assert snap["steps"] == 12 and snap["restores"] == 1
  kinds = [json.loads(line)["event"] for line in lines]
  assert kinds.count("train_step") == 12 and kinds.count("ckpt_save") == 3
  assert "mpi_train_step_latency_nativehist" in parsed


def test_idle_metrics_parse_and_failing_sink_is_counted():
  tm = ttel.TrainMetrics(clock=FakeClock())
  assert tm.metrics_text() == jtel.TrainMetrics(
      clock=FakeClock()).metrics_text()
  parse_metrics_text(tm.metrics_text())

  def bad(line):
    raise OSError("disk full")

  tm = ttel.TrainMetrics(clock=FakeClock(), sink=bad)
  tm.record_step(1, loss=0.5, wall_s=0.01)
  assert tm.sink_errors == 1 and tm.steps == 1


# --- fit_resumable -----------------------------------------------------------


def _state():
  return tloop.create_train_state(num_planes=2, norm=None, device="cpu")


def _mini_step(state, batch):
  state.step += 1
  return state, {"loss": float(batch["x"].mean())}


def _epoch(e):
  return [{"x": torch.full((2, 3), 0.1 * (e + 1) + 0.01 * i)}
          for i in range(3)]


def test_fit_resumable_records_steps_saves_and_events(tmp_path):
  tm = ttel.TrainMetrics()
  ev = EventLog(clock=FakeClock())
  store = CheckpointStore(str(tmp_path), events=ev)
  _, report = tloop.fit_resumable(_state(), 2, _epoch, store,
                                  step=_mini_step, resume="never",
                                  telemetry=tm, events=ev)
  assert report["final_step"] == 6
  snap = tm.snapshot()
  assert snap["steps"] == 6 and snap["step"] == 6
  assert snap["examples"] == 12          # 6 steps x batch of 2
  assert snap["epoch"] == 1
  assert snap["loss"] == pytest.approx(report["losses"][-1])
  assert snap["ckpt"]["saves"] == report["saves"]
  assert snap["ckpt"]["save_bytes"] > 0
  assert ev.count("ckpt_save") == report["saves"]
  save = ev.snapshot(kind="ckpt_save")["events"][0]
  assert save["bytes"] > 0 and save["reason"] == "initial"


def test_fit_resumable_restore_rollback_and_preemption(tmp_path):
  ev = EventLog(clock=FakeClock())
  tloop.fit_resumable(_state(), 1, _epoch,
                      CheckpointStore(str(tmp_path / "a"), events=ev),
                      step=_mini_step, resume="never")
  tm = ttel.TrainMetrics()
  _, report = tloop.fit_resumable(
      _state(), 2, _epoch, CheckpointStore(str(tmp_path / "a"), events=ev),
      step=_mini_step, resume="auto", telemetry=tm, events=ev)
  assert report["resumed_from"] == 3
  assert tm.snapshot()["restores"] == 1 and ev.count("ckpt_restore") >= 1

  poisoned = []

  def nan_step(state, batch):
    at = state.step
    state, metrics = _mini_step(state, batch)
    if at == 4 and not poisoned:  # one transient glitch
      poisoned.append(True)
      return state, {"loss": float("nan")}
    return state, metrics

  tm2, ev2 = ttel.TrainMetrics(), EventLog(clock=FakeClock())
  _, report = tloop.fit_resumable(
      _state(), 2, _epoch, CheckpointStore(str(tmp_path / "nan"),
                                           events=ev2),
      step=nan_step, resume="never", nan_guard=NanGuard(max_rollbacks=3),
      telemetry=tm2, events=ev2)
  assert report["nan_rollbacks"] >= 1
  assert tm2.snapshot()["nan_rollbacks"] == report["nan_rollbacks"]
  roll = ev2.snapshot(kind="nan_rollback")["events"]
  assert roll and roll[0]["to_step"] in report["nan_rollback_steps"]

  tm3, ev3 = ttel.TrainMetrics(), EventLog(clock=FakeClock())
  preempt = PreemptionGuard()

  def step(state, batch):
    state, metrics = _mini_step(state, batch)
    if state.step == 2:
      preempt.request()
    return state, metrics

  _, report = tloop.fit_resumable(
      _state(), 2, _epoch, CheckpointStore(str(tmp_path / "p"), events=ev3),
      step=step, resume="never", preemption=preempt, telemetry=tm3,
      events=ev3)
  assert report["preempted"] is True
  assert tm3.snapshot()["preemptions"] == 1 and ev3.count("preempt") == 1


def _scrape(port, path="/metrics"):
  with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                              timeout=30) as resp:
    return resp.read().decode()


def test_metrics_server_scrapes_a_running_loop(tmp_path):
  tm = ttel.TrainMetrics()
  ev = EventLog(clock=FakeClock())
  httpd = ttel.make_train_metrics_server(tm, events=ev)
  port = httpd.server_address[1]
  server = threading.Thread(target=httpd.serve_forever, daemon=True)
  server.start()
  reached, release, result = threading.Event(), threading.Event(), {}

  def gated_step(state, batch):
    state, metrics = _mini_step(state, batch)
    if state.step == 2:
      reached.set()
      assert release.wait(60), "scraper never released the loop"
    return state, metrics

  def run():
    _, result["report"] = tloop.fit_resumable(
        _state(), 2, _epoch, CheckpointStore(str(tmp_path), events=ev),
        step=gated_step, resume="never", telemetry=tm, events=ev)

  worker = threading.Thread(target=run, daemon=True)
  worker.start()
  try:
    assert reached.wait(60)
    live = parse_metrics_text(_scrape(port))
    assert live["mpi_train_steps_total"]["samples"][
        ("mpi_train_steps_total", ())] == 1          # mid-run
    health = json.loads(_scrape(port, "/healthz"))
    assert health["status"] == "ok" and health["role"] == "train"
    assert health["steps"] == 1
  finally:
    release.set()
    worker.join(120)
  try:
    assert not worker.is_alive()
    done = parse_metrics_text(_scrape(port))
    assert done["mpi_train_steps_total"]["samples"][
        ("mpi_train_steps_total", ())] == 6
    assert done["mpi_train_ckpt_saves_total"]["samples"][
        ("mpi_train_ckpt_saves_total", ())] == result["report"]["saves"]
    events = json.loads(_scrape(port, "/debug/events"))
    assert events["by_kind"].get("ckpt_save", 0) == \
        result["report"]["saves"]
  finally:
    httpd.shutdown()
    httpd.server_close()
    server.join(10)


# --- the CLI -----------------------------------------------------------------


def test_cli_train_metrics_flags_end_to_end(tmp_path, capsys):
  pf, ml, el = (str(tmp_path / n) for n in ("port", "m.jsonl", "e.jsonl"))
  assert cli.main(["train", "--device", "cpu", "--synthetic",
                   "--synthetic-scenes", "2", "--img-size", "16",
                   "--num-planes", "2", "--epochs", "1", "--no-vgg-loss",
                   "--no-valid", "--dataset", str(tmp_path / "data"),
                   "--ckpt", str(tmp_path / "ck"), "--metrics-port", "0",
                   "--metrics-port-file", pf, "--metrics-log", ml,
                   "--event-log", el]) == 0
  summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  tel = summary["telemetry"]
  assert tel["steps"] == summary["steps"] == 2
  assert tel["metrics_port"] == int(open(pf).read())
  steps = [json.loads(line) for line in open(ml)]
  assert sum(1 for r in steps if r.get("event") == "train_step") == 2
  kinds = [json.loads(line)["kind"] for line in open(el)]
  assert kinds.count("ckpt_save") == summary["ckpt"]["saves"]


@pytest.mark.parametrize("argv,message", [
    (["--metrics-port", "0"], r"--metrics-port require\(s\) --ckpt"),
    (["--metrics-log", "m"], r"--metrics-log require\(s\) --ckpt"),
    (["--event-log", "e"], r"--event-log require\(s\) --ckpt"),
    (["--ckpt", "c", "--metrics-port-file", "p"],
     "--metrics-port-file requires --metrics-port"),
])
def test_cli_train_metrics_flag_guards(tmp_path, argv, message):
  with pytest.raises(SystemExit, match=message):
    cli.main(["train", "--device", "cpu", "--synthetic", "--dataset",
              str(tmp_path)] + argv)
