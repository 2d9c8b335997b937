"""Training telemetry: step metrics, Prometheus export, JSONL sink, HTTP.

A copy of ``mpi_vision_tpu/train/telemetry.py`` with its imports
rewritten. Serving has ``/stats`` + ``/metrics``; without this module a
training run would export nothing — a step-time regression or a
NaN-rollback storm would stay invisible. ``TrainMetrics`` closes that: ``fit_resumable``
records per-step wall time, examples/s, loss, and learning rate, plus
checkpoint save duration/bytes and the rollback / preemption / restore
counters, and the whole state exports three ways:

  * ``metrics_text()`` — ``mpi_train_*`` Prometheus families rendered
    via the existing ``obs.prom.Registry`` machinery, served by
    ``make_train_metrics_server`` (``train --metrics-port``: a stdlib
    listener with ``/metrics`` + ``/stats`` + ``/healthz`` +
    ``/debug/events``) so a training run is scrapeable exactly like a
    serve backend.
  * ``snapshot()`` — the JSON ``/stats`` payload.
  * an optional ``sink`` receiving one JSON line per step / save
    (``train --metrics-log``): the greppable offline record.

Clocks are injectable (clock-lint covers this file); the loop reads step
wall time through ``clock()`` so telemetry and the stall watchdog can
share one base in tests.
"""

from __future__ import annotations

import collections
import functools
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from mpi_vision_tpu_torch.obs import hist as hist_mod
from mpi_vision_tpu_torch.obs import prom
from mpi_vision_tpu_torch.obs.events import file_sink as _file_sink

PREFIX = "mpi_train_"

# Recent step wall times retained for the throughput/percentile window
# (lifetime totals ride separate counters).
STEP_WINDOW = 256


class TrainMetrics:
  """Lock-guarded training counters + Prometheus/JSON export.

  Args:
    clock: injectable monotonic clock (step timing, uptime).
    sink: optional ``str -> None`` receiving one JSON line per recorded
      step and checkpoint save (``train --metrics-log``). Failures are
      counted (``sink_errors``), never raised into the step loop.
  """

  def __init__(self, clock=time.monotonic, sink=None):
    self._clock = clock
    self.sink = sink
    self._lock = threading.Lock()
    self._t0 = clock()
    self._recent = collections.deque(maxlen=STEP_WINDOW)  # (wall_s, examples)
    # Native histograms (obs/hist.py, the ROADMAP flight-recorder
    # follow-on): percentile-TRUE step/save latency quantiles over the
    # whole run, mergeable across trainers exactly like the serve-side
    # request histograms.
    self._hist_step = hist_mod.NativeHistogram()
    self._hist_save = hist_mod.NativeHistogram()
    self.steps = 0
    self.examples = 0
    self.step_seconds = 0.0
    self.last_step_s = 0.0
    self.last_loss: float | None = None
    self.last_lr: float | None = None
    self.opt_step = 0
    self.epoch = 0
    self.ckpt_saves = 0
    self.ckpt_save_seconds = 0.0
    self.ckpt_save_bytes = 0
    self.last_save_s = 0.0
    self.last_save_bytes = 0
    self.nan_rollbacks = 0
    self.preemptions = 0
    self.restores = 0
    self.sink_errors = 0

  def clock(self) -> float:
    """The telemetry clock (the loop brackets each step with it)."""
    return self._clock()

  def _emit(self, record: dict) -> None:
    sink = self.sink
    if sink is None:
      return
    try:
      sink(json.dumps(record))
    except Exception:  # noqa: BLE001 - a dying sink must not stop training
      with self._lock:
        self.sink_errors += 1

  # -- recording -----------------------------------------------------------

  def record_step(self, step: int, loss: float, wall_s: float,
                  examples: int = 1, lr: float | None = None) -> None:
    """One completed optimizer step (loss already fetched to host)."""
    with self._lock:
      self.steps += 1
      self.opt_step = int(step)
      self.examples += int(examples)
      self.step_seconds += float(wall_s)
      self.last_step_s = float(wall_s)
      self.last_loss = float(loss)
      if lr is not None:
        self.last_lr = float(lr)
      self._recent.append((float(wall_s), int(examples)))
      self._hist_step.record(float(wall_s))
    self._emit({"event": "train_step", "step": int(step),
                "loss": round(float(loss), 6),
                "wall_ms": round(float(wall_s) * 1e3, 3),
                "examples": int(examples),
                **({"lr": float(lr)} if lr is not None else {})})

  def record_save(self, step: int, seconds: float, nbytes: int,
                  reason: str = "") -> None:
    with self._lock:
      self.ckpt_saves += 1
      self.ckpt_save_seconds += float(seconds)
      self.ckpt_save_bytes += int(nbytes)
      self.last_save_s = float(seconds)
      self.last_save_bytes = int(nbytes)
      self._hist_save.record(float(seconds))
    self._emit({"event": "ckpt_save", "step": int(step),
                "seconds": round(float(seconds), 6), "bytes": int(nbytes),
                **({"reason": reason} if reason else {})})

  def record_rollback(self, to_step: int) -> None:
    with self._lock:
      self.nan_rollbacks += 1
    self._emit({"event": "nan_rollback", "to_step": int(to_step)})

  def record_preemption(self, step: int) -> None:
    with self._lock:
      self.preemptions += 1
    self._emit({"event": "preempt", "step": int(step)})

  def record_restore(self, step: int) -> None:
    with self._lock:
      self.restores += 1
    self._emit({"event": "restore", "step": int(step)})

  def record_epoch(self, epoch: int) -> None:
    with self._lock:
      self.epoch = int(epoch)

  # -- export --------------------------------------------------------------

  def snapshot(self) -> dict:
    """The training ``/stats`` payload (JSON-ready)."""
    with self._lock:
      uptime = max(self._clock() - self._t0, 1e-9)
      recent_wall = sum(w for w, _ in self._recent)
      recent_examples = sum(n for _, n in self._recent)
      recent = sorted(w for w, _ in self._recent)
      p50 = self._hist_step.quantile(0.5)
      p99 = self._hist_step.quantile(0.99)
      out = {
          "uptime_s": round(uptime, 3),
          "steps": self.steps,
          "step": self.opt_step,
          "epoch": self.epoch,
          "examples": self.examples,
          "step_seconds": round(self.step_seconds, 6),
          "last_step_ms": round(self.last_step_s * 1e3, 3),
          "examples_per_sec": (round(recent_examples / recent_wall, 3)
                               if recent_wall > 0 else None),
          "loss": self.last_loss,
          "learning_rate": self.last_lr,
          "ckpt": {
              "saves": self.ckpt_saves,
              "save_seconds": round(self.ckpt_save_seconds, 6),
              "save_bytes": self.ckpt_save_bytes,
              "last_save_ms": round(self.last_save_s * 1e3, 3),
              "last_save_bytes": self.last_save_bytes,
          },
          "nan_rollbacks": self.nan_rollbacks,
          "preemptions": self.preemptions,
          "restores": self.restores,
          "sink_errors": self.sink_errors,
          # Whole-run JSON snapshots of the native histograms: what the
          # registry renders and what a pool aggregator merges exactly.
          "step_latency_hist": self._hist_step.snapshot(),
          "save_latency_hist": self._hist_save.snapshot(),
      }
      if recent:
        # Percentile-true quantiles off the native histogram (whole-run,
        # ~9% worst-case relative error); max stays the recent window's
        # observed extreme.
        out["step_ms"] = {
            "p50": None if p50 is None else round(p50 * 1e3, 3),
            "p99": None if p99 is None else round(p99 * 1e3, 3),
            "max": round(recent[-1] * 1e3, 3)}
      return out

  def registry(self, snapshot: dict | None = None) -> prom.Registry:
    """The ``mpi_train_*`` families for one snapshot (scrape a training
    run exactly like a serve backend)."""
    snap = snapshot if snapshot is not None else self.snapshot()
    reg = prom.Registry()
    p = PREFIX
    reg.gauge(p + "uptime_seconds", "Seconds since telemetry started.",
              snap["uptime_s"])
    reg.counter(p + "steps_total", "Completed optimizer steps.",
                snap["steps"])
    reg.gauge(p + "step", "Current optimizer step counter.", snap["step"])
    reg.gauge(p + "epoch", "Last finished epoch index.", snap["epoch"])
    reg.counter(p + "examples_total", "Training examples consumed.",
                snap["examples"])
    reg.counter(p + "step_seconds_total",
                "Cumulative wall time inside optimizer steps.",
                snap["step_seconds"])
    reg.gauge(p + "last_step_seconds", "Wall time of the newest step.",
              snap["last_step_ms"] / 1e3)
    reg.gauge(p + "examples_per_second",
              "Recent-window training throughput.",
              snap["examples_per_sec"])
    reg.gauge(p + "loss", "Loss of the newest step.", snap["loss"])
    reg.gauge(p + "learning_rate",
              "Learning rate applied to the newest step.",
              snap["learning_rate"])
    ck = snap["ckpt"]
    reg.counter(p + "ckpt_saves_total", "Checkpoint saves published.",
                ck["saves"])
    reg.counter(p + "ckpt_save_seconds_total",
                "Cumulative wall time inside checkpoint saves.",
                ck["save_seconds"])
    reg.counter(p + "ckpt_save_bytes_total",
                "Cumulative bytes written by checkpoint saves.",
                ck["save_bytes"])
    reg.counter(p + "nan_rollbacks_total",
                "NaN-guard rollbacks to a previous checkpoint.",
                snap["nan_rollbacks"])
    reg.counter(p + "preemptions_total",
                "Preemption saves (SIGTERM or injected).",
                snap["preemptions"])
    reg.counter(p + "restores_total",
                "Checkpoint restores (resume + rollbacks).",
                snap["restores"])
    # Native-histogram families (exact cross-trainer merges, per-bucket
    # resolution) + the percentile-true quantile gauges read off them.
    hist_mod.add_family(
        reg, p + "step_latency_nativehist",
        "Optimizer-step wall time, native exponential buckets.",
        [({}, snap.get("step_latency_hist"))])
    hist_mod.add_family(
        reg, p + "ckpt_save_latency_nativehist",
        "Checkpoint save wall time, native exponential buckets.",
        [({}, snap.get("save_latency_hist"))])
    q_gauge = reg.gauge(
        p + "step_quantile_seconds",
        "Whole-run step wall time at quantile q, estimated from the "
        "native histogram (NaN while idle).")
    for q in hist_mod.QUANTILES:
      q_gauge.sample(hist_mod.quantile_of(snap.get("step_latency_hist"), q),
                     {"q": hist_mod.q_label(q)})
    return reg

  def metrics_text(self) -> str:
    return self.registry().render()


class _TrainMetricsHandler(BaseHTTPRequestHandler):
  """The ``train --metrics-port`` surface: the serve endpoints a scraper
  already knows, minus the request path."""

  def __init__(self, metrics: TrainMetrics, events, *args, **kwargs):
    self.metrics = metrics
    self.events = events
    super().__init__(*args, **kwargs)

  def log_message(self, fmt, *args):  # noqa: A003 - stdlib signature
    pass

  def _send(self, body: bytes, status: int = 200,
            content_type: str = "application/json") -> None:
    try:
      self.send_response(status)
      self.send_header("Content-Type", content_type)
      self.send_header("Content-Length", str(len(body)))
      self.end_headers()
      self.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError):
      self.close_connection = True

  def do_GET(self):  # noqa: N802 - stdlib name
    parsed = urllib.parse.urlsplit(self.path)
    path = parsed.path
    if path == "/metrics":
      self._send(self.metrics.metrics_text().encode(),
                 content_type="text/plain; version=0.0.4; charset=utf-8")
    elif path == "/stats":
      self._send(json.dumps(self.metrics.snapshot()).encode())
    elif path == "/healthz":
      snap = self.metrics.snapshot()
      # steps/saves/last_step_ms ride along for the queue supervisor:
      # one GET gives it the progress counters for wedge detection
      # (saves count too — epoch-boundary checkpoint I/O is progress,
      # not a hang) and the step wall time for the latency SLO.
      self._send(json.dumps({"status": "ok", "role": "train",
                             "steps": snap["steps"],
                             "step": snap["step"],
                             "saves": snap["ckpt"]["saves"],
                             "last_step_ms": snap["last_step_ms"]}).encode())
    elif path == "/debug/events" and self.events is not None:
      # Same query surface as the serve/router handlers: ?kind= filters,
      # ?recent=N bounds (400 on a non-integer N).
      query = urllib.parse.parse_qs(parsed.query)
      kind = query.get("kind", [None])[0]
      try:
        recent = int(query.get("recent", ["128"])[0])
      except ValueError:
        self._send(json.dumps(
            {"error": "recent must be an integer"}).encode(), status=400)
        return
      self._send(json.dumps(
          self.events.snapshot(recent=recent, kind=kind)).encode())
    else:
      self._send(json.dumps({"error": f"unknown path {self.path}"}).encode(),
                 status=404)


def make_train_metrics_server(metrics: TrainMetrics, events=None,
                              host: str = "127.0.0.1",
                              port: int = 0) -> ThreadingHTTPServer:
  """A ready-to-``serve_forever`` threaded listener exporting a training
  run's ``/metrics`` + ``/stats`` + ``/healthz`` (+ ``/debug/events``
  when an ``obs.events.EventLog`` is supplied). Port 0 = ephemeral; the
  bound port is ``server.server_address[1]``."""
  handler = functools.partial(_TrainMetricsHandler, metrics, events)
  server = ThreadingHTTPServer((host, port), handler)
  server.daemon_threads = True
  return server


# The ``--metrics-log`` sink: one JSON line per record, append mode —
# exactly the event log's line sink, re-exported under the name the
# train CLI flags document (one implementation to keep correct).
file_metrics_sink = _file_sink
