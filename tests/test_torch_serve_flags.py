"""The port's ``serve`` resilience and trace flags, and ``render_traced``.

The JAX ``serve`` records a span tree per request by default
(``--trace``, ``Tracer(ring=256)``) and builds a ``ResilienceConfig``
from ``--retries/--backoff-*/--breaker-*/--watchdog-s``, or none under
``--no-resilience``; ``--max-inflight-cap`` bounds ``--max-inflight
auto``. Pinned here on the port: each of those flags has the JAX
parser's default, the same argv builds the same ``ResilienceConfig``
and tracer as the JAX ``cmd_serve`` does, ``--no-resilience`` yields a
service with no resilience layer, ``GET /debug/traces?id=<X-Trace-Id>``
returns the render's span tree from a default ``serve`` process, and
``RenderService.render_traced`` returns ``(image, trace_id)``. The
``cluster`` parser carries every JAX flag with its default, plus
``--device``, and ``cmd_cluster`` refuses the same misuses with the same
words.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from mpi_vision_tpu import cli as jcli
from mpi_vision_tpu import serve as jserve
from mpi_vision_tpu_torch import cli
from mpi_vision_tpu_torch import serve as tserve
from mpi_vision_tpu_torch.obs import Tracer
from mpi_vision_tpu_torch.serve import RenderService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SERVE_FLAGS = ("max_inflight_cap", "resilience", "retries", "backoff_ms",
               "backoff_max_ms", "breaker_threshold", "breaker_reset_s",
               "watchdog_s", "trace", "trace_ring", "trace_log")


def _subparser_actions(parser, command):
  sub = next(a for a in parser._actions
             if getattr(a, "choices", None) and command in a.choices)
  return {a.dest: a for a in sub.choices[command]._actions
          if a.dest != "help"}


def test_serve_flags_have_the_jax_defaults():
  port = vars(cli.build_parser().parse_args(["serve"]))
  ref = vars(jcli.build_parser().parse_args(["serve"]))
  for flag in SERVE_FLAGS:
    assert port[flag] == ref[flag], flag
  # The trace and resilience layers are on unless switched off.
  assert port["trace"] is True and port["resilience"] is True
  off = cli.build_parser().parse_args(
      ["serve", "--no-resilience", "--no-trace", "--trace-log"])
  assert off.resilience is False and off.trace is False and off.trace_log


def test_cluster_parser_has_every_jax_flag_with_its_default():
  port = _subparser_actions(cli.build_parser(), "cluster")
  ref = _subparser_actions(jcli.build_parser(), "cluster")
  assert set(port) == set(ref) | {"device"}
  for dest, action in ref.items():
    assert port[dest].default == action.default, dest
    assert port[dest].option_strings == action.option_strings, dest
  assert port["device"].default == "cuda"
  assert port["device"].choices == ("cuda", "cpu")


class _Built(Exception):
  """Raised by the stand-in service once it has seen its kwargs."""


def _service_kwargs(monkeypatch, module, cli_mod, argv):
  seen = {}

  def fake_service(**kwargs):
    seen.update(kwargs)
    raise _Built

  monkeypatch.setattr(module, "RenderService", fake_service)
  args = cli_mod.build_parser().parse_args(["serve", *argv])
  with pytest.raises(_Built):
    cli_mod.cmd_serve(args)
  return seen


@pytest.mark.parametrize("argv", [
    [],
    ["--retries", "4", "--backoff-ms", "10", "--backoff-max-ms", "80",
     "--breaker-threshold", "2", "--breaker-reset-s", "3",
     "--watchdog-s", "0", "--trace-ring", "8", "--max-inflight", "auto",
     "--max-inflight-cap", "6"],
    ["--no-resilience", "--no-trace"],
], ids=["defaults", "knobs", "off"])
def test_same_argv_builds_the_same_layers_as_jax(monkeypatch, argv):
  port = _service_kwargs(monkeypatch, tserve, cli, argv)
  ref = _service_kwargs(monkeypatch, jserve, jcli, argv)
  assert port["max_inflight"] == ref["max_inflight"]
  assert port["max_inflight_cap"] == ref["max_inflight_cap"]
  if ref["resilience"] is None:
    assert port["resilience"] is None
  else:
    assert dataclasses.asdict(port["resilience"]) == \
        dataclasses.asdict(ref["resilience"])
  if ref["tracer"] is None:
    assert port["tracer"] is None
  else:
    assert isinstance(port["tracer"], Tracer)
    assert port["tracer"].snapshot()["ring_size"] == \
        ref["tracer"].snapshot()["ring_size"]
    assert (port["tracer"].emit is None) == (ref["tracer"].emit is None)


def test_render_traced_returns_the_image_and_its_trace_id():
  svc = RenderService(device="cpu", max_batch=2, max_wait_ms=0.5,
                      tracer=Tracer())
  untraced = RenderService(device="cpu", max_batch=2, max_wait_ms=0.5)
  try:
    for s in (svc, untraced):
      s.add_synthetic_scenes(1, height=16, width=16, planes=2)
    pose = np.eye(4)
    pose[0, 3] = 0.02
    img, trace_id = svc.render_traced("scene_000", pose)
    np.testing.assert_array_equal(img, svc.render("scene_000", pose))
    assert trace_id
    spans = svc.tracer.find(trace_id)
    assert len(spans) == 1 and spans[0]["name"] == "render"
    assert {"queue_wait", "dispatch"} <= {s["name"]
                                          for s in spans[0]["spans"]}
    img2, no_id = untraced.render_traced("scene_000", pose)
    assert no_id == ""  # tracing off: no id
    np.testing.assert_array_equal(img2, img)
  finally:
    svc.close()
    untraced.close()


def _serve(tmp_path, *extra):
  port_file = tmp_path / "port"
  proc = subprocess.Popen(
      [sys.executable, "-m", "mpi_vision_tpu_torch", "serve",
       "--device", "cpu", "--port", "0", "--port-file", str(port_file),
       "--scenes", "1", "--img-size", "16", "--num-planes", "2",
       "--duration", "120", *extra],
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
      env=dict(os.environ, OMP_NUM_THREADS="1"))
  deadline = time.monotonic() + 60.0
  while not port_file.exists():
    if proc.poll() is not None or time.monotonic() > deadline:
      proc.kill()
      raise AssertionError(proc.communicate()[1].decode()[-2000:])
    time.sleep(0.05)
  return proc, f"http://127.0.0.1:{int(port_file.read_text())}"


def _get_json(url):
  with urllib.request.urlopen(url, timeout=30) as resp:
    return json.loads(resp.read())


def _stop(proc):
  proc.send_signal(signal.SIGTERM)
  out, err = proc.communicate(timeout=60)
  assert proc.returncode == 0, err.decode()[-2000:]
  return json.loads(out.decode().strip().splitlines()[-1])


def test_default_serve_returns_the_renders_span_tree(tmp_path):
  proc, base = _serve(tmp_path)
  try:
    body = json.dumps({"scene_id": "scene_000",
                       "pose": np.eye(4).tolist()}).encode()
    req = urllib.request.Request(base + "/render", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
      trace_id = resp.headers["X-Trace-Id"]
    found = _get_json(f"{base}/debug/traces?id={trace_id}")
    assert [t["trace_id"] for t in found["traces"]] == [trace_id]
    names = {s["name"] for s in found["traces"][0]["spans"]}
    assert {"queue_wait", "dispatch"} <= names
    assert "breaker" in _get_json(base + "/stats")  # resilience is on
  finally:
    summary = _stop(proc)
  assert summary["traces"] >= 1


def test_no_resilience_serves_without_the_layer(tmp_path):
  proc, base = _serve(tmp_path, "--no-resilience", "--no-trace")
  try:
    stats = _get_json(base + "/stats")
    assert "breaker" not in stats  # no ResilienceConfig, no breaker
    health = _get_json(base + "/healthz")
    assert health["status"] == "ok" and "breaker" not in health
  finally:
    summary = _stop(proc)
  assert "traces" not in summary


@pytest.mark.parametrize("argv", [
    [],
    ["--backends", "2", "--join", "h:1"],
    ["--backends", "2", "--rolling-restart", "--join", "h:1"],
    ["--join", "h:1", "--restart-hook", "echo"],
    ["--backends", "2", "--supervise", "--restart-hook", "echo"],
    ["--backends", "2", "--autoscale-max", "3"],
    ["--backends", "2", "--autoscale"],
    ["--backends", "2", "--lease-dir", "d"],
    ["--backends", "2", "--gossip-interval-s", "1"],
    ["--backends", "2", "--restart-budget", "0"],
    ["--backends", "2", "--route-rot-bucket-deg", "5"],
    ["--backends", "2", "--tsdb-points", "10"],
], ids=lambda argv: " ".join(argv) or "nothing")
def test_cluster_refuses_what_the_jax_cluster_refuses(argv):
  """Every guard runs before a backend is spawned, with JAX's words."""
  messages = []
  for cli_mod in (cli, jcli):
    args = cli_mod.build_parser().parse_args(["cluster", *argv])
    with pytest.raises(SystemExit) as info:
      cli_mod.cmd_cluster(args)
    messages.append(str(info.value))
  assert messages[0] == messages[1] and messages[0]
