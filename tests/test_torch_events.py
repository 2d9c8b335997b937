"""The port's event log, device profiler and debug hooks against the JAX
package's.

``obs/events.py`` is a copy of the JAX module: the same ``emit`` sequence
under one fake clock gives the same records, and the rotating file sink
writes the same files. ``obs/profile.py`` keeps the JAX capture guard (one
capture at a time, ``ProfileBusyError`` -> HTTP 409) over
``torch.profiler``; ``debug.py`` maps ``named_scope`` to NVTX +
``record_function`` ranges (no synchronise), ``trace`` to a Chrome trace,
and ``checked`` to a NaN/inf check of the outputs. Tolerance: 1e-5 between
a ``checked`` port render and the JAX render (``tests/test_torch_core.py``'s
bound for the plain render).
"""

import contextlib
import json
import os
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_vision_tpu.core import render as jrender
from mpi_vision_tpu.obs import events as jevents
from mpi_vision_tpu.obs import profile as jprofile
from mpi_vision_tpu_torch import debug
from mpi_vision_tpu_torch.core import camera as tcamera
from mpi_vision_tpu_torch.core import render as trender
from mpi_vision_tpu_torch.obs import events as tevents
from mpi_vision_tpu_torch.obs import profile as tprofile
from mpi_vision_tpu_torch.serve import RenderService, make_http_server

H = W = 16
P = 4


class _Clock:

  def __init__(self, t=1.7e9):
    self.t = t

  def __call__(self):
    self.t += 0.125
    return self.t


def _script(log):
  log.emit("breaker", old="closed", new="open")
  log.emit("watchdog_trip", attempt=1, fallback=False, deadline_capped=False)
  log.emit("scene_swap", scenes=["a", "b"], prebake=True)
  for i in range(6):
    log.emit("slo_alert", slo="availability", firing=bool(i % 2), n=i)
  log.emit("breaker", old="open", new="half_open")


def test_event_log_records_equal_jax():
  ours = tevents.EventLog(capacity=5, clock=_Clock())
  theirs = jevents.EventLog(capacity=5, clock=_Clock())
  _script(ours)
  _script(theirs)
  for kind in (None, "breaker", "slo_alert", "nope"):
    for recent in (0, 3, 128):
      assert (ours.snapshot(recent=recent, kind=kind)
              == theirs.snapshot(recent=recent, kind=kind))
  assert ours.count("slo_alert") == theirs.count("slo_alert") == 6
  assert (ours.emitted, ours.dropped) == (theirs.emitted, theirs.dropped)
  assert tevents.NULL_EVENTS.snapshot() == jevents.NULL_EVENTS.snapshot()
  assert tevents.NULL_EVENTS.emit("x", a=1) is None


def test_file_sink_rotation_writes_the_same_files(tmp_path):
  files = {}
  for name, mod in (("port", tevents), ("jax", jevents)):
    root = tmp_path / name
    root.mkdir()
    sink = mod.file_sink(str(root / "events.jsonl"), max_bytes=300, keep=2)
    log = mod.EventLog(clock=_Clock(), sink=sink)
    _script(log)
    _script(log)
    sink.close()
    snap = log.snapshot()
    files[name] = ({p.name: p.read_bytes() for p in sorted(root.iterdir())},
                   snap["retention"], snap["sink_errors"])
  assert files["port"] == files["jax"]
  names = set(files["port"][0])
  assert names == {"events.jsonl", "events.jsonl.1", "events.jsonl.2"}
  assert files["port"][1]["rotations"] > 2
  assert files["port"][1]["segments_dropped"] > 0


def test_a_dying_sink_costs_a_counter():
  def sink(line):
    raise OSError("disk full")

  for mod in (tevents, jevents):
    log = mod.EventLog(clock=_Clock(), sink=sink)
    assert log.emit("breaker", old="a", new="b")["seq"] == 1
    assert log.sink_errors == 1


class _FakeProfilerCtx:
  """Stands in for ``debug.trace``: records entry, optionally blocks."""

  def __init__(self):
    self.dirs = []
    self.entered = threading.Event()
    self.release = threading.Event()
    self.block = False

  @contextlib.contextmanager
  def __call__(self, logdir):
    self.dirs.append(logdir)
    self.entered.set()
    if self.block:
      self.release.wait(30)
    yield


def test_profiler_guard_as_jax(tmp_path):
  assert tprofile.MAX_CAPTURE_SECONDS == jprofile.MAX_CAPTURE_SECONDS
  for mod in (tprofile, jprofile):
    ctx = _FakeProfilerCtx()
    prof = mod.DeviceProfiler(str(tmp_path / mod.__name__), trace_ctx=ctx,
                              sleep=lambda s: None)
    for bad in (0, -1, mod.MAX_CAPTURE_SECONDS + 1):
      with pytest.raises(ValueError):
        prof.capture(bad)
    prof._lock.acquire()
    try:
      assert prof.busy
      with pytest.raises(mod.ProfileBusyError):
        prof.capture(0.01)
    finally:
      prof._lock.release()
    out = prof.capture(0.01)
    assert out["capture"] == 1 and not prof.busy
    assert out["logdir"] == os.path.join(str(tmp_path / mod.__name__),
                                         "profile_0001")
    assert os.path.isdir(out["logdir"]) and ctx.dirs == [out["logdir"]]


def test_http_profile_busy_409_disabled_503_and_hook(tmp_path):
  ctx = _FakeProfilerCtx()
  hooked = []
  svc = RenderService(device="cpu", max_batch=2, max_wait_ms=1.0,
                      profiler=tprofile.DeviceProfiler(
                          str(tmp_path), trace_ctx=ctx,
                          sleep=lambda s: None),
                      profile_hook=hooked.append)
  plain = RenderService(device="cpu", max_batch=2, max_wait_ms=1.0)
  servers = [make_http_server(s, port=0) for s in (svc, plain)]
  for httpd in servers:
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
  base, plain_base = (f"http://127.0.0.1:{h.server_address[1]}"
                      for h in servers)
  try:
    out = json.loads(urllib.request.urlopen(
        base + "/debug/profile?seconds=0.05", timeout=60).read())
    assert out["capture"] == 1 and out["hook"] == "ok"
    assert hooked == [out["logdir"]] and os.path.isdir(out["logdir"])
    ctx.block = True
    ctx.entered.clear()
    first = threading.Thread(target=lambda: urllib.request.urlopen(
        base + "/debug/profile?seconds=0.05", timeout=60).read(),
        daemon=True)
    first.start()
    assert ctx.entered.wait(30)
    with pytest.raises(urllib.error.HTTPError) as err:
      urllib.request.urlopen(base + "/debug/profile?seconds=0.05",
                             timeout=60)
    assert err.value.code == 409 and err.value.headers["Retry-After"] == "1"
    ctx.release.set()
    first.join(30)
    for query in ("seconds=nope", "seconds=-1", "seconds=1e9"):
      with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(base + f"/debug/profile?{query}", timeout=60)
      assert err.value.code == 400, query
    with pytest.raises(urllib.error.HTTPError) as err:
      urllib.request.urlopen(plain_base + "/debug/profile?seconds=1",
                             timeout=60)
    assert err.value.code == 503
    assert svc.stats()["profile"] == {"captures": 2, "hook_failures": 0}
  finally:
    for httpd in servers:
      httpd.shutdown()
      httpd.server_close()
    svc.close()
    plain.close()


def _mpi_args(rng, poison=False):
  mpi = rng.uniform(0, 1, (1, 24, 24, 3, 4)).astype(np.float32)
  if poison:
    mpi[0, 12, 12, 1, 0] = np.nan
  pose = np.eye(4, dtype=np.float32)
  pose[0, 3] = 0.05
  k = np.array([[12, 0, 12], [0, 12, 12], [0, 0, 1]], np.float32)
  depths = tcamera.inv_depths(1.0, 100.0, 3).numpy()
  return mpi, pose[None], depths, k[None]


def test_checked_passes_clean_renders_and_raises_on_nan(rng):
  args = _mpi_args(rng)
  render = debug.checked(trender.render_mpi)
  got = render(*map(torch.from_numpy, args))
  want = jrender.render_mpi(*map(jnp.asarray, args))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
  with pytest.raises(FloatingPointError, match="render_mpi: non-finite"):
    render(*map(torch.from_numpy, _mpi_args(rng, poison=True)))
  nested = debug.checked(lambda: {"a": (torch.ones(2),
                                        torch.tensor([1.0, np.inf]))})
  with pytest.raises(FloatingPointError, match=r"\['a'\]\[1\]"):
    nested()
  assert debug.checked(lambda: torch.ones(3, dtype=torch.int64))().sum() == 3


def test_named_scope_is_nvtx_plus_record_function_without_sync(monkeypatch):
  calls = []
  monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
  monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                      lambda name: calls.append(("push", name)))
  monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                      lambda: calls.append(("pop",)))

  def no_sync(*a, **k):
    raise AssertionError("an annotation synchronised the device")

  monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
  with debug.named_scope("render/warp"):
    with debug.named_scope("render/composite"):
      calls.append(("body",))
  assert calls == [("push", "render/warp"), ("push", "render/composite"),
                   ("body",), ("pop",), ("pop",)]


def test_trace_records_render_ranges_of_other_threads(tmp_path, rng):
  """``debug.trace`` writes a Chrome trace holding the ``render/*``
  ranges, also those recorded on a worker thread (where the serving
  stack renders)."""
  args = [torch.from_numpy(a) for a in _mpi_args(rng)]

  def work():
    for method in ("scan", "pallas", "fused"):
      trender.render_mpi(*args, method=method)

  logdir = str(tmp_path / "trace")
  with debug.trace(logdir):
    worker = threading.Thread(target=work)
    worker.start()
    worker.join(60)
  events = json.load(open(os.path.join(logdir, "trace.json")))
  names = {e.get("name") for e in events["traceEvents"]}
  assert {"render/homographies", "render/warp", "render/composite",
          "render/warp_composite_scan"} <= names
