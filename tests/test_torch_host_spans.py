"""The tracer's host spans (``obs/trace.py`` ``Tracer.span``) and the
served path that records them.

On fake clocks: the off switch reads no clock, totals count each span's
own time (an inner span's time is taken out of the outer one), the ring
drops its oldest pieces and counts them, ``reset`` clears and re-anchors,
and ``host_spans`` maps the tracer's clock onto the wall clock's
nanoseconds. On a CPU service: one flight of three requests records the
engine's and the scheduler's spans, and ``render_async`` finishes one
trace per request.
"""

import time

import numpy as np
import pytest
import torch

from mpi_vision_tpu_torch.obs.trace import NULL_TRACER, Tracer
from mpi_vision_tpu_torch.serve import RenderService

H, W, P = 16, 24, 3


class _Clock:

  def __init__(self, t):
    self.t = t

  def __call__(self):
    return self.t


def _no_clock():
  raise AssertionError("a disabled tracer read a clock")


class _Scopes:
  """A scope factory that logs entries and exits instead of profiling."""

  def __init__(self):
    self.log = []

  def __call__(self, name):
    scopes = self

    class _Scope:

      def __enter__(self):
        scopes.log.append(("enter", name))

      def __exit__(self, *exc):
        scopes.log.append(("exit", name))
        return False

    return _Scope()


def test_disabled_span_reads_no_clock_and_is_shared():
  tracer = Tracer(enabled=False, clock=_no_clock, wall_clock=_no_clock,
                  scope=_no_clock)
  with tracer.span("scheduler/frame_copy"):
    with tracer.span("engine/event_wait", "wait"):
      pass
  tracer.reset()
  assert tracer.span("a") is NULL_TRACER.span("b", "wait")
  assert tracer.host_totals() == {}
  assert tracer.host_spans() == []
  snap = tracer.snapshot()
  assert snap["host_totals"] == {} and snap["host_dropped"] == 0


def test_totals_ring_drops_reset_and_the_wall_anchor():
  clock, wall = _Clock(100.0), _Clock(7_000_000_000)
  scopes = _Scopes()
  tracer = Tracer(clock=clock, wall_clock=wall, host_ring=4, scope=scopes)
  with pytest.raises(ValueError, match="kind"):
    tracer.span("x", "idle")
  with tracer.span("scheduler/resolve"):
    clock.t = 100.5
    for _ in range(2):
      with tracer.span("scheduler/frame_copy"):
        clock.t += 0.25
    clock.t = 101.5
  with tracer.span("engine/event_wait", "wait"):
    clock.t = 102.0
  # resolve lasted 1.5 s, 0.5 s of it in its two inner copies.
  assert tracer.host_totals() == {
      "engine/event_wait": {"s": 0.5, "n": 1},
      "scheduler/frame_copy": {"s": 0.5, "n": 2},
      "scheduler/resolve": {"s": 1.0, "n": 1}}
  assert scopes.log[:3] == [("enter", "scheduler/resolve"),
                            ("enter", "scheduler/frame_copy"),
                            ("exit", "scheduler/frame_copy")]
  assert scopes.log[-1] == ("exit", "engine/event_wait")
  # Five pieces into a ring of four: resolve [100, 100.5], copy, copy,
  # resolve [101, 101.5], wait (the copies meet: no piece between them);
  # the oldest is pushed out.
  assert tracer.host_dropped == 1
  spans = tracer.host_spans()
  assert [(name, kind) for _, name, kind, _, _ in spans] == [
      ("scheduler/frame_copy", "work"), ("scheduler/frame_copy", "work"),
      ("scheduler/resolve", "work"), ("engine/event_wait", "wait")]
  # On the wall clock: anchor (100.0 s, 7e9 ns), so t -> 7e9 + (t - 100) s.
  assert [(t0, t1) for *_, t0, t1 in spans] == [
      (7_500_000_000, 7_750_000_000), (7_750_000_000, 8_000_000_000),
      (8_000_000_000, 8_500_000_000), (8_500_000_000, 9_000_000_000)]
  assert {thread for thread, *_ in spans} == {"MainThread"}
  snap = tracer.snapshot()
  assert snap["host_totals"] == tracer.host_totals()
  assert snap["host_dropped"] == 1

  # A span open across reset counts from the reset on, on the new anchor.
  clock.t = 199.0
  with tracer.span("scheduler/await_requests", "wait"):
    clock.t, wall.t = 200.0, 50_000_000_000
    tracer.reset()
    assert tracer.host_totals() == {} and tracer.host_spans() == []
    assert tracer.host_dropped == 0
    clock.t = 200.25
  assert tracer.host_totals() == {
      "scheduler/await_requests": {"s": 0.25, "n": 1}}
  assert tracer.host_spans() == [
      ("MainThread", "scheduler/await_requests", "wait", 50_000_000_000,
       50_250_000_000)]


@pytest.fixture(scope="module")
def one_flight():
  """A CPU service on an enabled tracer, and one flight of three
  ``render_async`` requests (the batch fills at three, so the straggler
  window never runs out), each span also a ``debug.named_scope`` range."""
  tracer = Tracer()
  svc = RenderService(device="cpu", tracer=tracer, max_batch=3,
                      max_wait_ms=60_000.0, max_inflight=1)
  try:
    svc.add_synthetic_scenes(1, height=H, width=W, planes=P)
    tracer.reset()
    ns0 = time.time_ns()
    futs = [svc.render_async("scene_000", np.eye(4, dtype=np.float32))
            for _ in range(3)]
    frames = [f.result(60) for f in futs]
    ns1 = time.time_ns()
    yield {"tracer": tracer, "frames": frames, "ns": (ns0, ns1),
           "batches": svc.metrics.batches}
  finally:
    svc.close()


def test_a_flight_records_the_engine_and_scheduler_spans(one_flight):
  tracer = one_flight["tracer"]
  assert one_flight["batches"] == 1
  totals = tracer.host_totals()
  assert {name: totals[name]["n"] for name in (
      "engine/submit", "engine/event_wait", "scheduler/frame_copy",
      "scheduler/resolve")} == {
          "engine/submit": 1, "engine/event_wait": 1,
          "scheduler/frame_copy": 3, "scheduler/resolve": 1}
  assert totals["scheduler/assembly"]["n"] == 1
  assert all(t["s"] >= 0 for t in totals.values())
  spans = tracer.host_spans()
  ns0, ns1 = one_flight["ns"]
  # On the wall clock: every piece after the waiting dispatcher's first
  # opens between the first send and the last frame in hand (the last
  # resolve closes its trace after handing the frame over).
  ours = [s for s in spans if s[1] != "scheduler/await_requests"]
  assert all(ns0 <= t0 <= ns1 and t0 <= t1 for *_, t0, t1 in ours)
  # One thread's pieces never overlap: resolve is cut around its copies.
  by_thread = {}
  for thread, _, _, t0, t1 in spans:
    by_thread.setdefault(thread, []).append((t0, t1))
  for pieces in by_thread.values():
    pieces.sort()
    assert all(a[1] <= b[0] for a, b in zip(pieces, pieces[1:]))
  copies = {s[0] for s in spans if s[1] == "scheduler/frame_copy"}
  assert copies and copies.isdisjoint(
      {s[0] for s in spans if s[1] == "scheduler/await_requests"})


def test_render_async_finishes_one_trace_per_request(one_flight):
  tracer = one_flight["tracer"]
  assert all(f.shape == (H, W, 3) for f in one_flight["frames"])
  recent = tracer.snapshot(recent=16)["recent"]
  assert tracer.finished == 3 and len(recent) == 3
  for record in recent:
    assert record["name"] == "render" and record["error"] is None
    names = {span["name"] for span in record["spans"]}
    assert {"queue_wait", "dispatch"} <= names


def test_an_untraced_service_records_nothing():
  svc = RenderService(device="cpu", max_batch=3, max_wait_ms=0.0)
  try:
    svc.add_synthetic_scenes(1, height=H, width=W, planes=P)
    assert svc.tracer is NULL_TRACER and svc.engine.tracer is NULL_TRACER
    futs = [svc.render_async("scene_000", np.eye(4, dtype=np.float32))
            for _ in range(3)]
    assert all(f.result(60).shape == (H, W, 3) for f in futs)
  finally:
    svc.close()
  assert NULL_TRACER.host_totals() == {}
  assert NULL_TRACER.host_spans() == []
  assert NULL_TRACER.finished == 0


def test_a_profiler_started_inside_a_range_does_not_fail_it():
  """``/debug/profile`` starts the profiler while completers are inside
  ``named_scope`` ranges: those ranges leave the capture, and the request
  goes on."""
  from mpi_vision_tpu_torch.debug import named_scope

  prof = torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU])
  try:
    with named_scope("render/homographies"):
      prof.__enter__()
    with named_scope("render/warp_composite"):
      pass
  finally:
    prof.__exit__(None, None, None)
  names = {e.name for e in prof.events()}
  assert "render/warp_composite" in names
  assert "render/homographies" not in names
