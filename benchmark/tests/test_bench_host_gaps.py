"""``host_gaps.py`` on synthetic device intervals, CUDA calls and host
spans: the labels' order of precedence, the unattributed idle time, the
per-layer numbers, the clock check, and a summary that is the harness's
own where the program records no host spans."""

import pytest
import torch

from benchmark import common, host_gaps, serving

MS = 1_000_000


def _span(name, kind, t0, t1, thread="t"):
  return (thread, name, kind, t0 * MS, t1 * MS)


def test_a_cuda_call_over_half_the_gap_wins_then_work_then_wait():
  calls = [(0, 6 * MS, "cudaHostAlloc"),
           (20 * MS, 22 * MS, "cudaMemcpyAsync")]
  spans = [_span("scheduler/frame_copy", "work", 1, 5),
           _span("scheduler/await_requests", "wait", 0, 40),
           _span("scheduler/frame_copy", "work", 21, 23),
           _span("scheduler/resolve", "work", 23, 24),
           _span("scheduler/resolve", "work", 24.5, 26)]
  lab = host_gaps.Labeler(calls, spans)
  assert lab.label(0, 10 * MS) == "host in cudaHostAlloc"
  # The call covers 2 of 10 ms: the work spans decide, by their union
  # (resolve's two pieces, 2.5 ms, beat frame_copy's 2 ms).
  assert lab.label(20 * MS, 30 * MS) == "host in scheduler/resolve"
  assert lab.label(30 * MS, 40 * MS) == "host in scheduler/await_requests"
  assert lab.label(50 * MS, 60 * MS) is None
  # Covered by a call or a work span: 0-6, 20-24, 24.5-26 ms.
  assert lab.unattributed([(0, 10 * MS), (20 * MS, 30 * MS),
                           (50 * MS, 60 * MS)]) == (4 + 4.5 + 10) * MS


def test_union_covers_and_leaves_gaps():
  u = host_gaps.Union([(5, 8), (1, 3), (2, 4), (10, 10)])
  assert list(zip(u.starts, u.ends)) == [(1, 4), (5, 8)]
  assert u.covered(0, 6) == 4 and u.covered(4, 5) == 0
  assert u.gaps(0, 12) == [(0, 1), (4, 5), (8, 12)]


def test_layer_numbers_read_nothing_without_host_totals():
  assert host_gaps.layer_numbers(None, 45.0, 30.0, 3.0) == dict.fromkeys(
      ("frame_copy_ms", "event_wait_ms", "submit_ms",
       "dispatcher_starved_share", "idle_unattributed_share"))
  totals = {"scheduler/frame_copy": {"s": 2.0, "n": 400},
            "engine/event_wait": {"s": 3.0, "n": 100},
            "engine/submit": {"s": 0.5, "n": 100},
            "scheduler/await_requests": {"s": 9.0, "n": 50}}
  assert host_gaps.layer_numbers(totals, 45.0, 30.0, 3.0) == pytest.approx({
      "frame_copy_ms": 5.0, "event_wait_ms": 30.0, "submit_ms": 5.0,
      "dispatcher_starved_share": 20.0, "idle_unattributed_share": 10.0})


def test_window_totals_clip_the_pieces_to_the_window():
  spans = [_span("scheduler/await_requests", "wait", -2, 1),
           _span("scheduler/frame_copy", "work", 3, 4),
           _span("scheduler/await_requests", "wait", 9, 30)]
  out = host_gaps.window_totals(spans, 0, 10 * MS)
  assert list(out) == ["scheduler/await_requests", "scheduler/frame_copy"]
  assert out["scheduler/await_requests"] == {"s": pytest.approx(2e-3),
                                             "n": 1}
  assert out["scheduler/frame_copy"] == {"s": pytest.approx(1e-3), "n": 1}


def test_clock_offsets_measure_from_the_last_readback():
  dev = [(0, 0, 10 * MS, "Memcpy DtoH (Device -> Pinned)"),
         (0, 10 * MS, 12 * MS, "render_fused_kernel<4>"),
         (0, 12 * MS, 20 * MS, "Memcpy DtoH (Device -> Pinned)")]
  spans = [_span("engine/event_wait", "wait", 1, 10.2),
           _span("engine/event_wait", "wait", 12, 23),
           _span("engine/event_wait", "wait", -5, -1),
           _span("engine/submit", "work", 0, 1),
           _span("engine/submit", "work", 11, 12)]
  host = [(MS // 2, MS // 2 + 10, "cudaLaunchKernel"),
          (11 * MS, 11 * MS + 5, "cudaMemcpyAsync"),
          (MS - 5, MS + 5, "cudaMemcpyAsync"),
          (5 * MS, 6 * MS, "cudaEventSynchronize")]
  out = host_gaps.clock_offsets(spans, dev, host)
  assert out["waits"] == 3 and out["within"] == 1
  assert out["share"] == pytest.approx(1 / 3)
  assert out["launches"] == 3
  assert out["launches_inside_submit"] == pytest.approx(2 / 3)
  assert host_gaps.clock_offsets(spans, dev[1:2], host) is None
  calls = host_gaps.cuda_call_seconds(host, spans)
  assert calls["by_name"]["cudaEventSynchronize"] == pytest.approx(1e-3)
  assert calls["in_submit_s"] == pytest.approx(20e-9)


def _fake(cls, dev, host):
  """A finished traced window of ``cls`` on ``cuda:0``: 0-100 ms, with
  synthetic device events and CUDA calls."""

  class Fake(cls):

    def __init__(self):
      super().__init__(torch, ["cuda:0"], False)
      self._prof, self._ns0, self._ns1, self.window_s = (
          object(), 0, 100 * MS, 0.1)

    def _events(self):
      return dev, host

  return Fake()


class _ParentTracer:
  """A tracer as a program without host spans has it."""

  def snapshot(self, recent=32):
    return {"recent": []}


class _Tracer(_ParentTracer):
  host_dropped = 0

  def host_spans(self):
    return [_span("scheduler/frame_copy", "work", 30, 55),
            _span("engine/event_wait", "wait", 60, 75)]

  def host_totals(self):
    return {"scheduler/frame_copy": {"s": 0.025, "n": 5},
            "engine/event_wait": {"s": 0.015, "n": 1}}


DEV = [(0, 10 * MS, 20 * MS, "Memcpy HtoD (Pageable -> Device)"),
       (0, 60 * MS, 70 * MS, "Memcpy DtoH (Device -> Pinned)")]
HOST = [(0, 8 * MS, "cudaHostAlloc"), (21 * MS, 22 * MS, "cudaLaunchKernel")]


@pytest.mark.parametrize("spans", [False, True], ids=["none", "spans"])
def test_summary_names_gaps_by_spans_and_is_unchanged_without(monkeypatch,
                                                             spans):
  harness = common.DeviceTrace
  plain = _fake(harness, DEV, HOST).summary()
  svc = type("Svc", (), {"tracer": _Tracer() if spans else _ParentTracer()})
  monkeypatch.setattr(serving, "prepare",
                      lambda ctx, n: serving.Served(svc, [], None, None))
  sink = {}
  with host_gaps.span_summaries(sink):
    serving.prepare(None, 1)
    out = _fake(common.DeviceTrace, DEV, HOST).summary()
  assert common.DeviceTrace is harness  # restored on exit
  report = sink["host_spans"]
  if not spans:
    assert out == plain
    assert set(report["numbers"].values()) == {None}
    return
  # Gaps 20-60, 70-100, 0-10 ms: the copy covers 25 of 40 ms past a 1 ms
  # launch; nothing works in 70-100, the wait covers 5 ms of it; the
  # allocation covers 8 of 10 ms.
  gaps = out["breakdown"]["idle_gaps"]
  assert [g[0] for g in gaps] == ["host in scheduler/frame_copy",
                                  "host in engine/event_wait",
                                  "host in cudaHostAlloc"]
  assert [g[1] for g in gaps] == [g[1] for g in
                                  plain["breakdown"]["idle_gaps"]]
  assert report["longest"][0][:2] == [
      "host in scheduler/frame_copy", plain["breakdown"]["idle_gaps"][0][0]]
  # Idle 80 ms; covered by calls or work spans 8 + 1 + 25 ms.
  assert report["numbers"]["idle_unattributed_share"] == pytest.approx(
      100 * 46 / 80)
  # Read from the spans inside the window: one copy of 25 ms.
  assert report["numbers"]["frame_copy_ms"] == pytest.approx(25.0)
  assert report["clock"]["within"] == 0 and report["clock"]["waits"] == 1
  assert out["busy_s"] == plain["busy_s"]
