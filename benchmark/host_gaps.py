#!/usr/bin/env python3
"""Name the card's idle gaps by the program's host spans, and read the
spans by layer: one run of a serving cell as ``run.py --trace 1`` runs it.

    python3 benchmark/host_gaps.py --workload mpi1080p32.burst_1scene \\
        --seed <n> --seconds 45

The service's tracer records host spans (``obs/trace.py`` ``Tracer.span``)
on the wall clock's nanoseconds, which the profiler's events share. This
runs ``run.py``'s traced run with ``DeviceTrace.summary`` extended: an idle
gap of the first card that no CUDA call covers for over half its length
is named by the ``work`` span name that covers most of it, else by the
``wait`` span name that does, as ``host in <span>``; the printed line's
``breakdown`` carries those labels. Before the result line it prints one
line, ``{"host_spans": ...}``: the span totals (the program's, and the
window's from the spans), the per-layer numbers (``layer_numbers``, from
the window's), the idle seconds by label, the longest gaps with both
labels, the clock check (``clock_offsets``) and the CUDA calls' seconds.

Against a program whose tracer records no host spans the labels are
``run.py``'s and the numbers are None.
"""

from __future__ import annotations

import bisect
import contextlib
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class Union:
  """The union of ``(t0, t1)`` intervals, sorted and disjoint, for
  coverage queries."""

  def __init__(self, intervals):
    merged = []
    for t0, t1 in sorted(intervals):
      if merged and t0 <= merged[-1][1]:
        merged[-1][1] = max(merged[-1][1], t1)
      elif t1 > t0:
        merged.append([t0, t1])
    self.starts = [t0 for t0, _ in merged]
    self.ends = [t1 for _, t1 in merged]

  def covered(self, a, b):
    """Length of ``[a, b]`` inside the union."""
    total, i = 0, bisect.bisect_right(self.ends, a)
    while i < len(self.starts) and self.starts[i] < b:
      total += min(b, self.ends[i]) - max(a, self.starts[i])
      i += 1
    return total

  def gaps(self, lo, hi) -> list[tuple]:
    """The intervals of ``[lo, hi]`` outside the union."""
    edges = [lo] + [x for pair in zip(self.starts, self.ends)
                    for x in pair] + [hi]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


class Labeler:
  """Labels idle gaps from the CUDA calls ``(t0, t1, name)`` and the host
  spans ``(thread, name, kind, t0_ns, t1_ns)`` of one window."""

  def __init__(self, host_calls: list, spans: list):
    self.calls = sorted(host_calls)
    self._call_starts = [t0 for t0, _, _ in self.calls]
    self._call_longest = max((t1 - t0 for t0, t1, _ in self.calls),
                             default=0)
    self.by_kind = {}
    for kind in ("work", "wait"):
      names = {}
      for _, name, k, t0, t1 in spans:
        if k == kind:
          names.setdefault(name, []).append((t0, t1))
      self.by_kind[kind] = {n: Union(v) for n, v in sorted(names.items())}
    self._cover = Union([(t0, t1) for t0, t1, _ in self.calls]
                        + [(t0, t1) for _, _, k, t0, t1 in spans
                           if k == "work"])

  def label(self, a, b) -> str | None:
    """``host in <name>``: the CUDA call covering over half of ``[a, b]``,
    else the work span name covering most of it, else the wait span name;
    None where none overlaps."""
    lo = bisect.bisect_left(self._call_starts, a - self._call_longest)
    hi = bisect.bisect_left(self._call_starts, b)
    over = max(((min(b, t1) - max(a, t0), n)
                for t0, t1, n in self.calls[lo:hi] if t1 > a),
               default=(0, None))
    if over[1] is not None and over[0] > 0.5 * (b - a):
      return f"host in {over[1]}"
    for kind in ("work", "wait"):
      best = max(((u.covered(a, b), name)
                  for name, u in self.by_kind[kind].items()),
                 default=(0, None))
      if best[0] > 0:
        return f"host in {best[1]}"
    return None

  def unattributed(self, gaps) -> int:
    """How much of ``gaps`` no work span and no CUDA call covers."""
    return sum((b - a) - self._cover.covered(a, b) for a, b in gaps)


def layer_numbers(totals: dict | None, window_s: float | None,
                  idle_s: float | None = None,
                  unattributed_s: float | None = None) -> dict:
  """The per-layer numbers the spans give, each None where the run gave
  nothing to read: ms a frame copy, ms a flight blocked on its event, ms
  a flight's submit, the window's share (%) the dispatcher waited for
  work, and the share (%) of the first card's idle time that no work span
  or CUDA call covers."""

  def per_span_ms(name):
    t = (totals or {}).get(name)
    return 1e3 * t["s"] / t["n"] if t and t["n"] else None

  starved = (totals or {}).get("scheduler/await_requests")
  return {
      "frame_copy_ms": per_span_ms("scheduler/frame_copy"),
      "event_wait_ms": per_span_ms("engine/event_wait"),
      "submit_ms": per_span_ms("engine/submit"),
      "dispatcher_starved_share": (100.0 * starved["s"] / window_s
                                   if starved and window_s else None),
      "idle_unattributed_share": (
          100.0 * unattributed_s / idle_s
          if totals and idle_s and unattributed_s is not None else None),
  }


def window_totals(spans: list, lo: int, hi: int) -> dict:
  """``host_totals``' form for the spans' pieces inside ``[lo, hi]``:
  seconds clipped to the window and the pieces that start in it. The
  program's totals run from the window's start to when they are read,
  seconds later, while the dispatcher waits for requests that no longer
  come."""
  out = {}
  for _, name, _, t0, t1 in spans:
    if t1 > lo and t0 < hi:
      total = out.setdefault(name, {"s": 0.0, "n": 0})
      total["s"] += (min(t1, hi) - max(t0, lo)) * 1e-9
      total["n"] += t0 >= lo
  return dict(sorted(out.items()))


def clock_offsets(spans: list, dev: list, host: list,
                  within_ns: int = 1_000_000) -> dict | None:
  """Do the spans and the profiler's events share a clock? Two readings:

  * ``waits``: for each ``engine/event_wait`` span, nanoseconds from the
    end of the last ``Memcpy DtoH`` that ended before the span did to
    the span's end, and how many lie within ``within_ns``. A wait ends
    after its readback, later by the time its thread takes to run Python
    again.
  * ``launches``: the share of the CUDA calls that only ``engine/submit``
    makes in the window (``cudaLaunchKernel``, ``cudaMemcpyAsync``) that
    lie inside one of its spans, which hold them with microseconds to
    spare where the clocks agree.

  None without readbacks or waits."""
  from benchmark import common

  ends = sorted(t1 for _, _, t1, name in dev if "DtoH" in name)
  waits = [t1 for _, name, _, _, t1 in spans if name == "engine/event_wait"]
  if not ends or not waits:
    return None
  offsets = []
  for t1 in waits:
    j = bisect.bisect_right(ends, t1)
    if j:
      offsets.append(t1 - ends[j - 1])
  within = sum(1 for o in offsets if o <= within_ns)
  submits = Union((t0, t1) for _, name, _, t0, t1 in spans
                  if name == "engine/submit")
  calls = [(t0, t1) for t0, t1, name in host
           if name in ("cudaLaunchKernel", "cudaMemcpyAsync")]
  inside = sum(1 for t0, t1 in calls if submits.covered(t0, t1) == t1 - t0)
  return {"waits": len(waits), "within": within,
          "share": within / len(waits),
          "offset_ns": {f"p{round(q * 100):02d}": common.quantile(offsets, q)
                        for q in (0.05, 0.5, 0.95)},
          "launches": len(calls),
          "launches_inside_submit": inside / len(calls) if calls else None}


def cuda_call_seconds(host: list, spans: list, top: int = 8) -> dict:
  """Seconds of the CUDA calls by name, and of those made inside
  ``engine/submit`` spans: what of a submit is the runtime's."""
  submits = Union((t0, t1) for _, name, _, t0, t1 in spans
                  if name == "engine/submit")
  by_name, in_submit = {}, 0
  for t0, t1, name in host:
    by_name[name] = by_name.get(name, 0.0) + (t1 - t0) * 1e-9
    in_submit += submits.covered(t0, t1)
  return {"by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[
      :top]), "in_submit_s": in_submit * 1e-9}


def analyse(dt, tracer, top: int = 10) -> tuple[dict, list]:
  """The ``host_spans`` report of a traced window, and the labels of its
  ``top`` longest gaps in ``DeviceTrace.summary``'s order (None: no span
  or CUDA call overlaps)."""
  spans = tracer.host_spans() if hasattr(tracer, "host_spans") else []
  totals = tracer.host_totals() if hasattr(tracer, "host_totals") else None
  dev, host = dt._events()
  lo, hi = dt._ns0, dt._ns1
  in_window = window_totals(spans, lo, hi) if spans else None
  if dev:  # as DeviceTrace.summary widens it
    lo, hi = min(lo, min(e[1] for e in dev)), max(hi, max(e[2] for e in dev))
  first = min(dt.torch.device(d).index or 0 for d in dt.devices)
  gaps = Union((t0, t1) for i, t0, t1, _ in dev if i == first).gaps(lo, hi)
  labeler = Labeler(host, spans)
  idle_ns = sum(b - a for a, b in gaps)
  by_label = {}
  for a, b in gaps:
    name = labeler.label(a, b) or "unattributed"
    by_label[name] = by_label.get(name, 0.0) + (b - a) * 1e-9
  unattributed_s = labeler.unattributed(gaps) * 1e-9 if spans else None
  longest = sorted(((b - a, a, b) for a, b in gaps), reverse=True)[:top]
  report = {
      "totals": totals, "window_totals": in_window, "spans": len(spans),
      "dropped": getattr(tracer, "host_dropped", None),
      "window_s": dt.window_s, "idle_s": idle_ns * 1e-9, "gaps": len(gaps),
      "numbers": layer_numbers(in_window if totals else None,
                               dt.window_s, idle_ns * 1e-9,
                               unattributed_s),
      "idle_s_by_label": dict(sorted(by_label.items(),
                                     key=lambda kv: -kv[1])),
      "clock": clock_offsets(spans, dev, host),
      "cuda_calls": cuda_call_seconds(host, spans),
  }
  return report, [labeler.label(a, b) for _, a, b in longest]


@contextlib.contextmanager
def span_summaries(sink: dict):
  """Run the harness with ``DeviceTrace.summary`` labelling gaps by the
  service's host spans; the report lands in ``sink["host_spans"]``."""
  from benchmark import common, serving

  prepare, device_trace = serving.prepare, common.DeviceTrace
  served = {}

  def prepare_and_keep(ctx, n_scenes):
    served["it"] = prepare(ctx, n_scenes)
    return served["it"]

  class SpanTrace(device_trace):

    def summary(self, top: int = 10):
      out = super().summary(top)
      if out is None or "it" not in served:
        return out
      report, labels = analyse(self, served["it"].svc.tracer, top)
      gaps = out["breakdown"]["idle_gaps"]
      report["longest"] = [[new, old, length]
                           for new, (old, length) in zip(labels, gaps)]
      out["breakdown"]["idle_gaps"] = [
          [new or old, length] for new, (old, length) in zip(labels, gaps)]
      sink["host_spans"] = report
      return out

  serving.prepare, common.DeviceTrace = prepare_and_keep, SpanTrace
  try:
    yield sink
  finally:
    serving.prepare, common.DeviceTrace = prepare, device_trace


def main(argv=None) -> int:
  sys.path.insert(0, str(ROOT))
  from benchmark import run

  args = list(sys.argv[1:] if argv is None else argv)
  if "--trace" not in args:
    args += ["--trace", "1"]
  sink, line = {}, io.StringIO()
  with span_summaries(sink), contextlib.redirect_stdout(line):
    rc = run.main(args)
  print(json.dumps({"host_spans": sink.get("host_spans")}), flush=True)
  sys.stdout.write(line.getvalue())
  return rc


if __name__ == "__main__":
  sys.exit(main())
