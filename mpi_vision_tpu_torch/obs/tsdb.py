"""On-box time-series ring: bounded history for every metric family.

A copy of ``mpi_vision_tpu/obs/tsdb.py`` with its imports rewritten.

``/stats`` and ``/metrics`` are point-in-time — the question an incident
review actually asks is historical: "what did p99 look like during the
last rolling restart?". A real TSDB answers it, but a serving box must
answer it *without* one: ``TsdbRecorder`` samples the process's own
Prometheus exposition on a fixed cadence and keeps, per series, a
bounded ring of ``(wall_ts, value)`` points — a flight recorder, not a
database. Bounded twice (``max_points`` per series, ``max_series``
total) so a family with runaway label cardinality costs a counter, not
memory.

Served at ``GET /debug/tsdb?family=&recent=&points=`` on serve backends
(and the cluster router, which fans the same query out to every backend
and carries its own ring over the *aggregated* exposition — so one query
reads fleet history). The off-host shipper (``obs/ship.py``) batches
incremental snapshots of the same ring to a collector.

Sampling rides the exposition text through ``obs.prom.parse_metrics_text``
— every family any registry exports (native-histogram buckets, SLO
quantile gauges, edge counters) lands in the ring with zero per-family
wiring, and a family added next PR is recorded automatically.

Clocks are injectable (the serve/-wide rule; clock-lint covers this
file): timestamps are wall time because history is a cross-process
artifact — a router's ring and a backend's ring must be orderable side
by side, like the event log.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque

from mpi_vision_tpu_torch.obs import prom

PREFIX = "mpi_obs_tsdb_"


@dataclasses.dataclass(frozen=True)
class TsdbConfig:
  """Ring knobs (the ``serve``/``cluster`` CLI ``--tsdb-*`` flags map 1:1).

  ``interval_s`` is the sampling cadence; ``max_points`` bounds each
  series' ring (``interval_s * max_points`` of history — 10 s * 512 ~=
  85 min at the defaults); ``max_series`` bounds the whole recorder.

  Compaction (ROADMAP flight-recorder follow-on): with
  ``compact_after_s`` set, points older than it are *thinned* to one
  kept point per ``compact_stride * interval_s`` instead of scrolling
  off the ring — old history trades resolution for span, so the same
  ``max_points`` byte budget covers roughly ``compact_stride`` times
  more wall time at coarse grain while the recent window stays
  full-resolution. None disables (classic pure ring).
  """

  interval_s: float = 10.0
  max_points: int = 512
  max_series: int = 4096
  compact_after_s: float | None = None
  compact_stride: int = 8

  def __post_init__(self):
    if self.interval_s <= 0:
      raise ValueError(f"interval_s must be > 0, got {self.interval_s}")
    if self.max_points < 1:
      raise ValueError(f"max_points must be >= 1, got {self.max_points}")
    if self.max_series < 1:
      raise ValueError(f"max_series must be >= 1, got {self.max_series}")
    if self.compact_after_s is not None and self.compact_after_s <= 0:
      raise ValueError(
          f"compact_after_s must be > 0, got {self.compact_after_s}")
    if self.compact_stride < 2:
      # 1 would "compact" to the identity and silently disable the knob.
      raise ValueError(
          f"compact_stride must be >= 2, got {self.compact_stride}")


class TsdbRecorder:
  """Samples one exposition callable into bounded per-series rings.

  Args:
    collect: ``() -> str`` returning a Prometheus text exposition (a
      service's ``_render_metrics_text``; the router's aggregated one).
    config: ring knobs.
    clock: wall-clock source for point timestamps (injectable).
    sleep-free cadence: ``start()`` runs ``sample()`` every
      ``interval_s`` on a daemon thread gated by a stop event (tests
      drive ``sample()`` directly with a fake clock instead).
  """

  def __init__(self, collect, config: TsdbConfig | None = None,
               clock=time.time):
    self._collect = collect
    self.config = config if config is not None else TsdbConfig()
    self._clock = clock
    self._lock = threading.Lock()
    # (family, sample_name, labels_tuple) -> deque[(ts, value)]
    self._series: dict[tuple, deque] = {}
    self._stop = threading.Event()
    self._thread: threading.Thread | None = None
    self.samples = 0
    self.sample_errors = 0
    self.dropped_series = 0
    self.compacted_points = 0
    # Compaction cadence: at most one point per series crosses the age
    # cutoff per sampling tick, so sweeping every sample would rescan
    # O(all resident points) under the lock for nothing — one sweep per
    # stride drops the same points at 1/stride the cost.
    self._compact_countdown = self.config.compact_stride

  def now(self) -> float:
    """The recorder's wall clock — public so bundle builders (the
    incident recorder's collector) window ``snapshot_since`` against
    the same source that stamped the points."""
    return self._clock()

  # -- sampling ------------------------------------------------------------

  def sample(self) -> int:
    """Take one sample of every family; returns series touched.

    A failing collector costs a counter, never the caller — the
    recorder rides a daemon loop and must not be able to die of one bad
    render.
    """
    try:
      parsed = prom.parse_metrics_text(self._collect())
    except Exception:  # noqa: BLE001 - recording must not kill the loop
      with self._lock:
        self.sample_errors += 1
      return 0
    ts = round(self._clock(), 3)
    touched = 0
    with self._lock:
      for family, fam in parsed.items():
        for (sample_name, labels), value in fam["samples"].items():
          if not math.isfinite(value):
            # NaN ("no data", e.g. idle quantile gauges) and infinities
            # must not enter the ring: json.dumps would emit literal
            # NaN/Infinity tokens — invalid JSON for every /debug/tsdb
            # consumer and ship-sink collector.
            continue
          key = (family, sample_name, labels)
          ring = self._series.get(key)
          if ring is None:
            if len(self._series) >= self.config.max_series:
              self.dropped_series += 1
              continue
            ring = self._series[key] = deque(
                maxlen=self.config.max_points)
          ring.append((ts, float(value)))
          touched += 1
      self.samples += 1
      if self.config.compact_after_s is not None:
        self._compact_countdown -= 1
        if self._compact_countdown <= 0:
          self._compact_countdown = self.config.compact_stride
          self._compact_locked(ts)
    return touched

  def _compact_locked(self, now: float) -> None:
    """Thin every ring's old tail to the coarse stride (idempotent).

    Points with ``ts < now - compact_after_s`` keep only one sample per
    ``compact_stride * interval_s`` of wall time (the oldest in each
    stride window survives — its timestamp anchors the window, so a
    re-run keeps the same points and compaction converges). Recent
    points are untouched.
    """
    cutoff = now - self.config.compact_after_s
    stride_s = self.config.compact_stride * self.config.interval_s
    for key, ring in self._series.items():
      if not ring or ring[0][0] >= cutoff:
        continue  # nothing old enough
      kept: list = []
      last_kept_old: float | None = None
      dropped = 0
      for ts, value in ring:
        if ts >= cutoff:
          kept.append((ts, value))
        elif last_kept_old is None or ts - last_kept_old >= stride_s:
          kept.append((ts, value))
          last_kept_old = ts
        else:
          dropped += 1
      if dropped:
        self._series[key] = deque(kept, maxlen=self.config.max_points)
        self.compacted_points += dropped

  def _loop(self) -> None:
    while not self._stop.wait(self.config.interval_s):
      self.sample()

  def start(self) -> "TsdbRecorder":
    if self._thread is not None:
      raise RuntimeError("TsdbRecorder already started")
    self._thread = threading.Thread(target=self._loop,
                                    name="mpi-obs-tsdb", daemon=True)
    self._thread.start()
    return self

  def stop(self) -> None:
    self._stop.set()
    if self._thread is not None:
      self._thread.join(5.0)
      self._thread = None

  # -- queries -------------------------------------------------------------

  def families(self) -> list[str]:
    with self._lock:
      return sorted({key[0] for key in self._series})

  def query(self, family: str, recent_s: float | None = None,
            points: int | None = None, since_ts: float | None = None) -> dict:
    """Windowed series of one family (the ``/debug/tsdb`` payload).

    ``recent_s`` bounds the window to the trailing seconds, ``points``
    caps points per series (newest kept), ``since_ts`` filters to
    points strictly after a wall timestamp (the shipper's incremental
    cursor).
    """
    floor = None
    if recent_s is not None:
      floor = self._clock() - float(recent_s)
    if since_ts is not None:
      floor = max(floor, float(since_ts)) if floor is not None \
          else float(since_ts)
    out = []
    with self._lock:
      for (fam, sample_name, labels), ring in sorted(self._series.items()):
        if fam != family:
          continue
        pts = [[ts, value] for ts, value in ring
               if floor is None or ts > floor]
        if points is not None:
          # pts[-0:] would be the WHOLE list: <= 0 means none, not all.
          pts = pts[-int(points):] if int(points) > 0 else []
        if pts:
          out.append({"name": sample_name, "labels": dict(labels),
                      "points": pts})
    return {"family": family, "series": out}

  def snapshot_since(self, since_ts: float | None,
                     max_points_per_series: int = 64) -> dict:
    """Every family's points after ``since_ts`` (the shipper's batch
    item). Bounded per series so one batch can never carry the whole
    ring — truncation keeps the OLDEST points: the shipper's cursor
    advances past what was shipped, so a kept-newest cut would strand
    the older points behind the cursor forever, while kept-oldest just
    drains the backlog across ticks."""
    out: dict[str, list] = {}
    with self._lock:
      for (family, sample_name, labels), ring in sorted(
          self._series.items()):
        pts = [[ts, value] for ts, value in ring
               if since_ts is None or ts > since_ts]
        if not pts:
          continue
        out.setdefault(family, []).append({
            "name": sample_name, "labels": dict(labels),
            "points": pts[:max_points_per_series]})
    return out

  # -- introspection -------------------------------------------------------

  def stats(self) -> dict:
    with self._lock:
      return {
          "interval_s": self.config.interval_s,
          "max_points": self.config.max_points,
          "max_series": self.config.max_series,
          "series": len(self._series),
          "points": sum(len(ring) for ring in self._series.values()),
          "families": len({key[0] for key in self._series}),
          "samples": self.samples,
          "sample_errors": self.sample_errors,
          "dropped_series": self.dropped_series,
          "compacted_points": self.compacted_points,
          "compact_after_s": self.config.compact_after_s,
          "compact_stride": self.config.compact_stride,
      }


def parse_query(params: dict) -> tuple[str | None, float | None, int | None]:
  """``(family, recent_s, points)`` from parse_qs output — the one
  ``/debug/tsdb`` parameter contract, shared by the backend and router
  handlers. Raises ValueError on malformed numbers (handlers map it to
  400)."""
  family = params.get("family", [None])[0]
  recent = params.get("recent", [None])[0]
  recent = float(recent) if recent is not None else None
  points = params.get("points", [None])[0]
  points = int(points) if points is not None else None
  return family, recent, points


def registry(stats: dict | None) -> prom.Registry:
  """The ``mpi_obs_tsdb_*`` families (zeros while the ring is off — the
  always-exposed convention, so dashboards never depend on a knob)."""
  stats = stats or {}
  reg = prom.Registry()
  p = PREFIX
  reg.counter(p + "samples_total",
              "Sampling sweeps taken over the exposition.",
              stats.get("samples", 0))
  reg.counter(p + "sample_errors_total",
              "Sampling sweeps that failed (collector raised).",
              stats.get("sample_errors", 0))
  reg.counter(p + "dropped_series_total",
              "New series refused at the max_series cap.",
              stats.get("dropped_series", 0))
  reg.counter(p + "compacted_points_total",
              "Old points thinned to the coarse stride (downsampling).",
              stats.get("compacted_points", 0))
  reg.gauge(p + "series", "Series resident in the ring.",
            stats.get("series", 0))
  reg.gauge(p + "points", "Points resident across all series.",
            stats.get("points", 0))
  return reg
