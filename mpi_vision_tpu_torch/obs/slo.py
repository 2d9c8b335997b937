"""SLO engine: sliding-window objectives + multi-window burn-rate alerts.

A copy of ``mpi_vision_tpu/obs/slo.py`` with its imports rewritten. The
judgment layer on top of the raw telemetry (the serving counters say what
happened; this module says whether the service is *meeting objectives*).
Objectives over the serve request stream:

  * **availability** — a request is good when it completed without an
    error (errors, queue sheds, and breaker fast-fails are bad events:
    the user saw a failure either way).
  * **latency** — a *completed* request is good when its end-to-end
    latency is under ``latency_threshold_s`` (FastNeRF's 200 FPS target
    is only meaningful against exactly this kind of tracked bound).
  * **latency quantile** (``quantile`` set, e.g. 0.99 — the flight-
    recorder upgrade): "p99 render < threshold", judged from a **native
    histogram** (``obs/hist.py``) pooled over the window's time buckets
    — percentile-true, not a fixed threshold count. With ``per_scene``
    on, the same objective is additionally judged per scene over the
    bounded per-scene table, so one hot scene's tail pages before it
    drowns in the fleet average (alert names ``latency_p99:scene_007``).

Alerting follows the SRE-workbook multi-window burn-rate scheme: the
**burn rate** is ``(1 - attainment) / (1 - target)`` — 1.0 means the
error budget is being consumed exactly at the sustainable rate, 10x
means ten times too fast. An alert fires when the burn rate exceeds
``burn_threshold`` over BOTH the slow window (the problem is material)
and the fast window (the problem is happening *now*, not a stale spike
still inside the long window), and clears as soon as the fast window's
burn drops back under the threshold — recovery is visible within
``fast_window_s`` instead of lingering for the whole slow window.
Quantile alerts use the same two-window shape with the quantile itself
as the signal: fire when the windowed quantile exceeds the threshold in
both windows, clear when the fast window's quantile recovers; their
reported ``burn_rate`` is the ``quantile / threshold`` ratio.

Implementation is a ring of coarse time buckets (O(1) record, O(buckets)
snapshot, bounded memory regardless of traffic; each bucket carries a
small native histogram when the quantile objective is on), driven
entirely by an injectable clock so every rotation/alert edge is testable
with fake time.

``verdict()`` turns a snapshot into a pass/fail block against explicit
objectives. The JAX module's ``registry()``/``metrics_text()`` (its
``mpi_slo_*`` Prometheus families) wait for the port's ``/metrics``.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time

from mpi_vision_tpu_torch.obs import hist as hist_mod

_OBJECTIVES = ("availability", "latency")

# Per-scene quantile tracking is bounded exactly like the per-scene
# latency table in serve/metrics.py: at most this many distinct scenes,
# the rest aggregated under "_other" so scene-id cardinality can never
# balloon the ring.
PER_SCENE_CAP = 32


@dataclasses.dataclass(frozen=True)
class SloConfig:
  """Objectives + alerting knobs (the ``serve`` CLI flags map 1:1).

  Defaults suit a serving demo fleet: 99% availability, 95% of requests
  under 1 s, alert at 10x budget burn confirmed over a 60 s fast / 600 s
  slow window pair. ``min_requests`` keeps a single bad request on an
  idle service from paging. ``quantile`` (``--slo-quantile``, e.g. 0.99)
  adds the histogram-quantile objective "p-quantile latency under
  ``latency_threshold_s``"; ``per_scene`` (``--slo-per-scene``)
  additionally judges it per scene.
  """

  availability_target: float = 0.99
  latency_threshold_s: float = 1.0
  latency_target: float = 0.95
  fast_window_s: float = 60.0
  slow_window_s: float = 600.0
  burn_threshold: float = 10.0
  bucket_s: float | None = None  # None: fast_window_s / 12, floored 0.25
  min_requests: int = 10
  quantile: float | None = None  # e.g. 0.99; None = no quantile objective
  per_scene: bool = False

  def __post_init__(self):
    for name in ("availability_target", "latency_target"):
      v = getattr(self, name)
      if not 0.0 < v < 1.0:
        raise ValueError(f"{name} must be in (0, 1), got {v}")
    if self.latency_threshold_s <= 0:
      raise ValueError(
          f"latency_threshold_s must be > 0, got {self.latency_threshold_s}")
    if not 0 < self.fast_window_s <= self.slow_window_s:
      raise ValueError(
          f"need 0 < fast_window_s <= slow_window_s, got "
          f"{self.fast_window_s} / {self.slow_window_s}")
    if self.burn_threshold <= 0:
      raise ValueError(
          f"burn_threshold must be > 0, got {self.burn_threshold}")
    if self.bucket_s is not None and not (
        0 < self.bucket_s <= self.fast_window_s):
      raise ValueError(
          f"bucket_s must be in (0, fast_window_s], got {self.bucket_s}")
    if self.quantile is not None and not 0.0 < self.quantile < 1.0:
      raise ValueError(
          f"quantile must be in (0, 1), got {self.quantile}")
    if self.per_scene and self.quantile is None:
      raise ValueError("per_scene objectives require quantile (the "
                       "per-scene objective IS the quantile one)")

  def resolved_bucket_s(self) -> float:
    if self.bucket_s is not None:
      return float(self.bucket_s)
    return max(self.fast_window_s / 12.0, 0.25)

  def target(self, objective: str) -> float:
    return (self.availability_target if objective == "availability"
            else self.latency_target)

  def quantile_name(self) -> str | None:
    """The quantile objective's name ("latency_p99" for 0.99)."""
    if self.quantile is None:
      return None
    return f"latency_p{self.quantile * 100:g}"


class _Alert:
  """One objective's fire/clear state machine (single-threaded under the
  tracker's lock)."""

  __slots__ = ("firing", "fired", "cleared", "since")

  def __init__(self):
    self.firing = False
    self.fired = 0
    self.cleared = 0
    self.since: float | None = None  # tracker-clock time of last fire


class _Bucket:
  """One time bucket of the sliding window (plus its native histogram
  and bounded per-scene histograms when the quantile objective is on)."""

  __slots__ = ("idx", "total", "bad", "lat_total", "lat_bad", "hist",
               "scenes")

  def __init__(self, idx: int, with_hist: bool):
    self.idx = idx
    self.total = 0
    self.bad = 0
    self.lat_total = 0
    self.lat_bad = 0
    self.hist = hist_mod.NativeHistogram() if with_hist else None
    self.scenes: dict[str, hist_mod.NativeHistogram] | None = (
        {} if with_hist else None)


def burn_rate(bad: int, total: int, target: float) -> float:
  """Error-budget consumption rate over one window (0 when idle)."""
  if total <= 0:
    return 0.0
  return (bad / total) / (1.0 - target)


def worst_exemplar(hist) -> dict | None:
  """The largest-valued trace exemplar across a histogram's buckets —
  the request an operator chasing a quantile alert wants to click
  through first (resolvable at ``/debug/traces`` while the ring holds
  it). None when no recorded latency carried a trace id."""
  if hist is None or not hist.exemplars:
    return None
  tid, value = max(hist.exemplars.values(), key=lambda pair: pair[1])
  return {"trace_id": tid, "value_ms": round(value * 1e3, 3)}


class SloTracker:
  """Sliding-window SLO accounting + burn-rate alerting over requests.

  Args:
    config: objectives + alert knobs.
    clock: injectable monotonic clock driving bucket rotation and alert
      edges (share with the serving stack's other clocks).
    on_alert: optional ``(objective, firing, details) -> None`` callback
      fired on every alert transition (the serving layer routes it into
      the event log). Per-scene quantile alerts arrive with names like
      ``latency_p99:scene_007`` and a ``scene`` detail. Exceptions are
      swallowed and counted — alerting must not be able to fail the
      request path.
  """

  def __init__(self, config: SloConfig | None = None, clock=time.monotonic,
               on_alert=None):
    self.config = config if config is not None else SloConfig()
    self._clock = clock
    self.on_alert = on_alert
    self._bucket_s = self.config.resolved_bucket_s()
    # +1: the current (partial) bucket rides along with a full slow
    # window of closed ones.
    self._ring_len = int(math.ceil(
        self.config.slow_window_s / self._bucket_s)) + 1
    self._lock = threading.Lock()
    self.alert_errors = 0
    self.reset()

  def reset(self) -> None:
    """Drop all window state and alert history (load generators call
    this after warm-up, mirroring ``ServeMetrics.reset``)."""
    with self._lock:
      self._buckets: list[_Bucket] = []
      self._alerts: dict[str, _Alert] = {
          name: _Alert() for name in _OBJECTIVES}
      qname = self.config.quantile_name()
      if qname is not None:
        self._alerts[qname] = _Alert()
      # Bounded per-scene key table (the "_other" overflow mirrors
      # serve/metrics.py's per-scene cap).
      self._scene_keys: set[str] = set()
      # Memo for the merged quantile windows: (total, bucket idx) ->
      # result. See _quantile_windows_locked.
      self._qwindows_memo: tuple | None = None
      self.total = 0
      self.bad = 0

  # -- recording -----------------------------------------------------------

  def _bucket_locked(self, now: float) -> tuple[_Bucket, bool]:
    """The current bucket, plus whether it was freshly opened."""
    idx = int(now // self._bucket_s)
    rotated = not self._buckets or self._buckets[-1].idx < idx
    if rotated:
      self._buckets.append(
          _Bucket(idx, with_hist=self.config.quantile is not None))
      floor = idx - self._ring_len + 1
      while self._buckets and self._buckets[0].idx < floor:
        self._buckets.pop(0)
    return self._buckets[-1], rotated

  def _scene_key_locked(self, scene_id: str) -> str:
    key = str(scene_id)
    if key not in self._scene_keys:
      if len(self._scene_keys) >= PER_SCENE_CAP:
        return "_other"
      self._scene_keys.add(key)
    return key

  def record(self, ok: bool, latency_s: float | None = None,
             count: int = 1, scene_id: str | None = None,
             trace_id: str | None = None, availability: bool = True) -> None:
    """Account ``count`` request outcomes.

    ``ok=False`` consumes availability budget; ``latency_s`` (completed
    requests only) additionally scores the latency objective and — with
    the quantile objective on — lands in the window's native histogram
    (``scene_id`` additionally in the bounded per-scene one).
    ``trace_id`` becomes the latency's bucket exemplar, so a quantile
    alert carries a worst-offender trace resolvable at /debug/traces.
    ``availability=False`` scores ONLY the latency objective — for
    streams whose success accounting rides separate events (the train
    queue: attempt outcomes are the availability signal; per-step
    latency samples must not dilute it with good events).
    """
    with self._lock:
      bucket, rotated = self._bucket_locked(self._clock())
      bad = not ok
      if availability:
        bucket.total += count
        self.total += count
        if bad:
          bucket.bad += count
          self.bad += count
      if latency_s is not None:
        bucket.lat_total += count
        if latency_s > self.config.latency_threshold_s:
          bucket.lat_bad += count
          bad = True
        if bucket.hist is not None:
          for _ in range(count):
            bucket.hist.record(latency_s, exemplar=trace_id)
          if self.config.per_scene and scene_id is not None:
            key = self._scene_key_locked(scene_id)
            scene_hist = bucket.scenes.get(key)
            if scene_hist is None:
              scene_hist = bucket.scenes[key] = hist_mod.NativeHistogram()
            for _ in range(count):
              scene_hist.record(latency_s, exemplar=trace_id)
      # The full alert evaluation walks the whole bucket ring; this is
      # the serving hot path (every completed request lands here), so
      # only run it when an edge is actually possible: a bad event can
      # FIRE, any event can CLEAR a firing alert (good traffic dilutes
      # the fast burn), and a bucket rotation ages bad history out.
      # Healthy steady state — good events, nothing firing — pays one
      # scan per bucket_s instead of one per request; snapshot()/
      # alerts_firing() still re-check on every scrape. Quantile edges
      # are evaluated only on ROTATION (record-side): their evaluation
      # merges every in-window histogram — far too heavy to run per bad
      # request during exactly the incident that makes requests bad —
      # and the windowed quantile only moves materially at bucket
      # granularity anyway. Scrapes (healthz probes, /stats, /metrics)
      # still evaluate them every time, so quantile alert latency is
      # bounded by min(bucket_s, scrape interval).
      need_check = (bad or rotated
                    or any(a.firing for a in self._alerts.values()))
    if need_check:
      self.check(quantiles=rotated)

  def record_bad(self, count: int = 1) -> None:
    """Shorthand for failures with no latency sample (errors, sheds)."""
    self.record(ok=False, count=count)

  def fast_burn(self) -> float:
    """The hottest fast-window burn rate across both objectives — the
    brownout controller's overload signal.

    Cheap (one ring walk, no histogram merge) because it is read on the
    admission path. Objectives under ``min_requests`` in the window read
    0.0: a cold window must not read as an outage, and an emptying
    window is exactly how the ladder recovers.
    """
    with self._lock:
      now = self._clock()
      total, bad, lat_total, lat_bad = self._window_locked(
          now, self.config.fast_window_s)
    worst = 0.0
    if total >= self.config.min_requests:
      worst = burn_rate(bad, total, self.config.availability_target)
    if lat_total >= self.config.min_requests:
      worst = max(worst,
                  burn_rate(lat_bad, lat_total, self.config.latency_target))
    return worst

  # -- window math ---------------------------------------------------------

  def _window_floor(self, now: float, window_s: float) -> int:
    return int(now // self._bucket_s) - int(
        math.ceil(window_s / self._bucket_s)) + 1

  def _window_locked(self, now: float, window_s: float) -> tuple:
    """(total, bad, lat_total, lat_bad) over the trailing window."""
    floor = self._window_floor(now, window_s)
    total = bad = lat_total = lat_bad = 0
    for bucket in self._buckets:
      if bucket.idx >= floor:
        total += bucket.total
        bad += bucket.bad
        lat_total += bucket.lat_total
        lat_bad += bucket.lat_bad
    return total, bad, lat_total, lat_bad

  def _burns_locked(self, now: float) -> dict:
    """Per-objective per-window (total, bad, burn) triples."""
    out = {}
    for wname, wsec in (("fast", self.config.fast_window_s),
                        ("slow", self.config.slow_window_s)):
      total, bad, lat_total, lat_bad = self._window_locked(now, wsec)
      out.setdefault("availability", {})[wname] = (
          total, bad,
          burn_rate(bad, total, self.config.availability_target))
      out.setdefault("latency", {})[wname] = (
          lat_total, lat_bad,
          burn_rate(lat_bad, lat_total, self.config.latency_target))
    return out

  def _window_hists_locked(self, now: float, window_s: float) -> tuple:
    """``(pooled_hist, {scene: pooled_hist})`` over the trailing window
    — the native-histogram merge that makes windowed quantiles exact
    (per-bucket counts add; no re-bucketing)."""
    floor = self._window_floor(now, window_s)
    pooled = hist_mod.NativeHistogram()
    scenes: dict[str, hist_mod.NativeHistogram] = {}
    for bucket in self._buckets:
      if bucket.idx < floor or bucket.hist is None:
        continue
      pooled.merge_from(bucket.hist)
      if bucket.scenes:
        for key, scene_hist in bucket.scenes.items():
          acc = scenes.get(key)
          if acc is None:
            acc = scenes[key] = hist_mod.NativeHistogram()
          acc.merge_from(scene_hist)
    return pooled, scenes

  def _quantile_windows_locked(self, now: float) -> dict | None:
    """``{"fast": (hist, scene_hists), "slow": (...)}`` or None when the
    quantile objective is off.

    Memoized on ``(total events, current bucket index)``: the merged
    windows only change when data arrives or the window slides a bucket,
    but one scrape evaluates them several times (``alerts_firing`` +
    ``snapshot`` + the snapshot's own window entries) and a healthz
    probe must not pay the full ring-merge three times per poll. The
    memoized histograms are read-only to every consumer.
    """
    if self.config.quantile is None:
      return None
    key = (self.total, int(now // self._bucket_s))
    if self._qwindows_memo is not None and self._qwindows_memo[0] == key:
      return self._qwindows_memo[1]
    out = {
        "fast": self._window_hists_locked(now, self.config.fast_window_s),
        "slow": self._window_hists_locked(now, self.config.slow_window_s),
    }
    self._qwindows_memo = (key, out)
    return out

  # -- alerting ------------------------------------------------------------

  def _alert_locked(self, name: str) -> _Alert:
    alert = self._alerts.get(name)
    if alert is None:
      alert = self._alerts[name] = _Alert()
    return alert

  def check(self, quantiles: bool = True) -> list[str]:
    """Evaluate alert transitions; returns objectives that CHANGED state.

    Called from every ``record`` and every ``snapshot`` (so a scrape of
    an idle service still clears a stale alert once the fast window
    drains). ``quantiles=False`` (record's mid-bucket calls) skips the
    quantile objectives: their evaluation merges every in-window
    histogram, which must not run per request on the serving hot path.
    """
    transitions = []
    callbacks = []
    with self._lock:
      now = self._clock()
      burns = self._burns_locked(now)
      thr = self.config.burn_threshold
      for name in _OBJECTIVES:
        fast_total, _, fast_burn = burns[name]["fast"]
        slow_total, _, slow_burn = burns[name]["slow"]
        alert = self._alerts[name]
        if not alert.firing:
          # Fire: budget burning too fast over BOTH windows (the fast
          # window confirms the problem is current), with enough traffic
          # in the fast window to mean anything.
          if (fast_total >= self.config.min_requests
              and fast_burn >= thr and slow_burn >= thr):
            alert.firing = True
            alert.fired += 1
            alert.since = now
            transitions.append(name)
            callbacks.append((name, True, {
                "fast_burn": round(fast_burn, 3),
                "slow_burn": round(slow_burn, 3),
                "threshold": thr}))
        elif fast_burn < thr:
          # Clear: the fast window says the bleeding stopped (the slow
          # window may stay elevated for its whole width — that is
          # history, not an ongoing incident).
          alert.firing = False
          alert.cleared += 1
          alert.since = None
          transitions.append(name)
          callbacks.append((name, False, {
              "fast_burn": round(fast_burn, 3), "threshold": thr}))
      qwindows = (self._quantile_windows_locked(now) if quantiles
                  else None)
      if qwindows is not None:
        qname = self.config.quantile_name()
        fast_hist, fast_scenes = qwindows["fast"]
        slow_hist, slow_scenes = qwindows["slow"]
        self._check_quantile_locked(
            qname, None, fast_hist, slow_hist, now, transitions, callbacks)
        if self.config.per_scene:
          # Every scene in the slow window, plus any scene whose alert
          # is still firing (its traffic may have vanished — the clear
          # edge must still happen).
          firing_scenes = {n.partition(":")[2] for n, a in
                          self._alerts.items()
                          if ":" in n and a.firing}
          for scene in sorted(set(slow_scenes) | firing_scenes):
            self._check_quantile_locked(
                f"{qname}:{scene}", scene, fast_scenes.get(scene),
                slow_scenes.get(scene), now, transitions, callbacks)
    for name, firing, details in callbacks:
      if self.on_alert is not None:
        try:
          self.on_alert(name, firing, details)
        except Exception:  # noqa: BLE001 - alerting must not fail requests
          with self._lock:
            self.alert_errors += 1
    return transitions

  def _check_quantile_locked(self, name, scene, fast_hist, slow_hist,
                             now, transitions, callbacks) -> None:
    """One quantile alert's fire/clear decision (global or per-scene)."""
    cfg = self.config
    thr_s = cfg.latency_threshold_s
    fast_q = fast_hist.quantile(cfg.quantile) if fast_hist is not None \
        else None
    slow_q = slow_hist.quantile(cfg.quantile) if slow_hist is not None \
        else None
    alert = self._alert_locked(name)
    detail_base = {"quantile": cfg.quantile,
                   "threshold_ms": round(thr_s * 1e3, 3)}
    if scene is not None:
      detail_base["scene"] = scene
    if not alert.firing:
      if (fast_hist is not None and fast_hist.count >= cfg.min_requests
          and fast_q is not None and fast_q > thr_s
          and slow_q is not None and slow_q > thr_s):
        alert.firing = True
        alert.fired += 1
        alert.since = now
        transitions.append(name)
        exemplar = worst_exemplar(slow_hist) or worst_exemplar(fast_hist)
        callbacks.append((name, True, {
            **detail_base,
            "fast_ms": round(fast_q * 1e3, 3),
            "slow_ms": round(slow_q * 1e3, 3),
            # The worst offender's trace id rides the fire edge so the
            # page links straight to a recorded /debug/traces entry.
            **({"exemplar": exemplar} if exemplar is not None else {})}))
    elif fast_q is None or fast_q <= thr_s:
      alert.firing = False
      alert.cleared += 1
      alert.since = None
      transitions.append(name)
      callbacks.append((name, False, {
          **detail_base,
          "fast_ms": None if fast_q is None else round(fast_q * 1e3, 3)}))

  def alerts_firing(self) -> list[str]:
    self.check()
    with self._lock:
      return sorted(n for n, a in self._alerts.items() if a.firing)

  # -- export --------------------------------------------------------------

  @staticmethod
  def _quantile_window_entry(hist, q: float, thr_s: float,
                             window_s: float) -> dict:
    """One window's slice of a quantile objective's snapshot entry.

    Shape-compatible with the burn objectives' windows (requests / bad /
    attained / burn_rate) so the router's fleet summary aggregates it
    unchanged; ``bad`` is the histogram's over-threshold estimate and
    ``burn_rate`` is the quantile/threshold ratio.
    """
    count = hist.count if hist is not None else 0
    q_val = hist.quantile(q) if hist is not None else None
    over = (round(hist.fraction_over(thr_s) * count)
            if hist is not None and count else 0)
    out = {
        "window_s": window_s,
        "requests": count,
        "bad": over,
        "attained": (round(1.0 - over / count, 6) if count else None),
        "burn_rate": (round(q_val / thr_s, 4) if q_val is not None else 0.0),
        "quantile_ms": (round(q_val * 1e3, 3)
                        if q_val is not None else None),
    }
    exemplar = worst_exemplar(hist)
    if exemplar is not None:
      out["exemplar"] = exemplar
    return out

  def snapshot(self) -> dict:
    """The ``/stats`` ``slo`` block (JSON-ready)."""
    self.check()
    with self._lock:
      now = self._clock()
      burns = self._burns_locked(now)
      qwindows = self._quantile_windows_locked(now)
      cfg = self.config
      out = {
          "config": {
              "availability_target": cfg.availability_target,
              "latency_threshold_ms": round(cfg.latency_threshold_s * 1e3, 3),
              "latency_target": cfg.latency_target,
              "fast_window_s": cfg.fast_window_s,
              "slow_window_s": cfg.slow_window_s,
              "burn_threshold": cfg.burn_threshold,
              "min_requests": cfg.min_requests,
              **({"quantile": cfg.quantile,
                  "per_scene": cfg.per_scene}
                 if cfg.quantile is not None else {}),
          },
          "objectives": {},
          "alerts_firing": [],
          "alert_errors": self.alert_errors,
      }

      def alert_block(alert: _Alert) -> dict:
        block = {
            "firing": alert.firing,
            "fired": alert.fired,
            "cleared": alert.cleared,
        }
        if alert.since is not None:
          block["for_s"] = round(now - alert.since, 3)
        return block

      for name in _OBJECTIVES:
        alert = self._alerts[name]
        windows = {}
        for wname, wsec in (("fast", cfg.fast_window_s),
                            ("slow", cfg.slow_window_s)):
          total, bad, burn = burns[name][wname]
          windows[wname] = {
              "window_s": wsec,
              "requests": total,
              "bad": bad,
              "attained": (round(1.0 - bad / total, 6) if total else None),
              "burn_rate": round(burn, 4),
          }
        entry = {
            "target": cfg.target(name),
            "fast": windows["fast"],
            "slow": windows["slow"],
            "alert": alert_block(alert),
        }
        if name == "latency":
          entry["threshold_ms"] = round(cfg.latency_threshold_s * 1e3, 3)
        out["objectives"][name] = entry
      if qwindows is not None:
        qname = cfg.quantile_name()
        thr_s = cfg.latency_threshold_s
        fast_hist, fast_scenes = qwindows["fast"]
        slow_hist, slow_scenes = qwindows["slow"]
        out["objectives"][qname] = {
            "quantile": cfg.quantile,
            "threshold_ms": round(thr_s * 1e3, 3),
            "fast": self._quantile_window_entry(
                fast_hist, cfg.quantile, thr_s, cfg.fast_window_s),
            "slow": self._quantile_window_entry(
                slow_hist, cfg.quantile, thr_s, cfg.slow_window_s),
            "alert": alert_block(self._alert_locked(qname)),
        }
        if cfg.per_scene:
          per_scene = {}
          scenes = set(slow_scenes) | {
              n.partition(":")[2] for n, a in self._alerts.items()
              if ":" in n and (a.firing or a.fired)}
          for scene in sorted(scenes):
            per_scene[scene] = {
                "fast": self._quantile_window_entry(
                    fast_scenes.get(scene), cfg.quantile, thr_s,
                    cfg.fast_window_s),
                "slow": self._quantile_window_entry(
                    slow_scenes.get(scene), cfg.quantile, thr_s,
                    cfg.slow_window_s),
                "alert": alert_block(
                    self._alert_locked(f"{qname}:{scene}")),
            }
          out["per_scene"] = per_scene
      out["alerts_firing"] = sorted(
          n for n, a in self._alerts.items() if a.firing)
      return out


def verdict(snapshot: dict | None) -> dict | None:
  """The bench-side pass/fail block for one ``SloTracker.snapshot()``.

  Attainment over the SLOW window is the score (the fast window is for
  alert edges, not report cards). Quantile objectives pass when the slow
  window's pooled quantile beats the threshold. ``pass`` is None while
  the window saw no traffic; per-scene objectives report their own
  ``pass`` inside the ``per_scene`` block without flipping the global
  one (a single toy scene must not fail a fleet-wide bench line — the
  alert counters still say it paged). Returns None for services running
  without SLO tracking.
  """
  if not snapshot:
    return None
  out = {"objectives": {}, "alerts_firing": list(snapshot["alerts_firing"])}
  ok = True
  scored = False
  for name, entry in snapshot["objectives"].items():
    slow = entry["slow"]
    if "quantile" in entry:
      q_ms = slow["quantile_ms"]
      passed = None if q_ms is None else q_ms <= entry["threshold_ms"]
      out["objectives"][name] = {
          "quantile": entry["quantile"],
          "threshold_ms": entry["threshold_ms"],
          "quantile_ms": q_ms,
          "requests": slow["requests"],
          "burn_fast": entry["fast"]["burn_rate"],
          "burn_slow": slow["burn_rate"],
          "alerts_fired": entry["alert"]["fired"],
          "pass": passed,
      }
    else:
      attained = slow["attained"]
      passed = None if attained is None else attained >= entry["target"]
      out["objectives"][name] = {
          "target": entry["target"],
          "attained": attained,
          "requests": slow["requests"],
          "burn_fast": entry["fast"]["burn_rate"],
          "burn_slow": slow["burn_rate"],
          "alerts_fired": entry["alert"]["fired"],
          "pass": passed,
      }
    if passed is not None:
      scored = True
      ok = ok and passed
  if "per_scene" in snapshot:
    failing = sorted(
        scene for scene, entry in snapshot["per_scene"].items()
        if entry["slow"]["quantile_ms"] is not None
        and entry["slow"]["quantile_ms"]
        > snapshot["config"]["latency_threshold_ms"])
    out["per_scene"] = {
        "scenes": len(snapshot["per_scene"]),
        "failing": failing,
        "alerts_fired": sum(entry["alert"]["fired"]
                            for entry in snapshot["per_scene"].values()),
        "pass": not failing if snapshot["per_scene"] else None,
    }
  out["pass"] = ok if scored else None
  return out
