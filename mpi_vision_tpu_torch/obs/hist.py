"""Native (sparse, exponential-bucket) histograms with exemplars.

A copy of ``mpi_vision_tpu/obs/hist.py`` with its imports rewritten.

The flight recorder's measurement primitive. The classic fixed-bucket
latency histogram (``serve/metrics.py``'s ``LATENCY_BUCKETS_S``) answers
"how many requests beat 100 ms" but not "what IS p99" — quantiles read
off 13 hand-picked bounds are only as accurate as the nearest bound, and
a pool aggregator can do nothing better. A native histogram puts every
positive observation into an exponential bucket ``(base^(i-1), base^i]``
with ``base = 2^(1/scale)``, so:

  * **resolution is relative and uniform** — at ``scale = 4`` every
    bucket is ~19% wide, so a quantile estimate is within ~9% of truth
    at any magnitude, from 100 us cache hits to 30 s retry storms,
    without choosing bounds in advance;
  * **histograms merge exactly** — two histograms at one scale share the
    same bucket index space, so pooling across time buckets (the SLO
    windows) or across backends (the cluster router) is a per-index
    count sum, never a lossy re-bucketing. This is what lets the router
    aggregate them instead of dropping them as non-additive the way the
    ratio gauges are;
  * **exemplars ride the buckets** — each bucket remembers the most
    recent trace id observed in it, so "p99 is 1.4 s" links directly to
    a recorded trace of an actual 1.4 s request (``/debug/traces``).

Everything is a plain dict-of-ints snapshot away from JSON, so the same
representation rides ``/stats``, the Prometheus exposition
(``mpi_serve_*_nativehist`` families), the SLO windows, and the
off-host shipper.

No locking here: every holder (``ServeMetrics``, ``SloTracker``) already
serializes access under its own lock. No clock reads either (exemplars
are ordered by arrival, not time) — clock-lint covers this file.
"""

from __future__ import annotations

import math

# Buckets per power of two. base = 2**(1/SCALE) ~= 1.189: ~19% relative
# bucket width, worst-case ~9% quantile error — comfortably inside any
# latency objective's slack, at ~40 resident buckets for the us..minutes
# range real serving latencies span. One shared scale for the whole
# stack keeps every histogram in one index space, which is what makes
# the text-exposition pool merge a plain per-sample sum.
SCALE = 4

# Index clamp: base^-160 ~= 1e-12 s and base^120 ~= 1e9 s. Observations
# beyond these land in the edge bucket instead of growing the sparse
# map without bound (a hostile/buggy caller recording 1e-300 must not
# allocate 4000 buckets).
MIN_IDX = -160
MAX_IDX = 120

# The quantiles the convenience gauges export (/metrics, tsdb, router
# pool view). Labels use the short string forms below.
QUANTILES = (0.5, 0.9, 0.99)

# Per-backend quantile gauges are statements about ONE process — summing
# p99s across a pool is meaningless, so the cluster router drops this
# family from its summed exposition and computes its own pooled
# quantiles from the (correctly merged) native-histogram buckets.
NON_ADDITIVE_FAMILIES = frozenset({
    "mpi_serve_request_quantile_seconds",
})


def bucket_index(value: float, scale: int = SCALE) -> int:
  """The bucket index of a positive observation (clamped)."""
  idx = math.ceil(math.log2(value) * scale)
  return min(max(idx, MIN_IDX), MAX_IDX)


def bucket_bounds(idx: int, scale: int = SCALE) -> tuple[float, float]:
  """The ``(lower, upper]`` value range of bucket ``idx``."""
  return 2.0 ** ((idx - 1) / scale), 2.0 ** (idx / scale)


class NativeHistogram:
  """A sparse exponential-bucket histogram with per-bucket exemplars.

  ``record`` is O(1); ``quantile`` and ``snapshot`` are O(resident
  buckets) (tens, by construction). Non-positive observations land in
  the zero bucket (latencies are >= 0; a 0.0 is a legitimate "free"
  operation, not an error).
  """

  __slots__ = ("scale", "count", "sum", "zero", "buckets", "exemplars")

  def __init__(self, scale: int = SCALE):
    if scale < 1:
      raise ValueError(f"scale must be >= 1, got {scale}")
    self.scale = int(scale)
    self.count = 0
    self.sum = 0.0
    self.zero = 0
    self.buckets: dict[int, int] = {}
    # idx -> (exemplar_id, observed_value); newest observation wins so
    # the exemplar always points at a trace the ring plausibly still
    # holds.
    self.exemplars: dict[int, tuple[str, float]] = {}

  def record(self, value: float, exemplar: str | None = None) -> None:
    value = float(value)
    self.count += 1
    self.sum += value
    if value <= 0.0:
      self.zero += 1
      return
    idx = bucket_index(value, self.scale)
    self.buckets[idx] = self.buckets.get(idx, 0) + 1
    if exemplar:
      self.exemplars[idx] = (str(exemplar), value)

  def merge_from(self, other: "NativeHistogram | None") -> None:
    """Fold another live histogram into this one (exact merge — the SLO
    windows pool their per-time-bucket histograms this way)."""
    if other is None or other.count == 0:
      return
    if other.scale != self.scale:
      raise ValueError(
          f"cannot merge scale {other.scale} into {self.scale}")
    self.count += other.count
    self.sum += other.sum
    self.zero += other.zero
    for idx, n in other.buckets.items():
      self.buckets[idx] = self.buckets.get(idx, 0) + n
    for idx, pair in other.exemplars.items():
      mine = self.exemplars.get(idx)
      if mine is None or pair[1] >= mine[1]:
        self.exemplars[idx] = pair

  def merge_snapshot(self, snap: dict | None) -> None:
    """Fold another histogram's snapshot into this one (exact merge).

    Scales must match (the stack-wide ``SCALE`` guarantees it); on an
    exemplar collision the larger observed value wins — the tail is
    what an operator chasing a quantile alert wants to click through.
    """
    if not snap or not snap.get("count"):
      return
    if int(snap.get("scale", self.scale)) != self.scale:
      raise ValueError(
          f"cannot merge scale {snap.get('scale')} into {self.scale}")
    self.count += int(snap["count"])
    self.sum += float(snap["sum"])
    self.zero += int(snap.get("zero", 0))
    for key, n in (snap.get("buckets") or {}).items():
      idx = int(key)
      self.buckets[idx] = self.buckets.get(idx, 0) + int(n)
    for key, ex in (snap.get("exemplars") or {}).items():
      idx = int(key)
      pair = (str(ex["trace_id"]), float(ex["value"]))
      mine = self.exemplars.get(idx)
      if mine is None or pair[1] >= mine[1]:
        self.exemplars[idx] = pair

  def quantile(self, q: float) -> float | None:
    """Estimated value at quantile ``q`` (None while empty).

    Linear interpolation inside the containing bucket — bounded by the
    bucket's ~``1/scale`` relative width, which is the whole point of
    exponential buckets.
    """
    if not 0.0 <= q <= 1.0:
      raise ValueError(f"q must be in [0, 1], got {q}")
    if self.count == 0:
      return None
    rank = q * self.count
    if rank <= self.zero:
      return 0.0
    cum = self.zero
    for idx in sorted(self.buckets):
      n = self.buckets[idx]
      if cum + n >= rank:
        lo, hi = bucket_bounds(idx, self.scale)
        frac = (rank - cum) / n
        return lo + frac * (hi - lo)
      cum += n
    # Numerically possible only via float rank rounding: everything
    # counted, answer is the top of the highest bucket.
    return bucket_bounds(max(self.buckets), self.scale)[1]

  def fraction_over(self, threshold: float) -> float:
    """Estimated fraction of observations above ``threshold``."""
    if self.count == 0:
      return 0.0
    over = 0.0
    for idx, n in self.buckets.items():
      lo, hi = bucket_bounds(idx, self.scale)
      if lo >= threshold:
        over += n
      elif hi > threshold:
        over += n * (hi - threshold) / (hi - lo)
    return min(over / self.count, 1.0)

  def snapshot(self) -> dict:
    """JSON-ready state (str bucket keys; rides /stats and the shipper)."""
    return {
        "scale": self.scale,
        "count": self.count,
        "sum": round(self.sum, 6),
        "zero": self.zero,
        "buckets": {str(idx): n for idx, n in sorted(self.buckets.items())},
        "exemplars": {
            str(idx): {"trace_id": tid, "value": round(value, 6)}
            for idx, (tid, value) in sorted(self.exemplars.items())},
    }


def merge(snapshots) -> NativeHistogram:
  """A fresh histogram holding the exact merge of ``snapshots``
  (None/empty entries contribute nothing)."""
  out = NativeHistogram()
  for snap in snapshots:
    out.merge_snapshot(snap)
  return out


def quantile_of(snapshot: dict | None, q: float) -> float | None:
  """``quantile(q)`` straight off a snapshot dict (None while empty)."""
  if not snapshot or not snapshot.get("count"):
    return None
  return merge([snapshot]).quantile(q)


def q_label(q: float) -> str:
  """The ``q=`` label value for a quantile gauge ("0.99", "0.5")."""
  return f"{q:g}"


def add_family(reg, name: str, help_text: str, items) -> None:
  """Render native-histogram snapshots as one exposition family.

  ``items`` is ``[(extra_labels_dict, snapshot_or_None), ...]`` (one
  entry per label group — e.g. one per ``phase``). Emitted samples:
  ``_bucket{idx=,le=}`` per resident bucket (``le`` is the bucket's
  upper bound, for humans; ``idx`` is the merge key), ``_zero``,
  ``_sum``, ``_count``. Bucket samples carry their exemplar
  OpenMetrics-style (`` # {trace_id="..."} value``). Because every
  histogram shares ``SCALE``, the cluster aggregator's per-sample sum
  IS the exact bucket merge.
  """
  m = reg.histogram_family(name, help_text)
  for labels, snap in items:
    labels = dict(labels or {})
    snap = snap or {}
    scale = int(snap.get("scale", SCALE))
    exemplars = snap.get("exemplars") or {}
    for key, n in (snap.get("buckets") or {}).items():
      idx = int(key)
      ex = exemplars.get(key)
      m.sample(n, {**labels, "idx": str(idx),
                   "le": f"{bucket_bounds(idx, scale)[1]:.6g}"},
               suffix="_bucket",
               exemplar=(ex["trace_id"], ex["value"]) if ex else None)
    m.sample(snap.get("zero", 0), labels, suffix="_zero")
    m.sample(snap.get("sum", 0.0), labels, suffix="_sum")
    m.sample(snap.get("count", 0), labels, suffix="_count")


def snapshots_from_samples(samples: dict) -> dict:
  """Reconstruct snapshots from one family's parsed exposition samples.

  The router-side inverse of ``add_family``: ``samples`` is the
  ``{(sample_name, labels_tuple): value}`` map ``parse_metrics_text``
  returns for a ``*_nativehist`` family (already pool-summed by
  ``aggregate_metrics_texts`` — per-``idx`` sums are the exact merge).
  Returns ``{group_labels_tuple: snapshot}`` keyed by the labels minus
  ``idx``/``le``.
  """
  groups: dict[tuple, dict] = {}

  def group(labels) -> dict:
    key = tuple(kv for kv in labels if kv[0] not in ("idx", "le"))
    return groups.setdefault(key, {"scale": SCALE, "count": 0, "sum": 0.0,
                                   "zero": 0, "buckets": {},
                                   "exemplars": {}})

  for (sample_name, labels), value in samples.items():
    if sample_name.endswith("_bucket"):
      idx = next((v for k, v in labels if k == "idx"), None)
      if idx is None:
        continue
      g = group(labels)
      g["buckets"][idx] = g["buckets"].get(idx, 0) + int(value)
    elif sample_name.endswith("_zero"):
      group(labels)["zero"] += int(value)
    elif sample_name.endswith("_sum"):
      group(labels)["sum"] += float(value)
    elif sample_name.endswith("_count"):
      group(labels)["count"] += int(value)
  return groups
