"""SLO-driven brownout: degrade, don't die.

A copy of ``mpi_vision_tpu/serve/brownout.py`` with its imports rewritten.

Under sustained overload a backend has historically had two answers:
full-quality render or 503. MPI rendering has a middle path — quality
degrades smoothly with plane count and output resolution — so this
module turns the existing overload signals (SLO fast-window burn rate,
``obs/slo.py``; scheduler queue occupancy) into a **degradation
ladder**:

  * **L0** — full render, bit-identical to a service without brownout.
  * **L1** — reduced-plane compositing: the tile planner's content-culled
    plane list is thinned to ``plane_keep`` of its planes
    (``tiles.thin_planes``), reusing the tile planner's plane-subset plan.
  * **L2** — half-resolution render, nearest-neighbour upsampled at
    readback (``engine.upsample_nearest``) on top of L1.
  * **L3** — stale-while-overloaded edge serving: the edge cache's warp
    tolerance widens by ``l3_warp_scale`` so nearby cached full-quality
    frames absorb traffic that would otherwise render; actual renders
    stay at L2 cost.
  * **L4** — shed with ``Retry-After`` (everything, not just low
    priority).

**Hysteresis**: levels step down one at a time (``step_dwell_s`` between
consecutive steps; the first descent from a healthy level is immediate)
and recover one at a time only after the fast window has read healthy
continuously for ``recover_dwell_s``. The band between "overloaded" and
"healthy" holds the current level AND restarts the healthy timer, so the
ladder cannot flap across a noisy threshold.

**Priority admission**: requests carry a class (``X-Request-Class``:
interactive / prefetch / background — the router forwards it, the scene
fetcher and edge prefetch paths mark themselves background) and higher
ladder levels shed lower-priority classes first: background at L2+,
prefetch at L3+, interactive only at L4.

**The recovery contract**: brownout sheds and degraded serves are
deliberate load management, NOT outages — they are counted in their own
``mpi_serve_brownout_*`` families and are **never** fed to
``SloTracker.record_bad``. Feeding them back would pin the burn rate
high and deadlock the ladder at its deepest level forever; excluding
them is what lets the fast window read healthy again and drive recovery.

**The cache contract**: a degraded frame must never poison the bit-exact
edge-cache contract. Degraded responses are always labelled
(``X-Degraded`` + ``X-Brownout-Level``), never ``put`` into the edge
cache, and never carry (or validate against) a full-quality ETag — the
edge tier only ever holds L0 bytes, which is exactly why serving from it
at L3 is safe.

Clock discipline: every timestamp comes through the injected ``clock``
(the serve/-wide rule; tests drive the ladder on fake clocks).
"""

from __future__ import annotations

import dataclasses
import threading
import time

from mpi_vision_tpu_torch.serve import tiles as tiles_mod
from mpi_vision_tpu_torch.serve.scheduler import QueueFullError

# The request-priority header (request AND forwarded by the router).
REQUEST_CLASS_HEADER = "X-Request-Class"
# Response headers: the level that admitted the request, and a marker
# present exactly when the served bytes are below full quality.
LEVEL_HEADER = "X-Brownout-Level"
DEGRADED_HEADER = "X-Degraded"

# Priority classes, highest first. Unknown/absent classes normalize to
# "interactive" — an unlabelled request is a user-facing request.
REQUEST_CLASSES = ("interactive", "prefetch", "background")

MAX_LEVEL = 4

# Ladder level at which each class is shed (level >= threshold sheds).
_SHED_AT = {"background": 2, "prefetch": 3, "interactive": 4}

# Trailing batch-key field marking a half-resolution (L2+) render. The
# scheduler coalesces on key equality, so degraded and full-quality
# requests can never share a flight or a crop memo entry.
HALF_RES_TOKEN = "half"

# Families that must NOT be summed across a fleet (a pooled "level 7"
# from three backends at L2/L2/L3 is meaningless) — the router's
# aggregated /metrics drops these; per-backend levels ride /stats.
NON_ADDITIVE_FAMILIES = frozenset({"mpi_serve_brownout_level"})


def normalize_class(value) -> str:
  """Map a header value onto a known class; unknown -> interactive."""
  if value is None:
    return "interactive"
  cls = str(value).strip().lower()
  return cls if cls in REQUEST_CLASSES else "interactive"


def shed_level(request_class: str) -> int:
  """The ladder level at which ``request_class`` is shed."""
  return _SHED_AT.get(normalize_class(request_class), MAX_LEVEL)


def half_res_key(key: str) -> str:
  """Append the L2 half-resolution marker to a batch/scene key."""
  return key + tiles_mod.KEY_SEP + HALF_RES_TOKEN


def split_degrade_key(key: str) -> tuple[str, bool]:
  """Strip a trailing half-res marker: ``(base_key, is_half_res)``."""
  suffix = tiles_mod.KEY_SEP + HALF_RES_TOKEN
  if key.endswith(suffix):
    return key[:-len(suffix)], True
  return key, False


@dataclasses.dataclass(frozen=True)
class BrownoutConfig:
  """Brownout knobs (the ``serve`` CLI's ``--brownout-*`` flags map 1:1).

  ``burn_high``/``queue_high`` trigger descent (either signal past its
  threshold reads overloaded); ``recover_burn``/``recover_queue`` must
  BOTH hold for ``recover_dwell_s`` before one recovery step — the gap
  between the two threshold pairs is the hysteresis band.
  """

  burn_high: float = 2.0
  queue_high: float = 0.5
  recover_burn: float = 1.0
  recover_queue: float = 0.25
  step_dwell_s: float = 2.0
  recover_dwell_s: float = 5.0
  # Signal-evaluation rate limit: admission is per-request, the burn/
  # queue reads need not be.
  eval_interval_s: float = 0.25
  # L1: fraction of the content-culled plane list kept.
  plane_keep: float = 0.5
  # L3: multiplier on the edge cache's warp tolerances.
  l3_warp_scale: float = 3.0
  shed_retry_after_s: float = 1.0
  max_level: int = MAX_LEVEL

  def __post_init__(self):
    for name in ("burn_high", "queue_high", "recover_burn", "recover_queue",
                 "shed_retry_after_s"):
      if getattr(self, name) <= 0:
        raise ValueError(f"{name} must be > 0, got {getattr(self, name)}")
    for name in ("step_dwell_s", "recover_dwell_s", "eval_interval_s"):
      if getattr(self, name) < 0:
        raise ValueError(f"{name} must be >= 0, got {getattr(self, name)}")
    if self.recover_burn >= self.burn_high:
      raise ValueError(
          f"recover_burn ({self.recover_burn}) must be < burn_high "
          f"({self.burn_high}) — the gap IS the hysteresis band")
    if self.recover_queue >= self.queue_high:
      raise ValueError(
          f"recover_queue ({self.recover_queue}) must be < queue_high "
          f"({self.queue_high}) — the gap IS the hysteresis band")
    if not 0.0 < self.plane_keep <= 1.0:
      raise ValueError(f"plane_keep must be in (0, 1], got {self.plane_keep}")
    if self.l3_warp_scale < 1.0:
      raise ValueError(
          f"l3_warp_scale must be >= 1, got {self.l3_warp_scale}")
    if not 1 <= self.max_level <= MAX_LEVEL:
      raise ValueError(
          f"max_level must be in [1, {MAX_LEVEL}], got {self.max_level}")


class BrownoutShedError(QueueFullError):
  """A request shed by brownout admission control (HTTP 503 +
  ``Retry-After``, riding the queue-full arm). Deliberate load
  management — callers must NOT feed it to ``SloTracker.record_bad``
  (see the module docstring's recovery contract)."""

  def __init__(self, request_class: str, level: int, retry_after_s: float):
    super().__init__(
        f"brownout L{level} shed {request_class!r} request "
        f"(retry after {retry_after_s:g}s)")
    self.request_class = request_class
    self.level = int(level)
    self.retry_after_s = float(retry_after_s)


class BrownoutController:
  """The ladder state machine: signals in, admission decisions out.

  ``burn_fn`` returns the hottest SLO fast-window burn rate
  (``SloTracker.fast_burn``); ``queue_fn`` the scheduler's queue
  occupancy in [0, 1]. Both are read at most every ``eval_interval_s``
  (``tick`` is called per admission). ``on_transition(old, new, reason)``
  fires outside the lock on every level change — the service wires it to
  the event log.
  """

  def __init__(self, config: BrownoutConfig | None = None,
               burn_fn=None, queue_fn=None, on_transition=None,
               clock=time.monotonic):
    self.config = config if config is not None else BrownoutConfig()
    self._burn_fn = burn_fn
    self._queue_fn = queue_fn
    self._on_transition = on_transition
    self._clock = clock
    self._lock = threading.Lock()
    self._level = 0
    # None = never evaluated / never changed level: the first descent
    # under overload is immediate (the dwell throttles CONSECUTIVE
    # steps, it must not delay the first response to an incident).
    self._last_eval: float | None = None
    self._level_since: float | None = None
    self._healthy_since: float | None = None
    self._last_burn = 0.0
    self._last_queue = 0.0
    self.transitions_down = 0
    self.transitions_up = 0

  @property
  def level(self) -> int:
    with self._lock:
      return self._level

  def tick(self) -> int:
    """Evaluate the signals (rate-limited) and return the current level."""
    transition = None
    with self._lock:
      now = self._clock()
      cfg = self.config
      if (self._last_eval is not None
          and now - self._last_eval < cfg.eval_interval_s):
        return self._level
      self._last_eval = now
      burn = float(self._burn_fn()) if self._burn_fn is not None else 0.0
      queue = float(self._queue_fn()) if self._queue_fn is not None else 0.0
      self._last_burn, self._last_queue = burn, queue
      overloaded = burn >= cfg.burn_high or queue >= cfg.queue_high
      healthy = burn <= cfg.recover_burn and queue <= cfg.recover_queue
      if overloaded:
        self._healthy_since = None
        if self._level < cfg.max_level and (
            self._level_since is None
            or now - self._level_since >= cfg.step_dwell_s):
          transition = (self._level, self._level + 1, "overload")
          self._level += 1
          self._level_since = now
          self.transitions_down += 1
      elif healthy and self._level > 0:
        if self._healthy_since is None:
          self._healthy_since = now
        elif now - self._healthy_since >= cfg.recover_dwell_s:
          transition = (self._level, self._level - 1, "recover")
          self._level -= 1
          self._level_since = now
          self.transitions_up += 1
          # Each recovery step earns its own dwell — a 4-level climb
          # back to L0 takes 4 sustained-healthy windows, by design.
          self._healthy_since = now
      else:
        # The hysteresis band: hold the level AND restart the healthy
        # timer, so a burn hovering between the thresholds can neither
        # descend nor creep back up — no flapping.
        self._healthy_since = None
      out = self._level
    if transition is not None and self._on_transition is not None:
      self._on_transition(*transition)
    return out

  def admit(self, request_class: str) -> int:
    """Admission control for one request: returns the ladder level the
    request was admitted at (captured ONCE — the render pipeline uses
    this level even if the ladder moves mid-flight), or raises
    ``BrownoutShedError`` when the class is shed at the current level."""
    cls = normalize_class(request_class)
    level = self.tick()
    if level >= _SHED_AT[cls]:
      raise BrownoutShedError(cls, level, self.config.shed_retry_after_s)
    return level

  def snapshot(self) -> dict:
    with self._lock:
      return {
          "enabled": True,
          "level": self._level,
          "max_level": self.config.max_level,
          "transitions": {"down": self.transitions_down,
                          "up": self.transitions_up},
          "signals": {"burn": round(self._last_burn, 4),
                      "queue_fraction": round(self._last_queue, 4)},
          "thresholds": {"burn_high": self.config.burn_high,
                         "queue_high": self.config.queue_high,
                         "recover_burn": self.config.recover_burn,
                         "recover_queue": self.config.recover_queue},
      }

  def reset_counters(self) -> None:
    """Zero the transition counters (load generators call this after
    warm-up, next to ``ServeMetrics.reset``). The level itself is live
    state and stays."""
    with self._lock:
      self.transitions_down = 0
      self.transitions_up = 0


def fleet_scale_signal(summary: dict | None) -> dict:
  """Distill the router's fleet brownout summary into the autoscaler's
  scale-up signal (``serve/cluster/autoscale.py`` consumes this).

  Brownout is the bridge while capacity spawns: any backend riding a
  nonzero ladder level is already paying for overload with quality, so
  a fleet-wide nonzero ``max_level`` is a scale-up trigger on its own —
  the autoscaler's new capacity is what lets the ladder descend back to
  L0 instead of camping in degraded service. Tolerates a missing or
  partial summary (backends without the controller contribute nothing).
  """
  summary = summary or {}
  levels = summary.get("levels") or {}
  max_level = summary.get("max_level")
  if max_level is None:
    max_level = max(levels.values(), default=0)
  return {
      "max_level": int(max_level),
      "backends_browned": len(levels),
      "backends_enabled": int(summary.get("backends_enabled") or 0),
  }
