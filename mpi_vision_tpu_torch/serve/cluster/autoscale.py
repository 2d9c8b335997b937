"""Elastic fleet: SLO-driven autoscaling with zero-drop scale-down.

A copy of ``mpi_vision_tpu/serve/cluster/autoscale.py`` with its imports
rewritten. The elastic fleet: every input signal already existed
without a consumer — the router's per-backend load table, multi-window
burn-rate alerts, queue-depth sheds, the brownout level, and the
attribution ledger. This module closes the loop with two pieces:

  * ``AutoscalePolicy`` — a pure state machine on an injectable clock.
    Scale-up trips on sustained SLO fast-burn, queue-depth pressure, or
    a fleet-wide nonzero brownout ``max_level`` (brownout is the bridge
    that keeps the SLO alive WHILE capacity spawns; a nonzero level is
    the fleet saying "I am already degrading to survive"). Scale-down
    trips on sustained low utilization from the load table and
    attribution ledger. Hysteresis bands (trip above ``*_high``,
    recover below ``*_recover``, freeze in between), separate up/down
    sustain windows and cooldowns, min/max pool clamps, and a
    per-window scaling budget (``resilience.RestartBudget`` semantics)
    mean a flapping signal cannot thrash the ring.
  * ``Autoscaler`` — the actuator, run ONLY by the lease-holding
    supervisor (its ``tick()`` is called from ``FleetSupervisor.tick``
    after ``_ensure_lease`` succeeded, so standby replicas never act).
    Scale-up spawns via ``BackendPool.spawn_backend`` locally or a
    ``--provision-hook`` command for ``--join`` fleets, warms the new
    backend's (scene, tile) ring assignment through the asset tier's
    manifest diff BEFORE the router admits it (the FastNeRF lesson:
    un-warmed capacity tanks p99 worse than no capacity), then
    ``Router.resize`` moves only the touched keys. Scale-down reuses
    the drainless eject -> drain -> SIGTERM -> retire choreography, so
    shrinking the fleet drops zero requests; quarantine/restart-budget
    state is adopted by the supervisor, never reset.

Every decision is gossiped as a versioned record under the reserved
``_autoscale`` key (never a backend id — the supervisor skips it when
adopting observations), so a supervisor death mid-scale-out converges
under the new leaseholder: ``converge()`` reads the half-finished
record and either completes the admit (backend answering) or retires
the stranded spawn, instead of leaking a provisioned-but-unrouted
process forever.
"""

from __future__ import annotations

import dataclasses
import json
import re
import signal
import time

from mpi_vision_tpu_torch.serve import brownout as brownout_mod
from mpi_vision_tpu_torch.serve.resilience import RestartBudget

# The reserved gossip key autoscale decisions travel under. Not a valid
# pool backend id (those match ``b\d+``), and the supervisor's
# observation-adoption explicitly skips it.
AUTOSCALE_KEY = "_autoscale"

_BACKEND_ID = re.compile(r"^b(\d+)$")


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
  """Policy knobs. Trip/recover pairs form hysteresis bands: the signal
  must cross ``*_high`` to start accumulating pressure and fall back
  below ``*_recover`` to reset it; in between, accumulated time
  freezes (neither grows nor resets), so a signal hovering at the
  threshold cannot flap the pool."""

  min_backends: int = 1
  max_backends: int = 4
  # -- scale-up triggers (any one trips) --
  burn_high: float = 2.0        # worst fast-burn >= this trips
  burn_recover: float = 1.0     # ... and must fall below this to calm
  queue_high: float = 8.0       # mean backend queue depth >= this trips
  queue_recover: float = 2.0
  brownout_high: int = 1        # fleet max brownout level >= this trips
  # -- scale-down trigger (utilization = busy device-seconds fraction) --
  util_low: float = 0.15        # util <= this accumulates idle time
  util_recover: float = 0.35    # util >= this resets idle time
  # -- sustain windows (accumulated seconds before acting) --
  up_sustain_s: float = 2.0
  down_sustain_s: float = 20.0
  # -- cooldowns after ANY scale action --
  up_cooldown_s: float = 10.0
  down_cooldown_s: float = 30.0
  # -- per-window scaling budget (RestartBudget semantics) --
  budget: int = 4
  budget_window_s: float = 300.0

  def __post_init__(self):
    if self.min_backends < 1:
      raise ValueError(
          f"min_backends must be >= 1, got {self.min_backends}")
    if self.max_backends < self.min_backends:
      raise ValueError(
          f"max_backends ({self.max_backends}) must be >= min_backends "
          f"({self.min_backends})")
    for high, recover, name in ((self.burn_high, self.burn_recover, "burn"),
                                (self.queue_high, self.queue_recover,
                                 "queue")):
      if recover >= high:
        raise ValueError(
            f"{name}_recover ({recover}) must be < {name}_high ({high}) "
            "(the hysteresis band would be empty or inverted)")
    if self.brownout_high < 1:
      raise ValueError(
          f"brownout_high must be >= 1, got {self.brownout_high}")
    if not self.util_low < self.util_recover:
      raise ValueError(
          f"util_low ({self.util_low}) must be < util_recover "
          f"({self.util_recover})")
    for v, name in ((self.up_sustain_s, "up_sustain_s"),
                    (self.down_sustain_s, "down_sustain_s")):
      if v <= 0:
        raise ValueError(f"{name} must be > 0, got {v}")
    for v, name in ((self.up_cooldown_s, "up_cooldown_s"),
                    (self.down_cooldown_s, "down_cooldown_s")):
      if v < 0:
        raise ValueError(f"{name} must be >= 0, got {v}")
    if self.budget < 1:
      raise ValueError(f"budget must be >= 1, got {self.budget}")
    if self.budget_window_s <= 0:
      raise ValueError(
          f"budget_window_s must be > 0, got {self.budget_window_s}")


class AutoscalePolicy:
  """The decision state machine: signals in, at most one action out.

  Pure and single-threaded by contract (the supervisor tick drives it
  under its operation lock); everything reads time through the
  injectable ``clock``, so the whole trip/recover/cooldown/budget
  surface unit-tests on a fake clock in milliseconds.
  """

  def __init__(self, config: AutoscaleConfig | None = None,
               clock=time.monotonic):
    self.config = config if config is not None else AutoscaleConfig()
    self._clock = clock
    self.budget = RestartBudget(max_restarts=self.config.budget,
                                window_s=self.config.budget_window_s,
                                clock=clock)
    self._last_at: float | None = None   # previous decide() timestamp
    self._pressure_s = 0.0               # accumulated tripping time
    self._idle_s = 0.0                   # accumulated idle time
    self._last_scale_at: float | None = None
    self.decisions = 0
    self.ups = 0
    self.downs = 0
    self.denied_budget = 0
    self.clamped_max = 0
    self.clamped_min = 0
    self.cooldown_holds = 0

  # -- signal classification ------------------------------------------------

  def _tripping(self, s: dict) -> str | None:
    """The first scale-up trigger currently over its trip threshold."""
    c = self.config
    if (s.get("fast_burn") or 0.0) >= c.burn_high:
      return f"slo fast-burn {s['fast_burn']:.2f} >= {c.burn_high:g}"
    if (s.get("queue_depth") or 0.0) >= c.queue_high:
      return f"queue depth {s['queue_depth']:.1f} >= {c.queue_high:g}"
    if (s.get("brownout_level") or 0) >= c.brownout_high:
      return (f"brownout level {s['brownout_level']} >= "
              f"{c.brownout_high}")
    return None

  def _calm(self, s: dict) -> bool:
    """Every scale-up signal is back below its RECOVER threshold."""
    c = self.config
    return ((s.get("fast_burn") or 0.0) < c.burn_recover
            and (s.get("queue_depth") or 0.0) < c.queue_recover
            and (s.get("brownout_level") or 0) == 0)

  # -- the decision ---------------------------------------------------------

  def decide(self, signals: dict, n_backends: int) -> dict | None:
    """Fold one signal sample in; return an action dict or None.

    ``signals``: ``fast_burn`` (worst multi-window fast burn rate),
    ``queue_depth`` (mean absolute backend queue depth),
    ``brownout_level`` (fleet max), ``util`` (busy device-seconds
    fraction, None when unmeasurable this sample). The action dict is
    ``{"action": "up"|"down", "reason", "signals", "at"}`` — the
    caller actuates; the policy only ever says what and why.
    """
    now = self._clock()
    dt = 0.0 if self._last_at is None else max(0.0, now - self._last_at)
    self._last_at = now
    self.decisions += 1
    c = self.config

    trip = self._tripping(signals)
    calm = self._calm(signals)
    if trip is not None:
      self._pressure_s += dt
    elif calm:
      self._pressure_s = 0.0
    # else: in the hysteresis band — pressure freezes.

    util = signals.get("util")
    if trip is not None or (util is not None and util >= c.util_recover):
      self._idle_s = 0.0
    elif util is not None and util <= c.util_low and calm:
      self._idle_s += dt
    # else: unmeasurable sample or mid-band — idle time freezes.

    if self._pressure_s >= c.up_sustain_s and trip is not None:
      return self._fire("up", trip, signals, n_backends, now)
    if self._idle_s >= c.down_sustain_s:
      reason = (f"utilization {util:.2f} <= {c.util_low:g} for "
                f"{self._idle_s:.1f}s" if util is not None
                else f"idle for {self._idle_s:.1f}s")
      return self._fire("down", reason, signals, n_backends, now)
    return None

  def _fire(self, action: str, reason: str, signals: dict,
            n_backends: int, now: float) -> dict | None:
    """Gate a sustained trigger through clamp -> cooldown -> budget.

    A held-back trigger keeps its accumulated sustain time: the moment
    the gate opens (cooldown elapses, budget refills, pool bound
    changes) the very next sample fires, instead of re-earning the
    whole sustain window.
    """
    c = self.config
    if action == "up" and n_backends >= c.max_backends:
      self.clamped_max += 1
      return None
    if action == "down" and n_backends <= c.min_backends:
      self.clamped_min += 1
      return None
    cooldown = c.up_cooldown_s if action == "up" else c.down_cooldown_s
    if (self._last_scale_at is not None
        and now - self._last_scale_at < cooldown):
      self.cooldown_holds += 1
      return None
    if not self.budget.try_spend():
      self.denied_budget += 1
      return None
    self._last_scale_at = now
    self._pressure_s = 0.0
    self._idle_s = 0.0
    if action == "up":
      self.ups += 1
    else:
      self.downs += 1
    return {"action": action, "reason": reason,
            "signals": dict(signals), "at": now}

  def snapshot(self) -> dict:
    return {
        "config": dataclasses.asdict(self.config),
        "pressure_s": round(self._pressure_s, 3),
        "idle_s": round(self._idle_s, 3),
        "last_scale_at": self._last_scale_at,
        "decisions": self.decisions,
        "ups": self.ups,
        "downs": self.downs,
        "denied_budget": self.denied_budget,
        "clamped_max": self.clamped_max,
        "clamped_min": self.clamped_min,
        "cooldown_holds": self.cooldown_holds,
        "budget": self.budget.snapshot(),
    }


class Autoscaler:
  """The actuator: signals -> policy -> spawn/warm/admit or
  eject/drain/retire, with every phase gossiped for convergence.

  Owned by (and only ever ticked from) the lease-holding
  ``FleetSupervisor`` — construction wires ``supervisor`` back-ref via
  ``FleetSupervisor(autoscaler=...)``. All entry points run under the
  supervisor's operation lock, so this class needs no locking of its
  own.

  Args:
    policy: the ``AutoscalePolicy`` state machine.
    pool: ``BackendPool`` (local spawn/retire) or ``RemoteBackendPool``
      (``--join`` fleet; pair with ``provision_hook``).
    router: the ``Router`` whose ring this scales.
    gossip: optional ``GossipState`` decisions are recorded into (the
      convergence substrate; None = no crash-safety record).
    events: lifecycle event log (share the router's).
    provision_hook: optional argv prefix run as
      ``hook backend_id`` -> must print ``host:port`` of the new
      backend on stdout (the ``--join`` fleet's spawn path).
    scenes: the ring keys whose placement scaling audits/warms
      (typically ``pool.scene_ids()``).
    eval_interval_s: minimum seconds between signal evaluations
      (``tick()`` is called every supervisor tick; this rate-limits
      the ``/stats`` fan-out).
    drain_s: scale-down drain pause between eject and SIGTERM.
    warm_timeout_s: per-spawn warming budget before the admit aborts.
    hook_timeout_s: provision-hook subprocess budget.
    transport: injectable HTTP transport (tests); default
      ``router.HttpTransport``.
    runner: injectable subprocess runner for the hook (tests).
    clock / sleep: injectable time sources (the serve/-wide lint rule).
    log: diagnostics sink (None = silent).
  """

  def __init__(self, policy: AutoscalePolicy, pool, router, gossip=None,
               events=None, provision_hook=None, scenes=(),
               eval_interval_s: float = 1.0, drain_s: float = 0.5,
               warm_timeout_s: float = 60.0, hook_timeout_s: float = 60.0,
               transport=None, runner=None, clock=time.monotonic,
               sleep=None, log=None):
    if eval_interval_s <= 0:
      raise ValueError(
          f"eval_interval_s must be > 0, got {eval_interval_s}")
    if drain_s < 0:
      raise ValueError(f"drain_s must be >= 0, got {drain_s}")
    self.policy = policy
    self.pool = pool
    self.router = router
    self.gossip = gossip
    self.events = events
    self.provision_hook = (list(provision_hook) if provision_hook
                           else None)
    self.scenes = [str(s) for s in scenes]
    self.eval_interval_s = float(eval_interval_s)
    self.drain_s = float(drain_s)
    self.warm_timeout_s = float(warm_timeout_s)
    self.hook_timeout_s = float(hook_timeout_s)
    if transport is not None:
      self.transport = transport
    else:
      from mpi_vision_tpu_torch.serve.cluster.router import HttpTransport

      self.transport = HttpTransport()
    if runner is not None:
      self._runner = runner
    else:
      import subprocess

      self._runner = subprocess.run
    self._clock = clock
    self._sleep = sleep if sleep is not None else time.sleep
    self._log = log if log is not None else (lambda msg: None)
    self.supervisor = None  # back-ref bound by FleetSupervisor
    self._seq = 0
    self._denied_seen = 0
    self._busy_prev: tuple[float, float, frozenset] | None = None
    self._last_eval_at: float | None = None
    self.ups = 0
    self.downs = 0
    self.aborts = 0
    self.converges = 0
    self.signal_errors = 0
    self.last_signals: dict | None = None
    self.last_action: dict | None = None

  # -- event/gossip plumbing ------------------------------------------------

  def _record(self, **fields) -> None:
    """Gossip the current decision record under the reserved key. The
    full field set is written every time (gossip merges fields over the
    previous observation, so a partial write would leak stale fields
    from the PREVIOUS decision into this one)."""
    if self.gossip is None:
      return
    record = {"seq": fields.get("seq"), "action": fields.get("action"),
              "backend": fields.get("backend"),
              "address": fields.get("address"),
              "phase": fields.get("phase"),
              "reason": fields.get("reason")}
    self.gossip.observe(AUTOSCALE_KEY, **record)

  # -- signals --------------------------------------------------------------

  def _signals(self) -> dict:
    """One ``/stats`` fan-out folded into the policy's signal dict.
    A failed fan-out yields neutral signals (nothing trips, nothing
    accumulates idle) — the autoscaler must never act on darkness."""
    try:
      stats = self.router.stats()
    except Exception as e:  # noqa: BLE001 - stats fan-out is best-effort
      self.signal_errors += 1
      self._log(f"autoscale: stats fan-out failed: {e!r}")
      return {"fast_burn": 0.0, "queue_depth": 0.0, "brownout_level": 0,
              "util": None}
    slo = stats.get("slo") or {}
    fast_burn = 0.0
    for worst in (slo.get("worst") or {}).values():
      fast_burn = max(fast_burn, float(worst.get("fast_burn") or 0.0))
    backends = stats.get("backends") or {}
    depths = [float(p.get("queue_depth") or 0.0)
              for p in backends.values() if isinstance(p, dict)]
    queue_depth = sum(depths) / len(depths) if depths else 0.0
    level = brownout_mod.fleet_scale_signal(
        stats.get("brownout"))["max_level"]
    return {"fast_burn": round(fast_burn, 4),
            "queue_depth": round(queue_depth, 3),
            "brownout_level": level,
            "util": self._utilization(stats, backends)}

  def _utilization(self, stats: dict, backends: dict) -> float | None:
    """Fleet busy-fraction: the delta of cumulative busy device-seconds
    (attribution ledger totals when reporting, else the per-backend
    render counters) over wall time x pool size. None on the first
    sample and across membership changes (cumulative counters from a
    different pool cannot be compared)."""
    members = frozenset(backends)
    busy = None
    attrib = stats.get("attrib") or {}
    if attrib.get("backends"):
      device_s = (attrib.get("totals") or {}).get("device_s") or {}
      busy = float(sum(device_s.values()))
    else:
      vals = [float(p.get("device_render_seconds") or 0.0)
              for p in backends.values() if isinstance(p, dict)]
      busy = sum(vals) if vals else None
    now = self._clock()
    prev = self._busy_prev
    self._busy_prev = None if busy is None else (now, busy, members)
    if busy is None or prev is None or prev[2] != members:
      return None
    dt = now - prev[0]
    if dt <= 0 or not members:
      return None
    return round(max(0.0, busy - prev[1]) / (dt * len(members)), 4)

  # -- the tick -------------------------------------------------------------

  def tick(self) -> dict | None:
    """One evaluation pass; called by the LEASE-HOLDING supervisor tick
    (never from a standby — that is the single-actuator guarantee)."""
    now = self._clock()
    if (self._last_eval_at is not None
        and now - self._last_eval_at < self.eval_interval_s):
      return None
    self._last_eval_at = now
    signals = self._signals()
    self.last_signals = signals
    action = self.policy.decide(signals, len(self.router.backend_ids()))
    self._note_denials()
    if action is None:
      return None
    self.last_action = action
    if action["action"] == "up":
      return self.scale_up(action["reason"], signals)
    return self.scale_down(action["reason"], signals)

  def _note_denials(self) -> None:
    """Mirror new policy budget denials into the router's counter."""
    new = self.policy.denied_budget - self._denied_seen
    if new > 0 and self.router is not None:
      for _ in range(new):
        self.router.metrics.record_autoscale("budget_denied")
    self._denied_seen = self.policy.denied_budget

  # -- scale-up -------------------------------------------------------------

  def _next_id(self) -> str:
    """The next free ``b{i}`` across the pool AND the router (a retired
    id can be reused; a half-provisioned one must not collide)."""
    used = set(self.pool.addresses()) | set(self.router.backend_ids())
    i = 0
    while f"b{i}" in used:
      i += 1
    return f"b{i}"

  def scale_up(self, reason: str, signals: dict | None = None) -> dict:
    self._seq += 1
    seq = self._seq
    backend_id = self._next_id()
    self._record(seq=seq, action="up", backend=backend_id, address=None,
                 phase="provisioning", reason=reason)
    try:
      backend_id, address = self._provision(backend_id)
    except Exception as e:  # noqa: BLE001 - a failed spawn is an abort
      return self._abort(seq, "up", backend_id, None,
                         f"provision failed: {e!r}")
    self._record(seq=seq, action="up", backend=backend_id,
                 address=address, phase="warming", reason=reason)
    return self._admit(seq, backend_id, address, reason)

  def _provision(self, backend_id: str) -> tuple[str, str]:
    if self.provision_hook is None:
      return self.pool.spawn_backend(backend_id)
    proc = self._runner(self.provision_hook + [backend_id],
                        capture_output=True, text=True,
                        timeout=self.hook_timeout_s)
    if proc.returncode != 0:
      raise RuntimeError(
          f"provision hook exited {proc.returncode}: "
          f"{(proc.stderr or proc.stdout or '').strip()[:500]}")
    lines = [ln.strip() for ln in (proc.stdout or "").splitlines()
             if ln.strip()]
    if not lines or ":" not in lines[-1]:
      raise RuntimeError(
          "provision hook printed no host:port address "
          f"(stdout: {(proc.stdout or '').strip()[:200]!r})")
    address = lines[-1]
    self.pool.add_address(backend_id, address)
    return backend_id, address

  def _admit(self, seq: int, backend_id: str, address: str, reason: str,
             converged: bool = False) -> dict:
    """Warm-then-admit: compute the NEW backend's post-resize (scene,
    tile) assignment from a ring preview, warm it over the asset tier,
    and only then move the live ring. An un-warmable backend is retired
    and the scale-up aborts — admitting cold capacity would tank p99,
    the exact failure scale-up exists to prevent."""
    preview = self.router.resize_preview(add=[backend_id],
                                         keys=self.scenes)
    assignment = [k for k, placement in preview["after"].items()
                  if backend_id in placement]
    donors = [a for b, a in self.router.addresses().items()
              if b not in self.router.ejected()]
    from mpi_vision_tpu_torch.serve.assets import fetch as fetch_mod

    warm = fetch_mod.warm_backend(
        address, assignment, donors=donors, transport=self.transport,
        timeout_s=self.warm_timeout_s, clock=self._clock,
        sleep=self._sleep)
    if not warm["ok"]:
      self._retire_spawn(backend_id)
      return self._abort(
          seq, "up", backend_id, address,
          f"warming failed for {sorted(warm['failed'])}")
    diff = self.router.resize(add={backend_id: address},
                              keys=self.scenes)
    self.router.metrics.record_autoscale("up")
    self.ups += 1
    if converged:
      self.converges += 1
    if self.events is not None:
      self.events.emit("autoscale_up", backend=backend_id, address=address,
                       reason=reason, warmed=len(warm["warmed"]),
                       moved=len(diff["moved"]),
                       backends=len(self.router.backend_ids()),
                       converged=converged)
    self._record(seq=seq, action="up", backend=backend_id,
                 address=address, phase="done", reason=reason)
    self._log(f"autoscale: UP {backend_id} @ {address} ({reason}); "
              f"warmed {len(warm['warmed'])} keys, "
              f"{len(diff['moved'])} moved")
    return {"action": "up", "backend": backend_id, "address": address,
            "warm": warm, "diff": diff}

  def _retire_spawn(self, backend_id: str) -> None:
    """Tear down a spawn that never made it into the ring."""
    try:
      if self.pool.alive(backend_id):
        self.pool.kill(backend_id, signal.SIGTERM)
      self.pool.retire(backend_id)
    except Exception as e:  # noqa: BLE001 - cleanup is best-effort
      self._log(f"autoscale: retire of failed spawn {backend_id} "
                f"failed: {e!r}")

  # -- scale-down -----------------------------------------------------------

  def _victim(self) -> str | None:
    """The highest-numbered routed backend that is not quarantined
    (quarantine is evidence, not capacity — retiring it would erase the
    crash-loop verdict a later readmit decision needs)."""
    quarantined = set()
    if self.supervisor is not None:
      quarantined = set(self.supervisor.quarantined())
    numbered = []
    for b in self.router.backend_ids():
      m = _BACKEND_ID.match(b)
      if b not in quarantined:
        numbered.append((m.group(1).zfill(12) if m else b, b))
    return max(numbered)[1] if numbered else None

  def scale_down(self, reason: str, signals: dict | None = None) -> dict:
    victim = self._victim()
    if victim is None:
      return self._abort(self._seq, "down", None, None,
                         "no retirable backend")
    self._seq += 1
    seq = self._seq
    address = self.router.addresses().get(victim)
    self._record(seq=seq, action="down", backend=victim,
                 address=address, phase="retiring", reason=reason)
    return self._retire(seq, victim, reason)

  def _retire(self, seq: int, backend_id: str, reason: str,
              converged: bool = False) -> dict:
    """The drainless choreography, reused from rolling restart: eject
    (planned downtime must not look like failure), drain in-flight
    forwards, SIGTERM (the backend finishes what it holds), retire the
    process, THEN move the ring. Ordering is the zero-drop guarantee:
    no request routes to the victim after the eject, and none it
    already holds is killed before the drain."""
    self.router.eject(backend_id, reason="autoscale")
    if self.drain_s > 0:
      self._sleep(self.drain_s)
    try:
      if self.pool.alive(backend_id):
        self.pool.kill(backend_id, signal.SIGTERM)
      self.pool.retire(backend_id)
    except Exception as e:  # noqa: BLE001 - report, readmit, move on
      self.router.readmit(backend_id)
      return self._abort(seq, "down", backend_id, None,
                         f"retire failed: {e!r}")
    diff = self.router.resize(remove=[backend_id], keys=self.scenes)
    if self.supervisor is not None:
      self.supervisor.forget(backend_id)
    if self.gossip is not None:
      # Overwrite the backend's own gossip record so a peer adopting
      # observations sees a deliberate retirement, not a dead backend.
      self.gossip.observe(backend_id, state="retired", quarantined=False,
                          ejected=True, reason="autoscale retire",
                          budget_ages_s=[])
    self.router.metrics.record_autoscale("down")
    self.downs += 1
    if converged:
      self.converges += 1
    if self.events is not None:
      self.events.emit("autoscale_down", backend=backend_id, reason=reason,
                       moved=len(diff["moved"]),
                       backends=len(self.router.backend_ids()),
                       converged=converged)
    self._record(seq=seq, action="down", backend=backend_id,
                 address=None, phase="done", reason=reason)
    self._log(f"autoscale: DOWN {backend_id} ({reason}); "
              f"{len(diff['moved'])} keys moved")
    return {"action": "down", "backend": backend_id, "diff": diff}

  # -- aborts ---------------------------------------------------------------

  def _abort(self, seq: int, action: str, backend_id, address,
             why: str) -> dict:
    self.aborts += 1
    self.router.metrics.record_autoscale("abort")
    if self.events is not None:
      self.events.emit("autoscale_abort", action=action, backend=backend_id,
                       reason=why)
    self._record(seq=seq, action=action, backend=backend_id,
                 address=address, phase="aborted", reason=why)
    self._log(f"autoscale: ABORT {action} {backend_id}: {why}")
    return {"action": "abort", "of": action, "backend": backend_id,
            "reason": why}

  # -- convergence (takeover of a half-finished decision) -------------------

  def converge(self) -> dict | None:
    """Finish (or cleanly abort) a predecessor's half-done decision.

    Called by the supervisor on lease TAKEOVER, after observations are
    adopted: the gossiped ``_autoscale`` record is the dead leader's
    last word. A scale-up stuck in ``provisioning``/``warming`` either
    completes (the spawned backend answers ``/healthz``) or is retired
    as stranded; a scale-down stuck in ``retiring`` re-runs the retire
    (every step is idempotent). ``done``/``aborted`` records need
    nothing.
    """
    if self.gossip is None:
      return None
    obs = self.gossip.observation(AUTOSCALE_KEY)
    if obs is None:
      return None
    fields = obs["fields"]
    seq = int(fields.get("seq") or 0)
    self._seq = max(self._seq, seq)
    phase = fields.get("phase")
    if phase in (None, "done", "aborted"):
      return None
    action = fields.get("action")
    backend_id = fields.get("backend")
    address = fields.get("address")
    reason = f"converged after takeover: {fields.get('reason')}"
    self._log(f"autoscale: converging half-finished {action} "
              f"({backend_id} @ {address}, phase {phase})")
    if action == "up" and backend_id:
      if backend_id in self.router.backend_ids():
        # The old leader admitted it but died before recording done.
        self._record(seq=seq, action="up", backend=backend_id,
                     address=address, phase="done", reason=reason)
        return {"action": "noop", "backend": backend_id}
      if address and self._healthy(address):
        return self._admit(seq, backend_id, address, reason,
                           converged=True)
      self._retire_spawn(backend_id)
      return self._abort(seq, "up", backend_id, address,
                         "stranded scale-out (backend unreachable "
                         "after takeover)")
    if action == "down" and backend_id:
      if backend_id in self.router.backend_ids():
        return self._retire(seq, backend_id, reason, converged=True)
      self._record(seq=seq, action="down", backend=backend_id,
                   address=None, phase="done", reason=reason)
      return {"action": "noop", "backend": backend_id}
    return None

  def _healthy(self, address: str) -> bool:
    try:
      _, _, body = self.transport.request(
          "GET", f"http://{address}/healthz", timeout=2.0)
      payload = json.loads(body)
    except (ConnectionError, ValueError, UnicodeDecodeError):
      return False
    return (isinstance(payload, dict)
            and payload.get("status") in ("ok", "degraded"))

  # -- introspection --------------------------------------------------------

  def snapshot(self) -> dict:
    return {
        "policy": self.policy.snapshot(),
        "scenes": len(self.scenes),
        "provision_hook": bool(self.provision_hook),
        "eval_interval_s": self.eval_interval_s,
        "ups": self.ups,
        "downs": self.downs,
        "aborts": self.aborts,
        "converges": self.converges,
        "signal_errors": self.signal_errors,
        "last_signals": self.last_signals,
        "last_action": self.last_action,
    }
