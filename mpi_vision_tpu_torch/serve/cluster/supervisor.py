"""Self-healing fleet supervision: probe, restart, contain, roll.

A copy of ``mpi_vision_tpu/serve/cluster/supervisor.py`` with its imports
rewritten.

``BackendPool`` (pool.py) can SIGKILL and respawn backends for chaos
drills, but nothing in the routing tier *notices* a dead backend on its own —
a host loss stayed failed-over until an operator intervened, and a
crash-looping binary would have been respawned forever. This module is
the production half of a self-healing fleet:

  * **detection** — a monitor loop (injectable clock/sleep, like every
    other loop in this repo) checks each backend for process exit and
    health-probes it over ``/healthz``; ``wedge_after`` consecutive
    probe timeouts or ``unhealthy`` answers mark a still-running process
    as *wedged* (hung device, deadlocked dispatcher) and it is treated
    exactly like a corpse: killed and replaced. ``degraded`` is NOT a
    failure — a backend riding its CPU fallback or burning an SLO
    budget is answering, and restarting it would turn a partial failure
    into a total one.
  * **restart with containment** — dead/wedged backends respawn on the
    SAME port (the router's breaker re-closes through its standard
    half-open probe) after an exponential backoff
    (``resilience.RetryPolicy``), guarded by a per-backend
    ``resilience.RestartBudget``: more than ``restart_budget`` restarts
    inside ``budget_window_s`` means the backend is crash-looping, and
    it is **quarantined** — restarts stop, the router ejects it for
    good, ``backend_quarantined`` is emitted, and the remaining
    replicas keep serving. ``readmit()`` is the operator's way back in.
  * **rolling restart under live traffic** — ``rolling_restart()``
    takes backends down one at a time: eject from the router (planned
    downtime must not look like failure — no failed attempts, no
    breaker transitions), drain, SIGTERM (the backend finishes its
    in-flight requests), respawn on the same port, readmit, and wait
    for the router's breaker to be closed again before touching the
    next backend. With ``replication >= 2`` the replica walk covers
    every scene throughout, so clients see zero failed requests — the
    drainless redeploy live checkpoint reload was built for.

Every lifecycle decision lands in ``obs/events.py`` (``backend_restart``,
``backend_quarantined``, ``rolling_restart_{begin,step,end}``; the
router adds ``backend_eject``/``backend_readmit``) and in the router's
``mpi_cluster_{restarts,quarantines}_total`` metrics, so an incident
review reads one ``/debug/events`` stream instead of N hosts' stderr.
"""

from __future__ import annotations

import json
import random
import signal
import threading
import time

from mpi_vision_tpu_torch.obs.events import EventLog
from mpi_vision_tpu_torch.serve.resilience import RestartBudget, RetryPolicy


class _Supervised:
  """One backend's supervision record (guarded by the supervisor lock)."""

  __slots__ = ("state", "probe_failures", "attempt", "restarts",
               "restart_failures", "next_restart_at", "last_restart_at",
               "budget", "last_probe_status", "last_reason")

  def __init__(self, budget: RestartBudget):
    self.state = FleetSupervisor.UP
    self.probe_failures = 0
    self.attempt = 0  # consecutive crash-loop restarts (backoff input)
    self.restarts = 0
    self.restart_failures = 0
    self.next_restart_at: float | None = None
    self.last_restart_at: float | None = None
    self.budget = budget
    self.last_probe_status: str | None = None
    self.last_reason: str | None = None


class FleetSupervisor:
  """Monitor, restart, quarantine, and roll a pool of serve backends.

  Args:
    pool: the backend pool (``BackendPool`` or anything with
      ``addresses()`` / ``alive(id)`` / ``kill(id, sig)`` /
      ``restart(id)``).
    router: optional ``Router`` — gets ``eject``/``readmit`` calls
      around every planned or detected outage, and its
      ``mpi_cluster_{restarts,quarantines}_total`` counters.
    events: lifecycle event log (share the router's so ``/debug/events``
      tells the whole story; a private one is made if omitted).
    probe_s: monitor-loop period.
    probe_timeout_s: per-backend ``/healthz`` probe budget.
    wedge_after: consecutive failed probes (timeout / ``unhealthy`` /
      garbage) that declare a still-running backend wedged.
    restart_budget / budget_window_s: per-backend crash-loop guard
      (``resilience.RestartBudget``) — more restarts than this inside
      the window quarantines the backend instead of respawning it.
    backoff_base_s / backoff_mult / backoff_max_s: exponential restart
      backoff (``resilience.RetryPolicy``; first restart of an episode
      is immediate, repeats back off).
    load_refresh_s: feed the router's load-aware replica table from one
      ``/stats`` fan-out at most this often (<= 0 disables).
    transport: injectable HTTP transport (tests); default
      ``router.HttpTransport`` semantics — raises ``ConnectionError``
      when no HTTP conversation happened.
    clock / sleep: injectable time sources (the serve/-wide lint rule).
    log: diagnostics sink (None = silent).
    lease: optional supervision lease (``lease.FileLease`` /
      ``lease.GossipLease``) — every tick must hold it before probing,
      so exactly one of N router replicas supervises at a time; losing
      it (``SupervisionLeaseLost``) demotes this supervisor to standby,
      and acquiring one marked ``takeover`` adopts the previous
      leader's gossiped budget/quarantine state first (a crash-looper
      cannot reset its countdown by outliving its supervisor).
    gossip: optional ``gossip.GossipState`` this supervisor publishes
      its per-backend observations into (and adopts them from on
      takeover).
    autoscaler: optional ``autoscale.Autoscaler`` — ticked after every
      probe pass WHILE the lease is held (the single-actuator
      guarantee: standby replicas never scale), and asked to
      ``converge()`` a predecessor's half-finished decision on
      takeover.
  """

  UP = "up"
  DOWN = "down"
  RESTARTING = "restarting"
  QUARANTINED = "quarantined"

  def __init__(self, pool, router=None, events: EventLog | None = None,
               probe_s: float = 1.0, probe_timeout_s: float = 2.0,
               wedge_after: int = 3, restart_budget: int = 3,
               budget_window_s: float = 60.0, backoff_base_s: float = 0.5,
               backoff_mult: float = 2.0, backoff_max_s: float = 15.0,
               load_refresh_s: float = 2.0, transport=None,
               clock=time.monotonic, sleep=None, log=None,
               lease=None, gossip=None, autoscaler=None):
    if probe_s <= 0:
      raise ValueError(f"probe_s must be > 0, got {probe_s}")
    if wedge_after < 1:
      raise ValueError(f"wedge_after must be >= 1, got {wedge_after}")
    # Fail at construction, not inside the monitor loop: _loop swallows
    # tick exceptions by design, so a lazily-raised RestartBudget
    # ValueError would leave supervision silently dead.
    if restart_budget < 1:
      raise ValueError(f"restart_budget must be >= 1, got {restart_budget}")
    if budget_window_s <= 0:
      raise ValueError(
          f"budget_window_s must be > 0, got {budget_window_s}")
    self.pool = pool
    self.router = router
    self.events = events if events is not None else EventLog()
    self.probe_s = float(probe_s)
    self.probe_timeout_s = float(probe_timeout_s)
    self.wedge_after = int(wedge_after)
    self.restart_budget = int(restart_budget)
    self.budget_window_s = float(budget_window_s)
    # Reuse the serving retry policy's backoff curve (jitter off: two
    # supervisors never race one pool, and determinism is worth more).
    self._backoff_policy = RetryPolicy(
        max_retries=0, backoff_base_s=float(backoff_base_s),
        backoff_mult=float(backoff_mult), backoff_max_s=float(backoff_max_s),
        jitter=0.0)
    self._backoff_rng = random.Random(0)  # unused at jitter 0; API-required
    self.load_refresh_s = float(load_refresh_s)
    if transport is not None:
      self.transport = transport
    else:
      from mpi_vision_tpu_torch.serve.cluster.router import HttpTransport

      self.transport = HttpTransport()
    self._clock = clock
    self._sleep = sleep if sleep is not None else time.sleep
    self._log = log if log is not None else (lambda msg: None)
    # Two locks, the CheckpointWatcher pattern: _op_lock serializes
    # whole supervision operations (a tick, a rolling restart) and is
    # held across seconds-long respawns; _lock guards only the small
    # state table so snapshot()/state() never block behind a restart.
    self._op_lock = threading.Lock()
    self._lock = threading.Lock()
    self._states: dict[str, _Supervised] = {}
    self._stop = threading.Event()
    self._thread: threading.Thread | None = None
    self._last_load_refresh: float | None = None
    self.ticks = 0
    self.tick_errors = 0
    self.restarts_total = 0
    self.quarantines_total = 0
    self.lease = lease
    self.gossip = gossip
    self._lease_held = False
    self.takeovers_total = 0
    self.autoscaler = autoscaler
    self.autoscale_errors = 0
    if autoscaler is not None:
      autoscaler.supervisor = self  # victim selection needs quarantines

  # -- state access --------------------------------------------------------

  def _state_for(self, backend_id: str) -> _Supervised:
    with self._lock:
      st = self._states.get(backend_id)
      if st is None:
        st = self._states[backend_id] = _Supervised(RestartBudget(
            max_restarts=self.restart_budget,
            window_s=self.budget_window_s, clock=self._clock))
      return st

  def state(self, backend_id: str) -> str | None:
    with self._lock:
      st = self._states.get(str(backend_id))
      return st.state if st is not None else None

  def quarantined(self) -> list[str]:
    with self._lock:
      return sorted(b for b, st in self._states.items()
                    if st.state == self.QUARANTINED)

  def snapshot(self) -> dict:
    with self._lock:
      backends = {}
      for backend_id in sorted(self._states):
        st = self._states[backend_id]
        backends[backend_id] = {
            "state": st.state,
            "restarts": st.restarts,
            "restart_failures": st.restart_failures,
            "probe_failures": st.probe_failures,
            "last_probe_status": st.last_probe_status,
            "last_reason": st.last_reason,
            "budget": st.budget.snapshot(),
        }
      out = {
          "ticks": self.ticks,
          "tick_errors": self.tick_errors,
          "restarts": self.restarts_total,
          "quarantines": self.quarantines_total,
          "probe_s": self.probe_s,
          "wedge_after": self.wedge_after,
          "restart_budget": self.restart_budget,
          "budget_window_s": self.budget_window_s,
          "lease_held": self._lease_held,
          "takeovers": self.takeovers_total,
          "autoscale_errors": self.autoscale_errors,
          "backends": backends,
      }
    if self.autoscaler is not None:
      # Outside _lock: the autoscaler snapshot is its own state.
      out["autoscale"] = self.autoscaler.snapshot()
    return out

  # -- probing -------------------------------------------------------------

  def _probe_status(self, address: str) -> str:
    """One ``/healthz`` probe -> its ``status`` string, ``"unreachable"``
    on transport failure/timeout, ``"garbage"`` on an unparseable body."""
    try:
      _, _, body = self.transport.request(
          "GET", f"http://{address}/healthz",
          timeout=self.probe_timeout_s)
    except ConnectionError:
      return "unreachable"
    try:
      payload = json.loads(body)
    except (ValueError, UnicodeDecodeError):
      return "garbage"
    status = payload.get("status") if isinstance(payload, dict) else None
    return status if isinstance(status, str) else "garbage"

  # -- the monitor loop ----------------------------------------------------

  def tick(self) -> None:
    """One monitor pass over every pool backend (tests drive this by
    hand with fake clocks; the ``start()`` thread calls it on a cadence).

    Probes run serially under the operation lock — a deliberate
    simplicity trade: with several SIMULTANEOUSLY wedged backends a
    tick can take ``wedged x probe_timeout_s``, delaying wedge
    declarations and blocking ``readmit``/``rolling_restart`` on the
    lock for that long. Fine at this tier's pool sizes (a handful of
    hosts, 2 s probe budget); a fleet of dozens should fan probes out
    like the router's ``_fan_out_each`` does.
    """
    with self._op_lock:
      with self._lock:
        self.ticks += 1
      if not self._ensure_lease():
        return  # standby replica: a peer supervises; just keep trying
      for backend_id, address in sorted(self.pool.addresses().items()):
        st = self._state_for(backend_id)
        if st.state == self.QUARANTINED:
          continue
        if not self.pool.alive(backend_id):
          self._handle_down(backend_id, st,
                            st.last_reason if st.state == self.DOWN
                            else "process exit")
          continue
        status = self._probe_status(address)
        with self._lock:
          st.last_probe_status = status
        if status in ("ok", "degraded"):
          self._mark_recovered(backend_id, st)
          continue
        with self._lock:
          st.probe_failures += 1
          failures = st.probe_failures
        if failures >= self.wedge_after:
          # The process is alive but not answering (or persistently
          # unhealthy): a wedged backend serves nothing and blocks its
          # port — replace it like a corpse.
          self._handle_down(
              backend_id, st,
              st.last_reason if st.state == self.DOWN
              else f"wedged: {status} x{failures}")
      self._refresh_router_load()
      self._publish_observations()
      if self.autoscaler is not None:
        try:
          self.autoscaler.tick()
        except Exception as e:  # noqa: BLE001 - scaling never kills probing
          with self._lock:
            self.autoscale_errors += 1
          self._log(f"supervisor: autoscale tick failed: {e!r}")

  # -- leased supervision (router HA) --------------------------------------

  def _ensure_lease(self) -> bool:
    """Hold (or try to take) the supervision lease; False = standby.

    Heartbeats every tick while held; ``SupervisionLeaseLost`` demotes
    to standby (a peer reaped a wedged heartbeat — it supervises now).
    Acquiring a lease marked ``takeover`` adopts the dead leader's
    gossiped observations BEFORE the first probe pass, so in-window
    budget spends and quarantine verdicts survive the handoff.
    """
    if self.lease is None:
      if not self._lease_held:
        self._lease_held = True
        if self.router is not None:
          self.router.metrics.record_lease_held(True)
      return True
    from mpi_vision_tpu_torch.serve.cluster.lease import SupervisionLeaseLost

    if self._lease_held:
      try:
        self.lease.heartbeat()
        return True
      except SupervisionLeaseLost as e:
        self._lease_held = False
        if self.router is not None:
          self.router.metrics.record_lease_held(False)
        self.events.emit("supervision_lease_lost", owner=self.lease.owner,
                         error=str(e))
        self._log(f"supervisor: lease lost, standing by: {e}")
        return False
    got = self.lease.try_acquire()
    if got is None:
      return False
    self._lease_held = True
    if self.router is not None:
      self.router.metrics.record_lease_held(True)
    if got.get("takeover"):
      with self._lock:
        self.takeovers_total += 1
      if self.router is not None:
        self.router.metrics.record_takeover()
      self.events.emit("supervision_takeover", owner=self.lease.owner,
                       previous=got.get("previous"))
      self._log(f"supervisor: TOOK OVER supervision from "
                f"{got.get('previous')}")
      self._adopt_observations()
      if self.autoscaler is not None:
        try:
          self.autoscaler.converge()
        except Exception as e:  # noqa: BLE001 - takeover must complete
          with self._lock:
            self.autoscale_errors += 1
          self._log(f"supervisor: autoscale converge failed: {e!r}")
    else:
      self.events.emit("supervision_lease_acquired",
                       owner=self.lease.owner)
      self._log("supervisor: supervision lease acquired")
    return True

  def _adopt_observations(self) -> None:
    """Seed local supervision state from gossiped observations (the
    no-budget-reset half of takeover): in-window budget spends travel
    as ages re-aged by the observation's own staleness, and a gossiped
    quarantine verdict stays quarantined + ejected here."""
    if self.gossip is None:
      return
    from mpi_vision_tpu_torch.serve.cluster.autoscale import AUTOSCALE_KEY

    now = self.gossip.now()
    for backend_id, obs in sorted(self.gossip.observations().items()):
      fields = obs["fields"]
      if backend_id == AUTOSCALE_KEY or fields.get("state") == "retired":
        # The reserved decision record is not a backend, and a
        # deliberately retired backend must not be resurrected as a
        # supervision entry (the autoscaler's converge() owns both).
        continue
      st = self._state_for(backend_id)
      staleness = max(0.0, now - obs["version"])
      ages = fields.get("budget_ages_s")
      if isinstance(ages, list):
        try:
          st.budget.seed_ages(a + staleness for a in ages)
        except (TypeError, ValueError):
          pass  # malformed gossip never breaks supervision
      if fields.get("quarantined"):
        with self._lock:
          st.state = self.QUARANTINED
          st.last_reason = fields.get("reason") or "quarantined (adopted)"
        if self.router is not None:
          self.router.eject(backend_id, reason="quarantined")

  def _publish_observations(self) -> None:
    """Publish this supervisor's per-backend verdicts into the gossip
    state (versions only bump on change, so steady state is silent)."""
    if self.gossip is None:
      return
    with self._lock:
      states = {b: (st.state, st.last_reason, st.budget.spend_ages())
                for b, st in self._states.items()}
    for backend_id, (state, reason, ages) in sorted(states.items()):
      self.gossip.observe(
          backend_id, state=state,
          quarantined=state == self.QUARANTINED,
          ejected=state in (self.DOWN, self.RESTARTING),
          reason=reason,
          budget_ages_s=[round(a, 3) for a in ages])

  def _refresh_router_load(self) -> None:
    if (self.router is None or not self.router.load_aware
        or self.load_refresh_s <= 0):
      return
    now = self._clock()
    if (self._last_load_refresh is not None
        and now - self._last_load_refresh < self.load_refresh_s):
      return
    self._last_load_refresh = now
    self.router.refresh_load()

  def _mark_recovered(self, backend_id: str, st: _Supervised) -> None:
    with self._lock:
      was = st.state
      st.probe_failures = 0
      if st.state == self.UP:
        return
      st.state = self.UP
      st.next_restart_at = None
    # A wedge that un-wedged itself before the backoff elapsed: put the
    # backend back in rotation without burning a restart.
    if self.router is not None:
      self.router.readmit(backend_id)
    self._log(f"supervisor: {backend_id} recovered ({was} -> up) "
              "without a restart")

  def _handle_down(self, backend_id: str, st: _Supervised,
                   reason: str | None) -> None:
    reason = reason or "down"
    now = self._clock()
    with self._lock:
      first_detection = st.state != self.DOWN
      if first_detection:
        st.state = self.DOWN
        st.last_reason = reason
        # A backend that ran longer than the budget window since its
        # last restart is not crash-looping: backoff starts over.
        if (st.last_restart_at is None
            or now - st.last_restart_at > self.budget_window_s):
          st.attempt = 0
        st.next_restart_at = now + self._backoff_s(st.attempt)
      next_at = st.next_restart_at
    if first_detection:
      if self.router is not None:
        self.router.eject(backend_id, reason=reason)
      self._log(f"supervisor: {backend_id} down ({reason}); restart in "
                f"{max(next_at - now, 0.0):.2f}s")
    if next_at is not None and now < next_at:
      return  # backoff still cooling
    if not st.budget.try_spend():
      self._quarantine(backend_id, st, reason)
      return
    self._restart(backend_id, st, reason)

  def _backoff_s(self, attempt: int) -> float:
    if attempt <= 0:
      return 0.0  # first restart of an episode is immediate
    return self._backoff_policy.backoff_s(attempt, self._backoff_rng)

  def _note_restart(self, backend_id: str, st: _Supervised,
                    reason: str | None, attempt: int,
                    emit_event: bool = True) -> int:
    """Shared bookkeeping for every SUCCESSFUL respawn — crash/wedge
    recovery, a rolling-restart step, an operator readmit. One place
    keeps the per-backend record, ``restarts_total``, the router's
    ``mpi_cluster_restarts_total`` + readmit, and the
    ``backend_restart`` event in sync (rolling steps emit their own
    ``rolling_restart_step`` instead)."""
    with self._lock:
      st.restarts += 1
      st.last_restart_at = self._clock()
      st.next_restart_at = None
      st.probe_failures = 0
      st.state = self.UP
      self.restarts_total += 1
      restarts = st.restarts
    if self.router is not None:
      self.router.metrics.record_restart(backend_id)
      self.router.readmit(backend_id)
    if emit_event:
      self.events.emit("backend_restart", backend=backend_id, ok=True,
                       reason=reason, attempt=attempt, restarts=restarts)
    return restarts

  def _restart(self, backend_id: str, st: _Supervised, reason: str) -> None:
    with self._lock:
      st.state = self.RESTARTING
      st.attempt += 1
      attempt = st.attempt
    if self.pool.alive(backend_id):
      # Wedged: the old process still holds the port; evict it hard (it
      # stopped answering — there is nothing to drain).
      self.pool.kill(backend_id, signal.SIGKILL)
    try:
      self.pool.restart(backend_id)
    except Exception as e:  # noqa: BLE001 - a failed spawn is a crash too
      now = self._clock()
      with self._lock:
        st.restart_failures += 1
        st.state = self.DOWN
        st.next_restart_at = now + self._backoff_s(st.attempt)
      self.events.emit("backend_restart", backend=backend_id, ok=False,
                       reason=reason, attempt=attempt, error=repr(e))
      self._log(f"supervisor: restart of {backend_id} failed: {e!r}")
      return
    restarts = self._note_restart(backend_id, st, reason, attempt)
    self._log(f"supervisor: restarted {backend_id} ({reason}; "
              f"attempt {attempt}, lifetime restarts {restarts})")

  def _quarantine(self, backend_id: str, st: _Supervised,
                  reason: str) -> None:
    with self._lock:
      st.state = self.QUARANTINED
      self.quarantines_total += 1
      budget = st.budget.snapshot()
      restarts = st.restarts
    if self.pool.alive(backend_id):
      self.pool.kill(backend_id, signal.SIGKILL)  # no half-alive zombies
    if self.router is not None:
      self.router.metrics.record_quarantine(backend_id)
      self.router.eject(backend_id, reason="quarantined")
    self.events.emit("backend_quarantined", backend=backend_id,
                     reason=reason, restarts=restarts,
                     budget=budget["max_restarts"],
                     window_s=budget["window_s"])
    self._log(f"supervisor: QUARANTINED {backend_id} ({reason}): "
              f"{budget['max_restarts']} restarts inside "
              f"{budget['window_s']:g}s exhausted the budget; replicas "
              "keep serving; readmit() to retry")

  def readmit(self, backend_id: str) -> None:
    """Operator override: forget the quarantine, respawn if dead, and
    put the backend back in rotation (fresh budget and backoff)."""
    with self._op_lock:
      st = self._state_for(backend_id)
      with self._lock:
        st.budget.reset()
        st.attempt = 0
        st.probe_failures = 0
        st.next_restart_at = None
        st.last_reason = None
      if not self.pool.alive(backend_id):
        self.pool.restart(backend_id)  # raises to the operator on failure
        # Only a real respawn is a restart — readmitting an
        # already-running backend must not fabricate a count or event.
        self._note_restart(backend_id, st, "readmit", 0)
      else:
        with self._lock:
          st.state = self.UP
        if self.router is not None:
          self.router.readmit(backend_id)
      self._log(f"supervisor: {backend_id} readmitted")

  def forget(self, backend_id: str) -> None:
    """Drop a backend's supervision record (autoscale retirement: the
    backend is GONE by policy, and republishing its stale state would
    overwrite the ``retired`` gossip verdict every tick). Quarantined
    records are refused — quarantine is evidence, not capacity, and
    the autoscaler never selects a quarantined victim."""
    with self._lock:
      st = self._states.get(str(backend_id))
      if st is not None and st.state == self.QUARANTINED:
        raise ValueError(
            f"refusing to forget quarantined backend {backend_id!r}; "
            "readmit() it first")
      self._states.pop(str(backend_id), None)

  # -- rolling restart -----------------------------------------------------

  def rolling_restart(self, drain_s: float = 0.2,
                      settle_timeout_s: float = 60.0) -> dict:
    """Restart every non-quarantined backend, one at a time, under live
    traffic — the drainless redeploy.

    Per backend: eject from the router (planned downtime must not spend
    failed attempts or open a breaker), let already-dispatched forwards
    drain for ``drain_s``, SIGTERM (the serve CLI finishes in-flight
    requests before exiting), respawn on the same port, readmit, and
    wait up to ``settle_timeout_s`` for the router's breaker on that
    backend to be CLOSED (it re-closes through the standard half-open
    probe if unplanned failures had opened it) before moving on. With
    ``replication >= 2`` every scene keeps a live replica throughout,
    so clients see zero failed requests.

    Holds the supervision lock for the whole roll: the monitor loop
    cannot mistake a planned kill for a crash (and cannot burn restart
    budget on one). Returns a report dict with per-step outcomes.
    """
    with self._op_lock:
      order = [b for b in sorted(self.pool.addresses())
               if self.state(b) != self.QUARANTINED]
      self.events.emit("rolling_restart_begin", backends=order)
      self._log(f"supervisor: rolling restart over {order}")
      report = {"backends": order, "steps": [], "ok": True}
      for backend_id in order:
        step = self._rolling_step(backend_id, drain_s, settle_timeout_s)
        self.events.emit("rolling_restart_step", backend=backend_id,
                         ok=step["ok"])
        report["steps"].append(step)
        report["ok"] = report["ok"] and step["ok"]
      self.events.emit("rolling_restart_end", ok=report["ok"],
                       backends=order)
      self._log(f"supervisor: rolling restart "
                f"{'complete' if report['ok'] else 'FAILED'}")
      return report

  def _rolling_step(self, backend_id: str, drain_s: float,
                    settle_timeout_s: float) -> dict:
    st = self._state_for(backend_id)
    step: dict = {"backend": backend_id, "ok": False}
    if self.router is not None:
      self.router.eject(backend_id, reason="rolling_restart")
    if drain_s > 0:
      self._sleep(drain_s)  # dispatched forwards finish on the old proc
    try:
      if self.pool.alive(backend_id):
        self.pool.kill(backend_id, signal.SIGTERM)  # graceful drain
      self.pool.restart(backend_id)
    except Exception as e:  # noqa: BLE001 - the roll must report, not die
      # Leave the backend ejected and marked down: the monitor loop owns
      # recovery from here (budgeted restarts, quarantine on a loop).
      step["error"] = repr(e)
      with self._lock:
        st.state = self.DOWN
        st.last_reason = "rolling restart respawn failed"
        st.next_restart_at = self._clock()
      self._log(f"supervisor: rolling step {backend_id} failed: {e!r}")
      return step
    self._note_restart(backend_id, st, "rolling_restart", 0,
                       emit_event=False)  # the step event covers it
    with self._lock:
      st.attempt = 0  # a planned restart is not a crash-loop repeat
    if self.router is not None:
      deadline = self._clock() + settle_timeout_s
      state = self.router.breaker_state(backend_id)
      while (state is not None and state != "closed"
             and self._clock() < deadline):
        self._sleep(min(self.probe_s, 0.05))
        state = self.router.breaker_state(backend_id)
      step["breaker"] = state
      step["ok"] = state is None or state == "closed"
    else:
      step["ok"] = True
    return step

  # -- lifecycle -----------------------------------------------------------

  def start(self) -> "FleetSupervisor":
    if self._thread is not None:
      raise RuntimeError("FleetSupervisor already started")
    self._stop.clear()
    self._thread = threading.Thread(target=self._loop,
                                    name="mpi-fleet-supervisor",
                                    daemon=True)
    self._thread.start()
    return self

  def _loop(self) -> None:
    while not self._stop.is_set():
      try:
        self.tick()
      except Exception as e:  # noqa: BLE001 - the monitor must not die
        with self._lock:
          self.tick_errors += 1
        self._log(f"supervisor: tick failed: {e!r}")
      if self._stop.wait(self.probe_s):
        return

  def stop(self, timeout: float = 30.0) -> None:
    self._stop.set()
    thread = self._thread
    if thread is not None:
      thread.join(timeout)
      self._thread = None
    if self.lease is not None and self._lease_held:
      # Clean shutdown hands the lease over immediately (a peer's next
      # try_acquire succeeds without waiting out the TTL); a SIGKILLed
      # holder skips this and the TTL reap is the takeover path.
      try:
        self.lease.release()
      except OSError:
        pass
      self._lease_held = False
      if self.router is not None:
        self.router.metrics.record_lease_held(False)

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.stop()
