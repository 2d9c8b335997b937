"""The port's self-healing fleet supervisor: the unit state machine.

The fake-based cases of ``tests/serve/test_supervisor.py``, run against
the port's copy: a fake pool, a fake transport, and a fake clock drive
every edge of the state machine deterministically — exit/wedge
detection, exponential restart backoff, crash-loop quarantine at the
budget, wedge recovery without a restart, rolling-restart sequencing,
eject/readmit integration with a real ``Router``. Then one scripted
fleet life through both packages' supervisors and routers, compared
call for call. The real-process cases are in
``tests/test_torch_cluster_live.py``.
"""

import json
import signal

from mpi_vision_tpu.serve.cluster import FleetSupervisor as JFleetSupervisor
from mpi_vision_tpu.serve.cluster import Router as JRouter
from mpi_vision_tpu_torch.obs import parse_metrics_text
from mpi_vision_tpu_torch.serve.cluster import (
    FleetSupervisor,
    Router,
)
from mpi_vision_tpu_torch.serve.resilience import RestartBudget, RetryBudget


# --- budget units --------------------------------------------------------


class FakeClock:
  def __init__(self, t=1000.0):
    self.t = t

  def __call__(self):
    return self.t


def test_restart_budget_window_slides():
  clock = FakeClock()
  budget = RestartBudget(max_restarts=2, window_s=10.0, clock=clock)
  assert budget.try_spend() and budget.try_spend()
  assert not budget.try_spend()  # exhausted
  assert budget.remaining() == 0 and budget.snapshot()["refused"] == 1
  clock.t += 10.1  # the window slides past both spends
  assert budget.remaining() == 2
  assert budget.try_spend()


def test_retry_budget_deposits_and_refuses_when_dry():
  budget = RetryBudget(ratio=0.5, initial=1.0, cap=2.0)
  assert budget.try_withdraw()
  assert not budget.try_withdraw()  # dry
  for _ in range(4):  # 4 * 0.5 = 2 tokens, capped at 2
    budget.deposit()
  assert budget.try_withdraw() and budget.try_withdraw()
  assert not budget.try_withdraw()
  snap = budget.snapshot()
  assert snap["withdrawals"] == 3 and snap["refused"] == 2


# --- supervisor over fakes ----------------------------------------------


class FakePool:
  """Process-control fake: alive flags flip on kill/restart; every call
  is recorded so tests assert the exact kill/respawn sequence."""

  def __init__(self, backends=("b0", "b1", "b2")):
    self.addrs = {b: f"host-{b}:1" for b in backends}
    self._alive = {b: True for b in backends}
    self.kills: list[tuple[str, int]] = []
    self.restarts: list[str] = []
    self.fail_restarts: set[str] = set()

  def addresses(self):
    return dict(self.addrs)

  def alive(self, backend_id):
    return self._alive[backend_id]

  def kill(self, backend_id, sig=signal.SIGKILL):
    self.kills.append((backend_id, sig))
    self._alive[backend_id] = False

  def restart(self, backend_id):
    self.restarts.append(backend_id)
    if backend_id in self.fail_restarts:
      raise RuntimeError("spawn failed")
    self._alive[backend_id] = True
    return self.addrs[backend_id]

  def die(self, backend_id):  # the crash itself (no signal recorded)
    self._alive[backend_id] = False


class FakeTransport:
  """address -> handler(method, path) -> (status, headers, body);
  raising ConnectionError simulates a dead/hung host."""

  def __init__(self):
    self.handlers = {}

  def set(self, address, handler):
    self.handlers[address] = handler

  def set_health(self, address, status):
    def handler(method, path):
      if path == "/healthz":
        return 200, {}, json.dumps({"status": status}).encode()
      if path == "/stats":
        return 200, {}, json.dumps({"queue_depth": 0}).encode()
      return 404, {}, b"{}"
    self.handlers[address] = handler

  def set_dead(self, address):
    def handler(method, path):
      raise ConnectionError("connection refused")
    self.handlers[address] = handler

  def request(self, method, url, body=None, headers=None, timeout=30.0):
    address, _, path = url[len("http://"):].partition("/")
    return self.handlers[address]("GET", "/" + path)


def _fake_fleet(clock=None, router=True, **sup_kwargs):
  clock = clock if clock is not None else FakeClock()
  pool = FakePool()
  transport = FakeTransport()
  for addr in pool.addrs.values():
    transport.set_health(addr, "ok")
  rt = None
  events = None
  if router:
    rt = Router(pool.addrs, replication=2, transport=transport,
                clock=clock)
    events = rt.events  # one log tells the whole story (the CLI wiring)
  sup = FleetSupervisor(
      pool, router=rt, events=events, transport=transport, clock=clock,
      sleep=lambda s: None, load_refresh_s=0, **sup_kwargs)
  return pool, transport, rt, sup, clock


def test_supervisor_restarts_a_dead_backend_and_readmits():
  pool, transport, router, sup, clock = _fake_fleet()
  pool.die("b1")
  sup.tick()
  assert pool.restarts == ["b1"] and pool.alive("b1")
  assert sup.state("b1") == FleetSupervisor.UP
  assert router.ejected() == []  # ejected on detection, readmitted after
  assert router.metrics.snapshot()["restarts"] == {"b1": 1}
  events = sup.events.snapshot()["by_kind"]
  assert events["backend_restart"] == 1
  assert events.get("backend_eject", 0) == 1  # router-side edges logged
  assert events.get("backend_readmit", 0) == 1


def test_supervisor_wedged_backend_is_killed_and_replaced():
  pool, transport, router, sup, clock = _fake_fleet(wedge_after=3)
  transport.set_dead(pool.addrs["b2"])  # alive but not answering
  for _ in range(2):
    sup.tick()
  assert pool.restarts == []  # below wedge_after: not declared dead yet
  sup.tick()  # 3rd consecutive failure: wedged -> SIGKILL -> respawn
  assert ("b2", signal.SIGKILL) in pool.kills
  assert pool.restarts == ["b2"]
  assert sup.snapshot()["backends"]["b2"]["restarts"] == 1
  # A persistently-unhealthy answer wedges the same way a timeout does
  # (this one is a repeat inside the budget window, so it backs off).
  transport.set_health(pool.addrs["b2"], "unhealthy")
  for _ in range(3):
    sup.tick()
  assert pool.restarts == ["b2"]  # detected; 0.5s backoff cooling
  clock.t += 0.6
  sup.tick()
  assert pool.restarts == ["b2", "b2"]


def test_supervisor_degraded_backend_is_left_alone():
  pool, transport, router, sup, clock = _fake_fleet(wedge_after=1)
  transport.set_health(pool.addrs["b0"], "degraded")
  for _ in range(5):
    sup.tick()
  # Degraded answers (CPU fallback, SLO burn): restarting it would turn
  # a partial failure into a total one.
  assert pool.restarts == [] and pool.kills == []
  assert sup.state("b0") == FleetSupervisor.UP


def test_supervisor_exponential_backoff_between_crash_loop_restarts():
  pool, transport, router, sup, clock = _fake_fleet(
      restart_budget=10, budget_window_s=1000.0, backoff_base_s=0.5,
      backoff_mult=2.0, backoff_max_s=8.0)
  pool.die("b1")
  sup.tick()
  assert len(pool.restarts) == 1  # first restart of an episode: immediate
  pool.die("b1")  # crashed right back
  clock.t += 0.1
  sup.tick()  # detection starts the 0.5s backoff clock
  assert len(pool.restarts) == 1  # still cooling
  clock.t += 0.4
  sup.tick()
  assert len(pool.restarts) == 1  # 0.4 < 0.5: still cooling
  clock.t += 0.1
  sup.tick()
  assert len(pool.restarts) == 2
  pool.die("b1")
  sup.tick()  # detection: second repeat backs off 1.0s
  clock.t += 0.6
  sup.tick()
  assert len(pool.restarts) == 2  # 0.6 < 1.0: still cooling
  clock.t += 0.5
  sup.tick()
  assert len(pool.restarts) == 3


def test_supervisor_backoff_resets_after_a_long_healthy_run():
  pool, transport, router, sup, clock = _fake_fleet(
      restart_budget=10, budget_window_s=60.0, backoff_base_s=0.5)
  pool.die("b1")
  sup.tick()
  pool.die("b1")
  sup.tick()  # detection: 0.5s backoff (a repeat crash)
  clock.t += 0.6
  sup.tick()
  assert len(pool.restarts) == 2
  clock.t += 61.0  # ran past the budget window: not a crash loop
  pool.die("b1")
  sup.tick()
  assert len(pool.restarts) == 3  # immediate again, no carried backoff


def test_supervisor_quarantines_a_crash_looper_at_the_budget():
  pool, transport, router, sup, clock = _fake_fleet(
      restart_budget=2, budget_window_s=1000.0, backoff_base_s=0.1,
      backoff_max_s=0.1)
  for _ in range(5):
    pool.die("b1")
    sup.tick()
    clock.t += 0.2  # clear every backoff
    sup.tick()
  assert sup.state("b1") == FleetSupervisor.QUARANTINED
  assert len(pool.restarts) == 2  # exactly the budget, then containment
  assert sup.quarantined() == ["b1"]
  # Quarantine is sticky: more ticks, no more respawns.
  for _ in range(5):
    clock.t += 1.0
    sup.tick()
  assert len(pool.restarts) == 2
  # The router ejected it for good and counts the quarantine — and the
  # eject reason ESCALATED from the transient crash reason to the
  # permanent verdict (an operator reading /stats must see why it is
  # out of rotation NOW, not why it first went down).
  assert router.ejected() == ["b1"]
  assert router.stats()["backend_info"]["b1"]["eject_reason"] \
      == "quarantined"
  assert router.metrics.snapshot()["quarantines"] == {"b1": 1}
  families = parse_metrics_text(router._cluster_registry().render())
  assert families["mpi_cluster_quarantines_total"]["samples"][
      ("mpi_cluster_quarantines_total", (("backend", "b1"),))] == 1
  assert families["mpi_cluster_backend_up"]["samples"][
      ("mpi_cluster_backend_up", (("backend", "b1"),))] == 0
  assert sup.events.count("backend_quarantined") == 1


def test_supervisor_failed_respawn_counts_and_retries_until_quarantine():
  pool, transport, router, sup, clock = _fake_fleet(
      restart_budget=3, budget_window_s=1000.0, backoff_base_s=0.1,
      backoff_max_s=0.1)
  pool.fail_restarts.add("b0")
  pool.die("b0")
  for _ in range(10):
    sup.tick()
    clock.t += 0.2
  assert sup.state("b0") == FleetSupervisor.QUARANTINED
  snap = sup.snapshot()["backends"]["b0"]
  assert snap["restart_failures"] == 3 and snap["restarts"] == 0


def test_supervisor_wedge_that_recovers_is_readmitted_without_restart():
  pool, transport, router, sup, clock = _fake_fleet(
      wedge_after=1, backoff_base_s=5.0)
  pool.fail_restarts.add("b2")  # the respawn fails: backend stays down
  transport.set_dead(pool.addrs["b2"])
  sup.tick()
  assert sup.state("b2") == FleetSupervisor.DOWN
  assert router.ejected() == ["b2"]
  pool.fail_restarts.clear()
  pool._alive["b2"] = True  # the zombie un-wedged on its own
  transport.set_health(pool.addrs["b2"], "ok")
  sup.tick()
  assert sup.state("b2") == FleetSupervisor.UP
  assert router.ejected() == []  # back in rotation, no restart burned
  assert sup.snapshot()["backends"]["b2"]["restarts"] == 0


def test_supervisor_readmit_clears_quarantine_and_respawns():
  pool, transport, router, sup, clock = _fake_fleet(
      restart_budget=1, budget_window_s=1000.0, backoff_base_s=0.1)
  pool.die("b1")
  sup.tick()
  pool.die("b1")
  clock.t += 0.2
  sup.tick()
  clock.t += 0.2
  sup.tick()
  assert sup.state("b1") == FleetSupervisor.QUARANTINED
  sup.readmit("b1")
  assert sup.state("b1") == FleetSupervisor.UP and pool.alive("b1")
  assert router.ejected() == []
  assert sup.snapshot()["backends"]["b1"]["budget"]["remaining"] == 1


def test_supervisor_rolling_restart_sequences_and_reports():
  pool, transport, router, sup, clock = _fake_fleet()
  report = sup.rolling_restart(drain_s=0.0)
  assert report["ok"] and report["backends"] == ["b0", "b1", "b2"]
  assert pool.restarts == ["b0", "b1", "b2"]  # one at a time, in order
  # Planned downtime drains via SIGTERM, never SIGKILL.
  assert [k for k in pool.kills] == [
      ("b0", signal.SIGTERM), ("b1", signal.SIGTERM),
      ("b2", signal.SIGTERM)]
  assert router.ejected() == []  # every step readmitted its backend
  by_kind = sup.events.snapshot()["by_kind"]
  assert by_kind["rolling_restart_begin"] == 1
  assert by_kind["rolling_restart_step"] == 3
  assert by_kind["rolling_restart_end"] == 1
  assert all(s["breaker"] == "closed" for s in report["steps"])
  # No restart budget burned: planned restarts are not crashes.
  assert all(b["budget"]["in_window"] == 0
             for b in sup.snapshot()["backends"].values())


def test_supervisor_rolling_restart_skips_quarantined_and_reports_failure():
  pool, transport, router, sup, clock = _fake_fleet(
      restart_budget=1, budget_window_s=1000.0, backoff_base_s=0.1)
  pool.die("b0")
  sup.tick()
  pool.die("b0")
  clock.t += 0.2
  sup.tick()
  clock.t += 0.2
  sup.tick()
  assert sup.state("b0") == FleetSupervisor.QUARANTINED
  pool.fail_restarts.add("b2")
  report = sup.rolling_restart(drain_s=0.0)
  assert report["backends"] == ["b1", "b2"]  # quarantined b0 skipped
  assert not report["ok"]
  failed = next(s for s in report["steps"] if s["backend"] == "b2")
  assert "error" in failed and not failed["ok"]
  # The failed step leaves b2 to the monitor loop: down + ejected.
  assert sup.state("b2") == FleetSupervisor.DOWN
  assert "b2" in router.ejected()


def test_supervisor_feeds_router_load_table():
  clock = FakeClock()
  pool = FakePool()
  transport = FakeTransport()
  for b, addr in pool.addrs.items():
    def handler(method, path, _b=b):
      if path == "/healthz":
        return 200, {}, json.dumps({"status": "ok"}).encode()
      if path == "/stats":
        depth = {"b0": 9, "b1": 0, "b2": 1}[_b]
        return 200, {}, json.dumps({"queue_depth": depth}).encode()
      return 404, {}, b"{}"
    transport.set(addr, handler)
  router = Router(pool.addrs, replication=2, transport=transport,
                  clock=clock, load_threshold=4)
  sup = FleetSupervisor(pool, router=router, transport=transport,
                        clock=clock, sleep=lambda s: None,
                        load_refresh_s=1.0)
  sup.tick()
  with router._lock:
    assert {b: d for b, (d, _) in router._load.items()} == {
        "b0": 9.0, "b1": 0.0, "b2": 1.0}


# --- one scripted fleet life through both packages -----------------------


def _scripted_life(router_cls, sup_cls):
  clock = FakeClock()
  pool = FakePool()
  transport = FakeTransport()
  for addr in pool.addrs.values():
    transport.set_health(addr, "ok")
  router = router_cls(pool.addrs, replication=2, transport=transport,
                      clock=clock)
  sup = sup_cls(pool, router=router, events=router.events,
                transport=transport, clock=clock, sleep=lambda s: None,
                load_refresh_s=0, wedge_after=2, restart_budget=2,
                budget_window_s=30.0, backoff_base_s=1.0,
                backoff_max_s=4.0)
  log = []
  for step in range(30):
    if step in (1, 4, 9, 14):
      pool.die("b1")  # a crash-looper: quarantined at its budget
    if step == 3:
      transport.set_dead(pool.addrs["b2"])  # wedged: alive, not answering
    if step == 6:
      transport.set_health(pool.addrs["b2"], "ok")
    if step == 8:
      transport.set_health(pool.addrs["b0"], "degraded")  # left alone
    if step == 11:
      pool.fail_restarts.add("b2")
      pool.die("b2")
    if step == 13:
      pool.fail_restarts.discard("b2")
    if step == 20:
      sup.readmit("b1")
    sup.tick()
    log.append((step, {b: sup.state(b) for b in pool.addrs},
                list(pool.restarts), list(pool.kills), router.ejected()))
    clock.t += 1.0
  report = sup.rolling_restart(drain_s=0.0, settle_timeout_s=1.0)
  return log, sup.snapshot(), router.metrics.snapshot(), report


def test_scripted_fleet_life_equals_jax():
  port = _scripted_life(Router, FleetSupervisor)
  ref = _scripted_life(JRouter, JFleetSupervisor)
  assert port == ref
  log, snap, _, _ = port
  states = {s for entry in log for s in entry[1].values()}
  assert FleetSupervisor.QUARANTINED in states  # the script reached it
  assert snap["restarts"] > 0

