"""The port's elastic fleet: policy state machine, actuator choreography,
and takeover convergence.

The fake-based cases of ``tests/serve/test_autoscale.py``, run against
the port's copy, cheapest first:

  * ``AutoscalePolicy`` on a fake clock — every trip/recover band,
    sustain window, cooldown, budget gate, and min/max clamp is pinned
    deterministically in milliseconds of real time.
  * ``Autoscaler`` over fakes + a real ``Router`` — warm-BEFORE-admit
    ordering, the provision-hook spawn path, abort-and-retire on
    un-warmable capacity, eject-before-SIGTERM drainless retirement,
    and quarantine-aware victim selection.
  * The leaseholder-death drill — a supervisor takes over a gossiped
    half-finished scale-out and either completes the admit or retires
    the stranded spawn, with the dead leader's quarantine verdict and
    budget spends intact.

Then one seeded signal stream through both packages' policies, decision
for decision. The live scale-out/scale-in arc is in
``tests/test_torch_cluster_live.py``.
"""

import json
import signal

import numpy as np
import pytest

from mpi_vision_tpu.serve.cluster import AutoscaleConfig as JAutoscaleConfig
from mpi_vision_tpu.serve.cluster import AutoscalePolicy as JAutoscalePolicy
from mpi_vision_tpu_torch.serve.assets.fetch import warm_backend
from mpi_vision_tpu_torch.serve.cluster import (
    Autoscaler,
    AutoscaleConfig,
    AutoscalePolicy,
    FleetSupervisor,
    GossipState,
    Router,
)
from mpi_vision_tpu_torch.serve.cluster.autoscale import AUTOSCALE_KEY


class FakeClock:
  def __init__(self, t=1000.0):
    self.t = t

  def __call__(self):
    return self.t

  def sleep(self, s):
    self.t += s


def _policy(clock, **over):
  defaults = dict(min_backends=1, max_backends=4, burn_high=2.0,
                  burn_recover=1.0, queue_high=8.0, queue_recover=2.0,
                  util_low=0.15, util_recover=0.35, up_sustain_s=2.0,
                  down_sustain_s=20.0, up_cooldown_s=10.0,
                  down_cooldown_s=30.0, budget=4, budget_window_s=300.0)
  defaults.update(over)
  return AutoscalePolicy(AutoscaleConfig(**defaults), clock=clock)


CALM = {"fast_burn": 0.0, "queue_depth": 0.0, "brownout_level": 0,
        "util": None}


def _step(policy, clock, signals, n, dt=1.0):
  clock.t += dt
  return policy.decide(signals, n)


# --- config validation ---------------------------------------------------


def test_config_rejects_empty_or_inverted_bands():
  with pytest.raises(ValueError):
    AutoscaleConfig(queue_high=2.0, queue_recover=2.0)
  with pytest.raises(ValueError):
    AutoscaleConfig(burn_high=1.0, burn_recover=2.0)
  with pytest.raises(ValueError):
    AutoscaleConfig(util_low=0.5, util_recover=0.4)
  with pytest.raises(ValueError):
    AutoscaleConfig(min_backends=3, max_backends=2)
  with pytest.raises(ValueError):
    AutoscaleConfig(up_sustain_s=0.0)
  with pytest.raises(ValueError):
    AutoscaleConfig(budget=0)


# --- scale-up: trip, sustain, hysteresis ---------------------------------


def test_policy_scale_up_needs_sustained_pressure():
  clock = FakeClock()
  policy = _policy(clock, up_sustain_s=2.0)
  hot = dict(CALM, queue_depth=9.0)
  policy.decide(hot, 1)  # first sample: dt=0, nothing accumulated
  assert _step(policy, clock, hot, 1, dt=1.0) is None  # 1.0s < 2.0s
  action = _step(policy, clock, hot, 1, dt=1.0)
  assert action is not None and action["action"] == "up"
  assert "queue depth" in action["reason"]
  assert policy.ups == 1


def test_policy_each_signal_trips_scale_up():
  for signals, token in (
      (dict(CALM, fast_burn=2.5), "fast-burn"),
      (dict(CALM, queue_depth=8.0), "queue depth"),
      (dict(CALM, brownout_level=1), "brownout"),
  ):
    clock = FakeClock()
    policy = _policy(clock, up_sustain_s=1.0)
    policy.decide(signals, 1)
    action = _step(policy, clock, signals, 1, dt=1.0)
    assert action is not None and action["action"] == "up"
    assert token in action["reason"]


def test_policy_hysteresis_band_freezes_pressure():
  clock = FakeClock()
  policy = _policy(clock, queue_high=8.0, queue_recover=2.0,
                   up_sustain_s=3.0)
  hot = dict(CALM, queue_depth=9.0)
  mid = dict(CALM, queue_depth=5.0)  # between recover and high
  policy.decide(hot, 1)
  _step(policy, clock, hot, 1, dt=2.0)  # 2.0s accumulated
  # Hovering mid-band: pressure neither grows nor resets...
  for _ in range(10):
    assert _step(policy, clock, mid, 1, dt=1.0) is None
  assert policy.snapshot()["pressure_s"] == 2.0
  # ...so re-tripping needs only the remaining 1.0s, not a fresh 3.0s.
  action = _step(policy, clock, hot, 1, dt=1.0)
  assert action is not None and action["action"] == "up"


def test_policy_calm_resets_pressure():
  clock = FakeClock()
  policy = _policy(clock, up_sustain_s=3.0)
  hot = dict(CALM, queue_depth=9.0)
  policy.decide(hot, 1)
  _step(policy, clock, hot, 1, dt=2.0)
  _step(policy, clock, CALM, 1, dt=1.0)  # below every recover: reset
  assert policy.snapshot()["pressure_s"] == 0.0
  policy.decide(hot, 1)
  assert _step(policy, clock, hot, 1, dt=2.0) is None  # re-earning


# --- scale-down: idle accumulation ---------------------------------------


def test_policy_scale_down_on_sustained_idleness():
  clock = FakeClock()
  policy = _policy(clock, down_sustain_s=5.0)
  idle = dict(CALM, util=0.05)
  policy.decide(idle, 3)
  for _ in range(4):
    assert _step(policy, clock, idle, 3, dt=1.0) is None
  action = _step(policy, clock, idle, 3, dt=1.0)
  assert action is not None and action["action"] == "down"
  assert "utilization" in action["reason"]
  assert policy.downs == 1


def test_policy_unmeasurable_util_freezes_idle_time():
  clock = FakeClock()
  policy = _policy(clock, down_sustain_s=4.0)
  idle = dict(CALM, util=0.05)
  policy.decide(idle, 3)
  _step(policy, clock, idle, 3, dt=3.0)
  # A None-util sample (membership change, first sample): freeze.
  _step(policy, clock, dict(CALM, util=None), 3, dt=10.0)
  assert policy.snapshot()["idle_s"] == 3.0
  # Mid-band utilization also freezes (neither idle nor busy).
  _step(policy, clock, dict(CALM, util=0.25), 3, dt=10.0)
  assert policy.snapshot()["idle_s"] == 3.0
  action = _step(policy, clock, idle, 3, dt=1.0)
  assert action is not None and action["action"] == "down"


def test_policy_busy_or_tripping_resets_idle_time():
  clock = FakeClock()
  policy = _policy(clock, down_sustain_s=4.0)
  idle = dict(CALM, util=0.05)
  policy.decide(idle, 3)
  _step(policy, clock, idle, 3, dt=3.0)
  _step(policy, clock, dict(CALM, util=0.9), 3, dt=1.0)  # busy: reset
  assert policy.snapshot()["idle_s"] == 0.0
  policy.decide(idle, 3)
  _step(policy, clock, idle, 3, dt=3.0)
  # A scale-up trip also resets idle (the signals contradict).
  _step(policy, clock, dict(CALM, queue_depth=9.0, util=0.05), 3, dt=1.0)
  assert policy.snapshot()["idle_s"] == 0.0


# --- gates: clamps, cooldowns, budget ------------------------------------


def test_policy_clamps_at_pool_bounds_but_keeps_accumulation():
  clock = FakeClock()
  policy = _policy(clock, up_sustain_s=1.0, max_backends=2,
                   down_sustain_s=2.0, min_backends=1,
                   up_cooldown_s=0.0, down_cooldown_s=0.0)
  hot = dict(CALM, queue_depth=9.0)
  policy.decide(hot, 2)
  assert _step(policy, clock, hot, 2, dt=2.0) is None  # at max: held
  assert policy.clamped_max == 1
  # The moment headroom appears, the held pressure fires immediately.
  action = _step(policy, clock, hot, 1, dt=0.001)
  assert action is not None and action["action"] == "up"
  idle = dict(CALM, util=0.0)
  policy.decide(idle, 1)
  assert _step(policy, clock, idle, 1, dt=3.0) is None  # at min: held
  assert policy.clamped_min == 1
  action = _step(policy, clock, idle, 2, dt=0.001)
  assert action is not None and action["action"] == "down"


def test_policy_cooldown_holds_then_releases():
  clock = FakeClock()
  policy = _policy(clock, up_sustain_s=1.0, up_cooldown_s=10.0)
  hot = dict(CALM, queue_depth=9.0)
  policy.decide(hot, 1)
  assert _step(policy, clock, hot, 1, dt=1.0)["action"] == "up"
  # Still hot: the next sustained trip is held by the cooldown...
  assert _step(policy, clock, hot, 2, dt=2.0) is None
  assert policy.cooldown_holds == 1
  # ...and fires on the first sample past it (accumulation was kept).
  assert _step(policy, clock, hot, 2, dt=8.1)["action"] == "up"


def test_policy_budget_exhaustion_denies_then_window_slides():
  clock = FakeClock()
  policy = _policy(clock, up_sustain_s=1.0, up_cooldown_s=0.0,
                   budget=1, budget_window_s=60.0)
  hot = dict(CALM, queue_depth=9.0)
  policy.decide(hot, 1)
  assert _step(policy, clock, hot, 1, dt=1.0)["action"] == "up"
  assert _step(policy, clock, hot, 2, dt=2.0) is None  # budget dry
  assert policy.denied_budget == 1
  clock.t += 60.1  # the window slides past the spend
  assert _step(policy, clock, hot, 2, dt=1.0)["action"] == "up"
  snap = policy.snapshot()
  assert snap["budget"]["refused"] == 1 and snap["ups"] == 2


# --- the actuator over fakes ---------------------------------------------


class FakeScalePool:
  """Elastic pool fake: spawn/retire/kill bookkeeping with an optional
  ``on_kill`` probe so tests can assert WHAT WAS TRUE at kill time."""

  def __init__(self, backends=("b0", "b1")):
    self.addrs = {b: f"host-{b}:1" for b in backends}
    self._alive = {b: True for b in backends}
    self.spawned: list[str] = []
    self.retired: list[str] = []
    self.kills: list[tuple[str, int]] = []
    self.fail_spawn = False
    self.on_kill = None

  def addresses(self):
    return dict(self.addrs)

  def alive(self, backend_id):
    return self._alive.get(backend_id, False)

  def kill(self, backend_id, sig=signal.SIGKILL):
    if self.on_kill is not None:
      self.on_kill(backend_id, sig)
    self.kills.append((backend_id, sig))
    self._alive[backend_id] = False

  def spawn_backend(self, backend_id=None):
    if self.fail_spawn:
      raise RuntimeError("no capacity")
    bid = backend_id or f"b{len(self.addrs)}"
    self.addrs[bid] = f"host-{bid}:1"
    self._alive[bid] = True
    self.spawned.append(bid)
    return bid, self.addrs[bid]

  def add_address(self, backend_id, address):
    self.addrs[backend_id] = address
    self._alive[backend_id] = True

  def retire(self, backend_id):
    self.retired.append(backend_id)
    self.addrs.pop(backend_id, None)
    self._alive.pop(backend_id, None)

  def restart(self, backend_id):
    self._alive[backend_id] = True
    return self.addrs[backend_id]


class FakeTransport:
  """Method-aware ``address -> handler(method, path)`` transport; a
  missing handler is a dead host (ConnectionError)."""

  def __init__(self):
    self.handlers = {}
    self.log: list[tuple[str, str, str]] = []  # (address, method, path)

  def set_backend(self, address, state=None):
    state = state if state is not None else {}
    state.setdefault("status", "ok")
    state.setdefault("queue_depth", 0)
    state.setdefault("busy_s", 0.0)
    state.setdefault("render_ok", True)

    def handler(method, path):
      if path == "/healthz":
        return 200, {}, json.dumps({"status": state["status"]}).encode()
      if path == "/stats":
        return 200, {}, json.dumps({
            "queue_depth": state["queue_depth"],
            "device_render_seconds": state["busy_s"]}).encode()
      if path.startswith("/scene/") and path.endswith("/manifest"):
        if state.get("digest") is None:
          return 404, {}, b"{}"
        return 200, {}, json.dumps(
            {"scene_digest": state["digest"]}).encode()
      if path == "/render":
        return (200, {}, b"{}") if state["render_ok"] else (503, {}, b"{}")
      return 404, {}, b"{}"

    self.handlers[address] = handler
    return state

  def set_dead(self, address):
    self.handlers.pop(address, None)

  def request(self, method, url, body=None, headers=None, timeout=30.0):
    address, _, path = url[len("http://"):].partition("/")
    self.log.append((address, method, "/" + path))
    handler = self.handlers.get(address)
    if handler is None:
      raise ConnectionError(f"connection refused: {address}")
    return handler(method, "/" + path)


SCENES = ("scene_000", "scene_001")


def _elastic(backends=("b0", "b1"), gossip=None, config=None, **kw):
  clock = FakeClock()
  pool = FakeScalePool(backends)
  transport = FakeTransport()
  for addr in pool.addrs.values():
    transport.set_backend(addr)
  router = Router(pool.addresses(), replication=2, transport=transport,
                  clock=clock)
  policy = AutoscalePolicy(
      config or AutoscaleConfig(up_sustain_s=1.0, down_sustain_s=2.0,
                                up_cooldown_s=0.0, down_cooldown_s=0.0,
                                queue_high=4.0, queue_recover=1.0),
      clock=clock)
  asc = Autoscaler(policy, pool, router, gossip=gossip,
                   events=router.events, scenes=SCENES,
                   transport=transport, clock=clock, sleep=clock.sleep,
                   eval_interval_s=0.5, drain_s=0.25, warm_timeout_s=5.0,
                   **kw)
  return clock, pool, transport, router, asc


def test_warm_backend_manifest_fast_path_and_render_fallback():
  clock = FakeClock()
  transport = FakeTransport()
  transport.set_backend("donor:1", {"digest": "abc"})
  transport.set_backend("new:1", {"digest": "abc", "render_ok": False})
  out = warm_backend("new:1", SCENES, donors=("donor:1",),
                     transport=transport, timeout_s=2.0, clock=clock,
                     sleep=clock.sleep)
  assert out["ok"] and set(out["modes"].values()) == {"manifest"}
  # No manifests anywhere: the identity-pose render IS the warmup.
  transport.set_backend("new2:1", {})
  out = warm_backend("new2:1", SCENES, donors=("donor2:1",),
                     transport=transport, timeout_s=2.0, clock=clock,
                     sleep=clock.sleep)
  assert out["ok"] and set(out["modes"].values()) == {"render"}
  # Unreachable backend: deadline expires, never raises.
  out = warm_backend("dead:1", SCENES, transport=transport,
                     timeout_s=1.0, clock=clock, sleep=clock.sleep)
  assert not out["ok"] and sorted(out["failed"]) == sorted(SCENES)


def test_scale_up_warms_before_the_ring_admits():
  clock, pool, transport, router, asc = _elastic()
  admitted_at_warm_time = []
  state = transport.set_backend("host-b2:1")
  orig = transport.handlers["host-b2:1"]

  def probe(method, path):
    if path == "/render":
      admitted_at_warm_time.append("b2" in router.backend_ids())
    return orig(method, path)

  transport.handlers["host-b2:1"] = probe
  out = asc.scale_up("test pressure")
  assert out["action"] == "up" and out["backend"] == "b2"
  assert pool.spawned == ["b2"]
  assert "b2" in router.backend_ids()
  # THE ordering pin: every warming probe ran BEFORE the ring admit.
  assert admitted_at_warm_time and not any(admitted_at_warm_time)
  assert out["warm"]["ok"] and out["warm"]["modes"]
  assert router.events.count("autoscale_up") == 1
  assert router.metrics.snapshot()["autoscale"]["ups"] == 1


def test_scale_up_unwarmable_spawn_is_retired_not_admitted():
  clock, pool, transport, router, asc = _elastic()
  # No handler for the spawn's address: it never answers a warm probe.
  out = asc.scale_up("test pressure")
  assert out["action"] == "abort" and out["of"] == "up"
  assert "b2" not in router.backend_ids()
  assert pool.retired == ["b2"]  # no stranded process
  assert "b2" not in pool.addresses()
  assert router.events.count("autoscale_abort") == 1
  assert router.metrics.snapshot()["autoscale"]["aborts"] == 1
  assert asc.snapshot()["aborts"] == 1


def test_scale_up_failed_spawn_aborts():
  clock, pool, transport, router, asc = _elastic()
  pool.fail_spawn = True
  out = asc.scale_up("test pressure")
  assert out["action"] == "abort"
  assert router.backend_ids() == ["b0", "b1"]
  assert router.events.count("autoscale_abort") == 1


def test_provision_hook_spawns_remote_capacity():
  calls = []

  class Done:
    returncode = 0
    stdout = "joining fleet...\n127.9.9.9:7777\n"
    stderr = ""

  def runner(argv, **kw):
    calls.append((argv, kw))
    return Done()

  clock, pool, transport, router, asc = _elastic(
      provision_hook=["./provision.sh", "--zone", "z1"], runner=runner)
  transport.set_backend("127.9.9.9:7777")
  out = asc.scale_up("join pressure")
  assert out["action"] == "up" and out["address"] == "127.9.9.9:7777"
  assert calls[0][0] == ["./provision.sh", "--zone", "z1", "b2"]
  assert calls[0][1]["timeout"] == asc.hook_timeout_s
  assert pool.addresses()["b2"] == "127.9.9.9:7777"
  assert "b2" in router.backend_ids()
  assert pool.spawned == []  # the hook provisioned, not the local pool


def test_provision_hook_without_address_aborts():
  class Bad:
    returncode = 0
    stdout = "no address here\n"
    stderr = ""

  clock, pool, transport, router, asc = _elastic(
      provision_hook=["./provision.sh"], runner=lambda *a, **k: Bad())
  out = asc.scale_up("join pressure")
  assert out["action"] == "abort"
  assert "host:port" in out["reason"]


def test_next_id_skips_pool_and_router_and_reuses_retired():
  clock, pool, transport, router, asc = _elastic(("b0", "b2"))
  # b1 free (pool has b0+b2, router has b0+b2): lowest gap wins.
  assert asc._next_id() == "b1"


def test_scale_down_ejects_before_sigterm_and_moves_ring_last():
  clock, pool, transport, router, asc = _elastic(("b0", "b1", "b2"))
  seen = []
  pool.on_kill = lambda b, sig: seen.append(
      (sig, b in router.ejected(), b in router.backend_ids()))
  out = asc.scale_down("idle fleet")
  # Victim: the highest-numbered backend.
  assert out["action"] == "down" and out["backend"] == "b2"
  # At SIGTERM time the victim was already ejected (drained) but still
  # in the ring — the ring moves only after the process is retired.
  assert seen == [(signal.SIGTERM, True, True)]
  assert router.backend_ids() == ["b0", "b1"]
  assert pool.retired == ["b2"]
  assert router.events.count("autoscale_down") == 1
  assert router.metrics.snapshot()["autoscale"]["downs"] == 1


def test_scale_down_skips_quarantined_victims():
  clock, pool, transport, router, asc = _elastic(("b0", "b1", "b2"))

  class Sup:
    forgotten = []

    def quarantined(self):
      return ["b2"]

    def forget(self, b):
      self.forgotten.append(b)

  asc.supervisor = Sup()
  out = asc.scale_down("idle fleet")
  # b2 is evidence, not capacity: the next-highest backend retires.
  assert out["backend"] == "b1"
  assert asc.supervisor.forgotten == ["b1"]
  assert set(router.backend_ids()) == {"b0", "b2"}


def test_scale_down_records_retired_verdict_in_gossip():
  gossip = GossipState("routerA", clock=FakeClock(5000.0))
  clock, pool, transport, router, asc = _elastic(("b0", "b1"),
                                                 gossip=gossip)
  asc.scale_down("idle fleet")
  obs = gossip.observation("b1")
  assert obs["fields"]["state"] == "retired"
  assert not obs["fields"]["quarantined"]
  rec = gossip.observation(AUTOSCALE_KEY)["fields"]
  assert rec["action"] == "down" and rec["phase"] == "done"


def test_tick_closes_the_loop_from_signals_to_actions():
  gossip = GossipState("routerA", clock=FakeClock(5000.0))
  clock, pool, transport, router, asc = _elastic(gossip=gossip)
  # Saturate both backends' reported queues: tick must trip, sustain,
  # spawn b2, warm it, and admit it.
  for addr in list(pool.addrs.values()):
    transport.set_backend(addr, {"queue_depth": 9})
  transport.set_backend("host-b2:1")
  assert asc.tick() is None  # first sample: accumulating
  clock.t += 1.1
  out = asc.tick()
  assert out is not None and out["action"] == "up"
  assert "b2" in router.backend_ids()
  assert gossip.observation(AUTOSCALE_KEY)["fields"]["phase"] == "done"
  # Calm + idle: utilization deltas go to zero and the pool shrinks.
  for addr in list(pool.addrs.values()):
    transport.set_backend(addr, {"queue_depth": 0, "busy_s": 4.0})
  downs = 0
  for _ in range(20):
    clock.t += 1.0
    out = asc.tick()
    if out is not None and out.get("action") == "down":
      downs += 1
  assert downs >= 1
  assert len(router.backend_ids()) < 3


def test_eval_interval_rate_limits_signal_fanout():
  clock, pool, transport, router, asc = _elastic()
  asc.tick()
  n = len(transport.log)
  clock.t += 0.1  # below eval_interval_s=0.5
  asc.tick()
  assert len(transport.log) == n  # no second /stats fan-out
  clock.t += 0.5
  asc.tick()
  assert len(transport.log) > n


# --- leaseholder death mid-scale-out -------------------------------------


class TakeoverLease:
  """First try_acquire is a takeover of a dead leader."""

  owner = "routerB"

  def try_acquire(self):
    return {"takeover": True, "previous": "routerA"}

  def heartbeat(self):
    return None

  def release(self):
    return None


def _takeover_fleet(dead_leader_records, spawn_alive: bool,
                    spawn_exists: bool = True):
  """Fleet B adopting gossip that holds a half-finished scale-out: the
  dead leader spawned b2 (phase 'warming') and quarantined b1 before
  dying. ``spawn_alive`` decides whether b2 answers its /healthz;
  ``spawn_exists`` whether its process is in the pool at all."""
  wall = FakeClock(5000.0)
  stateA = GossipState("routerA", clock=wall)
  for key, fields in dead_leader_records:
    stateA.observe(key, **fields)
  stateB = GossipState("routerB", clock=wall)
  stateB.merge(stateA.wire())

  clock = FakeClock()
  pool = FakeScalePool(("b0", "b1"))
  pool._alive["b1"] = False  # the quarantined crash-looper is down
  if spawn_exists:
    pool.add_address("b2", "host-b2:1")  # the stranded spawn's process
  transport = FakeTransport()
  transport.set_backend("host-b0:1")
  if spawn_alive:
    transport.set_backend("host-b2:1")
  router = Router({"b0": "host-b0:1", "b1": "host-b1:1"}, replication=2,
                  transport=transport, clock=clock)
  policy = AutoscalePolicy(AutoscaleConfig(), clock=clock)
  asc = Autoscaler(policy, pool, router, gossip=stateB,
                   events=router.events, scenes=SCENES,
                   transport=transport, clock=clock, sleep=clock.sleep,
                   warm_timeout_s=2.0)
  sup = FleetSupervisor(pool, router=router, events=router.events,
                        transport=transport, clock=clock,
                        sleep=lambda s: None, load_refresh_s=0,
                        lease=TakeoverLease(), gossip=stateB,
                        autoscaler=asc)
  return stateB, pool, transport, router, asc, sup


_LEADER_RECORDS = (
    ("b1", dict(state="quarantined", quarantined=True, ejected=True,
                reason="crash loop", budget_ages_s=[1.0, 3.0])),
    (AUTOSCALE_KEY, dict(seq=7, action="up", backend="b2",
                         address="host-b2:1", phase="warming",
                         reason="queue depth 9.0 >= 4")),
)


def test_takeover_completes_a_half_finished_scale_out():
  stateB, pool, transport, router, asc, sup = _takeover_fleet(
      _LEADER_RECORDS, spawn_alive=True)
  sup.tick()  # acquire-as-takeover: adopt observations, then converge
  # The stranded spawn was warmed and admitted by the NEW leader.
  assert "b2" in router.backend_ids()
  assert asc.converges == 1
  assert stateB.observation(AUTOSCALE_KEY)["fields"]["phase"] == "done"
  assert stateB.observation(AUTOSCALE_KEY)["fields"]["seq"] == 7
  assert asc._seq >= 7  # future decisions version past the adopted one
  # The dead leader's quarantine verdict survived adoption intact.
  assert sup.state("b1") == FleetSupervisor.QUARANTINED
  assert "b1" in router.ejected()
  assert sup.snapshot()["backends"]["b1"]["budget"]["in_window"] == 2
  assert router.events.count("supervision_takeover") == 1
  assert router.events.count("autoscale_up") == 1


def test_takeover_retires_a_stranded_unreachable_spawn():
  stateB, pool, transport, router, asc, sup = _takeover_fleet(
      _LEADER_RECORDS, spawn_alive=False)
  sup.tick()
  # The spawn never answered: retired, not leaked, not admitted.
  assert "b2" not in router.backend_ids()
  assert "b2" in pool.retired
  assert "b2" not in pool.addresses()
  assert stateB.observation(AUTOSCALE_KEY)["fields"]["phase"] == "aborted"
  assert router.events.count("autoscale_abort") == 1
  assert sup.state("b1") == FleetSupervisor.QUARANTINED


def test_takeover_with_finished_record_is_a_noop():
  records = (("b2", dict(state="retired", quarantined=False, ejected=True,
                         reason="autoscale retire", budget_ages_s=[])),
             (AUTOSCALE_KEY, dict(seq=9, action="down", backend="b2",
                                  address=None, phase="done",
                                  reason="idle")),)
  stateB, pool, transport, router, asc, sup = _takeover_fleet(
      records, spawn_alive=False, spawn_exists=False)
  sup.tick()
  # A done record converges to nothing; the retired backend is NOT
  # resurrected as a supervision entry (the skip guard).
  assert asc.converges == 0 and asc.aborts == 0
  assert "b2" not in sup.snapshot()["backends"]
  assert asc._seq >= 9


def test_supervisor_forget_refuses_quarantined_records():
  stateB, pool, transport, router, asc, sup = _takeover_fleet(
      _LEADER_RECORDS, spawn_alive=True)
  sup.tick()
  with pytest.raises(ValueError):
    sup.forget("b1")
  assert sup.state("b1") == FleetSupervisor.QUARANTINED


# --- one seeded signal stream through both packages ----------------------


def _scripted_policy(config_cls, policy_cls):
  rng = np.random.default_rng(3)
  clock = FakeClock()
  policy = policy_cls(config_cls(
      min_backends=1, max_backends=5, up_sustain_s=2.0,
      down_sustain_s=6.0, up_cooldown_s=3.0, down_cooldown_s=5.0,
      budget=6, budget_window_s=60.0), clock=clock)
  n = 2
  decisions = []
  for step in range(400):
    clock.t += float(rng.uniform(0.1, 1.2))
    if step % 20 == 0:  # regimes last long enough to be sustained
      regime = rng.choice(["calm", "hot", "idle", "band"],
                          p=[0.2, 0.3, 0.3, 0.2])
    signals = dict(CALM)
    if regime == "hot":
      signals.update(fast_burn=float(rng.uniform(1.5, 4.0)),
                     queue_depth=float(rng.uniform(4.0, 12.0)),
                     brownout_level=int(rng.integers(2)))
    elif regime == "idle":
      signals.update(util=float(rng.uniform(0.0, 0.2)))
    elif regime == "band":
      signals.update(queue_depth=float(rng.uniform(2.0, 8.0)),
                     util=float(rng.uniform(0.15, 0.5)))
    action = policy.decide(signals, n)
    decisions.append(action)
    if action is not None:
      n += 1 if action["action"] == "up" else -1
  return decisions, policy.snapshot()


def test_seeded_signal_stream_equals_jax():
  port = _scripted_policy(AutoscaleConfig, AutoscalePolicy)
  ref = _scripted_policy(JAutoscaleConfig, JAutoscalePolicy)
  assert port == ref
  kinds = {d["action"] for d in port[0] if d is not None}
  assert kinds == {"up", "down"}  # the stream grows AND shrinks the pool

