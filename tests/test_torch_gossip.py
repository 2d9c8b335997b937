"""The port's router HA: gossip merge, supervision leases, leased handoff.

The fake-based cases of ``tests/serve/test_gossip.py``, run against the
port's copy, cheapest first:

  * ``GossipState``/``GossipNode`` units on fake clocks and transports —
    newest-version-wins merge, conflict counting with the deterministic
    origin tie-break, the lease slot's fresh-beats-stale rules, and
    push-pull convergence of two partitioned peers in one round.
  * ``FileLease``/``GossipLease`` state machines — atomic claim,
    heartbeat, stale-holder reap (takeover), split-brain heal, and the
    ``SupervisionLeaseLost`` demotion the loser must obey.
  * Leased ``FleetSupervisor`` handoff over fakes, and the
    ``RemoteBackendPool`` restart hook.

Then one scripted exchange through both packages' ``GossipState``, and a
wire state crossing between them. The real-process failover arc is in
``tests/test_torch_cluster_live.py``.
"""

import json

import numpy as np
import pytest

from mpi_vision_tpu.serve.cluster import GossipState as JGossipState
from mpi_vision_tpu_torch.serve.cluster import (
    FileLease,
    FleetSupervisor,
    GossipLease,
    GossipNode,
    GossipState,
    RemoteBackendPool,
    Router,
    SupervisionLeaseLost,
)
from mpi_vision_tpu_torch.serve.cluster.pool import BackendSpawnError


class FakeClock:
  def __init__(self, t=1000.0):
    self.t = t

  def __call__(self):
    return self.t


# --- GossipState: versioned observations ---------------------------------


def test_gossip_observe_bumps_version_only_on_change():
  clock = FakeClock()
  state = GossipState("routerA", clock=clock)
  assert state.observe("b0", state="up", quarantined=False)
  v1 = state.observation("b0")["version"]
  assert not state.observe("b0", state="up")  # no-op: nothing changed
  assert state.observation("b0")["version"] == v1
  clock.t += 1.0
  assert state.observe("b0", state="down")
  obs = state.observation("b0")
  assert obs["version"] > v1 and obs["origin"] == "routerA"
  # Fields MERGE over the previous observation (partial updates keep
  # the rest of the record).
  assert obs["fields"] == {"state": "down", "quarantined": False}


def test_gossip_merge_newest_version_wins_and_wire_roundtrips():
  clock = FakeClock()
  a = GossipState("routerA", clock=clock)
  b = GossipState("routerB", clock=clock)
  a.observe("b0", state="up")
  clock.t += 1.0
  b.observe("b0", state="down")  # newer observation of the same backend
  # The wire form is JSON-safe both ways (it crosses /gossip).
  wire = json.loads(json.dumps(b.wire()))
  result = a.merge(wire)
  assert result["merges"] == 1 and result["conflicts"] == 0
  assert result["changed"] == ["b0"]
  assert a.observation("b0")["fields"]["state"] == "down"
  # The older state flowing back the other way is NOT adopted.
  stale = json.loads(json.dumps(a.wire()))
  stale["observations"]["b0"]["version"] -= 2.0
  stale["observations"]["b0"]["fields"] = {"state": "up"}
  result = b.merge(stale)
  assert result["merges"] == 0
  assert b.observation("b0")["fields"]["state"] == "down"


def test_gossip_merge_version_tie_counts_conflict_and_both_sides_agree():
  clock = FakeClock()
  a = GossipState("routerA", clock=clock)
  b = GossipState("routerB", clock=clock)
  # Same version, different fields, different origins: the partitioned
  # split-brain worst case. Both sides must converge to ONE winner.
  entry_a = {"version": 5.0, "origin": "routerA", "fields": {"x": 1}}
  entry_b = {"version": 5.0, "origin": "routerB", "fields": {"x": 2}}
  a.merge({"observations": {"b0": entry_a}})
  b.merge({"observations": {"b0": entry_b}})
  ra = a.merge({"observations": {"b0": entry_b}})
  rb = b.merge({"observations": {"b0": entry_a}})
  assert ra["conflicts"] == 1 and rb["conflicts"] == 1
  # Greater origin id wins deterministically on BOTH sides.
  assert a.observation("b0")["fields"] == {"x": 2}
  assert b.observation("b0")["fields"] == {"x": 2}


def test_gossip_merge_malformed_entries_never_poison_the_table():
  state = GossipState("routerA", clock=FakeClock())
  state.observe("b0", state="up")
  result = state.merge({"observations": {
      "b0": {"version": "not-a-number", "origin": "x", "fields": {}},
      "b1": {"origin": "x", "fields": {}},           # missing version
      "b2": "garbage",                               # not even a dict
  }, "lease": "garbage"})
  assert result["merges"] == 0 and result["conflicts"] == 0
  assert state.observation("b0")["fields"] == {"state": "up"}
  assert state.observation("b1") is None


# --- GossipState: the lease slot -----------------------------------------


def test_gossip_lease_merge_same_owner_newer_heartbeat_wins():
  clock = FakeClock()
  a = GossipState("routerA", clock=clock)
  a.claim_lease("routerA")
  newer = dict(a.lease_view())
  newer["heartbeat_unix_s"] += 2.0
  b = GossipState("routerB", clock=clock)
  b.merge({"lease": newer})
  # The older heartbeat flowing in afterwards does not roll it back.
  b.merge({"lease": a.claim_lease("routerA")})
  assert b.lease_view()["heartbeat_unix_s"] == newer["heartbeat_unix_s"]


def test_gossip_lease_merge_fresh_beats_stale_and_ties_break_earliest():
  clock = FakeClock()
  a = GossipState("routerA", clock=clock, lease_ttl_s=5.0)
  b = GossipState("routerB", clock=clock, lease_ttl_s=5.0)
  a.claim_lease("routerA")
  clock.t += 1.0
  b.claim_lease("routerB")  # later claimant: split brain
  # Both fresh -> conflict, broken to the EARLIEST (since, owner) on
  # both sides: routerA claimed first and keeps the lease everywhere.
  rb = b.merge({"lease": a.lease_view()})
  ra = a.merge({"lease": b.lease_view()})
  assert rb["conflicts"] == 1 and ra["conflicts"] == 0
  assert a.lease_view()["owner"] == "routerA"
  assert b.lease_view()["owner"] == "routerA"
  # routerA goes quiet; once its heartbeat is stale a fresh claim wins.
  clock.t += 6.0
  b.claim_lease("routerB")
  a.merge({"lease": b.lease_view()})
  assert a.lease_view()["owner"] == "routerB" and a.lease_view()["fresh"]


# --- GossipNode: push-pull rounds ----------------------------------------


class NodeTransport:
  """peer address -> GossipNode; a round's POST becomes receive()."""

  def __init__(self):
    self.nodes = {}

  def request(self, method, url, body=None, headers=None, timeout=30.0):
    address, _, path = url[len("http://"):].partition("/")
    node = self.nodes.get(address)
    if node is None:
      raise ConnectionError("peer down")
    reply = node.receive(json.loads(body))
    return 200, {}, json.dumps(reply).encode()


def test_gossip_round_converges_partitioned_peers_and_counts_failures():
  clock = FakeClock()
  transport = NodeTransport()
  state_a = GossipState("routerA", clock=clock)
  state_b = GossipState("routerB", clock=clock)
  # Divergent histories from a partition: disjoint AND conflicting keys.
  state_a.observe("b0", state="up")
  state_a.observe("b1", state="down")
  clock.t += 1.0
  state_b.observe("b1", state="up")  # newer verdict on the shared key
  state_b.observe("b2", state="up")
  merged_on_b = []
  node_a = GossipNode(state_a, peers=["peer-b:1"], transport=transport,
                      clock=clock, sleep=lambda s: None)
  node_b = GossipNode(state_b, peers=["peer-a:1"], transport=transport,
                      clock=clock, sleep=lambda s: None,
                      on_merge=lambda ids: merged_on_b.append(ids))
  transport.nodes["peer-a:1"] = node_a
  transport.nodes["peer-b:1"] = node_b
  # ONE push-pull round converges both directions: A pushes its state
  # into B and merges B's reply.
  results = node_a.round()
  assert results == {"peer-b:1": "ok"}
  assert state_a.observations() == state_b.observations()
  assert state_a.observation("b1")["fields"]["state"] == "up"
  assert merged_on_b == [["b0"]]  # B adopted only A's novel key —
  # its own newer b1 verdict survived the push (newest wins).
  # A dead peer is counted and reported, never fatal.
  del transport.nodes["peer-b:1"]
  results = node_a.round()
  assert "ConnectionError" in results["peer-b:1"]
  peers = node_a.snapshot()["peers"]["peer-b:1"]
  assert peers["ok"] is False and peers["failures"] == 1
  assert node_a.rounds == 2


# --- FileLease -----------------------------------------------------------


def test_file_lease_acquire_heartbeat_release(tmp_path):
  clock = FakeClock()
  path = str(tmp_path / "sup.lease")
  a = FileLease(path, "routerA", ttl_s=5.0, clock=clock)
  b = FileLease(path, "routerB", ttl_s=5.0, clock=clock)
  got = a.try_acquire()
  assert got == {"takeover": False, "previous": None}
  assert b.try_acquire() is None  # held fresh by A
  assert b.holder()["owner"] == "routerA" and b.holder()["fresh"]
  clock.t += 3.0
  a.heartbeat()  # keeps the lease alive past the original stamp
  clock.t += 3.0  # 6s since acquire but only 3 since the heartbeat
  assert b.try_acquire() is None
  # Re-acquiring while held is an idempotent heartbeat, not a takeover.
  assert a.try_acquire() == {"takeover": False, "previous": "routerA"}
  a.release()
  got = b.try_acquire()
  assert got == {"takeover": False, "previous": None}  # clean handoff


def test_file_lease_stale_holder_is_reaped_as_takeover(tmp_path):
  clock = FakeClock()
  path = str(tmp_path / "sup.lease")
  a = FileLease(path, "routerA", ttl_s=2.0, clock=clock)
  b = FileLease(path, "routerB", ttl_s=2.0, clock=clock)
  a.try_acquire()
  clock.t += 2.5  # A died (no heartbeat): its lease goes stale
  assert b.holder()["fresh"] is False
  got = b.try_acquire()
  assert got == {"takeover": True, "previous": "routerA"}
  # The dead holder coming back finds its lease gone and steps down.
  with pytest.raises(SupervisionLeaseLost):
    a.heartbeat()


def test_gossip_lease_split_brain_heals_and_loser_steps_down():
  clock = FakeClock()
  state_a = GossipState("routerA", clock=clock, lease_ttl_s=5.0)
  state_b = GossipState("routerB", clock=clock, lease_ttl_s=5.0)
  lease_a = GossipLease(state_a, "routerA")
  lease_b = GossipLease(state_b, "routerB")
  # Partitioned: both acquire optimistically (nobody can stop them).
  assert lease_a.try_acquire() is not None
  clock.t += 1.0
  assert lease_b.try_acquire() is not None
  # The partition heals at the first merge: earliest claimant wins in
  # BOTH states, and the loser's next heartbeat steps down.
  state_b.merge({"lease": state_a.lease_view()})
  state_a.merge({"lease": state_b.lease_view()})
  assert state_a.lease_view()["owner"] == "routerA"
  lease_a.heartbeat()
  with pytest.raises(SupervisionLeaseLost):
    lease_b.heartbeat()
  assert lease_b.try_acquire() is None  # and cannot reclaim while fresh
  # A releases cleanly in ITS state; B still sees the old claim until
  # it goes stale (a gossiped release is just a stopped heartbeat), so
  # B reclaims only after the TTL — marked as a takeover.
  lease_a.release()
  assert state_a.lease_view() is None
  clock.t += 6.0
  got = lease_b.try_acquire()
  assert got == {"takeover": True, "previous": "routerA"}


# --- leased FleetSupervisor handoff over fakes ---------------------------


class FakePool:
  def __init__(self, backends=("b0", "b1", "b2")):
    self.addrs = {b: f"host-{b}:1" for b in backends}
    self._alive = {b: True for b in backends}
    self.restarts: list[str] = []

  def addresses(self):
    return dict(self.addrs)

  def alive(self, backend_id):
    return self._alive[backend_id]

  def kill(self, backend_id, sig=None):
    self._alive[backend_id] = False

  def restart(self, backend_id):
    self.restarts.append(backend_id)
    self._alive[backend_id] = True
    return self.addrs[backend_id]

  def die(self, backend_id):
    self._alive[backend_id] = False


class FakeTransport:
  def __init__(self):
    self.handlers = {}

  def set_health(self, address, status):
    def handler(method, path):
      if path == "/healthz":
        return 200, {}, json.dumps({"status": status}).encode()
      if path == "/stats":
        return 200, {}, json.dumps({"queue_depth": 0}).encode()
      return 404, {}, b"{}"
    self.handlers[address] = handler

  def request(self, method, url, body=None, headers=None, timeout=30.0):
    address, _, path = url[len("http://"):].partition("/")
    return self.handlers[address]("GET", "/" + path)


def _leased_fleet(lease, gossip, clock, **sup_kwargs):
  """One router replica's worth of fakes: pool + router + supervisor
  holding (or standing by for) the shared supervision lease."""
  pool = FakePool()
  transport = FakeTransport()
  for addr in pool.addrs.values():
    transport.set_health(addr, "ok")
  router = Router(pool.addrs, replication=2, transport=transport,
                  clock=clock)
  sup = FleetSupervisor(
      pool, router=router, events=router.events, transport=transport,
      clock=clock, sleep=lambda s: None, load_refresh_s=0,
      lease=lease, gossip=gossip, **sup_kwargs)
  return pool, router, sup


def test_supervisor_standby_replica_neither_probes_nor_restarts(tmp_path):
  clock = FakeClock()
  path = str(tmp_path / "sup.lease")
  state_a = GossipState("routerA", clock=clock)
  state_b = GossipState("routerB", clock=clock)
  pool_a, router_a, sup_a = _leased_fleet(
      FileLease(path, "routerA", ttl_s=5.0, clock=clock), state_a, clock)
  pool_b, router_b, sup_b = _leased_fleet(
      FileLease(path, "routerB", ttl_s=5.0, clock=clock), state_b, clock)
  sup_a.tick()  # A wins the lease
  assert sup_a.snapshot()["lease_held"] is True
  assert router_a.metrics.snapshot()["supervisor_lease_held"] == 1
  pool_b.die("b1")  # B's view of the fleet degrades...
  sup_b.tick()
  # ...but B is standby: no probes spent, no restart attempted — the
  # leader owns the fleet and B only keeps trying for the lease.
  assert sup_b.snapshot()["lease_held"] is False
  assert sup_b.snapshot()["takeovers"] == 0
  assert pool_b.restarts == []
  assert router_b.metrics.snapshot()["supervisor_lease_held"] == 0
  # A holds through heartbeats; B stays standby as long as A is fresh.
  for _ in range(3):
    clock.t += 1.0
    sup_a.tick()
    sup_b.tick()
  assert sup_b.snapshot()["lease_held"] is False


def test_supervisor_takeover_adopts_gossiped_budget_no_reset(tmp_path):
  """THE handoff pin: budget spends survive the supervisor's death.

  A spends its full restart budget on a crash-looper, publishes the
  spends into gossip, and dies. B reaps the stale lease, adopts the
  gossiped ages, and the looper's NEXT failure quarantines immediately
  — zero fresh restarts granted by the handoff."""
  clock = FakeClock()
  path = str(tmp_path / "sup.lease")
  state_a = GossipState("routerA", clock=clock)
  state_b = GossipState("routerB", clock=clock)
  pool_a, router_a, sup_a = _leased_fleet(
      FileLease(path, "routerA", ttl_s=5.0, clock=clock), state_a, clock,
      restart_budget=2, budget_window_s=1000.0, backoff_base_s=0.1,
      backoff_max_s=0.1)
  pool_b, router_b, sup_b = _leased_fleet(
      FileLease(path, "routerB", ttl_s=5.0, clock=clock), state_b, clock,
      restart_budget=2, budget_window_s=1000.0, backoff_base_s=0.1,
      backoff_max_s=0.1)
  # A supervises and burns the whole budget on b1's crash loop.
  sup_a.tick()
  pool_a.die("b1")
  sup_a.tick()  # restart 1 (immediate: first of the episode)
  pool_a.die("b1")
  clock.t += 0.2
  sup_a.tick()  # detection; 0.1s backoff
  clock.t += 0.2
  sup_a.tick()  # restart 2: budget now exhausted
  assert pool_a.restarts == ["b1", "b1"]
  # The tick published the spends as ages; anti-entropy carries them.
  ages = state_a.observation("b1")["fields"]["budget_ages_s"]
  assert len(ages) == 2
  state_b.merge(state_a.wire())
  # A dies (no release, no heartbeat). Its lease goes stale...
  clock.t += 6.0
  sup_b.tick()
  # ...and B takes over, adopting the budget instead of resetting it.
  snap_b = sup_b.snapshot()
  assert snap_b["lease_held"] is True and snap_b["takeovers"] == 1
  assert router_b.metrics.snapshot()["supervisor_takeovers"] == 1
  assert snap_b["backends"]["b1"]["budget"]["in_window"] == 2
  # The looper dies once more under B: quarantined IMMEDIATELY — the
  # handoff granted it zero fresh restarts.
  pool_b.die("b1")
  sup_b.tick()
  assert sup_b.state("b1") == FleetSupervisor.QUARANTINED
  assert pool_b.restarts == []
  assert router_b.ejected() == ["b1"]
  # The dead leader coming back mid-tick demotes itself to standby.
  sup_a.tick()
  assert sup_a.snapshot()["lease_held"] is False
  assert router_a.events.count("supervision_lease_lost") == 1
  assert router_b.events.count("supervision_takeover") == 1


def test_supervisor_takeover_adopts_gossiped_quarantine(tmp_path):
  """A quarantine verdict survives the handoff: the new leader keeps
  the backend out of rotation without re-litigating the crash loop."""
  clock = FakeClock()
  path = str(tmp_path / "sup.lease")
  state_a = GossipState("routerA", clock=clock)
  state_b = GossipState("routerB", clock=clock)
  pool_a, router_a, sup_a = _leased_fleet(
      FileLease(path, "routerA", ttl_s=5.0, clock=clock), state_a, clock,
      restart_budget=1, budget_window_s=1000.0, backoff_base_s=0.1,
      backoff_max_s=0.1)
  pool_b, router_b, sup_b = _leased_fleet(
      FileLease(path, "routerB", ttl_s=5.0, clock=clock), state_b, clock,
      restart_budget=1, budget_window_s=1000.0, backoff_base_s=0.1,
      backoff_max_s=0.1)
  sup_a.tick()
  pool_a.die("b2")
  sup_a.tick()  # restart 1: budget spent
  pool_a.die("b2")
  clock.t += 0.2
  sup_a.tick()
  clock.t += 0.2
  sup_a.tick()  # budget refused -> quarantined
  assert sup_a.state("b2") == FleetSupervisor.QUARANTINED
  assert state_a.observation("b2")["fields"]["quarantined"] is True
  state_b.merge(state_a.wire())
  clock.t += 6.0
  sup_b.tick()  # takeover adopts the verdict BEFORE the first probe
  assert sup_b.state("b2") == FleetSupervisor.QUARANTINED
  assert "b2" in router_b.ejected()
  assert router_b.stats()["backend_info"]["b2"]["eject_reason"] \
      == "quarantined"
  # Sticky under the new leader too: no respawns ever granted.
  for _ in range(3):
    clock.t += 1.0
    sup_b.tick()
  assert pool_b.restarts == []


# --- RemoteBackendPool: supervising a joined fleet -----------------------


def test_remote_pool_runs_hook_with_backend_argv():
  calls = []

  def runner(argv, timeout=None, capture_output=None):
    calls.append((argv, timeout))

    class R:
      returncode = 0
    return R()

  pool = RemoteBackendPool({"b0": "10.0.0.1:7070"},
                           restart_hook="notify-owner --urgency high",
                           hook_timeout_s=7.0, runner=runner)
  assert pool.alive("b0")  # liveness is the prober's judgment
  pool.kill("b0")          # no local process: a no-op, never an error
  assert pool.alive("b0")
  address = pool.restart("b0")
  assert address == "10.0.0.1:7070"
  # shlex argv + [backend_id, address] — the k8s-operator webhook shape.
  assert calls == [(["notify-owner", "--urgency", "high", "b0",
                     "10.0.0.1:7070"], 7.0)]
  assert pool.snapshot()["hook_invocations"] == 1
  assert pool.snapshot()["hook_failures"] == 0


def test_remote_pool_hook_failures_raise_and_count():
  def failing_runner(argv, timeout=None, capture_output=None):
    class R:
      returncode = 3
    return R()

  pool = RemoteBackendPool({"b0": "10.0.0.1:7070"},
                           restart_hook="broken-hook",
                           runner=failing_runner)
  with pytest.raises(BackendSpawnError):
    pool.restart("b0")

  def crashing_runner(argv, timeout=None, capture_output=None):
    raise OSError("no such file")

  pool._runner = crashing_runner
  with pytest.raises(BackendSpawnError):
    pool.restart("b0")
  assert pool.hook_failures == 2 and pool.hook_invocations == 2
  with pytest.raises(KeyError):
    pool.restart("nope")


def test_remote_pool_hook_failure_is_counted_by_supervisor_never_fatal():
  """A broken webhook must not kill supervision: the supervisor counts
  the failed 'spawn', keeps probing, and quarantines at the budget."""
  def failing_runner(argv, timeout=None, capture_output=None):
    class R:
      returncode = 1
    return R()

  clock = FakeClock()
  pool = RemoteBackendPool({"b0": "10.0.0.9:7070"},
                           restart_hook="broken-hook",
                           runner=failing_runner)
  transport = FakeTransport()
  # The remote backend is unreachable: no handler -> ConnectionError.
  transport.handlers["10.0.0.9:7070"] = \
      lambda method, path: (_ for _ in ()).throw(
          ConnectionError("refused"))
  sup = FleetSupervisor(pool, transport=transport, clock=clock,
                        sleep=lambda s: None, load_refresh_s=0,
                        wedge_after=1, restart_budget=2,
                        budget_window_s=1000.0, backoff_base_s=0.1,
                        backoff_max_s=0.1)
  for _ in range(8):
    sup.tick()
    clock.t += 0.2
  snap = sup.snapshot()["backends"]["b0"]
  assert snap["restart_failures"] >= 1  # counted...
  assert sup.snapshot()["tick_errors"] == 0  # ...never fatal
  assert sup.state("b0") == FleetSupervisor.QUARANTINED
  assert pool.hook_failures == snap["restart_failures"]


# --- one scripted exchange through both packages -------------------------


def _scripted_gossip(state_cls):
  rng = np.random.default_rng(11)
  clock = FakeClock()
  nodes = [state_cls(f"router{i}", clock=clock, lease_ttl_s=3.0)
           for i in range(3)]
  results = []
  for _ in range(120):
    clock.t += float(rng.uniform(0.0, 1.5))
    i, j = (int(x) for x in rng.choice(3, size=2, replace=False))
    op = rng.choice(["observe", "merge", "claim", "clear"],
                    p=[0.5, 0.3, 0.1, 0.1])
    if op == "observe":
      nodes[i].observe(f"b{int(rng.integers(4))}",
                       state=str(rng.choice(["up", "down", "wedged"])),
                       restarts=int(rng.integers(3)))
    elif op == "merge":
      results.append(nodes[i].merge(json.loads(json.dumps(nodes[j].wire()))))
    elif op == "claim":
      results.append(nodes[i].claim_lease(f"router{i}"))
    else:
      nodes[i].clear_lease(f"router{i}")
    results.append(nodes[i].lease_view())
  return results, [n.wire() for n in nodes]


def test_scripted_gossip_equals_jax_and_wires_cross():
  port = _scripted_gossip(GossipState)
  ref = _scripted_gossip(JGossipState)
  assert port == ref
  # A wire state either package wrote merges into the other the same way.
  clock = FakeClock(5000.0)
  a, b = GossipState("x", clock=clock), JGossipState("x", clock=clock)
  for wire in port[1]:
    assert a.merge(wire) == b.merge(wire)
  assert a.wire() == b.wire()

