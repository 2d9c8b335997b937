"""The port's cluster over real backend processes.

Every live case of ``tests/serve/test_cluster.py``,
``test_supervisor.py``, ``test_gossip.py`` and ``test_autoscale.py``,
run against ONE module-scoped port ``BackendPool`` of three ``python -m
mpi_vision_tpu_torch serve --device cpu`` children (32 px, 4 planes, 6
scenes; pixels a pure function of ``(seed, scene_id)``). Each group's
fixture re-gates the pool (``heal_pool``) before building its router, so
a group starts from three live, healthy backends whatever the previous
group's chaos left behind:

  * routing: ≥6 scenes sharded across the pool, bit-identical routed
    renders, router->backend trace stitching via the outbound W3C
    traceparent, a SIGKILL mid-load with failover + breaker isolation +
    degraded-not-unhealthy aggregation, resurrection through the
    half-open probe;
  * supervision: SIGKILL -> same-port respawn -> breaker re-close ->
    bit-identical pixels; a rolling restart with zero failed requests;
    crash-loop quarantine at exactly the restart budget;
  * router HA: a leased handoff between two supervising routers;
  * elasticity: a warmed scale-up and a drainless scale-down under
    closed-loop traffic with zero failed requests.

Plus the device rule of the port's pool: a ``cuda`` pool on a machine
with no card fails to start with the child's error, never on the CPU.
Every wait has its own timeout.
"""

import base64
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from mpi_vision_tpu_torch.obs import Tracer, parse_metrics_text
from mpi_vision_tpu_torch.serve.cluster import (
    AutoscaleConfig,
    AutoscalePolicy,
    Autoscaler,
    BackendPool,
    BackendSpawnError,
    FileLease,
    FleetSupervisor,
    GossipState,
    Router,
    SupervisionLeaseLost,
)

N_BACKENDS = 3
N_SCENES = 6
IMG, PLANES = 32, 4


def _pool_env():
  # One thread per child: three backends and the test process share the
  # box's cores.
  return dict(os.environ, OMP_NUM_THREADS="1")


def heal_pool(pool) -> dict:
  """Restart any backend a previous group's chaos left dead and return
  the (unchanged — restarts reuse ports) address map."""
  for bid in sorted(pool.addresses()):
    if not pool.alive(bid):
      pool.restart(bid)
  return pool.addresses()


@pytest.fixture(scope="module")
def backend_pool():
  """3 real port serve processes shared by every group in this file."""
  pool = BackendPool(
      N_BACKENDS, scenes=N_SCENES, img_size=IMG, planes=PLANES,
      device="cpu", env=_pool_env(), startup_timeout_s=60.0,
      extra_args=["--max-batch", "4", "--max-wait-ms", "1"],
      log=lambda m: print(m, file=sys.stderr))
  try:
    pool.start()
  except Exception:
    pool.close()
    raise
  yield pool
  pool.close()


def _render_body(sid, tx=0.0):
  pose = np.eye(4)
  pose[0, 3] = tx
  return json.dumps({"scene_id": sid, "pose": pose.tolist()}).encode()


def _decode(body):
  payload = json.loads(body)
  img = np.frombuffer(base64.b64decode(payload["image_b64"]), "<f4")
  return img.reshape(payload["shape"])


# --- the pool's device rule ------------------------------------------------


def test_pool_refuses_unknown_devices():
  with pytest.raises(ValueError, match="device"):
    BackendPool(1, device="tpu")


def test_cuda_pool_without_a_card_fails_with_the_childs_error(tmp_path):
  # The child sees no card, whatever this machine has.
  env = dict(_pool_env(), CUDA_VISIBLE_DEVICES="")
  pool = BackendPool(1, scenes=1, img_size=16, planes=2, env=env,
                     workdir=str(tmp_path), startup_timeout_s=60.0)
  assert pool.device == "cuda"  # the default
  try:
    with pytest.raises(BackendSpawnError, match="no CUDA device"):
      pool.start()
  finally:
    pool.close()
  log = (tmp_path / "b0.log").read_text()
  assert "no CUDA device" in log
  assert "serve: listening" not in log  # nothing served on the CPU


# --- routing over the live fleet -----------------------------------------


@pytest.fixture(scope="module")
def cluster(backend_pool):
  """≥3 real serve processes + a router with per-backend breakers.

  The pool is the module-shared one — spawning the backends is the
  expensive part, so every group rides the same fleet, re-gated healthy
  by its own fixture. The breaker cooldown is LONG
  so an opened breaker stays visibly open for the assertions; the
  resurrection test drives the probe through a fresh router with its
  own short-cooldown breakers.
  """
  pool, backends = backend_pool, heal_pool(backend_pool)
  router = Router(backends, replication=2, breaker_threshold=2,
                  breaker_reset_s=600.0, render_timeout_s=120.0,
                  tracer=Tracer())
  yield pool, router






def test_cluster_shards_scenes_and_routes_bit_identically(cluster):
  pool, router = cluster
  sids = pool.scene_ids()
  assert len(sids) >= 6
  primaries = {router.placement(sid)[0] for sid in sids}
  assert len(primaries) >= 2  # really sharded, not one hot backend
  for sid in sids[:3]:
    status, headers, body = router.forward_render(sid, _render_body(sid))
    assert status == 200
    routed = _decode(body)
    assert routed.shape == (pool.img_size, pool.img_size, 3)
    # Bit-identical to a DIRECT render on the very backend that served
    # it (the router is a pure forwarder; placement changes nothing in
    # the pixels).
    backend_addr = pool.addresses()[headers["X-Backend-Id"]]
    req = urllib.request.Request(
        f"http://{backend_addr}/render", data=_render_body(sid),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
      direct = _decode(resp.read())
    np.testing.assert_array_equal(routed, direct)


def test_cluster_trace_stitches_router_to_backend(cluster):
  pool, router = cluster
  sid = pool.scene_ids()[0]
  trace_id = "f" * 31 + "e"  # a fixed, greppable 32-hex id
  tr = router.tracer.start_trace("route", trace_id=trace_id, scene_id=sid)
  status, headers, _ = router.forward_render(
      sid, _render_body(sid, tx=0.01), trace_id=trace_id, trace=tr)
  tr.finish()
  assert status == 200
  # The backend honored the outbound traceparent: ITS response header
  # carries OUR trace id...
  assert headers["X-Trace-Id"] == trace_id
  backend_addr = pool.addresses()[headers["X-Backend-Id"]]
  with urllib.request.urlopen(
      f"http://{backend_addr}/debug/traces", timeout=30) as resp:
    backend_traces = json.loads(resp.read())
  backend_ids = {t["trace_id"] for t in backend_traces["recent"]}
  # ...and recorded a span tree under it, as did the router: one id,
  # two processes, a stitched distributed trace.
  assert trace_id in backend_ids
  router_ids = {t["trace_id"] for t in router.tracer.snapshot()["recent"]}
  assert trace_id in router_ids
  backend_tr = next(t for t in backend_traces["recent"]
                    if t["trace_id"] == trace_id)
  assert {"queue_wait", "dispatch"} <= {s["name"]
                                        for s in backend_tr["spans"]}


def test_cluster_sigkill_mid_load_fails_over_and_isolates(cluster):
  pool, router = cluster
  sids = pool.scene_ids()
  victim = router.placement(sids[0])[0]
  victim_scenes = [s for s in sids if victim in router.placement(s)]
  assert victim_scenes  # the victim must actually matter

  stop = threading.Event()
  failures: list[str] = []
  post_kill_ok: set[str] = set()
  killed = threading.Event()
  lock = threading.Lock()

  def worker(widx):
    i = 0
    while not stop.is_set():
      sid = sids[(widx + i) % len(sids)]
      i += 1
      try:
        status, _, _ = router.forward_render(
            sid, _render_body(sid, tx=0.002 * (i % 5)))
      except Exception as e:  # noqa: BLE001 - transition failures expected
        with lock:
          failures.append(f"{sid}: {e!r}")
        continue
      if status == 200 and killed.is_set():
        with lock:
          post_kill_ok.add(sid)

  threads = [threading.Thread(target=worker, args=(w,), daemon=True)
             for w in range(3)]
  for t in threads:
    t.start()
  # Let the load establish, then SIGKILL one backend under it.
  deadline = 60.0
  import time as _time
  t0 = _time.monotonic()
  while not router.metrics.snapshot()["requests"] and \
      _time.monotonic() - t0 < deadline:
    _time.sleep(0.05)
  pool.kill(victim)
  killed.set()
  # Keep loading until EVERY scene the victim served has rendered
  # successfully post-kill (failover proven), or the deadline says no.
  while not set(victim_scenes) <= post_kill_ok and \
      _time.monotonic() - t0 < deadline:
    _time.sleep(0.1)
  stop.set()
  for t in threads:
    t.join(30)

  assert set(victim_scenes) <= post_kill_ok, (
      f"scenes never failed over: {set(victim_scenes) - post_kill_ok}; "
      f"failures={failures[:5]}")
  info = router.stats()["backend_info"]
  assert info[victim]["breaker"]["state"] == "open"
  for bid, binfo in info.items():
    if bid != victim:
      assert binfo["breaker"]["state"] == "closed", (
          f"healthy backend {bid} breaker opened: {binfo}")  # isolation
  health = router.healthz()
  assert health["status"] == "degraded"  # NOT unhealthy: replicas cover
  assert health["backends_reachable"] == pool.n_backends - 1
  assert router.metrics.snapshot()["failovers"] >= 1


def test_cluster_resurrected_backend_serves_again(cluster):
  """The dead backend restarts on its old port; a fresh router (short
  breaker cooldown) sees its breaker open, then re-close through the
  half-open probe, then traffic flows to it again."""
  pool, router = cluster
  sids = pool.scene_ids()
  victim = router.placement(sids[0])[0]
  if pool.alive(victim):  # runs after the SIGKILL test; be self-sufficient
    pool.kill(victim)
  probe_router = Router(pool.addresses(), replication=2,
                        breaker_threshold=1, breaker_reset_s=0.5,
                        render_timeout_s=120.0)
  sid = next(s for s in sids if probe_router.placement(s)[0] == victim)
  status, headers, _ = probe_router.forward_render(sid, _render_body(sid))
  assert status == 200 and headers["X-Backend-Id"] != victim  # failover
  assert probe_router.stats()["backend_info"][victim]["breaker"][
      "state"] == "open"
  pool.restart(victim)
  import time as _time
  deadline = _time.monotonic() + 30.0
  served_by = None
  while _time.monotonic() < deadline:
    status, headers, _ = probe_router.forward_render(sid, _render_body(sid))
    assert status == 200
    if headers["X-Backend-Id"] == victim:
      served_by = victim
      break
    _time.sleep(0.2)
  assert served_by == victim, "probe never re-closed the breaker"
  assert probe_router.stats()["backend_info"][victim]["breaker"][
      "state"] == "closed"


# --- the supervised live fleet -------------------------------------------


@pytest.fixture(scope="module")
def fleet(backend_pool):
  """3 real serve processes + a router with short-cooldown per-backend
  breakers (0.5 s: a restarted backend's half-open probe re-closes
  within the test's traffic, not after minutes). The pool is the
  module-shared one, re-gated healthy here; the tests below run in
  definition order against it and leave it fully serving (3 live
  backends) for the next group."""
  pool, backends = backend_pool, heal_pool(backend_pool)
  router = Router(backends, replication=2, breaker_threshold=2,
                  breaker_reset_s=0.5, render_timeout_s=120.0)
  yield pool, router






def _supervisor(pool, router, **kwargs):
  kwargs.setdefault("probe_s", 0.05)
  kwargs.setdefault("backoff_base_s", 0.05)
  kwargs.setdefault("backoff_max_s", 0.2)
  kwargs.setdefault("load_refresh_s", 0)
  return FleetSupervisor(
      pool, router=router, events=router.events,
      log=lambda m: print(m, file=sys.stderr), **kwargs)


def test_fleet_sigkill_restart_breaker_recloses_bit_identical(fleet):
  """THE acceptance arc: SIGKILL -> supervisor respawns on the same
  port -> the router's breaker re-closes through its half-open probe ->
  the restarted backend serves bit-identical pixels."""
  pool, router = fleet
  sids = pool.scene_ids()
  victim = router.placement(sids[0])[0]
  vsid = sids[0]
  status, headers, body = router.forward_render(vsid, _render_body(vsid))
  assert status == 200 and headers["X-Backend-Id"] == victim
  baseline = _decode(body)

  pool.kill(victim)
  # Traffic meets the corpse: two failed attempts open ITS breaker
  # (threshold 2) while replicas keep answering.
  for _ in range(2):
    status, headers, _ = router.forward_render(vsid, _render_body(vsid))
    assert status == 200 and headers["X-Backend-Id"] != victim
  assert router.breaker_state(victim) == "open"

  sup = _supervisor(pool, router, restart_budget=5, budget_window_s=30.0)
  sup.tick()  # one monitor pass: detect exit, respawn, readmit
  assert pool.alive(victim)
  assert sup.state(victim) == FleetSupervisor.UP
  assert router.events.count("backend_restart") >= 1
  assert router.metrics.snapshot()["restarts"].get(victim, 0) >= 1

  # The breaker is still open; once the 0.5 s cooldown elapses the next
  # request IS the half-open probe and its success re-closes the
  # circuit — after which the victim serves its primary scene again.
  deadline = time.monotonic() + 60.0
  served = None
  while time.monotonic() < deadline:
    status, headers, body = router.forward_render(vsid, _render_body(vsid))
    assert status == 200
    if headers["X-Backend-Id"] == victim:
      served = _decode(body)
      break
    time.sleep(0.05)
  assert served is not None, "restarted backend never served again"
  assert router.breaker_state(victim) == "closed"
  np.testing.assert_array_equal(served, baseline)  # bit-identical


def test_fleet_rolling_restart_zero_failed_requests(fleet):
  """Rolling restart over 3 LIVE backends: every process is replaced,
  one at a time, while closed-loop clients hammer the router — and not
  one client request fails."""
  pool, router = fleet
  sids = pool.scene_ids()
  pids_before = {b: pool.pid(b) for b in pool.addresses()}
  sup = _supervisor(pool, router)

  stop = threading.Event()
  failures: list[str] = []
  ok_counts = [0] * 3
  lock = threading.Lock()

  def worker(w):
    i = 0
    while not stop.is_set():
      sid = sids[(w + i) % len(sids)]
      i += 1
      try:
        status, _, _ = router.forward_render(
            sid, _render_body(sid, tx=0.002 * (i % 5)))
      except Exception as e:  # noqa: BLE001 - any escape is a failure
        with lock:
          failures.append(f"{sid}: {e!r}")
        continue
      if status == 200:
        ok_counts[w] += 1
      else:
        with lock:
          failures.append(f"{sid}: http {status}")

  threads = [threading.Thread(target=worker, args=(w,), daemon=True)
             for w in range(3)]
  for t in threads:
    t.start()
  deadline = time.monotonic() + 60.0
  while sum(ok_counts) < 5 and time.monotonic() < deadline:
    time.sleep(0.05)  # traffic established before the roll
  report = sup.rolling_restart(drain_s=0.5, settle_timeout_s=60.0)
  # Keep loading briefly after the roll: the fleet must be fully back.
  end = time.monotonic() + 1.0
  while time.monotonic() < end:
    time.sleep(0.05)
  stop.set()
  for t in threads:
    t.join(30)

  assert report["ok"], report
  assert [s["backend"] for s in report["steps"]] == sorted(pids_before)
  assert failures == [], failures[:10]  # ZERO failed client requests
  assert sum(ok_counts) > 0
  pids_after = {b: pool.pid(b) for b in pool.addresses()}
  assert all(pids_after[b] != pids_before[b] for b in pids_before), (
      "rolling restart must replace every process")
  assert router.ejected() == []
  for b in pool.addresses():
    assert router.breaker_state(b) == "closed"
  assert router.events.count("rolling_restart_begin") >= 1
  assert router.events.count("rolling_restart_step") >= 3
  assert router.events.count("rolling_restart_end") >= 1


def test_fleet_crash_loop_quarantined_within_budget(fleet):
  """THE containment pin: a backend that dies every time it comes back
  is quarantined after exactly its restart budget — respawns stop, the
  event and router metric fire, and the remaining replicas keep serving
  every scene."""
  pool, router = fleet
  sids = pool.scene_ids()
  victim = router.placement(sids[0])[0]
  budget = 2
  sup = _supervisor(pool, router, restart_budget=budget,
                    budget_window_s=300.0).start()
  try:
    kills = 0
    deadline = time.monotonic() + 120.0
    while time.monotonic() < deadline and \
        sup.state(victim) != FleetSupervisor.QUARANTINED:
      if sup.state(victim) in (None, FleetSupervisor.UP) \
          and pool.alive(victim):
        pool.kill(victim)
        kills += 1
      time.sleep(0.02)
    assert sup.state(victim) == FleetSupervisor.QUARANTINED, (
        f"not quarantined after {kills} kills: {sup.snapshot()}")
    snap = sup.snapshot()["backends"][victim]
    assert snap["restarts"] == budget  # contained AT the budget
    assert router.events.count("backend_quarantined") == 1
    # Containment means containment: no further respawns.
    time.sleep(0.5)
    assert not pool.alive(victim)
    assert sup.snapshot()["backends"][victim]["restarts"] == budget
    # Visible at the router: ejected + quarantine counter + /metrics.
    assert victim in router.ejected()
    assert router.metrics.snapshot()["quarantines"] == {victim: 1}
    families = parse_metrics_text(router.metrics_text())
    assert families["mpi_cluster_quarantines_total"]["samples"][
        ("mpi_cluster_quarantines_total", (("backend", victim),))] == 1
    # The fleet keeps serving EVERY scene off the surviving replicas.
    for sid in sids:
      status, headers, _ = router.forward_render(sid, _render_body(sid))
      assert status == 200 and headers["X-Backend-Id"] != victim
    health = router.healthz()
    assert health["status"] == "degraded"  # honest, but not dead
    # Operator readmit: fresh budget, respawn, back in rotation.
    sup.readmit(victim)
    assert pool.alive(victim) and victim not in router.ejected()
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
      status, headers, _ = router.forward_render(
          sids[0], _render_body(sids[0]))
      assert status == 200
      if headers["X-Backend-Id"] == victim:
        break
      time.sleep(0.05)
    assert router.breaker_state(victim) in ("closed", "half_open")
  finally:
    sup.stop()


# --- leased handoff over the live fleet ----------------------------------


@pytest.fixture(scope="module")
def live_fleet(backend_pool):
  """The module-shared backend pool, re-gated healthy — the
  lease-handoff arc needs real processes to kill and respawn, not a
  particular pool size."""
  return backend_pool, heal_pool(backend_pool)




def test_live_failover_arc_lease_handoff_and_respawn(live_fleet, tmp_path):
  """The real-process failover arc: two router replicas supervise one
  LIVE fleet through a shared FileLease. The leader restarts a killed
  backend and publishes the spend into gossip; then the leader dies
  (stops heartbeating), the standby reaps the stale lease mid-stream,
  adopts the budget, and a backend killed AFTER the takeover is
  respawned by the NEW leader — requests succeed throughout."""
  pool, backends = live_fleet
  path = str(tmp_path / "sup.lease")
  state_a = GossipState("routerA", lease_ttl_s=1.0)
  state_b = GossipState("routerB", lease_ttl_s=1.0)

  def replica(node_id, state):
    router = Router(backends, replication=2, breaker_threshold=2,
                    breaker_reset_s=0.3, render_timeout_s=120.0)
    sup = FleetSupervisor(
        pool, router=router, events=router.events,
        probe_s=0.05, backoff_base_s=0.05, backoff_max_s=0.2,
        load_refresh_s=0, restart_budget=5, budget_window_s=300.0,
        lease=FileLease(path, node_id, ttl_s=1.0),
        gossip=state, log=lambda m: print(m, file=sys.stderr))
    return router, sup

  router_a, sup_a = replica("routerA", state_a)
  router_b, sup_b = replica("routerB", state_b)
  sids = pool.scene_ids()
  # The victim must be a backend that actually serves sids[0]: the
  # phase-4 convergence check waits for IT to answer that scene, and
  # on a >2-backend pool an arbitrary backend may not be in placement.
  victim = router_a.placement(sids[0])[0]

  # Phase 1: A leads, B stands by; the fleet serves through BOTH
  # router replicas (routing never needed the lease).
  sup_a.tick()
  sup_b.tick()
  assert sup_a.snapshot()["lease_held"] is True
  assert sup_b.snapshot()["lease_held"] is False
  for router in (router_a, router_b):
    status, _, _ = router.forward_render(sids[0], _render_body(sids[0]))
    assert status == 200

  # Phase 2: a backend dies under the leader; one tick respawns it and
  # the spend lands in gossip (anti-entropy simulated by one merge —
  # in production GossipNode rounds carry it).
  pool.kill(victim)
  sup_a.tick()
  assert pool.alive(victim)
  assert state_a.observation(victim)["fields"]["budget_ages_s"]
  state_b.merge(state_a.wire())

  # Phase 3: the leader dies mid-stream (no release — a SIGKILL'd
  # router heartbeats never again). The standby reaps the stale lease.
  time.sleep(1.3)  # > ttl_s: the lease is now stale on disk
  sup_b.tick()
  snap_b = sup_b.snapshot()
  assert snap_b["lease_held"] is True and snap_b["takeovers"] == 1
  assert snap_b["backends"][victim]["budget"]["in_window"] >= 1
  with pytest.raises(SupervisionLeaseLost):
    sup_a.lease.heartbeat()  # the corpse cannot sneak back in

  # Phase 4: a backend killed AFTER the takeover is respawned by the
  # NEW leader — supervision truly moved, and the fleet still serves.
  pool.kill(victim)
  deadline = time.monotonic() + 30.0
  while not pool.alive(victim) and time.monotonic() < deadline:
    sup_b.tick()
    time.sleep(0.05)
  assert pool.alive(victim), "new leader never respawned the backend"
  assert sup_b.snapshot()["backends"][victim]["restarts"] >= 1
  deadline = time.monotonic() + 30.0
  served = False
  while time.monotonic() < deadline:
    status, headers, _ = router_b.forward_render(
        sids[0], _render_body(sids[0]))
    assert status == 200
    if headers["X-Backend-Id"] == victim:
      served = True
      break
    time.sleep(0.05)
  assert served, "respawned backend never served under the new leader"
  assert router_b.metrics.snapshot()["supervisor_takeovers"] == 1


# --- the elastic live fleet ----------------------------------------------


@pytest.fixture(scope="module")
def elastic_fleet(backend_pool):
  pool, backends = backend_pool, heal_pool(backend_pool)
  router = Router(backends, replication=2, breaker_threshold=2,
                  breaker_reset_s=0.5, render_timeout_s=120.0)
  yield pool, router




def test_fleet_scale_up_warmed_admit_then_drainless_retire(elastic_fleet):
  """THE acceptance arc: under live closed-loop traffic the
  fleet grows by one REAL backend (spawned, warmed over HTTP, only
  then admitted to the ring) and shrinks back via the drainless
  eject -> drain -> SIGTERM -> retire choreography — with ZERO failed
  client requests across both transitions."""
  pool, router = elastic_fleet
  sids = pool.scene_ids()
  before = sorted(router.backend_ids())
  policy = AutoscalePolicy(AutoscaleConfig(
      min_backends=len(before), max_backends=len(before) + 1,
      up_cooldown_s=0.0, down_cooldown_s=0.0))
  asc = Autoscaler(policy, pool, router, events=router.events,
                   scenes=sids, drain_s=0.3, warm_timeout_s=120.0,
                   log=lambda m: print(m, file=sys.stderr))

  stop = threading.Event()
  failures: list[str] = []
  ok = [0] * 3
  lock = threading.Lock()

  def worker(w):
    i = 0
    while not stop.is_set():
      sid = sids[(w + i) % len(sids)]
      i += 1
      try:
        status, _, _ = router.forward_render(
            sid, _render_body(sid, tx=0.002 * (i % 5)))
      except Exception as e:  # noqa: BLE001 - any escape is a failure
        with lock:
          failures.append(f"{sid}: {e!r}")
        continue
      if status == 200:
        ok[w] += 1
      else:
        with lock:
          failures.append(f"{sid}: http {status}")

  threads = [threading.Thread(target=worker, args=(w,), daemon=True)
             for w in range(3)]
  for t in threads:
    t.start()
  new_backend = None
  try:
    deadline = time.monotonic() + 60.0
    while sum(ok) < 5 and time.monotonic() < deadline:
      time.sleep(0.05)  # traffic established before the ramp

    up = asc.scale_up("acceptance ramp")
    assert up["action"] == "up", up
    new_backend = up["backend"]
    assert new_backend not in before
    assert new_backend in router.backend_ids()
    assert pool.alive(new_backend)
    # Warmed means WARMED: every ring key the new backend now owns was
    # probed (manifest-diff or a real render) before the ring moved.
    owned = [k for k, placement in
             router.resize_preview(keys=sids)["after"].items()
             if new_backend in placement]
    assert up["warm"]["ok"]
    assert set(up["warm"]["modes"]) == set(owned)
    assert router.events.count("autoscale_up") >= 1

    end = time.monotonic() + 0.5
    while time.monotonic() < end:
      time.sleep(0.05)  # let traffic ride the grown fleet

    down = asc.scale_down("acceptance ramp-down")
    assert down["action"] == "down", down
    # Highest-numbered victim: the backend we just added.
    assert down["backend"] == new_backend
    new_backend = None
    assert sorted(router.backend_ids()) == before
    assert router.events.count("autoscale_down") >= 1

    end = time.monotonic() + 0.5
    while time.monotonic() < end:
      time.sleep(0.05)  # the shrunk fleet must still serve cleanly
  finally:
    stop.set()
    for t in threads:
      t.join(30)
    if new_backend is not None:  # a failed assert must not leak a proc
      pool.retire(new_backend)

  assert failures == [], failures[:10]  # ZERO failed client requests
  assert sum(ok) > 0
  assert router.ejected() == []
  snap = router.metrics.snapshot()["autoscale"]
  assert snap["ups"] >= 1 and snap["downs"] >= 1
  # Every scene still serves from the restored pool.
  for sid in sids:
    status, _, _ = router.forward_render(sid, _render_body(sid))
    assert status == 200
