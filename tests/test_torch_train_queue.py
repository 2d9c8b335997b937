"""The port's training job queue and supervisor against the JAX package's.

``train/queue.py`` is a copy of the JAX module and ``train/supervisor.py``
its counterpart (children are ``python -m mpi_vision_tpu_torch train
--device <device>``). Pinned here: the same operations on a fake clock
give equal job records through both packages, and a queue one package
wrote is leased and drained by the other; ``CheckpointStore.publish_from``
republishes a JAX-written checkpoint that both packages restore with its
hashes valid; the state machine on fakes (the cases of
``tests/test_train_queue.py``, the chaos bench's apart); the
``train-queue`` CLI's guards; and one module-scoped arc over real
``--device cpu`` children (32 px, 4 planes, no VGG), the cases of
``tests/test_train_queue_arc.py``: a poison job quarantined at exactly its
budget, a SIGKILLed-then-resumed job bit-exact to its clean sibling, and
both published checkpoints swapped live under render traffic with no
failed request; and two supervisors over real children draining one
shared queue, each job run exactly once.
"""

import hashlib
import json
import os
import signal
import threading
import time

import numpy as np
import pytest

from mpi_vision_tpu.ckpt import CheckpointStore as JCheckpointStore
from mpi_vision_tpu.obs.events import EventLog as JEventLog
from mpi_vision_tpu.train.queue import JobQueue as JJobQueue
from mpi_vision_tpu_torch import cli
from mpi_vision_tpu_torch.ckpt import CheckpointStore
from mpi_vision_tpu_torch.obs.events import EventLog
from mpi_vision_tpu_torch.train import faultinject as fi
from mpi_vision_tpu_torch.train.queue import (
    JobQueue,
    JobQueueError,
    LeaseLostError,
)
from mpi_vision_tpu_torch.train.supervisor import (
    JobSpecError,
    SubprocessLauncher,
    TrainSupervisor,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
  def __init__(self, t=1000.0):
    self.t = t

  def __call__(self):
    return self.t

  def sleep(self, seconds):
    self.t += max(float(seconds), 0.0)


# --- queue lifecycle ------------------------------------------------------


def test_submit_lease_complete_roundtrip(tmp_path):
  clock = FakeClock()
  events = EventLog(clock=clock)
  q = JobQueue(str(tmp_path), lease_s=30.0, clock=clock, events=events)
  jid = q.submit({"epochs": 1}, job_id="a")
  assert jid == "a" and q.get("a").state == "queued"
  job = q.lease("w1")
  assert job.id == "a" and job.state == "leased"
  assert q.lease("w2") is None  # single job, already claimed
  q.mark_running("a", "w1", attempt=0)
  assert q.get("a").attempts == 1
  q.complete("a", "w1", {"ok": True})
  assert q.get("a").state == "done"
  assert q.drained()
  assert events.count("training_job_done") == 1
  # The record is one atomic JSON file a fresh reader can reload whole.
  reloaded = JobQueue(str(tmp_path), clock=clock)
  assert reloaded.get("a").record["result"] == {"ok": True}


def test_lease_respects_backoff_floor_and_fifo(tmp_path):
  clock = FakeClock()
  q = JobQueue(str(tmp_path), clock=clock)
  q.submit({}, job_id="old")
  clock.t += 1.0
  q.submit({}, job_id="new")
  job = q.lease("w")
  assert job.id == "old"  # FIFO by creation time
  q.mark_running("old", "w", 0)
  q.requeue("old", "w", "crash", not_before_unix_s=clock() + 10.0)
  assert q.lease("w").id == "new"  # old is cooling off
  q.requeue("new", "w", "crash", not_before_unix_s=clock() + 5.0)
  assert q.lease("w") is None
  clock.t += 10.1
  assert q.lease("w").id == "old"


def test_dead_worker_lease_expires_and_requeues(tmp_path):
  clock = FakeClock()
  events = EventLog(clock=clock)
  q = JobQueue(str(tmp_path), lease_s=10.0, clock=clock, events=events)
  q.submit({}, job_id="a")
  q.lease("w1")
  q.mark_running("a", "w1", 0)
  assert q.reap_expired() == []  # heartbeat fresh
  clock.t += 9.0
  q.heartbeat("a", "w1")
  clock.t += 9.0
  assert q.reap_expired() == []  # refreshed in time
  clock.t += 10.1
  assert q.reap_expired() == ["a"]  # the worker died: requeued, not lost
  record = q.get("a").record
  assert record["state"] == "queued" and record["lease"] is None
  assert q.leases_expired == 1
  assert events.count("training_job_lease_expired") == 1
  # The dead worker's late write is refused: its lease is gone.
  with pytest.raises(LeaseLostError):
    q.heartbeat("a", "w1")
  with pytest.raises(LeaseLostError):
    q.complete("a", "w1")
  # A new worker resumes it (attempts carries across workers).
  job = q.lease("w2")
  q.mark_running("a", "w2", job.attempts)
  assert q.get("a").attempts == 2


def test_quarantine_is_terminal_until_readmitted(tmp_path):
  clock = FakeClock()
  events = EventLog(clock=clock)
  q = JobQueue(str(tmp_path), clock=clock, events=events)
  q.submit({}, job_id="p")
  q.lease("w")
  q.mark_running("p", "w", 0)
  q.quarantine("p", "w", "crash-loop")
  assert q.get("p").state == "quarantined"
  assert q.lease("w") is None and q.drained()
  assert events.count("training_job_quarantined") == 1
  q.readmit("p")
  assert q.get("p").state == "queued"
  assert q.lease("w").id == "p"


def test_queue_guards(tmp_path):
  q = JobQueue(str(tmp_path), clock=FakeClock())
  with pytest.raises(ValueError, match="lease_s"):
    JobQueue(str(tmp_path), lease_s=0)
  with pytest.raises(ValueError, match="must be a dict"):
    q.submit("nope")
  with pytest.raises(ValueError, match="job id"):
    q.submit({}, job_id="bad/../id")
  q.submit({}, job_id="dup")
  with pytest.raises(JobQueueError, match="already exists"):
    q.submit({}, job_id="dup")
  with pytest.raises(JobQueueError, match="not quarantined/failed"):
    q.readmit("dup")


# --- fault grammar --------------------------------------------------------


def test_fault_grammar_roundtrip():
  spec = fi.parse_fault("crash@step=7,hard,attempt=0")
  assert spec == {"kind": "crash", "attempt": 0, "step": 7, "hard": True}
  assert fi.format_fault(spec) == "crash@step=7,hard,attempt=0"
  assert fi.parse_fault("corrupt@save=1,mode=garble")["mode"] == "garble"
  assert fi.parse_fault("hang@step=2,seconds=9.5")["seconds"] == 9.5
  for bad in ("crash", "crash@", "boom@step=1", "crash@step=1,save=2",
              "nan@save=1", "corrupt@step=1", "crash@step=x",
              "crash@step=1,zorp=3"):
    with pytest.raises(fi.FaultSpecError):
      fi.parse_fault(bad)


def test_malformed_fault_entries_are_spec_errors_not_loops():
  """JSON job specs can carry dict or garbage fault entries: they must
  raise FaultSpecError (-> terminal spec-reject at the launcher), never
  a bare KeyError/TypeError that would strand the job in a
  lease-reap-respawn loop the restart budget cannot see."""
  for bad in (5, "crash@step=1", {"kind": "crash"},
              [{"kind": "crash"}], [{"step": 1}], [5], [None]):
    with pytest.raises(fi.FaultSpecError):
      fi.applicable(bad, 0)
    with pytest.raises(fi.FaultSpecError):
      fi.build_source(bad)
  # Valid dict entries (the JSON spec form) still work.
  assert fi.applicable([{"kind": "crash", "step": 1, "hard": True}],
                       0) == ["crash@step=1,hard"]
  # A typo'd key must REJECT, not silently vanish in the round-trip —
  # a dropped "atempt" gate turns a one-shot crash into a poison job.
  with pytest.raises(fi.FaultSpecError, match="atempt"):
    fi.applicable([{"kind": "crash", "step": 1, "atempt": 0}], 0)


def test_launcher_rejects_malformed_faults_terminally(tmp_path):
  launcher = SubprocessLauncher(str(tmp_path))
  queue = JobQueue(str(tmp_path / "q"), clock=FakeClock())
  queue.submit({"faults": [{"kind": "crash"}]}, job_id="garbage")
  with pytest.raises(JobSpecError):
    launcher.argv(queue.get("garbage"), 0, False)


def test_fault_attempt_gating():
  faults = ["crash@step=1,hard,attempt=0", "nan@step=2"]
  assert fi.applicable(faults, 0) == ["crash@step=1,hard,attempt=0",
                                      "nan@step=2"]
  assert fi.applicable(faults, 1) == ["nan@step=2"]  # gated crash dropped
  assert fi.build_source(faults, attempt=1).on_step(1) is None
  assert fi.build_source(faults, attempt=0).on_step(1) is not None
  assert fi.build_source(["crash@step=1,attempt=2"], attempt=0) is None


# --- supervisor over fakes ------------------------------------------------


class FakeHandle:
  def __init__(self, port=9):
    self.rc = None
    self.kills = []
    self.ckpt_dir = "<fake>"
    self.port = port
    self.health = {"status": "ok", "steps": 0, "last_step_ms": 25.0}
    self.term_exits_clean = False

  def poll(self):
    return self.rc

  def kill(self, sig):
    self.kills.append(int(sig))
    if sig == signal.SIGTERM and self.term_exits_clean:
      self.rc = 0
    else:
      self.rc = -int(sig)

  def metrics_address(self):
    return f"127.0.0.1:{self.port}"


class FakeLauncher:
  def __init__(self):
    self.spawned = []
    self.handles = {}
    self.reject = set()

  def __call__(self, job, attempt, resume):
    if job.id in self.reject:
      raise JobSpecError("bad spec")
    handle = FakeHandle(port=9000 + len(self.spawned))
    self.spawned.append((job.id, attempt, resume))
    self.handles[(job.id, attempt)] = handle
    return handle


class FakeTransport:
  """Keyed by the probed address (a probe of job A answered with job
  B's counters would reset the wrong stall clock)."""

  def __init__(self, launcher):
    self.launcher = launcher

  def request(self, method, url, body=None, headers=None, timeout=None):
    for handle in self.launcher.handles.values():
      if (handle.rc is None
          and url == f"http://{handle.metrics_address()}/healthz"):
        return 200, {}, json.dumps(handle.health).encode()
    raise ConnectionError("down")


class FakePublish:
  def __init__(self):
    self.calls = []

  def publish_from(self, src_root, meta_extra=None):
    self.calls.append((src_root, meta_extra))
    return len(self.calls) - 1, 0


def _sup(tmp_path, **kwargs):
  clock = kwargs.pop("clock", FakeClock())
  events = EventLog(clock=clock)
  queue = JobQueue(str(tmp_path), lease_s=60.0, clock=clock, events=events)
  launcher = FakeLauncher()
  defaults = dict(restart_budget=2, budget_window_s=600.0,
                  backoff_base_s=1.0, backoff_mult=2.0, backoff_max_s=8.0,
                  wedge_after=3, startup_grace_s=5.0)
  defaults.update(kwargs)
  supervisor = TrainSupervisor(
      queue, launcher=launcher, transport=FakeTransport(launcher),
      events=events, clock=clock, sleep=clock.sleep, **defaults)
  return clock, queue, launcher, supervisor, events


def test_crash_loop_quarantined_at_exactly_the_budget(tmp_path):
  clock, queue, launcher, sup, events = _sup(tmp_path, restart_budget=2)
  queue.submit({}, job_id="poison")
  sup.tick()
  assert launcher.spawned == [("poison", 0, False)]
  for attempt in (0, 1, 2):
    launcher.handles[("poison", attempt)].rc = 1
    sup.tick()          # detect the crash (first retry is immediate,
    clock.t += 10.0     # later ones back off; jump past any backoff)
    sup.tick()
  # 1 first attempt + 2 budgeted retries, then containment.
  assert queue.get("poison").state == "quarantined"
  assert queue.get("poison").attempts == 3
  assert sup.quarantines_total == 1 and sup.failures_total == 3
  assert [s[2] for s in launcher.spawned] == [False, True, True]  # resumes
  assert events.count("training_job_quarantined") == 1
  # Containment, not collapse: a sibling submitted later still drains.
  queue.submit({}, job_id="good")
  sup.tick()
  launcher.handles[("good", 0)].rc = 0
  sup.tick()
  assert queue.get("good").state == "done"


def test_backoff_between_repeat_failures(tmp_path):
  clock, queue, launcher, sup, _ = _sup(tmp_path, restart_budget=3,
                                        backoff_base_s=1.0)
  queue.submit({}, job_id="flappy")
  sup.tick()
  launcher.handles[("flappy", 0)].rc = 1
  sup.tick()  # failure 1: immediate retry (streak 1 -> backoff(0)=0)
  assert ("flappy", 1, True) in launcher.spawned
  launcher.handles[("flappy", 1)].rc = 1
  sup.tick()  # failure 2: 1s backoff — not runnable yet
  assert queue.get("flappy").state == "queued"
  sup.tick()
  assert len(launcher.spawned) == 2  # still cooling
  clock.t += 1.1
  sup.tick()
  assert launcher.spawned[-1] == ("flappy", 2, True)


def test_wedged_trainer_is_sigkilled_and_requeued(tmp_path):
  clock, queue, launcher, sup, events = _sup(tmp_path, wedge_after=2)
  queue.submit({}, job_id="stuck")
  sup.tick()
  handle = launcher.handles[("stuck", 0)]
  handle.health = {"status": "ok", "steps": 4, "last_step_ms": 25.0}
  sup.tick()  # progress observed: stall counter resets
  sup.tick()  # stall 1
  sup.tick()  # stall 2 -> wedged: SIGKILL + requeue (+ immediate respawn)
  assert handle.kills == [signal.SIGKILL]
  assert sup.wedges_total == 1 and sup.failures_total == 1
  assert events.count("training_job_wedged") == 1
  assert launcher.spawned[-1] == ("stuck", 1, True)


def test_startup_grace_tolerates_slow_first_compile(tmp_path):
  clock, queue, launcher, sup, _ = _sup(tmp_path, wedge_after=2,
                                        startup_grace_s=30.0)
  queue.submit({}, job_id="cold")
  sup.tick()
  handle = launcher.handles[("cold", 0)]
  handle.health = {"status": "garbage"}  # listener not answering yet
  for _ in range(10):  # way past wedge_after, inside the grace window
    clock.t += 1.0
    sup.tick()
  assert sup.wedges_total == 0 and handle.kills == []
  clock.t += 30.0  # grace expired, still no health: now it counts
  sup.tick()
  sup.tick()
  assert sup.wedges_total == 1


def test_preempt_requeues_without_spending_budget(tmp_path):
  clock, queue, launcher, sup, events = _sup(tmp_path, restart_budget=1)
  queue.submit({}, job_id="a")
  sup.tick()
  handle = launcher.handles[("a", 0)]
  handle.term_exits_clean = True  # the CLI's preempt save + clean exit
  assert sup.preempt(drain_timeout_s=1.0) == ["a"]
  record = queue.get("a").record
  assert record["state"] == "queued"
  assert record["history"][-1]["counted"] is False  # no budget spent
  assert sup.preemptions_total == 1 and sup.failures_total == 0
  assert events.count("training_job_preempt") == 1
  # The next tick resumes it and it completes.
  sup.tick()
  assert launcher.spawned[-1] == ("a", 1, True)
  launcher.handles[("a", 1)].rc = 0
  sup.tick()
  assert queue.get("a").state == "done"


def test_completed_job_publishes_into_the_watch_store(tmp_path):
  clock, queue, launcher, sup, events = _sup(tmp_path)
  publish = FakePublish()
  sup.publish_store = publish
  queue.submit({}, job_id="a")
  sup.tick()
  launcher.handles[("a", 0)].rc = 0
  sup.tick()
  assert publish.calls == [("<fake>", {"job": "a"})]
  assert queue.get("a").record["result"]["published_step"] == 0
  assert sup.publishes_total == 1
  assert events.count("training_job_published") == 1


def test_bad_spec_fails_terminally_without_stalling_the_queue(tmp_path):
  clock, queue, launcher, sup, _ = _sup(tmp_path)
  queue.submit({}, job_id="bad")
  queue.submit({}, job_id="good")
  launcher.reject.add("bad")
  sup.tick()
  assert queue.get("bad").state == "failed"
  assert sup.spec_rejects_total == 1
  launcher.handles[("good", 0)].rc = 0
  sup.tick()
  assert queue.get("good").state == "done" and queue.drained()


def test_slo_scores_attempts_and_step_latency(tmp_path):
  from mpi_vision_tpu_torch.obs.slo import SloConfig, SloTracker

  clock, queue, launcher, sup, _ = _sup(tmp_path, restart_budget=1)
  slo = SloTracker(SloConfig(latency_threshold_s=0.1), clock=clock)
  sup.slo = slo
  queue.submit({}, job_id="a")
  sup.tick()
  handle = launcher.handles[("a", 0)]
  sup.tick()  # first healthy probe: liveness baseline, no latency sample
  handle.health = {"status": "ok", "steps": 1, "last_step_ms": 250.0}
  sup.tick()  # a real step delta, 250ms > 100ms threshold: latency-bad
  handle.rc = 0
  sup.tick()  # attempt succeeded: availability-good
  snap = slo.snapshot()
  assert snap["objectives"]["latency"]["slow"]["bad"] == 1
  # Step samples score ONLY latency: availability is attempt outcomes
  # alone (one completed attempt == one good event), so a healthy job's
  # steady step stream cannot dilute a sibling's crash-loop out of the
  # availability burn rate.
  assert snap["objectives"]["availability"]["slow"]["requests"] == 1
  assert snap["objectives"]["availability"]["slow"]["bad"] == 0
  assert snap["objectives"]["latency"]["slow"]["requests"] == 1
  # The scrape surface joins the queue + SLO families (Registry.extend).
  text = sup.metrics_text()
  assert "mpi_train_queue_spawns_total" in text
  assert "mpi_slo_attainment" in text


def test_readmitted_job_gets_a_fresh_restart_budget(tmp_path):
  clock, queue, launcher, sup, _ = _sup(tmp_path, restart_budget=1)
  queue.submit({}, job_id="p")
  sup.tick()
  for attempt in (0, 1):
    launcher.handles[("p", attempt)].rc = 1
    sup.tick()
    clock.t += 10.0
    sup.tick()
  assert queue.get("p").state == "quarantined"
  assert queue.get("p").attempts == 2  # 1 + budget
  queue.readmit("p")
  # The operator override promises a FRESH budget: the next failure must
  # retry, not instantly re-quarantine off the exhausted old one.
  sup.tick()
  launcher.handles[("p", 2)].rc = 1
  sup.tick()
  # Fresh budget: the failure RETRIED (the first retry is immediate, so
  # the same tick respawned it as attempt 3) instead of re-quarantining.
  assert launcher.spawned[-1] == ("p", 3, True)
  assert queue.get("p").state == "running"
  launcher.handles[("p", 3)].rc = 1
  sup.tick()
  assert queue.get("p").state == "quarantined"  # fresh budget exhausted
  assert sup.quarantines_total == 2


def test_supervisor_guards():
  with pytest.raises(ValueError, match="concurrency"):
    TrainSupervisor(object(), launcher=lambda *a: None, concurrency=0)
  with pytest.raises(ValueError, match="restart_budget"):
    TrainSupervisor(object(), launcher=lambda *a: None, restart_budget=0)
  with pytest.raises(ValueError, match="wedge_after"):
    TrainSupervisor(object(), launcher=lambda *a: None, wedge_after=0)
  with pytest.raises(ValueError, match="launcher or a work_root"):
    TrainSupervisor(object())


def test_queue_registry_families(tmp_path):
  clock, queue, launcher, sup, _ = _sup(tmp_path)
  queue.submit({}, job_id="a")
  sup.tick()
  text = sup.metrics_text()
  assert 'mpi_train_queue_jobs{state="running"} 1' in text
  assert "mpi_train_queue_spawns_total 1" in text
  assert "mpi_train_queue_quarantines_total 0" in text


def test_queue_metrics_server_scrape_surface(tmp_path):
  """The ``train-queue --metrics-port`` listener: /metrics renders the
  mpi_train_queue_* registry the supervisor already builds, /stats the
  snapshot, /healthz the drain/quarantine headline — over real HTTP."""
  import json as json_mod
  import threading
  import urllib.request

  from mpi_vision_tpu_torch.train.supervisor import make_queue_metrics_server

  clock, queue, launcher, sup, events = _sup(tmp_path)
  queue.submit({}, job_id="a")
  sup.tick()
  server = make_queue_metrics_server(sup, events=events)
  threading.Thread(target=server.serve_forever, daemon=True).start()
  base = f"http://127.0.0.1:{server.server_address[1]}"
  try:
    with urllib.request.urlopen(base + "/metrics", timeout=5) as resp:
      text = resp.read().decode()
    assert "mpi_train_queue_spawns_total 1" in text
    with urllib.request.urlopen(base + "/stats", timeout=5) as resp:
      stats = json_mod.loads(resp.read())
    assert stats["spawns"] == 1 and "queue" in stats
    with urllib.request.urlopen(base + "/healthz", timeout=5) as resp:
      health = json_mod.loads(resp.read())
    assert health["status"] == "ok" and health["role"] == "train-queue"
    assert health["running"] == 1 and health["drained"] is False
    with urllib.request.urlopen(base + "/debug/events?recent=8",
                                timeout=5) as resp:
      ev = json_mod.loads(resp.read())
    assert ev["emitted"] >= 1
  finally:
    server.shutdown()
    server.server_close()


# --- the subprocess launcher's argv (no spawn) ----------------------------


def test_launcher_argv_isolation_and_faults(tmp_path):
  launcher = SubprocessLauncher(str(tmp_path))
  queue = JobQueue(str(tmp_path / "q"), clock=FakeClock())
  queue.submit({"epochs": 2, "img_size": 32, "num_planes": 4, "seed": 7,
                "faults": ["crash@step=1,hard,attempt=0"]}, job_id="j1")
  job = queue.get("j1")
  argv0 = launcher.argv(job, attempt=0, resume=False)
  assert "--ckpt" in argv0 and str(tmp_path / "j1" / "ckpt") in argv0
  assert "--resume" not in argv0
  assert "--inject-fault" in argv0  # attempt 0 carries its gated fault
  assert "--no-vgg-loss" in argv0 and "--no-valid" in argv0
  assert argv0[1:5] == ["-m", "mpi_vision_tpu_torch", "train", "--device"]
  assert argv0[5] == "cuda"  # the card unless the caller asks for the CPU
  assert SubprocessLauncher(str(tmp_path), device="cpu").argv(
      job, 0, False)[5] == "cpu"
  with pytest.raises(ValueError, match="device"):
    SubprocessLauncher(str(tmp_path), device="tpu")
  argv1 = launcher.argv(job, attempt=1, resume=True)
  assert "--resume" in argv1
  assert "--inject-fault" not in argv1  # the gate filtered it out
  queue.submit({"epochs": "two"}, job_id="j2")
  with pytest.raises(JobSpecError, match="epochs"):
    launcher.argv(queue.get("j2"), 0, False)


# --- review-round pins ----------------------------------------------------


def test_orphaned_claim_ages_out_and_job_stays_leasable(tmp_path):
  """A claimer killed between creating its claim file and leasing must
  not make the job permanently unleasable: the claim ages out after
  lease_s (requeued-never-lost applies to the claim protocol too)."""
  clock = FakeClock()
  q = JobQueue(str(tmp_path), lease_s=10.0, clock=clock)
  q.submit({}, job_id="a")
  # Forge a crashed peer's orphan claim.
  with open(q._claim_path("a"), "w") as fh:
    json.dump({"owner": "dead", "ts_unix_s": clock()}, fh)
  assert q.lease("w") is None  # fresh claim: a live peer, back off
  clock.t += 10.1
  job = q.lease("w")  # stale claim removed, job claimed normally
  assert job is not None and job.id == "a"


def test_completion_after_lease_reaped_is_skipped_not_crashed(tmp_path):
  """A tick that outlived lease_s may find its finished job already
  reaped: completion (and publish) must be skipped for the new owner,
  never crash the tick or double-publish."""
  clock = FakeClock()
  events = EventLog(clock=clock)
  queue = JobQueue(str(tmp_path), lease_s=5.0, clock=clock, events=events)
  launcher = FakeLauncher()
  sup = TrainSupervisor(queue, launcher=launcher,
                        transport=FakeTransport(launcher), events=events,
                        clock=clock, sleep=clock.sleep)
  publish = FakePublish()
  sup.publish_store = publish
  queue.submit({}, job_id="a")
  sup.tick()
  clock.t += 6.0  # the supervisor stalled past lease_s
  launcher.handles[("a", 0)].rc = 0
  sup.tick()  # reap_expired requeues "a" first, then the exit lands
  # The reaper's requeue stands: the stale attempt neither completed
  # the job nor published its checkpoint (the same tick may have
  # legitimately re-leased it as a fresh attempt — that is recovery,
  # not completion).
  assert queue.get("a").state != "done"
  assert publish.calls == []               # no publish for a lost lease
  assert sup.completes_total == 0 and sup.tick_errors == 0


def test_run_until_drained_is_interruptible(tmp_path):
  clock, queue, launcher, sup, _ = _sup(tmp_path)
  queue.submit({}, job_id="never-finishes")
  stops = iter([False, True])
  assert sup.run_until_drained(timeout_s=100.0,
                               should_stop=lambda: next(stops)) is False


def test_stale_claim_takeover_is_single_winner(tmp_path, monkeypatch):
  """Two workers judging the same orphan claim stale must not both win
  it: the takeover is an atomic rename, so the loser backs off instead
  of unlinking the winner's fresh claim (double-lease guard)."""
  clock = FakeClock()
  q = JobQueue(str(tmp_path), lease_s=10.0, clock=clock)
  q.submit({}, job_id="a")
  with open(q._claim_path("a"), "w") as fh:
    json.dump({"owner": "dead", "ts_unix_s": clock()}, fh)
  clock.t += 10.1
  # Simulate the loser: the orphan vanished under us (peer renamed it).
  import mpi_vision_tpu_torch.train.queue as qmod
  def rename_lost(src, dst):
    raise OSError("vanished: a peer won the takeover")
  monkeypatch.setattr(qmod.os, "rename", rename_lost)
  assert q.lease("slow-worker") is None  # backs off, no double lease
  monkeypatch.undo()
  assert q.lease("fast-worker").id == "a"  # recovery still works


def test_stale_takeover_restores_a_freshly_relinked_claim(tmp_path,
                                                          monkeypatch):
  """The takeover rename must verify what it moved: a peer may complete
  its own takeover and link a FRESH claim between our staleness read and
  the rename — stealing that claim would double-lease the job."""
  import os

  clock = FakeClock()
  q = JobQueue(str(tmp_path), lease_s=10.0, clock=clock)
  q.submit({}, job_id="a")
  with open(q._claim_path("a"), "w") as fh:
    json.dump({"owner": "dead", "ts_unix_s": clock()}, fh)
  clock.t += 10.1
  import mpi_vision_tpu_torch.train.queue as qmod
  real_rename = qmod.os.rename
  raced = {"done": False}
  def racing_rename(src, dst):
    if src == q._claim_path("a") and not raced["done"]:
      raced["done"] = True
      # The peer finished its takeover and linked a FRESH claim here.
      with open(src, "w") as fh:
        json.dump({"owner": "peer", "ts_unix_s": clock()}, fh)
    real_rename(src, dst)
  monkeypatch.setattr(qmod.os, "rename", racing_rename)
  assert q.lease("slow") is None  # backed off, nothing stolen
  # The peer's fresh claim is back in place, still guarding the job.
  with open(q._claim_path("a")) as fh:
    assert json.load(fh)["owner"] == "peer"


def test_sweep_spares_a_live_peers_inflight_write(tmp_path):
  clock = FakeClock()
  q = JobQueue(str(tmp_path), clock=clock)
  import os
  live = str(tmp_path / f".tmp-job-x-{os.getpid()+0}-deadbeef")
  # Our own pid counts as dead (fresh construction), so fake a LIVE
  # peer with pid 1 (init: always alive) and a dead one with an
  # implausible pid.
  peer = str(tmp_path / ".tmp-job-y-1-deadbeef")
  dead = str(tmp_path / ".tmp-job-z-999999999-deadbeef")
  for p in (peer, dead):
    open(p, "w").close()
  JobQueue(str(tmp_path), clock=clock)  # construction sweeps
  assert os.path.exists(peer)      # live peer's write untouched
  assert not os.path.exists(dead)  # crashed writer's junk removed
  os.unlink(peer)


def test_mark_running_lease_loss_kills_the_spawn(tmp_path):
  """A spawn slower than lease_s whose job was reaped mid-launch must
  kill the fresh process, not leak it unsupervised."""
  clock, queue, launcher, sup, _ = _sup(tmp_path)
  queue.submit({}, job_id="a")
  real_mark = queue.mark_running
  orphans = []
  def slow_mark(job_id, owner, attempt, detail=None):
    queue.mark_running = real_mark  # only the FIRST spawn is slow
    orphans.append(launcher.handles[(job_id, attempt)])
    clock.t += 120.0           # the spawn outlived lease_s (60)
    queue.reap_expired()       # another worker's reaper took the job
    return real_mark(job_id, owner, attempt, detail=detail)
  queue.mark_running = slow_mark
  sup.tick()
  assert signal.SIGKILL in orphans[0].kills  # the orphan was killed
  # The reaper's requeue stood at the instant of loss; the same tick
  # then re-leased the job as a fresh, properly-owned attempt.
  assert sup.running() == ["a"]
  assert queue.get("a").state == "running"
  fresh = launcher.handles[("a", 0)]
  assert fresh is not orphans[0] and fresh.kills == []


def test_run_until_drained_contains_tick_errors(tmp_path):
  clock, queue, launcher, sup, _ = _sup(tmp_path)
  queue.submit({}, job_id="a")
  boom = {"n": 0}
  real_tick = sup.tick
  def flaky_tick():
    if boom["n"] == 0:
      boom["n"] += 1
      raise OSError("transient NFS sadness")
    real_tick()
  # After the one flaky tick, real ticks run the job to completion.
  def finish_soon():
    real_tick()
    for handle in launcher.handles.values():
      handle.rc = 0
  sup.tick = lambda: (flaky_tick() if boom["n"] == 0 else finish_soon())
  assert sup.run_until_drained(timeout_s=50.0) is True
  assert sup.tick_errors == 1


# --- budget persistence + multi-worker drill -------------------------------


def _worker(tmp_path, owner, clock, **kwargs):
  """One worker's worth of machinery over the SHARED queue directory:
  its own JobQueue instance (the queue is the disk), launcher, and
  transport — only the clock is shared, like real co-located workers."""
  events = EventLog(clock=clock)
  queue = JobQueue(str(tmp_path), lease_s=60.0, clock=clock,
                   events=events)
  launcher = FakeLauncher()
  defaults = dict(restart_budget=2, budget_window_s=600.0,
                  backoff_base_s=1.0, backoff_mult=2.0, backoff_max_s=8.0,
                  wedge_after=3, startup_grace_s=5.0)
  defaults.update(kwargs)
  supervisor = TrainSupervisor(
      queue, launcher=launcher, transport=FakeTransport(launcher),
      events=events, clock=clock, sleep=clock.sleep, owner=owner,
      **defaults)
  return queue, launcher, supervisor


def test_budget_spends_persist_across_supervisor_restarts(tmp_path):
  """THE no-fresh-budget pin: a supervisor restart mid-crash-loop must
  resume the quarantine countdown from the spends persisted on the job
  record, not hand the poison job a whole new budget."""
  clock = FakeClock()
  queue1, launcher1, sup1 = _worker(tmp_path, "w1", clock,
                                    restart_budget=2)
  queue1.submit({}, job_id="loopy")
  sup1.tick()
  for attempt in (0, 1):  # two failures: the whole budget, spent
    launcher1.handles[("loopy", attempt)].rc = 1
    sup1.tick()
    clock.t += 10.0
    sup1.tick()
  # The spend window rode the requeue onto the record as wall times.
  spends = queue1.get("loopy").budget_spend_unix_s
  assert len(spends) == 2 and all(t <= clock() for t in spends)
  # The supervisor dies; its replacement reads the same queue dir.
  queue2, launcher2, sup2 = _worker(tmp_path, "w2", clock,
                                    restart_budget=2)
  # w1's in-flight attempt is still leased to w1 until the lease
  # expires; the replacement reaps it on its first tick.
  clock.t += 60.1
  sup2.tick()  # reap + lease + spawn attempt 3
  assert [s[0] for s in launcher2.spawned] == ["loopy"]
  launcher2.handles[("loopy", queue2.get("loopy").attempts - 1)].rc = 1
  sup2.tick()
  # Adopted budget: 2 in-window spends + this failure = immediate
  # quarantine. A fresh budget would have granted 2 more respawns.
  assert queue2.get("loopy").state == "quarantined"
  assert sup2.quarantines_total == 1
  assert len(launcher2.spawned) == 1  # zero extra respawns granted
  # readmit() clears the persisted window with the quarantine: the
  # operator's fresh-budget promise holds across restarts too.
  queue2.readmit("loopy")
  assert queue2.get("loopy").budget_spend_unix_s == []


def test_preempt_requeue_leaves_persisted_spends_untouched(tmp_path):
  """Preemption is planned downtime: it must neither spend budget NOR
  erase the crash-loop history a previous failure persisted."""
  clock = FakeClock()
  queue, launcher, sup = _worker(tmp_path, "w1", clock, restart_budget=3)
  queue.submit({}, job_id="a")
  sup.tick()
  launcher.handles[("a", 0)].rc = 1  # one real failure: one spend
  sup.tick()
  spends = queue.get("a").budget_spend_unix_s
  assert len(spends) == 1
  clock.t += 2.0
  sup.tick()  # respawn (attempt 1)
  assert sup.running() == ["a"]
  sup.preempt()
  assert queue.get("a").state == "queued"
  # No spend added, none erased: the window is exactly as it was.
  assert queue.get("a").budget_spend_unix_s == spends


def test_two_workers_one_queue_no_double_lease_no_lost_job(tmp_path):
  """The multi-worker drill on fakes: two supervisors drain one shared
  queue directory — every job runs under exactly one owner, a dead
  worker's jobs are reaped and finished by the survivor, and the dead
  worker's zombie attempts are fenced off (killed on lease loss)."""
  clock = FakeClock()
  queue_a, launcher_a, sup_a = _worker(tmp_path, "workerA", clock,
                                       concurrency=2)
  queue_b, launcher_b, sup_b = _worker(tmp_path, "workerB", clock,
                                       concurrency=2)
  for i in range(4):
    queue_a.submit({}, job_id=f"j{i}")
    clock.t += 0.01  # distinct create stamps keep FIFO deterministic
  sup_a.tick()  # A fills its 2 slots first...
  sup_b.tick()  # ...B gets the remaining 2
  ran_a, ran_b = set(sup_a.running()), set(sup_b.running())
  assert ran_a == {"j0", "j1"} and ran_b == {"j2", "j3"}
  assert ran_a.isdisjoint(ran_b)  # no job double-leased, none skipped
  # B's jobs complete; A then DIES (stops ticking, processes linger).
  for job_id in ran_b:
    launcher_b.handles[(job_id, 0)].rc = 0
  sup_b.tick()
  assert queue_b.get("j2").state == "done"
  assert queue_b.get("j3").state == "done"
  # Past A's lease TTL the survivor reaps and re-runs A's jobs — the
  # queue loses nothing to a dead worker.
  clock.t += 60.1
  sup_b.tick()
  assert queue_b.leases_expired == 2
  assert set(sup_b.running()) == {"j0", "j1"}
  assert [s for s in launcher_b.spawned if s[0] in ("j0", "j1")] == [
      ("j0", 1, True), ("j1", 1, True)]  # attempts carried, resumed
  # The dead worker lurching back must NOT fight the survivor: its
  # heartbeats fail (lease lost) and it fences its own zombies.
  sup_a.tick()
  assert sup_a.running() == []
  for job_id in ("j0", "j1"):
    assert signal.SIGKILL in launcher_a.handles[(job_id, 0)].kills
  # The survivor drains the re-run jobs to done: nothing lost, nothing
  # run twice concurrently.
  for job_id in ("j0", "j1"):
    launcher_b.handles[(job_id, 1)].rc = 0
  sup_b.tick()
  assert all(queue_b.get(f"j{i}").state == "done" for i in range(4))
  assert queue_b.drained()
  total_spawns = len(launcher_a.spawned) + len(launcher_b.spawned)
  assert total_spawns == 6  # 4 first attempts + 2 takeover re-runs


# --- the two packages share one on-disk queue -----------------------------


def _script(queue_cls, events_cls, root):
  """One scripted life of a 4-job queue; returns every job's record and
  the event kinds in order."""
  clock = FakeClock()
  events = events_cls(clock=clock)
  q = queue_cls(str(root), lease_s=10.0, clock=clock, events=events)
  for job_id, spec in (("a", {"epochs": 1}), ("b", {"seed": 3}),
                       ("c", {}), ("d", {"faults": ["crash@step=0,hard"]})):
    q.submit(spec, job_id=job_id)
    clock.t += 0.5
  q.lease("w1")
  q.mark_running("a", "w1", 0, detail={"resume": False})
  clock.t += 2.0
  q.heartbeat("a", "w1")
  q.requeue("a", "w1", "exit rc=1", not_before_unix_s=clock() + 1.0,
            budget_spend_unix_s=[clock() - 0.25])
  assert q.lease("w2").id == "b"
  q.mark_running("b", "w2", 0)
  clock.t += 11.0
  assert q.reap_expired() == ["b"]
  assert q.lease("w1").id == "a"
  q.mark_running("a", "w1", 1, detail={"resume": True})
  q.complete("a", "w1", {"attempts": 2, "published_step": 0})
  q.fail("c", "spec rejected")
  job = q.lease("w3")
  q.mark_running(job.id, "w3", job.attempts)
  q.quarantine(job.id, "w3", "crash-loop")
  q.readmit(job.id)
  return ({jid: q.get(jid).record for jid in q.job_ids()},
          [e["kind"] for e in events.snapshot(recent=64)["events"]],
          q.snapshot()["counts"])


def test_the_same_operations_give_equal_records_in_both_packages(tmp_path):
  ours = _script(JobQueue, EventLog, tmp_path / "torch")
  theirs = _script(JJobQueue, JEventLog, tmp_path / "jax")
  assert ours == theirs
  # The files on disk are the same bytes too (sorted keys, indent 1).
  for job_id in ours[0]:
    name = f"job-{job_id}.json"
    assert ((tmp_path / "torch" / name).read_bytes()
            == (tmp_path / "jax" / name).read_bytes())


@pytest.mark.parametrize("writer, drainer", [(JJobQueue, JobQueue),
                                             (JobQueue, JJobQueue)],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_a_queue_one_package_wrote_drains_through_the_other(tmp_path,
                                                            writer, drainer):
  clock = FakeClock()
  w = writer(str(tmp_path), lease_s=10.0, clock=clock)
  w.submit({"epochs": 1}, job_id="x")
  clock.t += 1.0
  w.submit({"epochs": 2}, job_id="y")
  # An orphan claim the writer's package left must age out in the other.
  with open(w._claim_path("y"), "w") as fh:
    json.dump({"owner": "dead", "ts_unix_s": clock()}, fh)
  d = drainer(str(tmp_path), lease_s=10.0, clock=clock)
  job = d.lease("other")
  assert job.id == "x" and d.lease("other2") is None
  d.mark_running("x", "other", job.attempts)
  d.complete("x", "other", {"ok": True})
  clock.t += 10.1
  assert d.lease("other").id == "y"
  d.mark_running("y", "other", 0)
  d.complete("y", "other")
  assert w.drained() and d.drained()
  assert w.get("x").record["result"] == {"ok": True}
  assert [h["event"] for h in w.get("y").record["history"]] == [
      "started", "done"]


# --- CheckpointStore.publish_from -----------------------------------------


def _tree(seed):
  rng = np.random.default_rng(seed)
  return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                     "b": rng.standard_normal(4).astype(np.float32)},
          "step": np.asarray(seed, np.int64)}


def test_publish_from_republishes_a_jax_checkpoint_byte_for_byte(tmp_path):
  src = JCheckpointStore(str(tmp_path / "job"))
  src.save(3, _tree(3), meta={"model": {"img_size": 32}})
  dst = CheckpointStore(str(tmp_path / "watch"), keep=4)
  assert dst.publish_from(str(tmp_path / "job"),
                          meta_extra={"job": "good"}) == (0, 3)
  assert dst.publish_from(str(tmp_path / "job")) == (1, 3)
  assert dst.steps() == [0, 1]
  src_dir = os.path.join(str(tmp_path / "job"), "step_0000000003")
  pub_dir = os.path.join(str(tmp_path / "watch"), "step_0000000000")
  with open(os.path.join(src_dir, "arrays.npz"), "rb") as a, \
       open(os.path.join(pub_dir, "arrays.npz"), "rb") as b:
    assert a.read() == b.read()
  # Both packages restore it with every array hash verified.
  for store in (CheckpointStore(str(tmp_path / "watch")),
                JCheckpointStore(str(tmp_path / "watch"))):
    restored = store.restore(step=0)
    assert restored.step == 0
    assert restored.meta == {"model": {"img_size": 32},
                             "published_from_step": 3, "job": "good"}
    for key, arr in src.restore().arrays.items():
      np.testing.assert_array_equal(restored.arrays[key], arr)


def test_publish_from_rolls_back_past_a_corrupt_newest(tmp_path):
  src = JCheckpointStore(str(tmp_path / "job"))
  src.save(1, _tree(1))
  src.save(2, _tree(2))
  arrays = os.path.join(str(tmp_path / "job"), "step_0000000002",
                        "arrays.npz")
  with open(arrays, "r+b") as fh:
    fh.seek(64)
    fh.write(b"\xff" * 16)
  dst = CheckpointStore(str(tmp_path / "watch"))
  assert dst.publish_from(str(tmp_path / "job")) == (0, 1)
  assert JCheckpointStore(str(tmp_path / "job")).steps() == [1]
  np.testing.assert_array_equal(
      JCheckpointStore(str(tmp_path / "watch")).restore().arrays[
          "['params']['w']"], _tree(1)["params"]["w"])
  with pytest.raises(FileNotFoundError, match="no restorable"):
    dst.publish_from(str(tmp_path / "empty"))


# --- the train-queue CLI --------------------------------------------------


@pytest.mark.parametrize("argv, msg", [
    (["--concurrency", "0"], "--concurrency"),
    (["--probe-s", "0"], "--probe-s"),
    (["--wedge-after", "0"], "--wedge-after"),
    (["--restart-budget", "0"], "--restart-budget"),
    (["--startup-grace-s", "-1"], "--startup-grace-s"),
    (["--metrics-port-file", "p"], "requires --metrics-port"),
    (["--no-slo", "--slo-availability", "0.9"], "SLO tracking"),
    (["--submit", "[1]"], "JSON object"),
], ids=["concurrency", "probe", "wedge", "budget", "grace", "portfile",
        "slo", "submit"])
def test_train_queue_cli_validates_at_the_door(tmp_path, argv, msg):
  args = cli.build_parser().parse_args(
      ["train-queue", "--root", str(tmp_path), *argv])
  with pytest.raises(SystemExit, match=msg):
    cli.cmd_train_queue(args)


def test_train_queue_cli_drains_a_rejected_spec_and_reports(tmp_path):
  # The children train on the card unless the caller asks for the CPU.
  assert cli.build_parser().parse_args(
      ["train-queue", "--root", str(tmp_path)]).device == "cuda"
  summary = cli.cmd_train_queue(cli.build_parser().parse_args([
      "train-queue", "--root", str(tmp_path / "q"), "--device", "cpu",
      "--submit", json.dumps({"id": "bad", "epochs": "two"}), "--drain",
      "--probe-s", "0.05", "--duration", "10"]))
  assert summary["device"] == "cpu" and summary["drained"] is True
  assert summary["jobs"]["failed"] == 1 and summary["spec_rejects"] == 1
  assert summary["spawns"] == 0 and summary["slo"] is not None


# --- the real-subprocess arc (--device cpu children) -----------------------

SPEC = {"epochs": 1, "img_size": 32, "num_planes": 4,
        "synthetic_scenes": 2, "save_every": 1, "seed": 7}
RESTART_BUDGET = 1  # poison: 1 first attempt + 1 retry, then quarantine


def _digest(ckpt_root: str) -> str:
  restored = CheckpointStore(ckpt_root).restore()
  assert restored is not None, f"no checkpoint under {ckpt_root}"
  h = hashlib.sha256()
  for key in sorted(restored.arrays):
    arr = np.asarray(restored.arrays[key], order="C")
    h.update(key.encode())
    h.update(str(arr.dtype).encode())
    h.update(arr.tobytes())
  return h.hexdigest()


@pytest.fixture(scope="module")
def arc(tmp_path_factory):
  """``train-queue --device cpu --drain`` over the arc's three jobs, with a
  ``serve --reload-ckpt-s`` stack in miniature swapping each publish in
  under render traffic."""
  from mpi_vision_tpu_torch.ckpt import CheckpointWatcher
  from mpi_vision_tpu_torch.ckpt.export import scenes_from_checkpoint
  from mpi_vision_tpu_torch.serve import RenderService

  root = tmp_path_factory.mktemp("train_queue_arc")
  publish_root = str(root / "publish")
  specs = [{**SPEC, "id": "good"},
           {**SPEC, "id": "poison", "seed": 3, "img_size": 16,
            "synthetic_scenes": 1, "faults": ["crash@step=0,hard"]},
           {**SPEC, "id": "victim", "faults": ["crash@step=1,hard,attempt=0"]}]
  argv = ["train-queue", "--root", str(root / "queue"), "--device", "cpu",
          "--publish", publish_root, "--concurrency", "3",
          "--probe-s", "0.1", "--wedge-after", "200",
          "--restart-budget", str(RESTART_BUDGET), "--drain",
          "--duration", "120", "--event-log", str(root / "events.jsonl")]
  for spec in specs:
    argv += ["--submit", json.dumps(spec)]
  out: dict = {}

  def drain():
    out["summary"] = cli.cmd_train_queue(cli.build_parser().parse_args(argv))

  with pytest.MonkeyPatch.context() as mp:
    # One thread a child (three train at once), and the repo importable
    # from the children whatever the working directory.
    mp.setenv("OMP_NUM_THREADS", "1")
    mp.setenv("PYTHONPATH", os.pathsep.join(
        [REPO, *filter(None, [os.environ.get("PYTHONPATH")])]))
    drainer = threading.Thread(target=drain)
    drainer.start()
    publish = CheckpointStore(publish_root)
    deadline = time.monotonic() + 120.0
    while publish.latest_step() is None and time.monotonic() < deadline:
      time.sleep(0.05)
    assert publish.latest_step() is not None, "no job published in time"
    first_step = publish.latest_step()

    def bake():
      return scenes_from_checkpoint(publish_root, scenes=1, stable_ids=True,
                                    device="cpu")[0]

    svc = RenderService(device="cpu", max_batch=4, max_wait_ms=0.5,
                        resilience=None)
    scenes = bake()
    for sid, rgba, depths, k in scenes:
      svc.add_scene(sid, rgba, depths, k)
    scene_id = scenes[0][0]
    last_bake: list = []

    def reload_step(step):
      new_scenes = bake()
      svc.swap_scenes({sid: (rgba, depths, k)
                       for sid, rgba, depths, k in new_scenes}, prebake=True)
      last_bake[:] = new_scenes

    watcher = CheckpointWatcher(publish, reload_step, poll_s=0.1,
                                initial_step=first_step).start()
    stop = threading.Event()
    failures: list = []
    completed = [0]

    def hammer():
      i = 0
      pose = np.eye(4, dtype=np.float32)
      while not stop.is_set():
        i += 1
        pose[0, 3] = 0.001 * (i % 7)
        try:
          img = svc.render(scene_id, pose, timeout=60)
          assert img.shape[-1] == 3
        except BaseException as e:  # noqa: BLE001 - any failure is the bug
          failures.append(e)
          return
        completed[0] += 1
        time.sleep(0.02)

    hammerer = threading.Thread(target=hammer, daemon=True)
    hammerer.start()
    drainer.join(150)
    final_deadline = time.monotonic() + 10.0
    while (watcher.seen_step != publish.latest_step()
           and time.monotonic() < final_deadline):
      time.sleep(0.05)
    stop.set()
    hammerer.join(30)
    watcher.stop()
  yield {"root": root, "summary": out.get("summary"),
         "queue": JobQueue(str(root / "queue")), "publish": publish,
         "svc": svc, "watcher": watcher, "failures": failures,
         "completed": completed[0], "scene_id": scene_id,
         "last_bake": last_bake}
  svc.close()


def test_arc_poison_quarantined_at_exactly_its_budget(arc):
  summary, queue = arc["summary"], arc["queue"]
  assert summary is not None and summary["drained"] is True, summary
  assert summary["device"] == "cpu"
  assert queue.get("good").state == "done"
  assert queue.get("victim").state == "done"
  poison = queue.get("poison")
  assert poison.state == "quarantined", poison.record
  assert poison.attempts == 1 + RESTART_BUDGET
  assert summary["quarantines"] == 1 and summary["publishes"] == 2
  # The children trained on the CPU, as asked.
  out = (arc["root"] / "queue" / "work" / "good" / "attempt-0.out")
  assert json.loads(out.read_text().splitlines()[-1])["device"] == "cpu"
  # Every attempt outcome scored the availability objective: good ok,
  # poison bad x2, victim bad then ok.
  assert summary["slo"] is not None


def test_arc_sigkilled_then_requeued_job_is_bit_exact(arc):
  work = arc["root"] / "queue" / "work"
  victim = arc["queue"].get("victim")
  assert victim.attempts == 2
  assert any(h["event"] == "requeued" for h in victim.record["history"])
  assert victim.record["history"][-1]["event"] == "done"
  assert (_digest(str(work / "victim" / "ckpt"))
          == _digest(str(work / "good" / "ckpt")))


def test_arc_publishes_served_live_with_zero_dropped_requests(arc):
  publish = arc["publish"]
  assert len(publish.steps()) == 2, publish.steps()
  assert arc["watcher"].snapshot()["reloads"] >= 1
  assert arc["watcher"].seen_step == publish.latest_step()
  assert not arc["failures"], f"renders failed: {arc['failures'][:3]}"
  assert arc["completed"] > 0
  from mpi_vision_tpu_torch.serve import RenderService

  got = arc["svc"].render(arc["scene_id"], np.eye(4, dtype=np.float32))
  assert arc["last_bake"], "the watcher never delivered a reload bake"
  with RenderService(device="cpu", max_batch=2, max_wait_ms=0.5,
                     resilience=None) as fresh:
    sid, rgba, depths, k = arc["last_bake"][0]
    fresh.add_scene(sid, rgba, depths, k)
    np.testing.assert_array_equal(
        got, fresh.render(sid, np.eye(4, dtype=np.float32)))


def test_two_real_workers_drain_one_queue_without_double_runs(
    tmp_path_factory):
  """The multi-worker smoke over REAL ``train --device cpu`` children:
  two supervisors (distinct owners, separate work roots) drain one
  shared queue directory. The on-disk lease protocol must hand each job
  to exactly one worker — both jobs complete, each spawned exactly once,
  and the two workers' spawn counts sum to the job count."""
  root = tmp_path_factory.mktemp("train_queue_two_workers")
  env = dict(os.environ, OMP_NUM_THREADS="1")
  env["PYTHONPATH"] = os.pathsep.join(
      [REPO, *filter(None, [os.environ.get("PYTHONPATH")])])
  tiny = {"epochs": 1, "img_size": 16, "num_planes": 4,
          "synthetic_scenes": 1, "save_every": 1, "seed": 5}
  queue_dir = str(root / "queue")
  submitter = JobQueue(queue_dir, lease_s=120.0)
  submitter.submit(dict(tiny), job_id="jobA")
  submitter.submit({**tiny, "seed": 6}, job_id="jobB")

  def worker(owner):
    queue = JobQueue(queue_dir, lease_s=120.0)
    return TrainSupervisor(
        queue, launcher=SubprocessLauncher(str(root / owner), env=env,
                                           device="cpu"),
        concurrency=1, probe_s=0.25, wedge_after=200,
        startup_grace_s=120.0, restart_budget=2, budget_window_s=600.0,
        backoff_base_s=0.1, backoff_max_s=0.5, owner=owner)

  sup1, sup2 = worker("worker1"), worker("worker2")
  sup1.start()
  sup2.start()
  try:
    deadline = time.monotonic() + 90.0
    while time.monotonic() < deadline:
      with sup1._lock:
        busy1 = bool(sup1._running)
      with sup2._lock:
        busy2 = bool(sup2._running)
      if not busy1 and not busy2 and submitter.drained():
        break
      time.sleep(0.1)
  finally:
    sup1.stop()
    sup2.stop()
  assert submitter.drained(), submitter.snapshot()
  for job_id in ("jobA", "jobB"):
    job = submitter.get(job_id)
    assert job.state == "done", job.record
    # Exactly one attempt ran it: no double-lease, no lost-and-retried.
    assert job.attempts == 1, job.record
  # Both spawns happened, each under exactly one owner.
  assert sup1.spawns_total + sup2.spawns_total == 2
  assert sup1.failures_total + sup2.failures_total == 0
