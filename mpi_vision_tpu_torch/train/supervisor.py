"""Training-job supervision: spawn, probe, contain, publish.

PyTorch-package counterpart of ``mpi_vision_tpu/train/supervisor.py``: the
same state machine, spawning ``python -m mpi_vision_tpu_torch train``
children on the card (``SubprocessLauncher(device="cuda")``, the default)
or, when asked, the CPU.

The training counterpart of ``serve/cluster/supervisor.py`` — the same
proven state machine, aimed at ``cli train`` subprocesses instead of
serve backends:

  * **isolation** — each job runs as a real ``train --ckpt`` subprocess
    with a private checkpoint/event/metrics directory under
    ``<work_root>/<job_id>/``, so one job's corruption or crash can
    never touch a sibling's artifacts.
  * **detection** — the monitor tick polls the process AND health-probes
    its ``--metrics-port`` ``/healthz``: ``wedge_after`` consecutive
    probes without step-counter progress on a LIVE process declare it
    wedged (hung device, deadlocked input pipeline) and it is SIGKILLed
    and requeued — exactly how the fleet supervisor treats a wedged
    backend. A startup grace period keeps the first kernel build (each
    child compiles the CUDA kernels on its first step) from reading as a
    wedge.
  * **containment** — failed attempts retry with
    ``resilience.RetryPolicy`` exponential backoff, bounded by a per-job
    ``resilience.RestartBudget``: a poison job (crashes every attempt)
    is **quarantined** at exactly its budget — ``training_job_quarantined``
    event + ``mpi_train_queue_quarantines_total`` — and the queue keeps
    draining the healthy jobs.
  * **preemption** — ``preempt()`` SIGTERMs every running job (the train
    CLI's ``PreemptionGuard`` saves a preempt checkpoint and exits
    cleanly) and requeues it WITHOUT spending budget (planned downtime,
    the rolling-restart rule); the next attempt resumes bit-exactly
    through ``fit_resumable``'s data cursor.
  * **ingest** — a completed job's checkpoint is republished
    byte-for-byte (``CheckpointStore.publish_from``) into the serve
    fleet's ``--reload-ckpt-s`` watch store, where the
    ``CheckpointWatcher`` -> ``scenes_from_checkpoint`` ->
    ``swap_scenes`` chain takes it live with zero dropped requests.

Queue SLOs ride the existing ``obs/slo.py`` engine: every attempt
outcome scores the **availability** objective (a crashed/wedged/
quarantined attempt is a bad event) and every observed training step
scores the **latency** objective, so a training fleet burns error budget
and pages exactly like the serving fleet does.

Everything is injectable — launcher, transport, clock, sleep — so the
whole state machine runs on fakes in the CPU tests.
"""

from __future__ import annotations

import functools
import json
import os
import signal
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from mpi_vision_tpu_torch.obs import prom
from mpi_vision_tpu_torch.serve.resilience import RestartBudget, RetryPolicy
from mpi_vision_tpu_torch.train import faultinject as fi
from mpi_vision_tpu_torch.train.queue import LeaseLostError

PREFIX = "mpi_train_queue_"


class JobSpecError(ValueError):
  """A job spec cannot be turned into a train invocation (terminal:
  the job is marked failed, the queue keeps draining)."""


class SubprocessHandle:
  """One live ``cli train`` attempt (what the launcher returns)."""

  def __init__(self, proc, job_dir: str, port_file: str):
    self.proc = proc
    self.job_dir = job_dir
    self.ckpt_dir = os.path.join(job_dir, "ckpt")
    self._port_file = port_file
    self._address: str | None = None

  def poll(self):
    return self.proc.poll()

  def kill(self, sig=signal.SIGKILL) -> None:
    try:
      self.proc.send_signal(sig)
    except (ProcessLookupError, OSError):  # already gone
      pass

  def metrics_address(self) -> str | None:
    """``host:port`` once the child's ``--metrics-port-file`` appears."""
    if self._address is None:
      try:
        with open(self._port_file) as fh:
          self._address = f"127.0.0.1:{int(fh.read().strip())}"
      except (OSError, ValueError):
        return None
    return self._address


class SubprocessLauncher:
  """Spec -> ``python -m mpi_vision_tpu_torch train --device <device>``
  subprocess, isolated under ``<work_root>/<job_id>/`` (ckpt/,
  events.jsonl, metrics.port, per-attempt stdout/stderr). ``device`` is
  "cuda" (the default: a child without a card fails rather than train on
  the CPU) or "cpu".

  Recognized spec keys (all optional unless noted): ``epochs``,
  ``img_size``, ``num_planes``, ``seed``, ``synthetic_scenes``,
  ``dataset`` (a RealEstate10K root; absent = ``--synthetic``),
  ``save_every`` (default 1 — resumability is the point of the queue),
  ``keep``, ``vgg`` / ``valid`` (default False: queue jobs are headless
  fine-tunes), ``extra_args`` (verbatim argv tail), ``faults`` (fault
  spec strings/dicts, see ``train/faultinject.py`` — attempt-gated
  entries are forwarded only to their attempt).
  """

  _INT_KEYS = ("epochs", "img_size", "num_planes", "seed",
               "synthetic_scenes", "save_every", "keep")

  def __init__(self, work_root: str, env: dict | None = None, log=None,
               device: str = "cuda"):
    if device not in ("cuda", "cpu"):
      raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    self.work_root = os.path.abspath(work_root)
    self.env = env
    self.device = device
    self._log = log if log is not None else (lambda _m: None)
    os.makedirs(self.work_root, exist_ok=True)

  def job_dir(self, job_id: str) -> str:
    return os.path.join(self.work_root, job_id)

  def ckpt_dir(self, job_id: str) -> str:
    return os.path.join(self.job_dir(job_id), "ckpt")

  def argv(self, job, attempt: int, resume: bool) -> list[str]:
    spec = job.spec
    vals = {}
    for key in self._INT_KEYS:
      if spec.get(key) is not None:
        try:
          vals[key] = int(spec[key])
        except (TypeError, ValueError):
          raise JobSpecError(f"spec key {key!r} must be an int, "
                             f"got {spec[key]!r}")
    job_dir = self.job_dir(job.id)
    argv = [sys.executable, "-m", "mpi_vision_tpu_torch", "train",
            "--device", self.device,
            "--ckpt", self.ckpt_dir(job.id),
            "--save-every", str(vals.get("save_every", 1)),
            "--metrics-port", "0",
            "--metrics-port-file", os.path.join(job_dir, "metrics.port"),
            "--event-log", os.path.join(job_dir, "events.jsonl")]
    if spec.get("dataset"):
      argv += ["--dataset", str(spec["dataset"])]
    else:
      argv += ["--synthetic"]
      if "synthetic_scenes" in vals:
        argv += ["--synthetic-scenes", str(vals["synthetic_scenes"])]
    for key, flag in (("epochs", "--epochs"), ("img_size", "--img-size"),
                      ("num_planes", "--num-planes"), ("seed", "--seed"),
                      ("keep", "--keep")):
      if key in vals:
        argv += [flag, str(vals[key])]
    if not spec.get("vgg", False):
      argv += ["--no-vgg-loss"]
    if not spec.get("valid", False):
      argv += ["--no-valid"]
    if resume:
      argv += ["--resume"]
    try:
      for fault in fi.applicable(spec.get("faults"), attempt):
        argv += ["--inject-fault", fault]
    except fi.FaultSpecError as e:
      raise JobSpecError(str(e))
    extra = spec.get("extra_args")
    if extra:
      argv += [str(a) for a in extra]
    return argv

  def __call__(self, job, attempt: int, resume: bool) -> SubprocessHandle:
    import subprocess

    argv = self.argv(job, attempt, resume)
    job_dir = self.job_dir(job.id)
    os.makedirs(job_dir, exist_ok=True)
    port_file = os.path.join(job_dir, "metrics.port")
    try:
      os.unlink(port_file)  # a stale port must never be probed
    except OSError:
      pass
    out = open(os.path.join(job_dir, f"attempt-{attempt}.out"), "ab")
    err = open(os.path.join(job_dir, f"attempt-{attempt}.err"), "ab")
    try:
      proc = subprocess.Popen(argv, stdout=out, stderr=err, env=self.env)
    finally:
      out.close()
      err.close()
    self._log(f"train-queue: spawned {job.id} attempt {attempt} "
              f"(pid {proc.pid})")
    return SubprocessHandle(proc, job_dir, port_file)


class _RunningJob:
  """Supervision record for one in-flight attempt."""

  __slots__ = ("job", "attempt", "handle", "started_at", "last_step",
               "last_saves", "stall_probes", "preempting")

  def __init__(self, job, attempt: int, handle, started_at: float):
    self.job = job
    self.attempt = attempt
    self.handle = handle
    self.started_at = started_at
    self.last_step: int | None = None
    self.last_saves: int | None = None
    self.stall_probes = 0
    self.preempting = False


class _JobState:
  """Per-job retry bookkeeping that outlives individual attempts."""

  __slots__ = ("budget", "attempt_streak")

  def __init__(self, budget: RestartBudget):
    self.budget = budget
    self.attempt_streak = 0  # consecutive failures (backoff input)


class TrainSupervisor:
  """Drain a ``JobQueue`` through supervised ``cli train`` subprocesses.

  Args:
    queue: the ``train.queue.JobQueue`` to drain.
    launcher: ``(job, attempt, resume) -> handle`` (default
      ``SubprocessLauncher`` over ``work_root``; tests inject fakes).
    work_root: per-job isolation root for the default launcher.
    publish_store: optional ``ckpt.CheckpointStore`` over the serve
      fleet's ``--reload-ckpt-s`` watch directory — completed jobs'
      checkpoints are republished into it (``publish_from``).
    concurrency: attempts in flight at once.
    probe_s: monitor tick / health-probe cadence.
    probe_timeout_s: per-probe ``/healthz`` budget.
    wedge_after: consecutive no-progress probes declaring a live
      process wedged (SIGKILL + requeue).
    startup_grace_s: window after spawn during which a job that has not
      yet completed a step is not wedge-counted (headroom for the
      child's import, CUDA start-up and first kernel build).
    restart_budget / budget_window_s: per-job crash-loop guard
      (``resilience.RestartBudget``) — the attempt that exceeds it
      quarantines the job instead of requeueing it.
    backoff_base_s / backoff_mult / backoff_max_s: retry backoff between
      repeat failures (``resilience.RetryPolicy``, jitter off).
    slo: optional ``obs.slo.SloTracker`` — attempt outcomes score the
      availability objective, observed step latencies the latency one.
    events: lifecycle event log (shared with the queue's, ideally).
    transport: injectable HTTP transport for probes (tests).
    clock / sleep: injectable time sources.
    log: diagnostics sink.
  """

  def __init__(self, queue, launcher=None, work_root: str | None = None,
               publish_store=None, concurrency: int = 1,
               probe_s: float = 1.0, probe_timeout_s: float = 2.0,
               wedge_after: int = 3, startup_grace_s: float = 60.0,
               restart_budget: int = 3, budget_window_s: float = 300.0,
               backoff_base_s: float = 0.5, backoff_mult: float = 2.0,
               backoff_max_s: float = 15.0, slo=None, events=None,
               transport=None, clock=time.monotonic, sleep=None,
               log=None, owner: str | None = None):
    if concurrency < 1:
      raise ValueError(f"concurrency must be >= 1, got {concurrency}")
    if probe_s <= 0:
      raise ValueError(f"probe_s must be > 0, got {probe_s}")
    if wedge_after < 1:
      raise ValueError(f"wedge_after must be >= 1, got {wedge_after}")
    if startup_grace_s < 0:
      raise ValueError(
          f"startup_grace_s must be >= 0, got {startup_grace_s}")
    # Fail at construction: the monitor loop swallows tick errors by
    # design (the fleet-supervisor rule), so a lazily-raised
    # RestartBudget ValueError would leave supervision silently dead.
    if restart_budget < 1:
      raise ValueError(f"restart_budget must be >= 1, got {restart_budget}")
    if budget_window_s <= 0:
      raise ValueError(f"budget_window_s must be > 0, got {budget_window_s}")
    if launcher is None and work_root is None:
      raise ValueError("need a launcher or a work_root to build one")
    self.queue = queue
    self.launcher = (launcher if launcher is not None
                     else SubprocessLauncher(work_root))
    self.publish_store = publish_store
    self.concurrency = int(concurrency)
    self.probe_s = float(probe_s)
    self.probe_timeout_s = float(probe_timeout_s)
    self.wedge_after = int(wedge_after)
    self.startup_grace_s = float(startup_grace_s)
    self.restart_budget = int(restart_budget)
    self.budget_window_s = float(budget_window_s)
    self._backoff_policy = RetryPolicy(
        max_retries=0, backoff_base_s=float(backoff_base_s),
        backoff_mult=float(backoff_mult),
        backoff_max_s=float(backoff_max_s), jitter=0.0)
    import random

    self._backoff_rng = random.Random(0)  # unused at jitter 0
    self.slo = slo
    self.events = events
    if transport is not None:
      self.transport = transport
    else:
      from mpi_vision_tpu_torch.serve.cluster.router import HttpTransport

      self.transport = HttpTransport()
    self._clock = clock
    self._sleep = sleep if sleep is not None else time.sleep
    self._log = log if log is not None else (lambda _m: None)
    self.owner = owner if owner is not None else f"sup-{os.getpid()}"
    # Two locks, the fleet-supervisor pattern: _op_lock serializes whole
    # ticks / preempts; _lock guards the counters so snapshot() never
    # blocks behind a spawn.
    self._op_lock = threading.Lock()
    self._lock = threading.Lock()
    self._running: dict[str, _RunningJob] = {}
    self._job_states: dict[str, _JobState] = {}
    self._stop = threading.Event()
    self._thread: threading.Thread | None = None
    self.ticks = 0
    self.tick_errors = 0
    self.spawns_total = 0
    self.completes_total = 0
    self.failures_total = 0
    self.wedges_total = 0
    self.requeues_total = 0
    self.quarantines_total = 0
    self.preemptions_total = 0
    self.publishes_total = 0
    self.publish_errors = 0
    self.spec_rejects_total = 0

  # -- helpers --------------------------------------------------------------

  def _emit(self, kind: str, **fields) -> None:
    if self.events is not None:
      self.events.emit(kind, **fields)

  def _job_state(self, job_id: str, job=None) -> _JobState:
    with self._lock:
      st = self._job_states.get(job_id)
      if st is None:
        st = self._job_states[job_id] = _JobState(RestartBudget(
            max_restarts=self.restart_budget,
            window_s=self.budget_window_s, clock=self._clock))
        if job is not None:
          # First sight of the job THIS process: adopt the spend window
          # a previous supervisor persisted on the record, so a restart
          # mid-crash-loop resumes the quarantine countdown instead of
          # handing the job a fresh budget. Spends travel as wall times
          # on the queue's clock and are re-anchored here as ages on
          # ours (the two clock bases never mix).
          spends = job.budget_spend_unix_s
          if spends:
            now = self.queue.now()
            st.budget.seed_ages([max(0.0, now - t) for t in spends])
      return st

  def _record_attempt(self, ok: bool) -> None:
    if self.slo is not None:
      self.slo.record(ok=ok)

  def _backoff_s(self, streak: int) -> float:
    if streak <= 0:
      return 0.0  # the first retry of an episode is immediate
    return self._backoff_policy.backoff_s(streak, self._backoff_rng)

  # -- the monitor tick -----------------------------------------------------

  def tick(self) -> None:
    """One supervision pass: reap stale leases, judge every running
    attempt, start new ones while slots are free. Tests drive this by
    hand with fake clocks; ``start()`` runs it on ``probe_s``."""
    with self._op_lock:
      with self._lock:
        self.ticks += 1
      self.queue.reap_expired()
      for job_id in sorted(self._running):
        self._check_running(job_id, self._running[job_id])
      self._fill_slots()

  def _check_running(self, job_id: str, run: _RunningJob) -> None:
    rc = run.handle.poll()
    if rc is None:
      try:
        self.queue.heartbeat(job_id, self.owner)
      except LeaseLostError:
        # The reaper (or another worker) took the job — ours is now a
        # zombie attempt writing to an abandoned store; kill it.
        run.handle.kill(signal.SIGKILL)
        self._forget(job_id)
        self._log(f"train-queue: lost lease on {job_id}; killed attempt")
        return
      self._probe(job_id, run)
      return
    self._forget(job_id)
    if rc == 0:
      if run.preempting:
        # A SIGTERM'd job exits 0 after its preempt save: planned
        # downtime, back in the queue with no budget spent.
        self._requeue(job_id, run, "preempt", count_attempt=False)
        with self._lock:
          self.preemptions_total += 1
        return
      self._complete(job_id, run)
      return
    if run.preempting:
      # Died before the preempt save could land (or by the follow-up
      # SIGKILL): still planned downtime — the checkpoint cursor from
      # the last periodic save resumes it bit-exactly.
      self._requeue(job_id, run, "preempt", count_attempt=False)
      with self._lock:
        self.preemptions_total += 1
      return
    self._attempt_failed(job_id, run, f"exit rc={rc}")

  def _probe(self, job_id: str, run: _RunningJob) -> None:
    address = run.handle.metrics_address()
    status, steps, saves, step_s = "unreachable", None, None, None
    if address is not None:
      try:
        _, _, body = self.transport.request(
            "GET", f"http://{address}/healthz",
            timeout=self.probe_timeout_s)
        payload = json.loads(body)
        status = str(payload.get("status", "garbage"))
        steps = int(payload.get("steps", 0))
        saves = int(payload.get("saves", 0))
        if payload.get("last_step_ms") is not None:
          step_s = float(payload["last_step_ms"]) / 1e3
      except (ConnectionError, ValueError, TypeError, UnicodeDecodeError):
        status = "unreachable"
    # Progress = the step OR save counter moved: epoch-boundary
    # checkpoint I/O advances no steps but is work, not a hang.
    progressed = (status == "ok" and steps is not None
                  and (run.last_step is None or steps > run.last_step
                       or saves > (run.last_saves or 0)))
    if progressed:
      prev = run.last_step
      run.last_step = steps
      run.last_saves = saves
      run.stall_probes = 0
      if (self.slo is not None and step_s is not None and step_s > 0
          and prev is not None and steps > prev):
        # The step-latency objective: a REAL counter delta scored
        # against the configured threshold, same engine as the serving
        # latency SLO (the first observation is liveness, not a step).
        # availability=False: attempt outcomes are the availability
        # signal — a healthy long job's steady step stream must not
        # dilute a sibling's crash-loop out of the burn rate.
        self.slo.record(ok=True, latency_s=step_s, scene_id=job_id,
                        availability=False)
      return
    # The grace window lasts until the FIRST completed step is visible
    # (a healthy listener answers long before the first kernel build
    # finishes — health alone must not start the wedge clock).
    in_grace = ((run.last_step is None or run.last_step < 1)
                and self._clock() - run.started_at < self.startup_grace_s)
    if in_grace:
      return  # first kernel build / listener startup: not a wedge yet
    run.stall_probes += 1
    if run.stall_probes < self.wedge_after:
      return
    # Alive but the step counter stopped (or health vanished): a wedged
    # trainer holds its lease and produces nothing — treat it like a
    # corpse, exactly as the fleet supervisor does.
    run.handle.kill(signal.SIGKILL)
    self._forget(job_id)
    with self._lock:
      self.wedges_total += 1
    self._emit("training_job_wedged", job=job_id, attempt=run.attempt,
               probes=run.stall_probes, last_step=run.last_step)
    self._log(f"train-queue: {job_id} WEDGED (no step progress over "
              f"{run.stall_probes} probes); killed")
    self._attempt_failed(job_id, run, "wedged", already_emitted=True)

  def _forget(self, job_id: str) -> None:
    with self._lock:
      self._running.pop(job_id, None)

  def _complete(self, job_id: str, run: _RunningJob) -> None:
    try:
      # Still ours? A tick that outlived lease_s (slow publish, many
      # probe timeouts) may have had this job reaped earlier in the
      # SAME tick — publishing a checkpoint for a job another worker
      # now owns would double-publish it.
      self.queue.heartbeat(job_id, self.owner)
    except LeaseLostError:
      self._log(f"train-queue: lost lease on {job_id} before completion; "
                "another worker owns it now")
      return
    result: dict = {"attempts": run.attempt + 1}
    if self.publish_store is not None:
      try:
        published, source = self.publish_store.publish_from(
            run.handle.ckpt_dir, meta_extra={"job": job_id})
        result["published_step"] = published
        with self._lock:
          self.publishes_total += 1
        self._emit("training_job_published", job=job_id,
                   published_step=published, source_step=source)
        self._log(f"train-queue: published {job_id} ckpt step {source} "
                  f"as watch-store step {published}")
      except Exception as e:  # noqa: BLE001 - publish must not lose the job
        # The job's own store still holds the artifact; completion
        # stands, the error is counted for the operator to republish.
        result["publish_error"] = repr(e)
        with self._lock:
          self.publish_errors += 1
        self._log(f"train-queue: publish of {job_id} failed: {e!r}")
    try:
      self.queue.complete(job_id, self.owner, result=result)
    except LeaseLostError:
      # Reaped between the heartbeat above and here (vanishing window):
      # the other worker re-runs it; our publish stands as a bounded,
      # logged duplicate rather than a crashed tick.
      self._log(f"train-queue: lost lease on {job_id} during completion")
      return
    with self._lock:
      self.completes_total += 1
      self._job_states.pop(job_id, None)
    self._record_attempt(ok=True)
    self._log(f"train-queue: {job_id} done "
              f"(attempt {run.attempt}, {result})")

  def _requeue(self, job_id: str, run: _RunningJob, reason: str,
               count_attempt: bool, not_before: float = 0.0,
               budget_spend_unix_s: list[float] | None = None) -> None:
    try:
      self.queue.requeue(job_id, self.owner, reason,
                         not_before_unix_s=not_before,
                         count_attempt=count_attempt,
                         budget_spend_unix_s=budget_spend_unix_s)
    except LeaseLostError:
      self._log(f"train-queue: lost lease on {job_id} during requeue")
      return
    with self._lock:
      self.requeues_total += 1

  def _attempt_failed(self, job_id: str, run: _RunningJob, reason: str,
                      already_emitted: bool = False) -> None:
    with self._lock:
      self.failures_total += 1
    self._record_attempt(ok=False)
    if not already_emitted:
      self._emit("training_job_attempt_failed", job=job_id,
                 attempt=run.attempt, reason=reason)
    st = self._job_state(job_id, run.job)
    st.attempt_streak += 1
    if not st.budget.try_spend():
      budget = st.budget.snapshot()
      try:
        self.queue.quarantine(
            job_id, self.owner,
            f"{reason}: {budget['max_restarts']} retries inside "
            f"{budget['window_s']:g}s exhausted the restart budget")
      except LeaseLostError:
        self._log(f"train-queue: lost lease on {job_id} during quarantine")
        return
      # Counted only after the queue write lands: a lost lease above
      # means the job actually requeued elsewhere, and the metric must
      # not claim a quarantine that never happened. Dropping the retry
      # state here matters for readmit(): an operator override promises
      # a fresh restart budget, not an instant re-quarantine off the
      # exhausted one (and terminal jobs must not leak _job_states).
      with self._lock:
        self.quarantines_total += 1
        self._job_states.pop(job_id, None)
      self._log(f"train-queue: QUARANTINED {job_id} ({reason}); "
                "queue keeps draining")
      return
    backoff = self._backoff_s(st.attempt_streak - 1)
    # Persist the spend window onto the record (as wall times on the
    # queue's clock — spend_ages() is base-free) so a replacement
    # supervisor adopts the countdown instead of resetting it.
    now = self.queue.now()
    self._requeue(job_id, run, reason, count_attempt=True,
                  not_before=now + backoff,
                  budget_spend_unix_s=[now - a
                                       for a in st.budget.spend_ages()])
    self._log(f"train-queue: {job_id} attempt {run.attempt} failed "
              f"({reason}); retry in {backoff:.2f}s")

  def _fill_slots(self) -> None:
    while True:
      with self._lock:
        if len(self._running) >= self.concurrency:
          return
      job = self.queue.lease(self.owner)
      if job is None:
        return
      attempt = job.attempts
      resume = attempt > 0  # a prior attempt may have left a cursor
      try:
        handle = self.launcher(job, attempt, resume)
      except JobSpecError as e:
        # Garbage in must not stall the queue OR burn retries: terminal.
        self.queue.fail(job.id, str(e))
        with self._lock:
          self.spec_rejects_total += 1
        self._record_attempt(ok=False)
        self._log(f"train-queue: {job.id} spec rejected: {e}")
        continue
      try:
        self.queue.mark_running(job.id, self.owner, attempt,
                                detail={"resume": resume})
      except LeaseLostError:
        # A spawn slower than lease_s let the reaper take the job: the
        # fresh process has no owner — kill it rather than leak an
        # unsupervised trainer writing into the work dir.
        handle.kill(signal.SIGKILL)
        self._log(f"train-queue: lost lease on {job.id} during spawn; "
                  "killed the attempt")
        continue
      run = _RunningJob(job, attempt, handle, self._clock())
      with self._lock:
        self._running[job.id] = run
        self.spawns_total += 1
      self._emit("training_job_started", job=job.id, attempt=attempt,
                 resume=resume)

  # -- preemption -----------------------------------------------------------

  def preempt(self, drain_timeout_s: float = 30.0) -> list[str]:
    """SIGTERM every running attempt, wait for its preempt save, and
    requeue it with NO budget spent; returns the requeued job ids.

    The train CLI's ``PreemptionGuard`` turns the SIGTERM into a
    ``"preempt"``-tagged checkpoint at the next step boundary, so the
    requeued job resumes bit-exactly from its cursor. An attempt that
    ignores the drain window is SIGKILLed — its newest periodic save
    still resumes it exactly (that is the store's whole contract).
    """
    with self._op_lock:
      requeued = []
      with self._lock:
        running = dict(self._running)
      for run in running.values():
        run.preempting = True
        run.handle.kill(signal.SIGTERM)
        self._emit("training_job_preempt", job=run.job.id,
                   attempt=run.attempt)
      deadline = self._clock() + drain_timeout_s
      for job_id, run in running.items():
        while run.handle.poll() is None and self._clock() < deadline:
          self._sleep(min(self.probe_s, 0.05))
        if run.handle.poll() is None:
          run.handle.kill(signal.SIGKILL)
          while run.handle.poll() is None:
            self._sleep(0.01)
        self._forget(job_id)
        self._requeue(job_id, run, "preempt", count_attempt=False)
        with self._lock:
          self.preemptions_total += 1
        requeued.append(job_id)
      return requeued

  # -- lifecycle ------------------------------------------------------------

  def start(self) -> "TrainSupervisor":
    if self._thread is not None:
      raise RuntimeError("TrainSupervisor already started")
    self._stop.clear()
    self._thread = threading.Thread(target=self._loop,
                                    name="mpi-train-queue-supervisor",
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
        self._log(f"train-queue: tick failed: {e!r}")
      if self._stop.wait(self.probe_s):
        return

  def stop(self, timeout: float = 30.0, preempt: bool = False) -> None:
    """Stop the monitor; with ``preempt=True`` drain running attempts
    back into the queue first (the SIGTERM shutdown path)."""
    self._stop.set()
    thread = self._thread
    if thread is not None:
      thread.join(timeout)
      self._thread = None
    if preempt:
      self.preempt()

  def run_until_drained(self, timeout_s: float = 600.0,
                        should_stop=None) -> bool:
    """Tick (on the caller's thread) until the queue is drained; the
    ``train-queue --drain`` loop. ``should_stop`` is
    an optional ``() -> bool`` polled each cycle (the CLI wires its
    SIGTERM/SIGINT event here so a draining run stays interruptible)."""
    deadline = self._clock() + timeout_s
    while self._clock() < deadline:
      if should_stop is not None and should_stop():
        return False
      try:
        self.tick()
      except Exception as e:  # noqa: BLE001 - same containment as _loop
        # One environmental blip (NFS read error, permission hiccup)
        # must cost a counted tick error, not abort the whole drain.
        with self._lock:
          self.tick_errors += 1
        self._log(f"train-queue: tick failed: {e!r}")
      with self._lock:
        busy = bool(self._running)
      if not busy and self.queue.drained():
        return True
      self._sleep(self.probe_s)
    return False

  # -- introspection --------------------------------------------------------

  def running(self) -> list[str]:
    with self._lock:
      return sorted(self._running)

  def snapshot(self) -> dict:
    with self._lock:
      running = {
          job_id: {"attempt": run.attempt, "last_step": run.last_step,
                   "stall_probes": run.stall_probes,
                   "preempting": run.preempting}
          for job_id, run in sorted(self._running.items())}
      out = {
          "ticks": self.ticks,
          "tick_errors": self.tick_errors,
          "concurrency": self.concurrency,
          "wedge_after": self.wedge_after,
          "restart_budget": self.restart_budget,
          "budget_window_s": self.budget_window_s,
          "spawns": self.spawns_total,
          "completes": self.completes_total,
          "failures": self.failures_total,
          "wedges": self.wedges_total,
          "requeues": self.requeues_total,
          "quarantines": self.quarantines_total,
          "preemptions": self.preemptions_total,
          "publishes": self.publishes_total,
          "publish_errors": self.publish_errors,
          "spec_rejects": self.spec_rejects_total,
          "running": running,
      }
    out["queue"] = self.queue.snapshot()
    if self.slo is not None:
      out["slo"] = self.slo.snapshot()
    return out

  def registry(self, snapshot: dict | None = None) -> prom.Registry:
    """``mpi_train_queue_*`` + (when SLOs are on) ``mpi_slo_*`` families
    — scrape the training queue exactly like a serve backend."""
    snap = snapshot if snapshot is not None else self.snapshot()
    reg = queue_registry(snap)
    if self.slo is not None:
      reg.extend(self.slo.registry(snap.get("slo")))
    return reg

  def metrics_text(self) -> str:
    return self.registry().render()


def queue_registry(snap: dict) -> prom.Registry:
  """The ``mpi_train_queue_*`` families for one supervisor snapshot."""
  reg = prom.Registry()
  p = PREFIX
  jobs = reg.gauge(p + "jobs", "Jobs in the queue, by state.")
  for state, count in sorted(snap.get("queue", {}).get("counts",
                                                       {}).items()):
    jobs.sample(count, {"state": state})
  reg.gauge(p + "running", "Attempts currently in flight.",
            len(snap.get("running", {})))
  reg.counter(p + "spawns_total", "Training attempts launched.",
              snap.get("spawns", 0))
  reg.counter(p + "completed_total", "Jobs that finished training.",
              snap.get("completes", 0))
  reg.counter(p + "failures_total",
              "Attempts that crashed or were killed as wedged.",
              snap.get("failures", 0))
  reg.counter(p + "wedges_total",
              "Live processes killed for a stalled step counter.",
              snap.get("wedges", 0))
  reg.counter(p + "requeues_total",
              "Jobs returned to the queue (failures + preemptions).",
              snap.get("requeues", 0))
  reg.counter(p + "quarantines_total",
              "Poison jobs quarantined at their restart budget.",
              snap.get("quarantines", 0))
  reg.counter(p + "preemptions_total",
              "Attempts SIGTERM'd and requeued as planned downtime.",
              snap.get("preemptions", 0))
  reg.counter(p + "publishes_total",
              "Completed-job checkpoints republished to the watch store.",
              snap.get("publishes", 0))
  reg.counter(p + "publish_errors_total",
              "Publishes that failed (the job's own store keeps the "
              "artifact).", snap.get("publish_errors", 0))
  reg.counter(p + "spec_rejects_total",
              "Jobs failed terminally for an unbuildable spec.",
              snap.get("spec_rejects", 0))
  reg.counter(p + "lease_expired_total",
              "Leases reaped from dead workers (jobs requeued, not "
              "lost).", snap.get("queue", {}).get("leases_expired", 0))
  return reg


class _QueueMetricsHandler(BaseHTTPRequestHandler):
  """The ``train-queue --metrics-port`` surface: the scrape endpoints a
  serve backend already exposes (``/metrics``, ``/stats``, ``/healthz``,
  and ``/debug/events`` when an event log rides along), minus any
  request path — the supervisor has none."""

  def __init__(self, supervisor: "TrainSupervisor", events, *args,
               **kwargs):
    self.supervisor = supervisor
    self.events = events
    super().__init__(*args, **kwargs)

  def log_message(self, fmt, *args):  # noqa: A003 - stdlib signature
    pass

  def _send(self, body: bytes, status: int = 200,
            content_type: str = "application/json") -> None:
    try:
      self.send_response(status)
      self.send_header("Content-Type", content_type)
      self.send_header("Content-Length", str(len(body)))
      self.end_headers()
      self.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError):
      self.close_connection = True

  def do_GET(self):  # noqa: N802 - stdlib name
    parsed = urllib.parse.urlsplit(self.path)
    path = parsed.path
    if path == "/metrics":
      self._send(self.supervisor.metrics_text().encode(),
                 content_type="text/plain; version=0.0.4; charset=utf-8")
    elif path == "/stats":
      self._send(json.dumps(self.supervisor.snapshot()).encode())
    elif path == "/healthz":
      snap = self.supervisor.snapshot()
      self._send(json.dumps({
          "status": "ok", "role": "train-queue",
          "jobs": snap["queue"]["counts"],
          "running": len(snap["running"]),
          "quarantines": snap["quarantines"],
          "drained": self.supervisor.queue.drained()}).encode())
    elif path == "/debug/events" and self.events is not None:
      query = urllib.parse.parse_qs(parsed.query)
      kind = query.get("kind", [None])[0]
      try:
        recent = int(query.get("recent", ["128"])[0])
      except ValueError:
        self._send(json.dumps(
            {"error": "recent must be an integer"}).encode(), status=400)
        return
      self._send(json.dumps(
          self.events.snapshot(recent=recent, kind=kind)).encode())
    else:
      self._send(json.dumps({"error": f"unknown path {self.path}"}).encode(),
                 status=404)


def make_queue_metrics_server(supervisor: "TrainSupervisor", events=None,
                              host: str = "127.0.0.1",
                              port: int = 0) -> "ThreadingHTTPServer":
  """A ready-to-``serve_forever`` threaded listener exporting the
  supervisor's ``mpi_train_queue_*`` registry over ``/metrics`` +
  ``/stats`` + ``/healthz`` (+ ``/debug/events`` with an event log).
  Port 0 = ephemeral; the bound port is ``server.server_address[1]``."""
  handler = functools.partial(_QueueMetricsHandler, supervisor, events)
  server = ThreadingHTTPServer((host, port), handler)
  server.daemon_threads = True
  return server
