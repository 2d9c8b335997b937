"""Durable on-disk training job queue: crash-safe multi-job ingest.

PyTorch-package copy of ``mpi_vision_tpu/train/queue.py`` (host-only; the
two differ in this docstring). The records and the ``O_EXCL``
claim files have the same format, so either package drains a queue the
other wrote.

The training half of the fleet's robustness story (the serving half is
``serve/cluster/supervisor.py``): a directory of atomic JSON job specs
that survives any process death at any instant. Each job is ONE file
``<root>/job-<id>.json`` written via the repo-wide tmp -> fsync ->
rename pattern (``ckpt/store.py``), so a reader never sees a torn spec
and a killed writer leaves either the old record or the new one — never
neither.

States::

    queued -> leased -> running -> done
                   \\-> queued      (attempt failed / preempted: requeue)
                   \\-> quarantined (restart budget exhausted: poison job)
    queued -> failed                (spec rejected before any attempt)

Liveness is lease + heartbeat, not process identity: ``lease()`` claims
the oldest runnable job for an ``owner`` token and stamps a heartbeat;
the worker must keep ``heartbeat()``-ing while it babysits the job.
``reap_expired()`` requeues any leased/running job whose heartbeat is
older than ``lease_s`` — a SIGKILLed worker's jobs are *requeued, never
lost*, and the next worker resumes them bit-exactly through the
checkpoint cursor (``fit_resumable``). Claims are raced safely across
processes through an ``O_EXCL`` claim file per job, so two workers
polling one queue directory cannot double-lease.

Timestamps are wall clock through an injectable ``clock``: queue records
are cross-process artifacts and must be orderable next to the event log and
checkpoint manifests.
"""

from __future__ import annotations

import errno
import json
import os
import re
import time
import uuid
from typing import Callable

STATES = ("queued", "leased", "running", "done", "failed", "quarantined")
# States a worker may claim from / states holding a live lease.
RUNNABLE = ("queued",)
LEASED_STATES = ("leased", "running")

_ID_RE = re.compile(r"^[a-zA-Z0-9._-]{1,64}$")
_JOB_RE = re.compile(r"^job-([a-zA-Z0-9._-]{1,64})\.json$")


def _pid_alive(pid: int) -> bool:
  try:
    os.kill(pid, 0)
  except ProcessLookupError:
    return False
  except PermissionError:  # pragma: no cover - alive, other user
    return True
  return True


class JobQueueError(RuntimeError):
  """A queue operation was illegal (bad state transition, lost lease)."""


class LeaseLostError(JobQueueError):
  """The caller no longer owns the job it tried to act on (its lease
  expired and another worker — or the reaper — took over)."""


class Job:
  """One job record (a plain dict on disk; this wrapper adds accessors)."""

  __slots__ = ("record",)

  def __init__(self, record: dict):
    self.record = record

  @property
  def id(self) -> str:
    return self.record["id"]

  @property
  def state(self) -> str:
    return self.record["state"]

  @property
  def spec(self) -> dict:
    return self.record["spec"]

  @property
  def attempts(self) -> int:
    return int(self.record["attempts"])

  @property
  def lease(self) -> dict | None:
    return self.record.get("lease")

  @property
  def not_before_unix_s(self) -> float:
    """Earliest wall time this job may be leased again (retry backoff)."""
    return float(self.record.get("not_before_unix_s", 0.0))

  @property
  def budget_spend_unix_s(self) -> list[float]:
    """Wall times of the restart-budget spends still in this job's
    crash-loop window (persisted at requeue so a supervisor restart
    cannot hand a crash-looper a fresh budget)."""
    return [float(t) for t in self.record.get("budget_spend_unix_s", [])]

  def __repr__(self) -> str:  # pragma: no cover - debugging sugar
    return f"Job({self.id!r}, {self.state!r}, attempts={self.attempts})"


class JobQueue:
  """Crash-safe multi-job queue over one directory.

  Args:
    root: queue directory (created on first use).
    lease_s: heartbeat staleness after which a leased/running job is
      considered abandoned and ``reap_expired()`` requeues it.
    clock: wall-clock source for every timestamp (injectable).
    events: optional ``obs.events.EventLog`` — job lifecycle transitions
      are exactly what an ingest incident review greps for.
  """

  def __init__(self, root: str, lease_s: float = 60.0,
               clock: Callable[[], float] = time.time, events=None):
    if lease_s <= 0:
      raise ValueError(f"lease_s must be > 0, got {lease_s}")
    self.root = os.path.abspath(root)
    self.lease_s = float(lease_s)
    self._clock = clock
    self.events = events
    self.requeues = 0
    self.leases_expired = 0
    os.makedirs(self.root, exist_ok=True)
    self._sweep_stale()

  def now(self) -> float:
    """The queue's wall clock (retry ``not_before`` floors must be on
    the same base as the heartbeats)."""
    return self._clock()

  # -- paths & atomic IO ----------------------------------------------------

  def _job_path(self, job_id: str) -> str:
    return os.path.join(self.root, f"job-{job_id}.json")

  def _claim_path(self, job_id: str) -> str:
    return os.path.join(self.root, f".claim-{job_id}")

  def _sweep_stale(self) -> None:
    """Drop half-written staging files left by a KILLED writer (the
    published job files themselves are always whole — rename is
    atomic). The queue root is shared by every worker, and tmp names
    embed their writer's pid: a live peer's in-flight write is not ours
    to delete (unlinking it would fail the peer's os.replace)."""
    for name in os.listdir(self.root):
      if not name.startswith(".tmp-job-"):
        continue
      m = re.match(r"^\.tmp-job-.*-(\d+)-[0-9a-f]+$", name)
      if m is not None:
        pid = int(m.group(1))
        if pid != os.getpid() and _pid_alive(pid):
          continue  # a live peer's in-flight write
      try:
        os.unlink(os.path.join(self.root, name))
      except OSError:  # pragma: no cover - concurrent sweep
        pass

  def _write(self, record: dict) -> None:
    """Atomically publish one job record (tmp + fsync + rename)."""
    path = self._job_path(record["id"])
    tmp = os.path.join(
        self.root, f".tmp-job-{record['id']}-{os.getpid()}-{uuid.uuid4().hex[:8]}")
    record["updated_unix_s"] = round(self._clock(), 6)
    with open(tmp, "w") as fh:
      json.dump(record, fh, indent=1, sort_keys=True)
      fh.flush()
      os.fsync(fh.fileno())
    os.replace(tmp, path)

  def _read(self, job_id: str) -> dict | None:
    try:
      with open(self._job_path(job_id)) as fh:
        return json.load(fh)
    except FileNotFoundError:
      return None
    except (OSError, ValueError) as e:
      # A published record is never torn (atomic rename); anything
      # unreadable here is environmental — surface it, don't guess.
      raise JobQueueError(f"job {job_id!r} record unreadable: {e!r}")

  def _emit(self, kind: str, **fields) -> None:
    if self.events is not None:
      self.events.emit(kind, **fields)

  # -- submission -----------------------------------------------------------

  def submit(self, spec: dict, job_id: str | None = None) -> str:
    """Enqueue one job; returns its id.

    ``spec`` is the opaque training payload (the supervisor's launcher
    interprets it); it must be JSON-serializable. Ids are caller-chosen
    (stable re-submission) or generated.
    """
    if not isinstance(spec, dict):
      raise ValueError(f"spec must be a dict, got {type(spec).__name__}")
    job_id = job_id if job_id is not None else uuid.uuid4().hex[:12]
    if not isinstance(job_id, str) or not _ID_RE.match(job_id):
      raise ValueError(f"job id {job_id!r} must be a string matching "
                      f"{_ID_RE.pattern}")
    if os.path.exists(self._job_path(job_id)):
      raise JobQueueError(f"job {job_id!r} already exists")
    record = {
        "id": job_id,
        "state": "queued",
        "spec": dict(spec),
        "attempts": 0,
        "requeues": 0,
        "created_unix_s": round(self._clock(), 6),
        "not_before_unix_s": 0.0,
        "history": [],
    }
    self._write(record)
    self._emit("training_job_submitted", job=job_id)
    return job_id

  # -- worker side ----------------------------------------------------------

  def _try_claim(self, job_id: str, owner: str, now: float) -> bool:
    """Atomically create the job's claim file (write-then-link so the
    claim is never visible without its timestamp). A claim older than
    ``lease_s`` is a crashed claimer's orphan — without recovery it
    would make the job permanently unleasable, the exact loss this
    queue exists to prevent — so it is removed and the claim retried
    once."""
    claim = self._claim_path(job_id)
    tmp = f"{claim}.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as fh:
      json.dump({"owner": str(owner), "ts_unix_s": round(now, 6)}, fh)
    try:
      for attempt in range(2):
        try:
          os.link(tmp, claim)
          return True
        except OSError as e:
          if e.errno != errno.EEXIST:
            raise
          if attempt or not self._claim_stale(claim, now):
            return False  # a live peer is mid-claim on this job
          # Take the orphan over by ATOMIC rename (an unlink here could
          # delete a peer's freshly linked claim and double-lease the
          # job), then VERIFY what we actually moved: a racing peer may
          # have completed its own takeover and linked a FRESH claim at
          # this path between our staleness read and the rename.
          stale_tmp = f"{tmp}.stale"
          try:
            os.rename(claim, stale_tmp)
          except OSError:
            return False  # a peer won the takeover race
          if not self._claim_stale(stale_tmp, now):
            # We grabbed a live peer's fresh claim — put it back and
            # back off. (If the peer already finished leasing, its own
            # claim unlink became a no-op when we renamed it away, so
            # the restore recreates a short-lived orphan that ages out
            # after lease_s; an idle beat, never a double lease.)
            try:
              os.rename(stale_tmp, claim)
            except OSError:  # pragma: no cover - concurrent cleanup
              pass
            return False
          try:
            os.unlink(stale_tmp)
          except OSError:  # pragma: no cover - concurrent cleanup
            pass
      return False
    finally:
      try:
        os.unlink(tmp)
      except OSError:  # pragma: no cover - concurrent cleanup
        pass

  def _claim_stale(self, claim: str, now: float) -> bool:
    try:
      with open(claim) as fh:
        ts = float(json.load(fh).get("ts_unix_s", 0.0))
    except (OSError, ValueError, TypeError):
      return False  # vanished (peer finished) or unreadable: assume live
    return now - ts > self.lease_s

  def lease(self, owner: str) -> Job | None:
    """Claim the oldest runnable job for ``owner`` (None when idle).

    Runnable = ``queued`` with its retry backoff (``not_before``)
    elapsed. The claim itself is an atomic link of a timestamped file,
    so two workers polling one directory cannot double-lease; the loser
    simply moves to the next candidate, and a crashed claimer's orphan
    ages out after ``lease_s``.
    """
    now = self._clock()
    candidates = sorted(
        (rec["created_unix_s"], rec["id"], rec)
        for rec in (self._read(jid) for jid in self.job_ids())
        if rec is not None and rec["state"] in RUNNABLE
        and float(rec.get("not_before_unix_s", 0.0)) <= now)
    for _, job_id, record in candidates:
      claim = self._claim_path(job_id)
      if not self._try_claim(job_id, owner, now):
        continue
      try:
        # Re-read under the claim: the snapshot above may be stale.
        fresh = self._read(job_id)
        if (fresh is None or fresh["state"] not in RUNNABLE
            or float(fresh.get("not_before_unix_s", 0.0)) > now):
          continue
        fresh["state"] = "leased"
        fresh["lease"] = {"owner": str(owner),
                          "heartbeat_unix_s": round(now, 6)}
        self._write(fresh)
        self._emit("training_job_leased", job=job_id, owner=str(owner))
        return Job(fresh)
      finally:
        # The lease now lives in the job record itself; the claim file
        # only guarded the transition.
        try:
          os.unlink(claim)
        except OSError:  # pragma: no cover - concurrent cleanup
          pass
    return None

  def _owned(self, job_id: str, owner: str) -> dict:
    record = self._read(job_id)
    if record is None:
      raise JobQueueError(f"job {job_id!r} does not exist")
    lease = record.get("lease")
    if (record["state"] not in LEASED_STATES or lease is None
        or lease.get("owner") != owner):
      raise LeaseLostError(
          f"job {job_id!r} is not leased by {owner!r} "
          f"(state {record['state']!r}, lease {lease!r})")
    return record

  def heartbeat(self, job_id: str, owner: str) -> None:
    """Refresh the lease; raises ``LeaseLostError`` if it was reaped."""
    record = self._owned(job_id, owner)
    record["lease"]["heartbeat_unix_s"] = round(self._clock(), 6)
    self._write(record)

  def mark_running(self, job_id: str, owner: str, attempt: int,
                   detail: dict | None = None) -> None:
    """leased -> running: the attempt's process is up. ``attempts`` counts
    every spawn, so it reads 1 after the first launch."""
    record = self._owned(job_id, owner)
    record["state"] = "running"
    record["attempts"] = int(attempt) + 1
    record["lease"]["heartbeat_unix_s"] = round(self._clock(), 6)
    record["history"].append({"event": "started", "attempt": int(attempt),
                              "ts_unix_s": round(self._clock(), 6),
                              **(detail or {})})
    self._write(record)

  def complete(self, job_id: str, owner: str,
               result: dict | None = None) -> None:
    """running -> done (terminal)."""
    record = self._owned(job_id, owner)
    record["state"] = "done"
    record["lease"] = None
    record["result"] = dict(result or {})
    record["history"].append({"event": "done",
                              "ts_unix_s": round(self._clock(), 6)})
    self._write(record)
    self._emit("training_job_done", job=job_id,
               attempts=record["attempts"])

  def requeue(self, job_id: str, owner: str, reason: str,
              not_before_unix_s: float = 0.0,
              count_attempt: bool = True,
              budget_spend_unix_s: list[float] | None = None) -> None:
    """Back to ``queued`` after a failed or preempted attempt.

    ``count_attempt=False`` is planned downtime (SIGTERM preemption):
    it must not look like a crash to the restart budget, exactly as the
    fleet supervisor's rolling restart spends no attempts.
    ``not_before_unix_s`` is the retry backoff floor.
    ``budget_spend_unix_s`` persists the supervisor's in-window
    restart-budget spend times (wall clock) onto the record, so a
    supervisor that restarts mid-crash-loop resumes the countdown
    instead of resetting it; None leaves the persisted list untouched
    (preemption requeues spend nothing and must not erase history).
    """
    record = self._owned(job_id, owner)
    record["state"] = "queued"
    record["lease"] = None
    record["not_before_unix_s"] = round(float(not_before_unix_s), 6)
    if budget_spend_unix_s is not None:
      record["budget_spend_unix_s"] = [
          round(float(t), 6) for t in budget_spend_unix_s]
    record["requeues"] = int(record.get("requeues", 0)) + 1
    record["history"].append({"event": "requeued", "reason": str(reason),
                              "counted": bool(count_attempt),
                              "ts_unix_s": round(self._clock(), 6)})
    self._write(record)
    self.requeues += 1
    self._emit("training_job_requeued", job=job_id, reason=str(reason),
               counted=bool(count_attempt))

  def quarantine(self, job_id: str, owner: str | None, reason: str) -> None:
    """Terminal containment: the job is poison (restart budget exhausted)
    and the queue keeps draining without it. ``owner=None`` is the
    operator path (quarantining an un-leased job by hand)."""
    record = (self._owned(job_id, owner) if owner is not None
              else self._read(job_id))
    if record is None:
      raise JobQueueError(f"job {job_id!r} does not exist")
    record["state"] = "quarantined"
    record["lease"] = None
    record["quarantine_reason"] = str(reason)
    record["history"].append({"event": "quarantined", "reason": str(reason),
                              "ts_unix_s": round(self._clock(), 6)})
    self._write(record)
    self._emit("training_job_quarantined", job=job_id, reason=str(reason),
               attempts=record["attempts"])

  def fail(self, job_id: str, reason: str) -> None:
    """Terminal rejection of a job that never ran (malformed spec): the
    queue must keep draining past garbage input, loudly."""
    record = self._read(job_id)
    if record is None:
      raise JobQueueError(f"job {job_id!r} does not exist")
    record["state"] = "failed"
    record["lease"] = None
    record["failure_reason"] = str(reason)
    record["history"].append({"event": "failed", "reason": str(reason),
                              "ts_unix_s": round(self._clock(), 6)})
    self._write(record)
    self._emit("training_job_failed", job=job_id, reason=str(reason))

  def readmit(self, job_id: str) -> None:
    """Operator override: put a quarantined/failed job back in the queue
    (fresh backoff; attempt history is kept — it is evidence)."""
    record = self._read(job_id)
    if record is None:
      raise JobQueueError(f"job {job_id!r} does not exist")
    if record["state"] not in ("quarantined", "failed"):
      raise JobQueueError(
          f"job {job_id!r} is {record['state']!r}, not quarantined/failed")
    record["state"] = "queued"
    record["not_before_unix_s"] = 0.0
    # The override's promise is a FRESH restart budget: drop the
    # persisted spend window along with the in-memory one.
    record.pop("budget_spend_unix_s", None)
    record["history"].append({"event": "readmitted",
                              "ts_unix_s": round(self._clock(), 6)})
    self._write(record)
    self._emit("training_job_readmitted", job=job_id)

  # -- the reaper -----------------------------------------------------------

  def reap_expired(self) -> list[str]:
    """Requeue every leased/running job whose heartbeat went stale.

    THE crash-safety property: a worker that died (or was SIGKILLed, or
    lost its host) stops heartbeating, and after ``lease_s`` its jobs
    return to ``queued`` for any worker to resume — through the
    checkpoint cursor, bit-exactly. Requeue-on-expiry does not count an
    attempt: the budget charges observed process failures, not worker
    losses (the serving fleet's planned-downtime rule).
    """
    now = self._clock()
    reaped = []
    for job_id in self.job_ids():
      record = self._read(job_id)
      if record is None or record["state"] not in LEASED_STATES:
        continue
      lease = record.get("lease") or {}
      beat = float(lease.get("heartbeat_unix_s", 0.0))
      if now - beat <= self.lease_s:
        continue
      record["state"] = "queued"
      record["lease"] = None
      record["requeues"] = int(record.get("requeues", 0)) + 1
      record["history"].append({
          "event": "lease_expired", "owner": lease.get("owner"),
          "idle_s": round(now - beat, 3),
          "ts_unix_s": round(now, 6)})
      self._write(record)
      reaped.append(job_id)
      self.leases_expired += 1
      self.requeues += 1
      self._emit("training_job_lease_expired", job=job_id,
                 owner=lease.get("owner"), idle_s=round(now - beat, 3))
    return reaped

  # -- introspection --------------------------------------------------------

  def job_ids(self) -> list[str]:
    out = []
    for name in os.listdir(self.root):
      m = _JOB_RE.match(name)
      if m:
        out.append(m.group(1))
    return sorted(out)

  def get(self, job_id: str) -> Job | None:
    record = self._read(job_id)
    return Job(record) if record is not None else None

  def jobs(self) -> list[Job]:
    return [job for job in (self.get(jid) for jid in self.job_ids())
            if job is not None]

  def counts(self) -> dict:
    out = {state: 0 for state in STATES}
    for job in self.jobs():
      out[job.state] = out.get(job.state, 0) + 1
    return out

  def drained(self) -> bool:
    """True when no job is runnable or in flight (done/failed/quarantined
    are all terminal) — the ``train-queue --drain`` exit condition."""
    counts = self.counts()
    return (counts["queued"] + counts["leased"] + counts["running"]) == 0

  def snapshot(self) -> dict:
    return {
        "root": self.root,
        "lease_s": self.lease_s,
        "counts": self.counts(),
        "requeues": self.requeues,
        "leases_expired": self.leases_expired,
    }
