"""Supervision leases: exactly one router runs the FleetSupervisor.

A copy of ``mpi_vision_tpu/serve/cluster/lease.py``.

Two implementations behind one ``try_acquire / heartbeat / release``
contract (the train-queue lease discipline, applied to supervision):

* ``FileLease`` — co-located routers share a directory; the lease is a
  JSON file claimed with the same atomic hard-link + stale-reap
  protocol as ``train/queue.py`` job claims (lease-don't-lock: a dead
  holder's file is reaped by its stale heartbeat, never by guessing at
  process identity).
* ``GossipLease`` — ``--join``ed routers share no filesystem; the lease
  is the claim slot in the gossip state, converged by the merge rules
  in ``gossip.py`` (fresh beats stale; fresh-vs-fresh breaks to the
  earliest claimant, and the loser's next heartbeat raises
  ``SupervisionLeaseLost`` so it steps down).

Wall clocks only (injectable): lease stamps cross process boundaries.
"""

from __future__ import annotations

import json
import os
import time
import uuid


class SupervisionLeaseLost(RuntimeError):
  """The holder's lease was taken by another node; stop supervising."""


def _fresh(heartbeat_unix_s: float, now: float, ttl_s: float) -> bool:
  return now - heartbeat_unix_s <= ttl_s


class FileLease:
  """On-disk supervision lease for routers sharing a filesystem.

  The claim is ``os.link(tmp, path)`` — atomic on POSIX, EEXIST when
  held. A held lease whose heartbeat is older than ``ttl_s`` is reaped
  by renaming it aside, re-verifying staleness on the renamed copy
  (another claimant may have won the rename race), and retrying the
  link once — the exact ``train/queue.py`` ``_try_claim`` discipline.
  """

  def __init__(self, path: str, owner: str, ttl_s: float = 5.0,
               clock=time.time):
    if not owner:
      raise ValueError("owner must be non-empty")
    if ttl_s <= 0:
      raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
    self.path = str(path)
    self.owner = str(owner)
    self.ttl_s = float(ttl_s)
    self._clock = clock
    os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)

  def _read(self, path: str | None = None) -> dict | None:
    try:
      with open(path or self.path, "rb") as f:
        rec = json.loads(f.read())
      if not isinstance(rec, dict):
        return None
      return {"owner": str(rec["owner"]),
              "since_unix_s": float(rec["since_unix_s"]),
              "heartbeat_unix_s": float(rec["heartbeat_unix_s"])}
    except (OSError, ValueError, KeyError, TypeError):
      return None

  def _write_tmp(self, record: dict) -> str:
    tmp = f"{self.path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as f:
      json.dump(record, f)
      f.flush()
      os.fsync(f.fileno())
    return tmp

  def holder(self) -> dict | None:
    """Who holds the lease, with a freshness verdict (None: unheld)."""
    rec = self._read()
    if rec is None:
      return None
    rec["fresh"] = _fresh(rec["heartbeat_unix_s"], self._clock(),
                          self.ttl_s)
    return rec

  def try_acquire(self) -> dict | None:
    """Claim the lease. None: another holder is fresh. Otherwise
    ``{"takeover": bool, "previous": owner | None}`` — takeover means a
    stale holder's lease was reaped (its supervisor died or wedged)."""
    now = self._clock()
    cur = self._read()
    if cur is not None and cur["owner"] == self.owner:
      self.heartbeat()
      return {"takeover": False, "previous": self.owner}
    record = {"owner": self.owner, "since_unix_s": now,
              "heartbeat_unix_s": now}
    tmp = self._write_tmp(record)
    try:
      for _ in range(2):  # second try only after reaping a stale holder
        try:
          os.link(tmp, self.path)
          previous = None if cur is None else cur["owner"]
          return {"takeover": cur is not None
                  and not _fresh(cur["heartbeat_unix_s"], now, self.ttl_s),
                  "previous": previous}
        except FileExistsError:
          pass
        cur = self._read()
        if cur is not None and (cur["owner"] == self.owner
                                or _fresh(cur["heartbeat_unix_s"],
                                          self._clock(), self.ttl_s)):
          return None if cur["owner"] != self.owner else \
              {"takeover": False, "previous": self.owner}
        # Stale (or unreadable) holder: rename it aside, re-verify on
        # the renamed copy, restore if a racing heartbeat refreshed it.
        aside = f"{self.path}.stale.{os.getpid()}.{uuid.uuid4().hex[:8]}"
        try:
          os.rename(self.path, aside)
        except OSError:
          continue  # someone else reaped (or released) first: retry link
        reread = self._read(aside)
        if reread is not None and _fresh(reread["heartbeat_unix_s"],
                                         self._clock(), self.ttl_s):
          try:
            os.rename(aside, self.path)  # fresh after all: put it back
          except OSError:
            os.unlink(aside)
          return None
        cur = reread
        os.unlink(aside)
      return None
    finally:
      try:
        os.unlink(tmp)
      except OSError:
        pass

  def heartbeat(self) -> None:
    """Refresh the holder's heartbeat; SupervisionLeaseLost if another
    node reaped the lease out from under a wedged holder."""
    cur = self._read()
    if cur is None or cur["owner"] != self.owner:
      raise SupervisionLeaseLost(
          f"lease {self.path} now held by "
          f"{cur['owner'] if cur else 'nobody'}")
    record = {"owner": self.owner, "since_unix_s": cur["since_unix_s"],
              "heartbeat_unix_s": self._clock()}
    tmp = self._write_tmp(record)
    try:
      os.replace(tmp, self.path)
    except OSError:
      try:
        os.unlink(tmp)
      except OSError:
        pass
      raise

  def release(self) -> None:
    cur = self._read()
    if cur is not None and cur["owner"] == self.owner:
      try:
        os.unlink(self.path)
      except OSError:
        pass


class GossipLease:
  """Supervision lease carried in the gossip state (joined fleets).

  Acquisition is optimistic — claim locally, let anti-entropy converge.
  A split brain (two routers claiming in the same partition window)
  heals at the first merge: the (since, owner) tie-break installs ONE
  winner in both states, and the loser's next ``heartbeat`` sees a
  fresh foreign owner and raises ``SupervisionLeaseLost``.
  """

  def __init__(self, state, owner: str):
    if not owner:
      raise ValueError("owner must be non-empty")
    self.state = state
    self.owner = str(owner)

  def holder(self) -> dict | None:
    return self.state.lease_view()

  def try_acquire(self) -> dict | None:
    cur = self.state.lease_view()
    if cur is not None and cur["owner"] != self.owner and cur["fresh"]:
      return None
    previous = None if cur is None else cur["owner"]
    takeover = cur is not None and cur["owner"] != self.owner
    self.state.claim_lease(self.owner)
    return {"takeover": takeover, "previous": previous}

  def heartbeat(self) -> None:
    cur = self.state.lease_view()
    if cur is not None and cur["owner"] != self.owner and cur["fresh"]:
      raise SupervisionLeaseLost(
          f"gossiped lease now held by {cur['owner']}")
    self.state.claim_lease(self.owner)

  def release(self) -> None:
    self.state.clear_lease(self.owner)
