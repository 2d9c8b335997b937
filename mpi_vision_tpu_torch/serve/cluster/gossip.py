"""Anti-entropy health gossip between router replicas.

A copy of ``mpi_vision_tpu/serve/cluster/gossip.py``.

N routers front one backend fleet; each keeps a ``GossipState`` of
versioned per-backend observations (health, eject/quarantine verdicts,
restart-budget spend ages, load) plus at most one supervision-lease
claim. A ``GossipNode`` periodically pushes its state to every peer's
``/gossip`` endpoint and merges the peer's state out of the reply
(push-pull), so observations reach every router in O(log N) rounds and
a router that learns of a quarantine via gossip ejects the backend
without spending its own breaker probes.

Merge discipline: newest version wins per backend; an equal-version
disagreement is counted as a conflict and broken deterministically by
the greater origin id, so two partitioned routers converge to ONE state
on rejoin no matter which direction the rounds run. Budget spends
travel as AGES (seconds ago), never absolute timestamps — each process
re-anchors them on its own clock, so the protocol never assumes
synchronized clocks between routers.

Everything reads time through an injectable wall clock (``time.time``:
versions and lease heartbeats cross process boundaries) and sends
through an injectable transport, so every state machine unit-tests on
fakes in milliseconds.
"""

from __future__ import annotations

import json
import threading
import time


class GossipState:
  """The versioned observation table one router gossips.

  Thread-safe. ``observe`` is the local-authority write path (the
  supervisor publishing what it directly sees); ``merge`` is the
  remote path (adopting a peer's newer observations). The lease slot
  holds at most one supervision claim; freshness is judged against
  ``lease_ttl_s`` on the LOCAL clock, which works because heartbeats
  gossip as recent wall-clock stamps and staleness tolerances are
  seconds, not milliseconds.
  """

  def __init__(self, node_id: str, clock=time.time,
               lease_ttl_s: float = 5.0):
    if not node_id:
      raise ValueError("node_id must be non-empty")
    if lease_ttl_s <= 0:
      raise ValueError(f"lease_ttl_s must be > 0, got {lease_ttl_s}")
    self.node_id = str(node_id)
    self.lease_ttl_s = float(lease_ttl_s)
    self._clock = clock
    self._lock = threading.Lock()
    # backend_id -> {"version": float, "origin": str, "fields": dict}
    self._obs: dict[str, dict] = {}
    # {"owner", "since_unix_s", "heartbeat_unix_s"} | None
    self._lease: dict | None = None

  def now(self) -> float:
    return self._clock()

  # --- local observations -------------------------------------------------

  def observe(self, backend_id: str, **fields) -> bool:
    """Record locally-observed facts about one backend.

    Fields merge over the previous observation; the version only bumps
    when the merged fields actually changed, so a steady-state fleet
    gossips no-ops (and peers count no merges) between incidents.
    """
    with self._lock:
      prev = self._obs.get(backend_id)
      merged = dict(prev["fields"]) if prev else {}
      merged.update(fields)
      if prev is not None and merged == prev["fields"]:
        return False
      now = self._clock()
      version = now if prev is None else max(now, prev["version"] + 1e-6)
      self._obs[backend_id] = {
          "version": version, "origin": self.node_id, "fields": merged}
      return True

  def observations(self) -> dict[str, dict]:
    with self._lock:
      return {b: {"version": o["version"], "origin": o["origin"],
                  "fields": dict(o["fields"])}
              for b, o in self._obs.items()}

  def observation(self, backend_id: str) -> dict | None:
    with self._lock:
      o = self._obs.get(backend_id)
      return None if o is None else {
          "version": o["version"], "origin": o["origin"],
          "fields": dict(o["fields"])}

  # --- the lease slot -----------------------------------------------------

  def claim_lease(self, owner: str) -> dict:
    """Stamp (or re-heartbeat) the supervision lease for ``owner``."""
    with self._lock:
      now = self._clock()
      cur = self._lease
      since = (cur["since_unix_s"]
               if cur is not None and cur["owner"] == owner else now)
      self._lease = {"owner": owner, "since_unix_s": since,
                     "heartbeat_unix_s": now}
      return dict(self._lease)

  def clear_lease(self, owner: str) -> None:
    """Drop the lease iff ``owner`` still holds it (clean shutdown)."""
    with self._lock:
      if self._lease is not None and self._lease["owner"] == owner:
        self._lease = None

  def lease_view(self) -> dict | None:
    """The lease as gossip sees it, with a freshness verdict."""
    with self._lock:
      if self._lease is None:
        return None
      out = dict(self._lease)
      out["fresh"] = (self._clock() - out["heartbeat_unix_s"]
                      <= self.lease_ttl_s)
      return out

  # --- wire + merge -------------------------------------------------------

  def wire(self) -> dict:
    """The JSON-safe body one anti-entropy round sends."""
    with self._lock:
      return {
          "node": self.node_id,
          "observations": {
              b: {"version": o["version"], "origin": o["origin"],
                  "fields": dict(o["fields"])}
              for b, o in self._obs.items()},
          "lease": None if self._lease is None else dict(self._lease),
      }

  def merge(self, remote: dict) -> dict:
    """Fold a peer's wire state in. Newest version wins per backend;
    version ties with differing fields count as conflicts and resolve
    to the greater origin id (deterministic: both sides pick the same
    winner). Returns ``{"merges", "conflicts", "changed"}`` where
    ``changed`` lists backend ids whose adopted fields differ from what
    this node held before."""
    merges = conflicts = 0
    changed: list[str] = []
    remote_obs = remote.get("observations") or {}
    with self._lock:
      for backend_id, theirs in remote_obs.items():
        try:
          version = float(theirs["version"])
          origin = str(theirs["origin"])
          fields = dict(theirs["fields"])
        except (KeyError, TypeError, ValueError):
          continue  # a malformed entry never poisons the table
        mine = self._obs.get(backend_id)
        adopt = False
        if mine is None or version > mine["version"]:
          adopt = True
        elif version == mine["version"] and fields != mine["fields"]:
          conflicts += 1
          adopt = origin > mine["origin"]
        if adopt:
          merges += 1
          if mine is None or fields != mine["fields"]:
            changed.append(backend_id)
          self._obs[backend_id] = {
              "version": version, "origin": origin, "fields": fields}
      conflicts += self._merge_lease_locked(remote.get("lease"))
    return {"merges": merges, "conflicts": conflicts, "changed": changed}

  def _merge_lease_locked(self, theirs) -> int:
    """Lease merge. Same owner: newer heartbeat wins (earliest since
    kept). Different owners: a fresh claim beats a stale one; two fresh
    claims are a conflict (counted) broken by the smaller
    ``(since_unix_s, owner)`` — the earliest claimant keeps the lease
    and the loser's own heartbeat observes it has lost."""
    if not isinstance(theirs, dict):
      return 0
    try:
      owner = str(theirs["owner"])
      since = float(theirs["since_unix_s"])
      beat = float(theirs["heartbeat_unix_s"])
    except (KeyError, TypeError, ValueError):
      return 0
    mine = self._lease
    if mine is None:
      self._lease = {"owner": owner, "since_unix_s": since,
                     "heartbeat_unix_s": beat}
      return 0
    if mine["owner"] == owner:
      if beat > mine["heartbeat_unix_s"]:
        self._lease = {"owner": owner,
                       "since_unix_s": min(since, mine["since_unix_s"]),
                       "heartbeat_unix_s": beat}
      return 0
    now = self._clock()
    mine_fresh = now - mine["heartbeat_unix_s"] <= self.lease_ttl_s
    theirs_fresh = now - beat <= self.lease_ttl_s
    if theirs_fresh and not mine_fresh:
      self._lease = {"owner": owner, "since_unix_s": since,
                     "heartbeat_unix_s": beat}
      return 0
    if mine_fresh and not theirs_fresh:
      return 0
    # Both fresh (split brain mid-heal) or both stale: deterministic.
    if (since, owner) < (mine["since_unix_s"], mine["owner"]):
      self._lease = {"owner": owner, "since_unix_s": since,
                     "heartbeat_unix_s": beat}
    return 1 if (mine_fresh and theirs_fresh) else 0


class GossipNode:
  """The anti-entropy loop: one ``round()`` pushes this router's state
  to every peer and pulls each peer's state out of the reply.

  Peer failures are counted and logged, never fatal — gossip is the
  mechanism that SURVIVES partial failure. ``receive`` is shared with
  the HTTP ``/gossip`` endpoint so an inbound push merges identically
  to a pulled reply; ``on_merge(changed_backend_ids)`` lets the router
  apply adopted eject/quarantine verdicts to its own rotation.
  """

  def __init__(self, state: GossipState, peers, transport=None,
               interval_s: float = 1.0, timeout_s: float = 2.0,
               clock=time.time, sleep=None, events=None, metrics=None,
               on_merge=None, log=None):
    if interval_s <= 0:
      raise ValueError(f"interval_s must be > 0, got {interval_s}")
    if timeout_s <= 0:
      raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
    self.state = state
    self.peers = [str(p) for p in peers]
    if transport is None:
      from .router import HttpTransport
      transport = HttpTransport()
    self._transport = transport
    self.interval_s = float(interval_s)
    self.timeout_s = float(timeout_s)
    self._clock = clock
    self._events = events
    self._metrics = metrics
    self._on_merge = on_merge
    self._log = log or (lambda msg: None)
    self._lock = threading.Lock()
    # peer -> {"ok", "last_success_unix_s", "last_failure_unix_s",
    #          "failures", "last_error"}
    self._peer_table = {p: {"ok": None, "last_success_unix_s": None,
                            "last_failure_unix_s": None, "failures": 0,
                            "last_error": None}
                        for p in self.peers}
    self.rounds = 0
    self._stop = threading.Event()
    self._thread: threading.Thread | None = None

  # --- merging (shared by rounds and the /gossip endpoint) ----------------

  def receive(self, remote: dict) -> dict:
    """Merge a peer's wire state; returns this node's wire state (the
    pull half of push-pull). Metrics/events fire only when something
    actually changed, so steady-state gossip stays quiet."""
    result = self.state.merge(remote)
    if self._metrics is not None and (result["merges"]
                                      or result["conflicts"]):
      self._metrics.record_gossip_merge(result["merges"],
                                        result["conflicts"])
    if result["changed"]:
      if self._events is not None:
        self._events.emit("gossip_merge", peer=remote.get("node", "?"),
                          backends=sorted(result["changed"]),
                          conflicts=result["conflicts"])
      if self._on_merge is not None:
        try:
          self._on_merge(result["changed"])
        except Exception as e:  # noqa: BLE001 - apply is best-effort
          self._log(f"gossip: on_merge failed: {e!r}")
    return self.state.wire()

  def round(self) -> dict:
    """One anti-entropy round over every peer."""
    self.rounds += 1
    if self._metrics is not None:
      self._metrics.record_gossip_round()
    body = json.dumps(self.state.wire()).encode()
    results = {}
    for peer in self.peers:
      try:
        status, _, reply = self._transport.request(
            "POST", f"http://{peer}/gossip", body=body,
            headers={"Content-Type": "application/json"},
            timeout=self.timeout_s)
        if status != 200:
          raise ConnectionError(f"/gossip returned http {status}")
        self.receive(json.loads(reply))
        recovered = self._note_peer(peer, ok=True)
        if recovered and self._events is not None:
          # The fire/clear pair incident capture latches on: a peer
          # death fires an episode, this edge closes it.
          self._events.emit("gossip_peer_recovered", peer=peer)
        results[peer] = "ok"
      except Exception as e:  # noqa: BLE001 - a dead peer is routine
        self._note_peer(peer, ok=False, error=repr(e))
        if self._metrics is not None:
          self._metrics.record_gossip_peer_failure()
        if self._events is not None:
          self._events.emit("gossip_peer_failure", peer=peer,
                            error=repr(e))
        results[peer] = repr(e)
    return results

  def _note_peer(self, peer: str, ok: bool,
                 error: str | None = None) -> bool:
    """Update the peer table; True = this success ended a failure run
    (the ``gossip_peer_recovered`` edge)."""
    with self._lock:
      entry = self._peer_table.setdefault(
          peer, {"ok": None, "last_success_unix_s": None,
                 "last_failure_unix_s": None, "failures": 0,
                 "last_error": None})
      recovered = ok and entry["ok"] is False
      entry["ok"] = ok
      if ok:
        entry["last_success_unix_s"] = self._clock()
        entry["last_error"] = None
      else:
        entry["last_failure_unix_s"] = self._clock()
        entry["failures"] += 1
        entry["last_error"] = error
      return recovered

  def snapshot(self) -> dict:
    with self._lock:
      peers = {p: dict(e) for p, e in self._peer_table.items()}
    return {
        "node": self.state.node_id,
        "peers": peers,
        "rounds": self.rounds,
        "lease": self.state.lease_view(),
    }

  # --- the loop -----------------------------------------------------------

  def start(self) -> "GossipNode":
    if self._thread is not None:
      raise RuntimeError("gossip node already started")
    self._stop.clear()
    self._thread = threading.Thread(
        target=self._loop, name="gossip-node", daemon=True)
    self._thread.start()
    return self

  def _loop(self) -> None:
    while not self._stop.is_set():
      try:
        self.round()
      except Exception as e:  # noqa: BLE001 - the loop must survive
        self._log(f"gossip: round failed: {e!r}")
      self._stop.wait(self.interval_s)

  def stop(self, timeout: float = 10.0) -> None:
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout)
      self._thread = None
