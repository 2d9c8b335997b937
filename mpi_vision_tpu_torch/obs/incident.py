"""SLO-triggered incident recorder: the self-capturing black box.

A copy of ``mpi_vision_tpu/obs/incident.py`` with its imports rewritten.

When a burn-rate alert fires, an operator today hand-stitches four
surfaces under time pressure — ``/debug/traces``, ``/debug/tsdb``,
``/debug/events``, ``/stats``. This module captures that stitch *at the
moment of the fire edge*, automatically: ``RenderService`` hooks
``note_alert`` beside its ``_on_slo_alert`` callback, and on each fire
edge (deduplicated per alert name until the clear edge — one bundle per
incident, not one per evaluation) a daemon worker thread snapshots a
self-contained JSON bundle off the request path:

  * the firing objective + burn numbers (the alert record itself),
  * the slowest-trace exemplars from the Tracer ring,
  * the tsdb window covering the spike,
  * the recent event slice,
  * brownout ladder state and the top-K attribution cells at fire time,
  * optionally a ``DeviceProfiler`` capture (``--incident-profile``).

Bundles are written atomically (tmp + rename, the repo-wide publish
idiom) into a bounded on-disk ring (``--incident-dir``, keep-K oldest
pruned), listed/fetched at ``/debug/incidents``, and handed to the
``TelemetryShipper`` so they ride its batch -> retry -> disk-spool path
off-host — a sink outage loses nothing.

What exactly goes in the bundle is the *service's* decision: the
recorder takes a ``collect(alert) -> dict`` callable (adoption
pattern — a pre-built recorder without one is wired by the service,
like the shipper's tsdb), keeping this module free of serve imports.
Clocks are injectable (clock-lint covers this file); tests drive
``drain()`` directly instead of starting the worker.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import re
import threading
import time

from mpi_vision_tpu_torch.obs import prom
from mpi_vision_tpu_torch.obs.events import NULL_EVENTS

PREFIX = "mpi_obs_incident_"

_BUNDLE_RE = re.compile(r"^incident-(\d+)\.json$")


@dataclasses.dataclass(frozen=True)
class IncidentConfig:
  """Recorder knobs (the ``serve`` CLI ``--incident-*`` flags map 1:1).

  ``dir`` is the on-disk bundle ring; ``keep`` bounds it (oldest bundle
  pruned past it). ``tsdb_window_s`` is how much history the bundle
  freezes around the fire edge; ``top_k_cells`` bounds the attribution
  slice; ``profile_seconds`` > 0 additionally wraps a device-profiler
  capture into the bundle (needs the service's profiler configured).
  """

  dir: str
  keep: int = 8
  top_k_cells: int = 8
  tsdb_window_s: float = 300.0
  events_recent: int = 64
  traces_recent: int = 8
  profile_seconds: float = 0.0

  def __post_init__(self):
    if not self.dir:
      raise ValueError("IncidentConfig.dir must be set")
    if self.keep < 1:
      raise ValueError(f"keep must be >= 1, got {self.keep}")
    if self.top_k_cells < 0:
      raise ValueError(f"top_k_cells must be >= 0, got {self.top_k_cells}")
    if self.tsdb_window_s <= 0:
      raise ValueError(
          f"tsdb_window_s must be > 0, got {self.tsdb_window_s}")
    if self.events_recent < 0:
      raise ValueError(
          f"events_recent must be >= 0, got {self.events_recent}")
    if self.traces_recent < 0:
      raise ValueError(
          f"traces_recent must be >= 0, got {self.traces_recent}")
    if self.profile_seconds < 0:
      raise ValueError(
          f"profile_seconds must be >= 0, got {self.profile_seconds}")


class IncidentRecorder:
  """Fire-edge-triggered bundle capture with a bounded disk ring.

  Args:
    config: ring/window knobs.
    collect: ``(alert: dict) -> dict`` building the bundle's context
      (traces, tsdb window, events, attribution ...). May be None at
      construction — the adopting service wires its own, like the
      shipper's tsdb.
    on_bundle: optional ``(bundle: dict) -> None`` called after each
      capture lands on disk (the service wires the shipper's
      ``note_incident`` here); failures are counted, never fatal.
    events: event-log emitter for ``incident_captured`` /
      ``incident_capture_failed``.
    clock: monotonic source for capture durations.
    wall: wall-clock source for bundle timestamps (cross-process
      artifact, like the event log's).

  ``note_alert`` is O(1) and safe from the alert-callback path; capture
  runs on the worker thread (``start()``) or via ``drain()`` in tests.
  """

  def __init__(self, config: IncidentConfig, collect=None, on_bundle=None,
               events=NULL_EVENTS, clock=time.monotonic, wall=time.time):
    self.config = config
    self.collect = collect
    self.on_bundle = on_bundle
    self.events = events
    self._clock = clock
    self._wall = wall
    self._lock = threading.Lock()
    self._queue: queue.SimpleQueue = queue.SimpleQueue()
    self._firing: set[str] = set()
    self._thread: threading.Thread | None = None
    self._index: list[dict] = []  # oldest first, mirrors the disk ring
    self._seq = 0
    self.captures = 0
    self.capture_errors = 0
    self.suppressed = 0
    self.pending = 0
    self.pruned = 0
    self.ship_errors = 0
    os.makedirs(config.dir, exist_ok=True)
    # Resume past bundles a previous process left behind: the sequence
    # continues after the highest resident file (restarting at 1 would
    # rename OVER retained incidents) and the index lists them.
    for name in sorted(os.listdir(config.dir)):
      m = _BUNDLE_RE.match(name)
      if m is None:
        continue
      self._seq = max(self._seq, int(m.group(1)))
      path = os.path.join(config.dir, name)
      entry = {"id": name[:-len(".json")], "alert": None,
               "captured_at": None, "bytes": 0}
      try:
        entry["bytes"] = os.path.getsize(path)
        with open(path, "r") as fh:
          head = json.load(fh)
        entry["alert"] = (head.get("alert") or {}).get("alert")
        entry["captured_at"] = head.get("captured_at")
      except (OSError, ValueError):
        pass
      self._index.append(entry)

  # -- the alert edge (request-path cheap) ---------------------------------

  def note_alert(self, name: str, firing: bool, details=None) -> None:
    """Queue one capture on a fire edge; dedup until the clear edge.

    A re-fire of an already-firing alert is suppressed (counted) — one
    bundle per incident. The clear edge only releases the dedup latch;
    it never captures.
    """
    with self._lock:
      if not firing:
        self._firing.discard(name)
        return
      if name in self._firing:
        self.suppressed += 1
        return
      self._firing.add(name)
      self.pending += 1
    self._queue.put({"alert": name, "details": dict(details or {}),
                     "noted_at": round(self._wall(), 3)})

  # -- capture (worker thread / drain) -------------------------------------

  def _capture(self, job: dict) -> None:
    t0 = self._clock()
    with self._lock:
      self._seq += 1
      seq = self._seq
    incident_id = f"incident-{seq:06d}"
    context = {}
    if self.collect is not None:
      try:
        context = self.collect(job) or {}
      except Exception as e:  # noqa: BLE001 - a failing collector must
        # still leave a bundle naming the alert (a black box that dies
        # of the crash it was recording is no black box).
        with self._lock:
          self.capture_errors += 1
        context = {"collect_error": repr(e)}
    bundle = {
        "kind": "mpi_incident",
        "id": incident_id,
        "seq": seq,
        "alert": job,
        "captured_at": round(self._wall(), 3),
        "capture_s": None,  # stamped below, after the context snapshot
        **context,
    }
    bundle["capture_s"] = round(self._clock() - t0, 6)
    path = os.path.join(self.config.dir, incident_id + ".json")
    body = json.dumps(bundle).encode()
    try:
      tmp = path + ".tmp"
      with open(tmp, "wb") as fh:
        fh.write(body)
      os.replace(tmp, path)
    except OSError as e:
      with self._lock:
        self.capture_errors += 1
        self.pending -= 1
      self.events.emit("incident_capture_failed", incident=incident_id,
                       alert=job["alert"], error=repr(e))
      return
    with self._lock:
      self.captures += 1
      self.pending -= 1
      self._index.append({"id": incident_id, "alert": job["alert"],
                          "captured_at": bundle["captured_at"],
                          "bytes": len(body)})
      prune = self._index[:max(len(self._index) - self.config.keep, 0)]
      del self._index[:len(prune)]
    for entry in prune:
      try:
        os.remove(os.path.join(self.config.dir, entry["id"] + ".json"))
      except OSError:
        pass
      with self._lock:
        self.pruned += 1
    self.events.emit("incident_captured", incident=incident_id,
                     alert=job["alert"], bytes=len(body),
                     capture_s=bundle["capture_s"])
    if self.on_bundle is not None:
      try:
        self.on_bundle(bundle)
      except Exception:  # noqa: BLE001 - shipping is best-effort here;
        # the bundle is already durable on disk.
        with self._lock:
          self.ship_errors += 1

  def drain(self) -> int:
    """Capture every queued fire edge synchronously; returns how many.
    The worker loop body — tests (and an un-started adopted recorder)
    call it directly for deterministic captures."""
    done = 0
    while True:
      try:
        job = self._queue.get_nowait()
      except queue.Empty:
        return done
      if job is None:
        continue  # a stop sentinel racing a manual drain
      self._capture(job)
      done += 1

  def _loop(self) -> None:
    while True:
      job = self._queue.get()
      if job is None:
        return
      self._capture(job)

  def start(self) -> "IncidentRecorder":
    if self._thread is not None:
      raise RuntimeError("IncidentRecorder already started")
    self._thread = threading.Thread(target=self._loop,
                                    name="mpi-obs-incident", daemon=True)
    self._thread.start()
    return self

  def stop(self) -> None:
    """Stop the worker after it finishes everything already queued (the
    sentinel lands behind pending fire edges, so a capture racing close
    still reaches disk)."""
    if self._thread is not None:
      self._queue.put(None)
      self._thread.join(5.0)
      self._thread = None

  # -- introspection -------------------------------------------------------

  def list(self) -> list[dict]:
    """The bundle index, newest first (the ``/debug/incidents`` body)."""
    with self._lock:
      return [dict(entry) for entry in reversed(self._index)]

  def get(self, incident_id: str) -> dict:
    """One full bundle by id; raises KeyError when unknown (handlers
    map it to 404). Reads disk so a bundle from a previous process is
    fetchable too."""
    if _BUNDLE_RE.match(str(incident_id) + ".json") is None:
      raise KeyError(f"unknown incident {incident_id!r}")
    path = os.path.join(self.config.dir, str(incident_id) + ".json")
    try:
      with open(path, "r") as fh:
        return json.load(fh)
    except (OSError, ValueError):
      raise KeyError(f"unknown incident {incident_id!r}") from None

  def stats(self) -> dict:
    with self._lock:
      return {
          "dir": self.config.dir,
          "keep": self.config.keep,
          "captures": self.captures,
          "capture_errors": self.capture_errors,
          "suppressed": self.suppressed,
          "pending": self.pending,
          "pruned": self.pruned,
          "ship_errors": self.ship_errors,
          "bundles": len(self._index),
          "bundle_bytes": sum(e["bytes"] for e in self._index),
          "firing": sorted(self._firing),
      }


def registry(stats: dict | None) -> prom.Registry:
  """The ``mpi_obs_incident_*`` families (zeros while the recorder is
  off — the always-exposed convention)."""
  stats = stats or {}
  reg = prom.Registry()
  p = PREFIX
  reg.counter(p + "captures_total",
              "Incident bundles captured on SLO fire edges.",
              stats.get("captures", 0))
  reg.counter(p + "capture_errors_total",
              "Captures that failed (collector raised or disk write "
              "failed).", stats.get("capture_errors", 0))
  reg.counter(p + "suppressed_total",
              "Fire edges deduplicated while the same alert was still "
              "firing.", stats.get("suppressed", 0))
  reg.counter(p + "pruned_total",
              "Bundles pruned from the on-disk ring past keep-K.",
              stats.get("pruned", 0))
  reg.counter(p + "ship_errors_total",
              "Bundles whose shipper hand-off raised (bundle stays on "
              "disk).", stats.get("ship_errors", 0))
  reg.gauge(p + "pending", "Fire edges queued for capture.",
            stats.get("pending", 0))
  reg.gauge(p + "bundles", "Bundles resident in the on-disk ring.",
            stats.get("bundles", 0))
  reg.gauge(p + "bundle_bytes", "Bytes of bundles resident on disk.",
            stats.get("bundle_bytes", 0))
  return reg


class LifecycleIncidentTap:
  """Turn fleet-lifecycle EVENTS into incident fire/clear edges.

  The SLO engine owns alert edges on the request path; fleet-lifecycle
  incidents (a quarantine, a crash loop, a gossip peer death, an
  autoscale action) surface only in the event stream. This tap is an
  ``EventLog`` sink (tee it next to ``file_sink``): each JSON line is
  parsed and mapped onto ``IncidentRecorder.note_alert`` episodes, so
  the `/debug/incidents` ring captures ONE black-box bundle per
  lifecycle episode with the recorder's existing dedup latch:

    * ``backend_quarantined`` fires ``quarantine:{backend}`` (and
      closes any crash-loop episode — the quarantine verdict subsumes
      it); ``backend_readmit`` clears both.
    * ``backend_restart`` with ``attempt >= 2`` fires
      ``crash_loop:{backend}`` (the first restart of an episode is
      routine; the second consecutive one is a loop); a successful
      first-attempt restart clears it.
    * ``gossip_peer_failure`` fires ``gossip_peer:{peer}``;
      ``gossip_peer_recovered`` clears it.
    * ``autoscale_{up,down,abort}`` are point-in-time decisions, not
      conditions: each fires AND immediately clears a key unique per
      event (the log's own seq), so every decision captures exactly
      one bundle and can never latch.

  Parse or mapping failures are counted, never raised — a sink that
  throws would take the event log down with it.
  """

  def __init__(self, recorder: IncidentRecorder):
    self.recorder = recorder
    self.taps = 0
    self.errors = 0

  def __call__(self, line: str) -> None:
    self.sink(line)

  def sink(self, line: str) -> None:
    try:
      record = json.loads(line)
      self.note_event(record)
    except Exception:  # noqa: BLE001 - sinks must never throw upward
      self.errors += 1

  def note_event(self, record: dict) -> None:
    kind = record.get("kind")
    note = self.recorder.note_alert
    if kind == "backend_quarantined":
      backend = record.get("backend")
      note(f"crash_loop:{backend}", firing=False)
      note(f"quarantine:{backend}", firing=True, details=record)
    elif kind == "backend_readmit":
      backend = record.get("backend")
      note(f"quarantine:{backend}", firing=False)
      note(f"crash_loop:{backend}", firing=False)
    elif kind == "backend_restart" and record.get("ok"):
      backend = record.get("backend")
      if (record.get("attempt") or 0) >= 2:
        note(f"crash_loop:{backend}", firing=True, details=record)
      else:
        note(f"crash_loop:{backend}", firing=False)
    elif kind == "gossip_peer_failure":
      note(f"gossip_peer:{record.get('peer')}", firing=True,
           details=record)
    elif kind == "gossip_peer_recovered":
      note(f"gossip_peer:{record.get('peer')}", firing=False)
    elif kind in ("autoscale_up", "autoscale_down", "autoscale_abort"):
      name = f"{kind}:{record.get('seq')}"
      note(name, firing=True, details=record)
      note(name, firing=False)
    else:
      return
    self.taps += 1
