"""Off-host telemetry shipping: batches, retries, and a disk spool.

A copy of ``mpi_vision_tpu/obs/ship.py`` with its imports rewritten.

On-box telemetry dies with the box. The shipper is the flight
recorder's off-host leg: a daemon thread that periodically batches

  * **rotated event-log segments** — the ``FILE.1 .. FILE.<keep>`` files
    ``obs.events.file_sink`` rotation produces, which are invisible to
    the ``/debug/events`` ring (the retention blind spot): each shipped
    segment is deleted locally, so rotation only ever *drops* a segment
    the sink outlasted;
  * **SLO alert edges** — every fire/clear record, queued by the serving
    layer off the request path;
  * **incremental tsdb snapshots** — every series' points since the last
    successful ship (``obs.tsdb.TsdbRecorder.snapshot_since``),

and POSTs them as one JSON body to a configured HTTP sink. Failures ride
the existing ``serve.resilience.RetryPolicy`` (bounded exponential
backoff); a batch that still cannot be delivered spools to disk under a
byte budget (oldest spool file dropped when over it, counted) and drains
oldest-first when the sink recovers — a sink outage shorter than the
spool budget loses nothing. Everything is counted
(``mpi_obs_ship_*``), nothing is fatal, and none of it ever runs on the
request path (``note_alert`` is a lock-guarded deque append).

Clock, sleep, and transport are injectable (clock-lint covers this
file); tests drive ``tick()`` directly against a fake sink.
"""

from __future__ import annotations

import dataclasses
import functools
import http.client
import json
import os
import random
import re
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from mpi_vision_tpu_torch.obs import prom
from mpi_vision_tpu_torch.serve.resilience import RetryPolicy

PREFIX = "mpi_obs_ship_"

# Alert edges retained while the sink is down and the spool is off; past
# this the OLDEST edges drop (counted) — the ring bound, like the event
# log's.
MAX_PENDING_ALERTS = 256

# Claimed-but-undelivered event-log segments retained on disk during a
# sink outage. Claiming frees rotation's FILE.N slots, so without a cap
# a long outage under a busy event stream would grow FILE.ship.* without
# bound — the exact disk bound events_keep existed to provide. Past it
# the OLDEST claims drop (counted): newest telemetry survives, the
# outage window is bounded.
MAX_CLAIMED_SEGMENTS = 32

# Incident bundles retained in memory between ticks. Bundles are big
# (a frozen tsdb window each) and rare (one per fire edge, deduplicated
# by the recorder) — a deep backlog here would mean the interval is
# longer than the incident cadence, and the recorder's own disk ring
# still holds everything this cap sheds.
MAX_PENDING_INCIDENTS = 8


@dataclasses.dataclass(frozen=True)
class ShipConfig:
  """Shipper knobs (the ``serve`` CLI ``--ship-*`` flags map 1:1).

  ``url`` is the HTTP sink (POST, JSON body). ``spool_dir`` enables the
  disk spool (None: undeliverable batches drop, counted);
  ``spool_budget_bytes`` bounds it. ``events_path``/``events_keep``
  point at the event-log JSONL file whose rotated segments the shipper
  picks up (empty: no segment shipping).
  """

  url: str
  interval_s: float = 10.0
  timeout_s: float = 5.0
  spool_dir: str | None = None
  spool_budget_bytes: int = 64 << 20
  events_path: str | None = None
  events_keep: int = 3
  retry: RetryPolicy = RetryPolicy(max_retries=2, backoff_base_s=0.2,
                                   backoff_max_s=2.0)

  def __post_init__(self):
    if not self.url:
      raise ValueError("ShipConfig.url must be set")
    if self.interval_s <= 0:
      raise ValueError(f"interval_s must be > 0, got {self.interval_s}")
    if self.timeout_s <= 0:
      raise ValueError(f"timeout_s must be > 0, got {self.timeout_s}")
    if self.spool_budget_bytes <= 0:
      raise ValueError(
          f"spool_budget_bytes must be > 0, got {self.spool_budget_bytes}")
    if self.events_keep < 1:
      raise ValueError(f"events_keep must be >= 1, got {self.events_keep}")


class HttpPostTransport:
  """The default shipper->sink transport (stdlib urllib, no deps).

  ``post`` returns the HTTP status for any completed conversation and
  raises ``ConnectionError`` when none happened (refused, reset, DNS,
  timeout) — same contract as the cluster router's transport.
  """

  def post(self, url: str, body: bytes, timeout: float) -> int:
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/json"})
    try:
      with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status
    except urllib.error.HTTPError as e:
      with e:
        return e.code
    except (urllib.error.URLError, ConnectionError, TimeoutError,
            OSError, http.client.HTTPException) as e:
      # HTTPException (BadStatusLine, IncompleteRead, ...) is NOT an
      # OSError: a half-dead sink writing a garbled response must look
      # like a down sink (retry, then spool) — the same mapping the
      # cluster router's transport makes. Letting it escape would drop
      # the batch's already-drained alert edges with only a tick_error.
      raise ConnectionError(str(e) or repr(e)) from e


class TelemetryShipper:
  """Batches telemetry to an HTTP sink with retry + disk spool.

  Args:
    config: sink/spool/cadence knobs.
    tsdb: optional ``obs.tsdb.TsdbRecorder`` whose incremental snapshots
      ride each batch.
    transport: injectable sink transport (tests); default urllib POST.
    clock: wall-clock source for batch timestamps and the tsdb cursor.
    sleep: injectable retry-backoff sleep.
  """

  def __init__(self, config: ShipConfig, tsdb=None, transport=None,
               clock=time.time, sleep=time.sleep, seed: int = 0):
    self.config = config
    self.tsdb = tsdb
    self.transport = transport if transport is not None \
        else HttpPostTransport()
    self._clock = clock
    self._sleep = sleep
    self._rng = random.Random(seed)
    self._lock = threading.Lock()
    self._pending_alerts: deque = deque(maxlen=MAX_PENDING_ALERTS)
    self._pending_incidents: deque = deque(maxlen=MAX_PENDING_INCIDENTS)
    self._alerts_dropped_marker = 0
    self._stop = threading.Event()
    self._thread: threading.Thread | None = None
    self._spool_seq = 0
    self._last_tsdb_ts: float | None = None
    self.batches_shipped = 0
    self.posts = 0
    self.post_failures = 0
    self.retries = 0
    self.alert_edges = 0
    self.alert_edges_dropped = 0
    self.incident_bundles = 0
    self.incident_bundles_dropped = 0
    self.segments_shipped = 0
    self.segments_dropped = 0
    self.segment_errors = 0
    self.spooled = 0
    self.spool_dropped = 0
    self.tick_errors = 0
    # In-memory spool accounting: stats() feeds every /metrics render
    # (and every tsdb sample), which must not pay a directory walk +
    # per-file stat per scrape during exactly the outage that fills the
    # spool. Kept in sync by _spool/_drain_spool; seeded by one scan.
    self._spool_file_count = 0
    self._spool_bytes = 0
    if config.spool_dir:
      os.makedirs(config.spool_dir, exist_ok=True)
    # Resume the sequence past anything a previous process left behind
    # (spooled batches AND claimed segments): restarting at 1 would
    # os.replace OVER them — losing exactly the telemetry the spool/
    # claim files exist to preserve — and break the oldest-first order.
    for path in self._spool_files():
      name = os.path.basename(path)
      try:
        self._spool_seq = max(self._spool_seq,
                              int(name[len("spool-"):-len(".json")]))
      except ValueError:
        continue
      self._spool_file_count += 1
      try:
        self._spool_bytes += os.path.getsize(path)
      except OSError:
        pass
    for path in self._claimed_paths():
      try:
        self._spool_seq = max(self._spool_seq,
                              int(path.rpartition(".ship.")[2]))
      except ValueError:
        continue

  # -- inputs (never the request path's problem) ---------------------------

  def note_alert(self, record: dict) -> None:
    """Queue one SLO alert edge for the next batch (O(1), lock-guarded
    append — safe to call from the alert callback path)."""
    with self._lock:
      if len(self._pending_alerts) == self._pending_alerts.maxlen:
        self.alert_edges_dropped += 1
      self._pending_alerts.append(dict(record))
      self.alert_edges += 1

  def note_incident(self, bundle: dict) -> None:
    """Queue one incident bundle (``obs.incident``) for the next batch.

    Bundles ride the same batch -> retry -> disk-spool arc as alert
    edges, so a sink outage shorter than the spool budget loses none of
    them and recovery drains them in capture order. O(1) append — the
    recorder's daemon worker calls this, never the request path."""
    with self._lock:
      if len(self._pending_incidents) == self._pending_incidents.maxlen:
        self.incident_bundles_dropped += 1
      self._pending_incidents.append(bundle)
      self.incident_bundles += 1

  # -- shipping ------------------------------------------------------------

  def _post_with_retry(self, body: bytes) -> bool:
    """One delivery attempt arc through the RetryPolicy; True = landed."""
    policy = self.config.retry
    attempt = 0
    while True:
      with self._lock:
        self.posts += 1
      try:
        status = self.transport.post(self.config.url, body,
                                     self.config.timeout_s)
        if 200 <= status < 300:
          return True
      except Exception:  # noqa: BLE001 - ANY transport failure is "sink
        # down": the batch's alert edges are already drained, so an
        # exception escaping here (instead of retry -> spool) would be
        # silent telemetry loss counted only as a tick_error.
        pass
      with self._lock:
        self.post_failures += 1
      attempt += 1
      if attempt > policy.max_retries:
        return False
      with self._lock:
        self.retries += 1
      self._sleep(policy.backoff_s(attempt, self._rng))

  # -- spool ---------------------------------------------------------------

  def _spool_files(self) -> list[str]:
    if not self.config.spool_dir:
      return []
    try:
      names = sorted(n for n in os.listdir(self.config.spool_dir)
                     if n.startswith("spool-") and n.endswith(".json"))
    except OSError:
      return []
    return [os.path.join(self.config.spool_dir, n) for n in names]

  def _spool(self, body: bytes) -> bool:
    """Persist one undeliverable batch; oldest files drop past the byte
    budget (a bounded spool that refuses new data would lose the NEWEST
    telemetry — exactly the window an operator wants)."""
    if not self.config.spool_dir:
      return False
    with self._lock:
      self._spool_seq += 1
      seq = self._spool_seq
    path = os.path.join(self.config.spool_dir, f"spool-{seq:08d}.json")
    try:
      tmp = path + ".tmp"
      with open(tmp, "wb") as fh:
        fh.write(body)
      os.replace(tmp, path)
    except OSError:
      return False
    with self._lock:
      self.spooled += 1
      self._spool_file_count += 1
      self._spool_bytes += len(body)
    files = self._spool_files()
    total = 0
    sizes = {}
    for f in files:
      try:
        sizes[f] = os.path.getsize(f)
        total += sizes[f]
      except OSError:
        continue
    # Never evict the file just written (files[-1], highest seq): the
    # True return tells tick() the batch is covered and the cursor
    # advances — evicting it here would silently lose exactly that
    # window. A single batch larger than the whole budget overshoots it
    # by one batch, bounded.
    for f in files[:-1]:
      if total <= self.config.spool_budget_bytes:
        break
      try:
        os.remove(f)
        total -= sizes.get(f, 0)
        with self._lock:
          self.spool_dropped += 1
          self._spool_file_count -= 1
          self._spool_bytes -= sizes.get(f, 0)
      except OSError:
        pass
    return True

  def _drain_spool(self) -> None:
    """Replay spooled batches oldest-first; stop at the first failure
    (the sink is still down — retrying the rest only burns backoff)."""
    for path in self._spool_files():
      try:
        body = open(path, "rb").read()
      except OSError:
        continue
      if not self._post_with_retry(body):
        return
      with self._lock:
        self.batches_shipped += 1
      try:
        os.remove(path)
        with self._lock:
          self._spool_file_count -= 1
          self._spool_bytes -= len(body)
      except OSError:
        pass

  # -- event-log segments --------------------------------------------------

  def _segment_paths(self) -> list[str]:
    """Rotated event-log segments, oldest first (``FILE.<keep>`` is the
    next to be dropped by rotation, so it ships first)."""
    if not self.config.events_path:
      return []
    out = []
    for i in range(self.config.events_keep, 0, -1):
      path = f"{self.config.events_path}.{i}"
      if os.path.exists(path):
        out.append(path)
    return out

  def _claimed_paths(self) -> list[str]:
    """Segments already claimed (renamed ``FILE.ship.N``) but not yet
    delivered — a previous tick's sink outage, or a crashed process."""
    if not self.config.events_path:
      return []
    directory = os.path.dirname(self.config.events_path) or "."
    prefix = os.path.basename(self.config.events_path) + ".ship."
    try:
      names = sorted(n for n in os.listdir(directory)
                     if n.startswith(prefix))
    except OSError:
      return []
    return [os.path.join(directory, n) for n in names]

  def pending_segments(self) -> int:
    """Rotated (or claimed-but-undelivered) segments still on disk."""
    return len(self._segment_paths()) + len(self._claimed_paths())

  def _claim_segments(self) -> list[str]:
    """Atomically rename each rotated segment out of rotation's
    namespace (``FILE.N`` -> ``FILE.ship.<seq>``) BEFORE shipping it.

    Rotation only ever touches ``FILE.1..FILE.<keep>``, so once claimed
    a segment can neither be overwritten by a rotation that happens
    mid-POST nor — the race this protocol exists to kill — deleted by
    name after rotation already put a NEWER, unshipped segment at that
    name. A claim that fails (rotation won the rename) just means the
    file moved; it is picked up next tick.
    """
    claimed = []
    for path in self._segment_paths():
      with self._lock:
        self._spool_seq += 1
        seq = self._spool_seq
      target = f"{self.config.events_path}.ship.{seq:08d}"
      try:
        os.replace(path, target)
      except OSError:
        continue
      claimed.append(target)
    # Bound the claim backlog (see MAX_CLAIMED_SEGMENTS): drop oldest.
    backlog = self._claimed_paths()
    for path in backlog[:max(len(backlog) - MAX_CLAIMED_SEGMENTS, 0)]:
      try:
        os.remove(path)
        with self._lock:
          self.segments_dropped += 1
      except OSError:
        pass
    return claimed

  def _ship_segments(self) -> None:
    """Ship each claimed segment as its own POST and delete it locally —
    once the bytes are off-host, the rotation slot is free and the
    retention blind spot closes. Undelivered claims stay on disk for the
    next tick (they survive restarts too). Claiming (and its backlog
    trim) runs BEFORE the listing, so the iteration never holds paths
    the trim just deleted (which would double-book every trimmed
    segment as a segment_error)."""
    self._claim_segments()
    for path in self._claimed_paths():
      try:
        content = open(path, "r", errors="replace").read()
      except OSError:
        with self._lock:
          self.segment_errors += 1
        continue
      body = json.dumps({
          "kind": "mpi_events_segment",
          "segment": os.path.basename(path),
          "sent_at": round(self._clock(), 3),
          "lines": content.count("\n"),
          "content": content,
      }).encode()
      if not self._post_with_retry(body):
        return  # sink down: claimed segments wait for the next tick
      with self._lock:
        self.segments_shipped += 1
      try:
        os.remove(path)
      except OSError:
        with self._lock:
          self.segment_errors += 1

  # -- the periodic cycle --------------------------------------------------

  def _build_batch(self) -> tuple[bytes | None, float | None]:
    """One batch plus the tsdb cursor it covers.

    The cursor is derived from the points actually INCLUDED, never a
    fresh clock read: a sampler sweep that stamped its timestamp before
    this ran but appended after would fall between a clock-read cursor
    and the snapshot — skipped forever. Specifically it is the MINIMUM
    over series of each series' last shipped timestamp: when per-series
    truncation held some series back, a max would strand their
    remainder behind the cursor; the min re-ships a few already-sent
    points instead (duplicates are fine for a collector, loss is not).
    Batches with no tsdb item leave the cursor alone.
    """
    now = round(self._clock(), 3)
    with self._lock:
      alerts = list(self._pending_alerts)
      self._pending_alerts.clear()
      incidents = list(self._pending_incidents)
      self._pending_incidents.clear()
      tsdb_cursor = self._last_tsdb_ts
    cursor = tsdb_cursor
    items: list[dict] = []
    if alerts:
      items.append({"kind": "slo_alert_edges", "edges": alerts})
    if incidents:
      items.append({"kind": "incidents", "bundles": incidents})
    if self.tsdb is not None:
      families = self.tsdb.snapshot_since(tsdb_cursor)
      if families:
        items.append({"kind": "tsdb", "since": tsdb_cursor,
                      "families": families})
        cursor = min(series["points"][-1][0]
                     for series_list in families.values()
                     for series in series_list)
    if not items:
      return None, cursor
    return json.dumps({"kind": "mpi_telemetry", "sent_at": now,
                       "items": items}).encode(), cursor

  def tick(self) -> None:
    """One shipping cycle: drain the spool, ship rotated segments, ship
    the current batch (spooling it on failure). Never raises."""
    try:
      self._drain_spool()
      self._ship_segments()
      body, cursor = self._build_batch()
      if body is None:
        return
      if self._post_with_retry(body):
        with self._lock:
          self.batches_shipped += 1
          self._last_tsdb_ts = cursor
      elif self._spool(body):
        # Spooled: the batch's tsdb points are covered (they reach the
        # sink on drain) — advance the cursor so recovery does not
        # double-ship them.
        with self._lock:
          self._last_tsdb_ts = cursor
      else:
        # Neither delivered nor spooled (spool off or unwritable): the
        # batch is gone but its tsdb points still sit in the ring —
        # leave the cursor so the next tick re-ships them for free.
        # Only the alert edges are truly lost, counted here.
        with self._lock:
          self.spool_dropped += 1
    except Exception:  # noqa: BLE001 - shipping must never kill its thread
      with self._lock:
        self.tick_errors += 1

  def _loop(self) -> None:
    while not self._stop.wait(self.config.interval_s):
      self.tick()

  def start(self) -> "TelemetryShipper":
    if self._thread is not None:
      raise RuntimeError("TelemetryShipper already started")
    self._thread = threading.Thread(target=self._loop,
                                    name="mpi-obs-ship", daemon=True)
    self._thread.start()
    return self

  def stop(self) -> None:
    self._stop.set()
    if self._thread is not None:
      self._thread.join(5.0)
      self._thread = None

  # -- introspection -------------------------------------------------------

  def stats(self) -> dict:
    with self._lock:
      return {
          "url": self.config.url,
          "interval_s": self.config.interval_s,
          "batches_shipped": self.batches_shipped,
          "posts": self.posts,
          "post_failures": self.post_failures,
          "retries": self.retries,
          "alert_edges": self.alert_edges,
          "alert_edges_dropped": self.alert_edges_dropped,
          "alert_edges_pending": len(self._pending_alerts),
          "incident_bundles": self.incident_bundles,
          "incident_bundles_dropped": self.incident_bundles_dropped,
          "incident_bundles_pending": len(self._pending_incidents),
          "segments_shipped": self.segments_shipped,
          "segments_dropped": self.segments_dropped,
          "segment_errors": self.segment_errors,
          "spooled": self.spooled,
          "spool_dropped": self.spool_dropped,
          "spool_files": self._spool_file_count,
          "spool_bytes": self._spool_bytes,
          "tick_errors": self.tick_errors,
      }


def registry(stats: dict | None) -> prom.Registry:
  """The ``mpi_obs_ship_*`` families (zeros while shipping is off — the
  always-exposed convention)."""
  stats = stats or {}
  reg = prom.Registry()
  p = PREFIX
  reg.counter(p + "batches_total", "Telemetry batches delivered to the "
              "sink (spool replays included).",
              stats.get("batches_shipped", 0))
  reg.counter(p + "posts_total", "HTTP POST attempts against the sink.",
              stats.get("posts", 0))
  reg.counter(p + "failures_total",
              "POST attempts that failed (transport error or non-2xx).",
              stats.get("post_failures", 0))
  reg.counter(p + "retries_total",
              "Backoff retries inside delivery arcs.",
              stats.get("retries", 0))
  reg.counter(p + "alert_edges_total", "SLO alert edges queued for "
              "shipping.", stats.get("alert_edges", 0))
  reg.counter(p + "alert_edges_dropped_total",
              "Alert edges dropped from the pending ring while the sink "
              "was down.", stats.get("alert_edges_dropped", 0))
  reg.counter(p + "incident_bundles_total",
              "Incident bundles queued for shipping (obs.incident).",
              stats.get("incident_bundles", 0))
  reg.counter(p + "incident_bundles_dropped_total",
              "Incident bundles dropped from the pending ring (the "
              "recorder's disk ring still holds them).",
              stats.get("incident_bundles_dropped", 0))
  reg.counter(p + "segments_shipped_total",
              "Rotated event-log segments delivered and deleted locally.",
              stats.get("segments_shipped", 0))
  reg.counter(p + "segments_dropped_total",
              "Claimed segments dropped past the claim-backlog bound "
              "during a long sink outage.",
              stats.get("segments_dropped", 0))
  reg.counter(p + "spooled_total",
              "Batches written to the disk spool during sink outages.",
              stats.get("spooled", 0))
  reg.counter(p + "spool_dropped_total",
              "Batches dropped past the spool byte budget (or with the "
              "spool disabled).", stats.get("spool_dropped", 0))
  reg.counter(p + "segment_errors_total",
              "Segment reads/deletes that failed (I/O).",
              stats.get("segment_errors", 0))
  reg.counter(p + "tick_errors_total",
              "Shipping cycles that raised (the never-fatal backstop — "
              "a climbing value means the shipper is broken, not the "
              "sink).", stats.get("tick_errors", 0))
  reg.gauge(p + "spool_bytes", "Bytes waiting in the disk spool.",
            stats.get("spool_bytes", 0))
  reg.gauge(p + "spool_files", "Batches waiting in the disk spool.",
            stats.get("spool_files", 0))
  return reg


class _SinkHandler(BaseHTTPRequestHandler):
  """The collector side of the shipping contract: accept one POSTed
  JSON batch, durably write it to the sink directory (temp file +
  atomic rename, the repo-wide publish idiom), and only then answer
  2xx — the shipper deletes segments on 2xx, so an early OK would be
  the one way this pipeline could lose telemetry."""

  def __init__(self, sink: "ShipSink", *args, **kwargs):
    self.sink = sink
    super().__init__(*args, **kwargs)

  def log_message(self, fmt, *args):  # noqa: A003 - stdlib signature
    pass

  def _send(self, body: bytes, status: int = 200) -> None:
    try:
      self.send_response(status)
      self.send_header("Content-Type", "application/json")
      self.send_header("Content-Length", str(len(body)))
      self.end_headers()
      self.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError):
      self.close_connection = True

  def do_GET(self):  # noqa: N802 - stdlib name
    if self.path == "/healthz":
      self._send(json.dumps({"status": "ok", "role": "ship-sink",
                             **self.sink.stats()}).encode())
    elif self.path == "/stats":
      self._send(json.dumps(self.sink.stats()).encode())
    else:
      self._send(json.dumps({"error": f"unknown path {self.path}"}).encode(),
                 status=404)

  def do_POST(self):  # noqa: N802 - stdlib name
    try:
      length = int(self.headers.get("Content-Length", "0"))
    except ValueError:
      self._send(json.dumps({"error": "bad Content-Length"}).encode(),
                 status=400)
      return
    if length <= 0 or length > self.sink.max_body_bytes:
      self._send(json.dumps(
          {"error": f"body must be 1..{self.sink.max_body_bytes} "
                    "bytes"}).encode(), status=413 if length > 0 else 400)
      return
    body = self.rfile.read(length)
    try:
      json.loads(body)
    except ValueError:
      self.sink.note_reject()
      self._send(json.dumps({"error": "body is not JSON"}).encode(),
                 status=400)
      return
    try:
      path = self.sink.accept(body)
    except OSError as e:
      # Disk trouble must read as a delivery failure so the shipper
      # retries/spools — a 2xx here would delete the only copy.
      self._send(json.dumps({"error": f"sink write failed: {e}"}).encode(),
                 status=503)
      return
    self._send(json.dumps({"ok": True, "stored": os.path.basename(path)})
               .encode())


class ShipSink:
  """A directory-backed batch store for the collector CLI (`ship-sink`).

  Each accepted batch lands as ``batch-NNNNNNNN.json`` (monotonic
  sequence, atomic rename). Resuming over an existing directory
  continues the numbering after the highest resident file, so restarts
  never overwrite delivered telemetry.
  """

  def __init__(self, directory: str, max_body_bytes: int = 8 << 20):
    self.directory = os.path.abspath(directory)
    os.makedirs(self.directory, exist_ok=True)
    self.max_body_bytes = int(max_body_bytes)
    self._lock = threading.Lock()
    self.received = 0
    self.rejected = 0
    self.bytes_received = 0
    seqs = [int(m.group(1)) for m in
            (re.match(r"batch-(\d+)\.json$", name)
             for name in os.listdir(self.directory)) if m]
    self._seq = max(seqs, default=0)

  def note_reject(self) -> None:
    with self._lock:
      self.rejected += 1

  def accept(self, body: bytes) -> str:
    """Durably store one batch; returns its path (raises OSError on
    disk failure — the handler maps that to a retryable 503)."""
    with self._lock:
      self._seq += 1
      seq = self._seq
    path = os.path.join(self.directory, f"batch-{seq:08d}.json")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
      f.write(body)
      f.flush()
      os.fsync(f.fileno())
    os.replace(tmp, path)
    with self._lock:
      self.received += 1
      self.bytes_received += len(body)
    return path

  def stats(self) -> dict:
    with self._lock:
      return {"dir": self.directory, "received": self.received,
              "rejected": self.rejected,
              "bytes_received": self.bytes_received,
              "next_seq": self._seq + 1}


def make_sink_server(directory: str, host: str = "127.0.0.1",
                     port: int = 0) -> "tuple[ThreadingHTTPServer, ShipSink]":
  """A ready-to-``serve_forever`` threaded collector for the shipper's
  POSTed batches (the ``ship-sink`` CLI's engine). Port 0 = ephemeral;
  the bound port is ``server.server_address[1]``."""
  sink = ShipSink(directory)
  handler = functools.partial(_SinkHandler, sink)
  server = ThreadingHTTPServer((host, port), handler)
  server.daemon_threads = True
  return server, sink
