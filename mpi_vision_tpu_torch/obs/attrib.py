"""Resource-attribution ledger: who is eating the fleet, by cell.

A copy of ``mpi_vision_tpu/obs/attrib.py`` with its imports rewritten.

The stack can say *that* the device is busy (``phase_seconds``), *that*
the queue is deep, and *that* an SLO is burning — but not **who** is
responsible. This module answers that: every completed request
accumulates its device phase-seconds (its share of the flight's
``InFlightBatch.timings`` split), queue-wait, response bytes, and
cache/edge/tile contribution into a bounded ``(scene_id x request-class x
brownout-level)`` cell. The two ROADMAP follow-ons that need the answer
— per-scene brownout ladders and the evidence-driven autoscaler — read
it from here; the incident recorder (``obs/incident.py``) freezes the
top cells into every bundle.

Bounds follow the repo's per-scene idiom (``serve/metrics.py``,
``obs/slo.py``): at most ``scene_cap`` distinct scenes, the rest folded
into ``_other`` so scene-id cardinality can never balloon the ledger.
The class dimension is the three brownout classes plus ``unlabeled``
(requests that entered below the front door), the level dimension is
the ladder's 0..4 — the whole table is a few hundred cells at worst.

**Conservation invariant**: the ledger is fed from inside
``ServeMetrics.record_request`` (requests) and from the scheduler's
flight retirement (device shares summing to exactly what
``record_batch`` added), so summed cells reconcile with the
pre-existing ``requests`` / ``phase_seconds`` totals — ``conservation``
surfaces the reconciliation, and a tier-1 pin holds it both in-process
and through the router's pool merge. Every ``mpi_serve_attrib_*``
family is **additive** (plain counters), so the cluster router's
summed ``/metrics`` aggregates a fleet-wide ledger with zero router
code — by design these names must never enter a ``NON_ADDITIVE``
drop list.

Recording is lock-cheap: one small-dict update under one lock, no
clock reads at all (latency/queue-wait are measured by the callers on
their injected clocks and handed in).
"""

from __future__ import annotations

import dataclasses
import math
import threading

from mpi_vision_tpu_torch.obs import prom

PREFIX = "mpi_serve_attrib_"

# Scene-dimension bound, same value and same ``_other`` fold as the
# per-scene tables in serve/metrics.py and obs/slo.py.
SCENE_CAP = 32
OVERFLOW_SCENE = "_other"

# Requests that never passed the brownout front door (raw scheduler
# submissions, internal warmups) — distinct from "interactive", which is
# what an *unlabelled HTTP request* normalizes to.
UNLABELED_CLASS = "unlabeled"

PHASES = ("h2d", "compute", "readback")


@dataclasses.dataclass(frozen=True)
class AttribConfig:
  """Ledger knobs (the ``serve`` CLI ``--attrib-*`` flags map 1:1)."""

  scene_cap: int = SCENE_CAP

  def __post_init__(self):
    if self.scene_cap < 1:
      raise ValueError(f"scene_cap must be >= 1, got {self.scene_cap}")


def _new_cell() -> dict:
  return {"requests": 0,
          "device_s": dict.fromkeys(PHASES, 0.0),
          "queue_wait_s": 0.0,
          "bytes_out": 0,
          "edge_hits": 0,
          "edge_warps": 0,
          "tiles_touched": 0}


def _merge_cell(into: dict, cell: dict) -> None:
  """Accumulate one cell into another (same schema) — shared by the
  ledger's totals and the router's fleet merge."""
  for key, value in cell.items():
    if key == "device_s":
      for phase, secs in value.items():
        into["device_s"][phase] = into["device_s"].get(phase, 0.0) + secs
    elif isinstance(value, (int, float)):
      into[key] = into.get(key, 0) + value


def cell_device_seconds(cell: dict) -> float:
  """A cell's total device time across phases (the ranking key)."""
  return sum((cell.get("device_s") or {}).values())


class AttribLedger:
  """Bounded per-``(scene, class, level)`` resource accounting.

  All recording methods are O(1) dict updates under one lock and are
  safe from the request path. ``reset()`` zeroes everything — it rides
  ``ServeMetrics.reset()`` so bench warmup discards ledger history
  together with the counters it must reconcile against.
  """

  def __init__(self, config: AttribConfig | None = None):
    self.config = config if config is not None else AttribConfig()
    self._lock = threading.Lock()
    self._cells: dict[tuple, dict] = {}
    self._scenes: set[str] = set()
    self.overflow_requests = 0

  def _key(self, scene_id, request_class, level) -> tuple:
    scene = str(scene_id) if scene_id is not None else "_unknown"
    if scene not in self._scenes:
      if len(self._scenes) >= self.config.scene_cap:
        scene = OVERFLOW_SCENE
      else:
        self._scenes.add(scene)
    cls = request_class if request_class else UNLABELED_CLASS
    return (scene, str(cls), int(level))

  # -- recording (request path) --------------------------------------------

  def record(self, scene_id, request_class=None, level: int = 0, *,
             device: dict | None = None, queue_wait_s: float = 0.0,
             edge: str | None = None) -> None:
    """Account one completed request into its cell.

    ``device`` is the request's share of its flight's phase split
    (``{"h2d": s, "compute": s, "readback": s}``; None for edge
    hits/warps, which never touched the device). ``edge`` is ``"hit"``
    or ``"warp"`` when the edge cache served the bytes.
    """
    with self._lock:
      key = self._key(scene_id, request_class, level)
      cell = self._cells.get(key)
      if cell is None:
        cell = self._cells[key] = _new_cell()
      if key[0] == OVERFLOW_SCENE:
        self.overflow_requests += 1
      cell["requests"] += 1
      if device:
        dev = cell["device_s"]
        for phase in PHASES:
          dev[phase] += device.get(phase, 0.0)
      if queue_wait_s > 0.0:
        cell["queue_wait_s"] += queue_wait_s
      if edge == "hit":
        cell["edge_hits"] += 1
      elif edge == "warp":
        cell["edge_warps"] += 1

  def record_bytes(self, scene_id, request_class=None, level: int = 0,
                   nbytes: int = 0) -> None:
    """Account response payload bytes (recorded after the render, so it
    is a separate O(1) touch of the same cell)."""
    if nbytes <= 0:
      return
    with self._lock:
      key = self._key(scene_id, request_class, level)
      cell = self._cells.get(key)
      if cell is None:
        cell = self._cells[key] = _new_cell()
      cell["bytes_out"] += int(nbytes)

  def record_tiles(self, scene_id, request_class=None, level: int = 0,
                   tiles: int = 0) -> None:
    """Account the source tiles a request's frustum could sample (tiled
    scenes only) — the per-request tile-tier demand signal."""
    if tiles <= 0:
      return
    with self._lock:
      key = self._key(scene_id, request_class, level)
      cell = self._cells.get(key)
      if cell is None:
        cell = self._cells[key] = _new_cell()
      cell["tiles_touched"] += int(tiles)

  def reset(self) -> None:
    with self._lock:
      self._cells.clear()
      self._scenes.clear()
      self.overflow_requests = 0

  # -- introspection -------------------------------------------------------

  def _totals_locked(self) -> dict:
    totals = _new_cell()
    for cell in self._cells.values():
      _merge_cell(totals, cell)
    return totals

  def snapshot(self, top: int | None = None,
               reference: dict | None = None) -> dict:
    """The ``/debug/attrib`` payload / ``/stats`` ``attrib`` block.

    Cells are sorted hottest-first by total device-seconds (requests
    break ties); ``top`` truncates (``cells_total`` still reports the
    full population). ``reference`` (``{"requests": n,
    "device_phase_seconds": {...}}`` from the metrics snapshot) adds
    the conservation reconciliation.
    """
    with self._lock:
      cells = [{"scene": key[0], "class": key[1], "level": key[2],
                **{k: (dict(v) if isinstance(v, dict) else v)
                   for k, v in cell.items()}}
               for key, cell in self._cells.items()]
      totals = self._totals_locked()
      overflow = self.overflow_requests
      scenes = len(self._scenes)
    cells.sort(key=lambda c: (cell_device_seconds(c), c["requests"]),
               reverse=True)
    out = {
        "cells": cells[:top] if top is not None else cells,
        "cells_total": len(cells),
        "totals": totals,
        "scenes": scenes,
        "scene_cap": self.config.scene_cap,
        "overflow_requests": overflow,
    }
    if reference is not None:
      out["conservation"] = self.conservation(
          reference.get("requests", 0),
          reference.get("device_phase_seconds") or {})
    return out

  def top_cells(self, k: int) -> list[dict]:
    """The ``k`` hottest cells by device-seconds (the incident bundle's
    "who was eating the device when it fired" slice)."""
    return self.snapshot(top=max(int(k), 0))["cells"]

  def conservation(self, requests: int, phase_seconds: dict) -> dict:
    """Reconcile cell sums against the metrics layer's own totals.

    Request counts must match exactly (both sides increment on the same
    ``record_request`` call); device seconds reconcile within float
    tolerance (each flight's phase split is divided across its batch
    and re-summed here).
    """
    with self._lock:
      totals = self._totals_locked()
    request_delta = int(requests) - totals["requests"]
    phase_ok = all(
        math.isclose(totals["device_s"][phase],
                     phase_seconds.get(phase, 0.0),
                     rel_tol=1e-6, abs_tol=1e-6)
        for phase in PHASES)
    return {
        "ok": request_delta == 0 and phase_ok,
        "ledger_requests": totals["requests"],
        "reference_requests": int(requests),
        "request_delta": request_delta,
        "ledger_device_s": dict(totals["device_s"]),
        "reference_device_s": {phase: phase_seconds.get(phase, 0.0)
                               for phase in PHASES},
    }


def merge_snapshots(snapshots) -> dict:
  """Merge several backends' ``attrib`` blocks into one fleet ledger
  (the cluster router's ``/stats`` summary). Cells with the same
  ``(scene, class, level)`` coordinates sum field-wise — the same
  aggregation the pool-summed ``/metrics`` families get for free."""
  fleet: dict[tuple, dict] = {}
  totals = _new_cell()
  overflow = 0
  backends = 0
  for snap in snapshots:
    if not snap:
      continue
    backends += 1
    overflow += snap.get("overflow_requests", 0)
    _merge_cell(totals, snap.get("totals") or {})
    for cell in snap.get("cells") or []:
      key = (cell.get("scene"), cell.get("class"), cell.get("level"))
      into = fleet.get(key)
      if into is None:
        into = fleet[key] = _new_cell()
      _merge_cell(into, cell)
  cells = [{"scene": key[0], "class": key[1], "level": key[2], **cell}
           for key, cell in fleet.items()]
  cells.sort(key=lambda c: (cell_device_seconds(c), c["requests"]),
             reverse=True)
  return {"cells": cells, "cells_total": len(cells), "totals": totals,
          "overflow_requests": overflow, "backends": backends}


def registry(snapshot: dict | None) -> prom.Registry:
  """The ``mpi_serve_attrib_*`` families (family headers always exposed,
  samples per live cell). Every family is a plain counter/additive
  gauge, so the router's pool merge sums a correct fleet ledger —
  never add one of these names to a NON_ADDITIVE drop set."""
  snap = snapshot or {}
  reg = prom.Registry()
  p = PREFIX
  req_m = reg.counter(
      p + "requests_total",
      "Completed requests per attribution cell, labels scene / class / "
      "level. Cell sums reconcile with mpi_serve_requests_total "
      "(conservation invariant).")
  dev_m = reg.counter(
      p + "device_seconds_total",
      "Device time attributed per cell, labels scene / class / level / "
      "phase (h2d | compute | readback). Cell sums reconcile with "
      "mpi_serve_device_phase_seconds_total.")
  wait_m = reg.counter(
      p + "queue_wait_seconds_total",
      "Scheduler queue wait attributed per cell (enqueue to dispatch).")
  bytes_m = reg.counter(
      p + "bytes_out_total",
      "Response payload bytes attributed per cell.")
  edge_m = reg.counter(
      p + "edge_serves_total",
      "Requests a cell answered from the edge frame cache instead of "
      "the device, label kind=hit | warp.")
  tiles_m = reg.counter(
      p + "tiles_touched_total",
      "Source tiles the cell's request frusta could sample (tiled "
      "scenes).")
  for cell in snap.get("cells") or []:
    labels = {"scene": cell["scene"], "class": cell["class"],
              "level": str(cell["level"])}
    req_m.sample(cell["requests"], labels)
    for phase in PHASES:
      secs = (cell.get("device_s") or {}).get(phase, 0.0)
      dev_m.sample(secs, {**labels, "phase": phase})
    wait_m.sample(cell.get("queue_wait_s", 0.0), labels)
    bytes_m.sample(cell.get("bytes_out", 0), labels)
    edge_m.sample(cell.get("edge_hits", 0), {**labels, "kind": "hit"})
    edge_m.sample(cell.get("edge_warps", 0), {**labels, "kind": "warp"})
    tiles_m.sample(cell.get("tiles_touched", 0), labels)
  reg.counter(p + "overflow_requests_total",
              "Requests folded into the _other scene past the scene "
              "cap.", snap.get("overflow_requests", 0))
  reg.gauge(p + "cells", "Attribution cells resident in the ledger.",
            snap.get("cells_total", 0))
  return reg
