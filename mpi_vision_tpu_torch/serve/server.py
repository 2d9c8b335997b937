"""Serving front ends: in-process service + stdlib HTTP server.

PyTorch counterpart of the core of ``mpi_vision_tpu/serve/server.py``.
``RenderService`` wires cache + engine + scheduler + metrics into one
object with a pure-Python API; ``make_http_server`` wraps a service in a
threaded stdlib ``http.server`` front end:

  GET  /healthz -> {"status": "ok" | "degraded" | "unhealthy", "devices",
                   "platform", "scenes", ...}
  GET  /stats   -> the metrics snapshot (latency percentiles, throughput,
                   batch-size histogram, queue depth, cache hit rate,
                   pipeline, engine, breaker)
  GET  /debug/traces -> recent + slowest-N finished request traces
                   (?id=<trace_id> returns just that id's records)
  POST /render  -> body {"scene_id": str, "pose": [[...4x4...]]} ->
                   {"scene_id", "shape", "dtype", "image_b64"} — raw
                   little-endian f32 pixels, base64 (shape [H, W, 3]).
                   ``Accept: application/octet-stream`` returns the raw
                   pixels instead, with ``X-Image-Shape`` and
                   ``X-Image-Dtype`` headers. Every response carries an
                   ``X-Trace-Id`` header (a valid inbound W3C
                   ``traceparent``'s trace-id is honoured).

Scenes register host-side (``add_scene``) and bake lazily through the LRU
cache on first request. 404 for unknown scenes, 400 for malformed
requests, 503 when the scheduler sheds load or the circuit breaker is
open; handler threads block on the scheduler future, so HTTP concurrency
turns into micro-batch coalescing on the device.
"""

from __future__ import annotations

import base64
import functools
import json
import math
import re
import threading
import time
import urllib.parse
import zlib
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from mpi_vision_tpu_torch.core import camera
from mpi_vision_tpu_torch.core.sampling import Convention
from mpi_vision_tpu_torch.obs.trace import (
    NULL_TRACE,
    NULL_TRACER,
    Tracer,
    new_trace_id,
)
from mpi_vision_tpu_torch.serve import cache as cache_mod
from mpi_vision_tpu_torch.serve.engine import RenderEngine
from mpi_vision_tpu_torch.serve.metrics import ServeMetrics
from mpi_vision_tpu_torch.serve.resilience import (
    CircuitBreaker,
    CircuitOpenError,
    ResilienceConfig,
    ResilientExecutor,
    TransientDeviceError,
)
from mpi_vision_tpu_torch.serve.scheduler import MicroBatcher, QueueFullError


def synthetic_scene(scene_id: str, height: int = 256, width: int = 256,
                    planes: int = 16, seed: int = 0):
  """A procedural (rgba_layers, depths, intrinsics) scene for demos/load.

  Smooth per-plane color gradients with sparse alpha, seeded by
  ``(seed, scene_id)`` — the JAX package's recipe, so both packages make
  the same scene from the same seed.
  """
  rng = np.random.default_rng([seed, zlib.crc32(str(scene_id).encode())])
  yy, xx = np.meshgrid(np.linspace(0, 1, height, dtype=np.float32),
                       np.linspace(0, 1, width, dtype=np.float32),
                       indexing="ij")
  layers = np.empty((height, width, planes, 4), np.float32)
  for p in range(planes):
    phase = rng.uniform(0, 2 * np.pi, 3)
    freq = rng.uniform(1.0, 4.0, 3)
    for c in range(3):
      layers[..., p, c] = 0.5 + 0.5 * np.sin(
          freq[c] * (xx + yy) * np.pi + phase[c])
    alpha = 0.5 + 0.5 * np.sin(freq[0] * xx * 7 + phase[0] + p)
    layers[..., p, 3] = np.clip(alpha - 0.3, 0.0, 1.0)
  depths = camera.inv_depths(1.0, 100.0, planes).numpy()
  fx = 0.5 * width
  k = camera.intrinsics_matrix(fx, fx, width / 2.0, height / 2.0).numpy()
  return layers, depths, k


class RenderService:
  """The in-process serving API (the HTTP layer is a thin shell on this).

  Args:
    cache_bytes: scene-cache byte budget.
    max_batch / max_wait_ms: micro-batching knobs (scheduler.py).
    max_inflight: streaming-pipeline window (scheduler.py): concurrent
      flights whose upload/render/readback overlap and whose futures
      complete out of dispatch order; 1 = blocking dispatch. ``"auto"``
      starts at 2 and grows while growing keeps shrinking the dispatch
      gap, capped at ``max_inflight_cap``.
    max_inflight_cap: hard ceiling for ``max_inflight="auto"``.
    method: render method (engine.py); 'fused_pallas', the CUDA kernel, by
      default.
    convention: coordinate convention for the engine (None keeps the
      engine default, the reference's REF_HOMOGRAPHY). Non-square scenes
      — 1080p included — should pass ``Convention.EXACT``: the reference
      convention's axis swap is only benign on square frames.
    device: "cuda" (default) or "cpu"; with no CUDA device the service
      raises unless the caller passes "cpu". Ignored with ``engine``.
    max_queue: pending-request cap; beyond it requests shed with 503.
    engine: explicit engine override (tests).
    resilience: retry/breaker/watchdog knobs (resilience.py); None turns
      the resilience layer off.
    tracer: request tracing (obs/trace.py); None is the no-op tracer.
    clock: injectable monotonic clock for the scheduler's deadlines.
  """

  def __init__(self, cache_bytes: int = 2 << 30, max_batch: int = 8,
               max_wait_ms: float = 2.0, max_inflight: "int | str" = 4,
               max_inflight_cap: int = 16, method: str = "fused_pallas",
               convention: "Convention | None" = None, device="cuda",
               max_queue: int = 1024, engine: RenderEngine | None = None,
               resilience: ResilienceConfig | None = ResilienceConfig(),
               tracer: Tracer | None = None, clock=time.monotonic):
    adaptive_inflight = max_inflight == "auto"
    if adaptive_inflight:
      if max_inflight_cap < 2:
        raise ValueError(
            f"max_inflight_cap must be >= 2 for auto, got {max_inflight_cap}")
      max_inflight = 2  # the adaptive starting window
    elif isinstance(max_inflight, str):
      raise ValueError(
          f"max_inflight must be an int or 'auto', got {max_inflight!r}")
    elif max_inflight < 1:
      raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
    # The engine's own window must not be the bottleneck under retries
    # (an abandoned attempt can briefly hold a slot next to its retry's)
    # nor under adaptive growth (size it for the cap, not the start).
    engine_window = max_inflight_cap if adaptive_inflight else max_inflight
    engine_kw = {} if convention is None else {"convention": convention}
    self.engine = engine if engine is not None else RenderEngine(
        method=method, device=device,
        max_inflight=max(8, 2 * engine_window), **engine_kw)
    self.cache = cache_mod.SceneCache(byte_budget=cache_bytes)
    self.metrics = ServeMetrics()
    self.tracer = tracer if tracer is not None else NULL_TRACER
    self.resilient = None if resilience is None else ResilientExecutor(
        resilience, metrics=self.metrics)
    self._scene_data: dict[str, tuple] = {}
    self._scene_lock = threading.Lock()
    self.scheduler = MicroBatcher(
        self.engine, self._get_scene, metrics=self.metrics,
        max_batch=max_batch, max_wait_ms=max_wait_ms,
        max_queue=max_queue, max_inflight=max_inflight,
        adaptive_inflight=adaptive_inflight,
        max_inflight_cap=max_inflight_cap if adaptive_inflight else None,
        resilient=self.resilient, clock=clock).start()
    self._closed = False

  def add_scene(self, scene_id: str, rgba_layers, depths,
                intrinsics) -> None:
    """Register a scene (host arrays); it bakes lazily on first request.
    Re-registering an id drops its baked copy."""
    entry = (np.asarray(rgba_layers, np.float32),
             np.asarray(depths, np.float32),
             np.asarray(intrinsics, np.float32))
    sid = str(scene_id)
    with self._scene_lock:
      self._scene_data[sid] = entry
    self.cache.invalidate(sid)

  def add_synthetic_scenes(self, n: int, height: int = 256, width: int = 256,
                           planes: int = 16, seed: int = 0) -> list[str]:
    ids = []
    for i in range(n):
      sid = f"scene_{i:03d}"
      self.add_scene(sid, *synthetic_scene(sid, height, width, planes,
                                           seed=seed + i))
      ids.append(sid)
    return ids

  def scene_ids(self) -> list[str]:
    with self._scene_lock:
      return sorted(self._scene_data)

  def _get_scene(self, scene_id: str) -> cache_mod.BakedScene:
    def bake():
      with self._scene_lock:
        entry = self._scene_data.get(scene_id)
      if entry is None:
        raise KeyError(f"unknown scene {scene_id!r}")
      return cache_mod.bake_scene(scene_id, *entry,
                                  device=self.engine.device)

    return self.cache.get_or_bake(scene_id, bake)

  def warmup(self, scene_ids=None) -> None:
    """Bake scenes (default: all registered) and render every batch
    bucket up to the scheduler's ``max_batch`` once on the first, so the
    kernel is built and the pinned buffers are allocated before traffic."""
    ids = list(scene_ids) if scene_ids is not None else self.scene_ids()
    if not ids:
      return
    scenes = [self._get_scene(sid) for sid in ids]
    eye = np.eye(4, dtype=np.float32)
    buckets = sorted({self.engine.batch_bucket(v)
                      for v in range(1, self.scheduler.max_batch + 1)})
    for b in buckets:
      self.engine.render_batch(scenes[0], np.broadcast_to(eye, (b, 4, 4)))

  # -- request path -------------------------------------------------------

  def render(self, scene_id: str, pose, timeout: float = 60.0,
             trace=NULL_TRACE) -> np.ndarray:
    """Blocking render of one ``[4, 4]`` pose -> ``[H, W, 3]`` f32."""
    return self.scheduler.render(scene_id, pose, timeout=timeout,
                                 trace=trace)

  def render_async(self, scene_id: str, pose):
    """Non-blocking render; returns a ``concurrent.futures.Future``."""
    return self.scheduler.submit(scene_id, pose)

  def stats(self) -> dict:
    out = self.metrics.snapshot(cache_stats=self.cache.stats())
    out.setdefault("pipeline", {})["max_inflight"] = \
        self.scheduler.max_inflight
    adaptive = self.scheduler.adaptive_snapshot()
    if adaptive is not None:
      out["pipeline"]["adaptive"] = adaptive
    out["engine"] = self.engine.describe()
    if self.resilient is not None:
      out["breaker"] = self.resilient.breaker.snapshot()
    return out

  def healthz(self) -> dict:
    """The health state machine: ok / degraded / unhealthy + reason.

    ``degraded``: the breaker has given up on the device and requests
    fast-fail 503 until its half-open probe succeeds. ``unhealthy``: the
    service is closed or its dispatch pipeline died.
    """
    out = {
        "devices": len(self.engine.devices),
        "platform": self.engine.platform,
        "scenes": len(self.scene_ids()),
    }
    snap = (self.resilient.breaker.snapshot()
            if self.resilient is not None else None)
    if self._closed:
      status, reason = "unhealthy", "service closed"
    elif not self.scheduler.dispatcher_alive():
      status, reason = "unhealthy", "dispatcher thread is not running"
    elif snap is not None and snap["state"] != CircuitBreaker.CLOSED:
      status = "degraded"
      reason = (f"circuit {snap['state']} after "
                f"{snap['consecutive_failures']} consecutive device "
                "failures; fast-failing renders (503)")
    else:
      status, reason = "ok", None
    out["status"] = status
    if reason is not None:
      out["reason"] = reason
    if snap is not None:
      out["breaker"] = snap
    return out

  def close(self) -> None:
    if not self._closed:
      self._closed = True
      self.scheduler.stop()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


# A /render body is a scene id + 4x4 pose (< 1 KB); anything near this cap
# is malformed or hostile, and the handler must not buffer it.
_MAX_BODY_BYTES = 1 << 20

# W3C traceparent: version, 32-hex trace-id, 16-hex parent span id,
# 2-hex flags. Versions above "00" may append dash-separated fields.
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})(-.+)?$")


def _inbound_trace_id(headers) -> str | None:
  """The trace-id of a valid inbound ``traceparent`` header, else None
  (invalid headers are ignored, never rejected)."""
  value = headers.get("traceparent")
  if value is None:
    return None
  m = _TRACEPARENT_RE.match(value.strip())
  if m is None or m.group(1) == "ff":
    return None
  if m.group(5) is not None and m.group(1) == "00":
    return None  # version 00 forbids trailing fields
  trace_id, parent_id = m.group(2), m.group(3)
  if trace_id == "0" * 32 or parent_id == "0" * 16:
    return None
  return trace_id


class _Handler(BaseHTTPRequestHandler):
  """One request per thread (ThreadingHTTPServer); blocking on the
  scheduler future is what feeds concurrent HTTP load into one batch."""

  def __init__(self, service: RenderService, *args, **kwargs):
    self.service = service
    super().__init__(*args, **kwargs)

  def log_message(self, fmt, *args):  # noqa: A003 - stdlib signature
    pass  # request logging is the metrics layer's job, not stderr's

  def _send_bytes(self, body: bytes, status: int = 200,
                  content_type: str = "application/json",
                  extra_headers: dict | None = None) -> None:
    # A client that hangs up mid-response must cost a counter, not a
    # stderr traceback from the handler thread.
    try:
      self.send_response(status)
      self.send_header("Content-Type", content_type)
      self.send_header("Content-Length", str(len(body)))
      for key, value in (extra_headers or {}).items():
        self.send_header(key, value)
      self.end_headers()
      self.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError):
      self.service.metrics.record_client_disconnect()
      self.close_connection = True

  def _send_json(self, payload: dict, status: int = 200,
                 extra_headers: dict | None = None) -> None:
    self._send_bytes(json.dumps(payload).encode(), status=status,
                     extra_headers=extra_headers)

  def do_GET(self):  # noqa: N802 - stdlib name
    parsed = urllib.parse.urlsplit(self.path)
    if parsed.path == "/healthz":
      health = self.service.healthz()
      # Status-code probes never read the body: unhealthy must be non-2xx.
      self._send_json(health,
                      status=503 if health["status"] == "unhealthy" else 200)
    elif parsed.path == "/stats":
      self._send_json(self.service.stats())
    elif parsed.path == "/debug/traces":
      query = urllib.parse.parse_qs(parsed.query)
      tid = query.get("id", [None])[0]
      if tid:
        self._send_json({"trace_id": tid,
                         "traces": self.service.tracer.find(tid)})
      else:
        self._send_json(self.service.tracer.snapshot())
    else:
      self._send_json({"error": f"unknown path {self.path}"}, status=404)

  def do_POST(self):  # noqa: N802 - stdlib name
    if self.path != "/render":
      self._send_json({"error": f"unknown path {self.path}"}, status=404)
      return
    inbound_tid = _inbound_trace_id(self.headers)
    tid_hdr = {"X-Trace-Id": inbound_tid or new_trace_id()}
    try:
      length = int(self.headers.get("Content-Length", "0"))
      if not 0 <= length <= _MAX_BODY_BYTES:
        raise ValueError(f"bad body length ({length} bytes)")
      req = json.loads(self.rfile.read(length) or b"{}")
      if not isinstance(req, dict):
        raise ValueError(f"body must be a JSON object, got {type(req).__name__}")
      scene_id = req["scene_id"]
      if not isinstance(scene_id, str):
        raise ValueError(
            f"scene_id must be a string, got {type(scene_id).__name__}")
      if any(ord(c) < 0x20 for c in scene_id):
        raise ValueError("scene_id must not contain control characters")
      pose = np.asarray(req["pose"], np.float32)
      if pose.shape != (4, 4):
        raise ValueError(f"pose must be 4x4, got {pose.shape}")
      if not np.isfinite(pose).all():
        raise ValueError("pose contains non-finite values")
    except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
      self._send_json({"error": f"bad request: {e}"}, status=400,
                      extra_headers=tid_hdr)
      return
    except (BrokenPipeError, ConnectionResetError):
      self.service.metrics.record_client_disconnect()
      self.close_connection = True
      return
    tr = self.service.tracer.start_trace("render", trace_id=inbound_tid,
                                         scene_id=str(scene_id), http=True)
    if tr.trace_id:
      tid_hdr = {"X-Trace-Id": tr.trace_id}
    try:
      img = self.service.render(scene_id, pose, trace=tr)
    except KeyError as e:
      self._send_json({"error": str(e)}, status=404, extra_headers=tid_hdr)
      return
    except QueueFullError as e:
      self._send_json({"error": str(e)}, status=503,
                      extra_headers={"Retry-After": "1", **tid_hdr})
      return
    except CircuitOpenError as e:
      retry_after = max(1, math.ceil(e.retry_after_s))
      self._send_json({"error": str(e), "retry_after_s": e.retry_after_s},
                      status=503,
                      extra_headers={"Retry-After": str(retry_after),
                                     **tid_hdr})
      return
    except TransientDeviceError as e:
      if getattr(e, "deadline_capped", False):
        self._send_json({"error": f"request deadline exceeded: {e}"},
                        status=504, extra_headers=tid_hdr)
      else:
        self._send_json({"error": f"transient device failure: {e}"},
                        status=503,
                        extra_headers={"Retry-After": "1", **tid_hdr})
      return
    except FuturesTimeoutError:
      self._send_json({"error": "render timed out in queue"}, status=504,
                      extra_headers=tid_hdr)
      return
    except Exception as e:  # noqa: BLE001 - surfaced to the client
      self._send_json({"error": f"render failed: {e}"}, status=500,
                      extra_headers=tid_hdr)
      return
    img = np.ascontiguousarray(img, np.dtype("<f4"))
    if "application/octet-stream" in self.headers.get("Accept", ""):
      self._send_bytes(
          img.tobytes(), content_type="application/octet-stream",
          extra_headers={
              "X-Image-Shape": ",".join(str(d) for d in img.shape),
              "X-Image-Dtype": "<f4",
              "X-Scene-Id": str(scene_id),
              **tid_hdr,
          })
      return
    self._send_json({
        "scene_id": scene_id,
        "shape": list(img.shape),
        "dtype": "<f4",
        "image_b64": base64.b64encode(img.tobytes()).decode(),
    }, extra_headers=tid_hdr)


def make_http_server(service: RenderService, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
  """A ready-to-``serve_forever`` threaded HTTP server (port 0 = ephemeral;
  the bound port is ``server.server_address[1]``)."""
  handler = functools.partial(_Handler, service)
  server = ThreadingHTTPServer((host, port), handler)
  server.daemon_threads = True
  return server
