"""HTTP-layer fuzzing of the port's ``make_http_server``: hostile /render
input maps to 4xx, never 500 or dispatcher death.

The cases of ``tests/serve/test_http_fuzz.py``, run against the port's
rewritten server on a CPU service.

The contract under fuzz: for ANY malformed body, header, or framing the
server (1) answers 4xx with a JSON error and an X-Trace-Id, (2) keeps
the dispatcher thread alive, and (3) still serves a well-formed request
afterwards. Also pins the W3C ``traceparent`` contract: a valid inbound
trace-id is echoed in ``X-Trace-Id`` (proxy trace stitching); invalid
ones are ignored, never rejected.
"""

import http.client
import json
import socket
import threading

import numpy as np
import pytest

from mpi_vision_tpu_torch.serve import RenderService, make_http_server
from mpi_vision_tpu_torch.serve.server import _inbound_trace_id


@pytest.fixture(scope="module")
def served():
  svc = RenderService(device="cpu", max_batch=2, max_wait_ms=0.5,
                      resilience=None)
  svc.add_synthetic_scenes(1, height=16, width=16, planes=2)
  httpd = make_http_server(svc, port=0)
  thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  thread.start()
  try:
    yield svc, httpd.server_address[1]
  finally:
    httpd.shutdown()
    svc.close()


def _post(port, body: bytes, headers=None, path="/render"):
  conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
  try:
    conn.request("POST", path, body=body,
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    resp = conn.getresponse()
    return resp.status, dict(resp.getheaders()), resp.read()
  finally:
    conn.close()


def _good_body():
  return json.dumps({"scene_id": "scene_000",
                     "pose": np.eye(4).tolist()}).encode()


BAD_BODIES = [
    b"",                                           # empty -> {} -> KeyError
    b"not json at all",
    b"{\"scene_id\": \"scene_000\"",               # truncated JSON
    b"[1, 2, 3]",                                  # not an object
    b"\"scene_000\"",                              # bare string
    b"{\"pose\": [[1]]}",                          # missing scene_id
    json.dumps({"scene_id": "scene_000"}).encode(),            # missing pose
    json.dumps({"scene_id": "scene_000", "pose": [[1, 2], [3, 4]]}).encode(),
    json.dumps({"scene_id": "scene_000", "pose": "eye"}).encode(),
    json.dumps({"scene_id": "scene_000",
                "pose": [["a"] * 4] * 4}).encode(),            # non-numeric
    json.dumps({"scene_id": {"nested": "dict"},
                "pose": np.eye(4).tolist()}).encode(),         # unhashable id
    json.dumps({"scene_id": None, "pose": np.eye(4).tolist()}).encode(),
    json.dumps({"scene_id": "scene_000",
                "pose": [[float("nan")] * 4] * 4}).encode(),   # non-finite
    # Control chars (esp. \x1f, the tile/ring key separator —
    # serve/tiles.py) must never reach the dispatcher as a scene id.
    json.dumps({"scene_id": "scene_000\x1ft0,0",
                "pose": np.eye(4).tolist()}).encode(),
    b"\xff\xfe garbage \x00\x01" * 16,             # binary junk
]


@pytest.mark.parametrize("body", BAD_BODIES,
                         ids=[f"body{i}" for i in range(len(BAD_BODIES))])
def test_malformed_bodies_map_to_400(served, body):
  svc, port = served
  status, headers, payload = _post(port, body)
  assert status == 400, payload
  assert "error" in json.loads(payload)
  assert headers.get("X-Trace-Id")
  assert svc.scheduler.dispatcher_alive()


def test_oversized_declared_length_is_4xx_without_buffering(served):
  svc, port = served
  # Declared 2 MB (over the 1 MB cap): must 4xx on the DECLARED length,
  # not block reading a body that never arrives.
  conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
  try:
    conn.putrequest("POST", "/render")
    conn.putheader("Content-Type", "application/json")
    conn.putheader("Content-Length", str(2 << 20))
    conn.endheaders()
    conn.send(b"{}")  # far fewer bytes than declared
    status = conn.getresponse().status
  finally:
    conn.close()
  assert status == 400
  assert svc.scheduler.dispatcher_alive()


def test_negative_content_length_is_4xx(served):
  svc, port = served
  # http.client refuses to send a negative length; raw socket it is.
  port_ = port
  with socket.create_connection(("127.0.0.1", port_), timeout=30) as sock:
    sock.sendall(b"POST /render HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Length: -5\r\n\r\n")
    data = sock.recv(4096)
  assert b"400" in data.split(b"\r\n", 1)[0]
  assert svc.scheduler.dispatcher_alive()


def test_garbage_request_line_does_not_kill_server(served):
  svc, port = served
  with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
    sock.sendall(b"\x16\x03\x01\x02\x00 TLS-at-the-plain-port\r\n\r\n")
    sock.recv(4096)  # stdlib answers 400 (or closes); either is fine
  status, _, _ = _post(port, _good_body())
  assert status == 200
  assert svc.scheduler.dispatcher_alive()


def test_unknown_paths_are_404(served):
  svc, port = served
  status, _, _ = _post(port, _good_body(), path="/rendr")
  assert status == 404
  conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
  try:
    conn.request("GET", "/render")  # POST-only path via GET
    assert conn.getresponse().status == 404
  finally:
    conn.close()


def test_unknown_scene_is_404_not_500(served):
  svc, port = served
  body = json.dumps({"scene_id": "no_such_scene",
                     "pose": np.eye(4).tolist()}).encode()
  status, _, payload = _post(port, body)
  assert status == 404, payload
  assert svc.scheduler.dispatcher_alive()


def test_weird_accept_header_still_renders_json(served):
  svc, port = served
  status, headers, payload = _post(
      port, _good_body(),
      headers={"Accept": "text/html;q=0.9, image/avif, */*;q=0.8"})
  assert status == 200
  out = json.loads(payload)
  assert out["shape"] == [16, 16, 3]


def test_fuzz_then_valid_render_still_works(served):
  """After the whole hostile barrage the service still renders."""
  svc, port = served
  for body in BAD_BODIES[:4]:
    _post(port, body)
  status, headers, payload = _post(port, _good_body())
  assert status == 200
  out = json.loads(payload)
  assert out["scene_id"] == "scene_000" and out["dtype"] == "<f4"
  assert svc.scheduler.dispatcher_alive()
  assert svc.healthz()["status"] == "ok"


# -- W3C traceparent stitching ---------------------------------------------

_VALID_TP = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"


def test_traceparent_trace_id_is_honored(served):
  svc, port = served
  status, headers, _ = _post(port, _good_body(),
                             headers={"traceparent": _VALID_TP})
  assert status == 200
  assert headers["X-Trace-Id"] == _VALID_TP.split("-")[1]


def test_traceparent_honored_on_error_responses_too(served):
  svc, port = served
  status, headers, _ = _post(port, b"not json",
                             headers={"traceparent": _VALID_TP})
  assert status == 400
  assert headers["X-Trace-Id"] == _VALID_TP.split("-")[1]


@pytest.mark.parametrize("bad", [
    "",
    "banana",
    "00-" + "0" * 32 + "-00f067aa0ba902b7-01",      # all-zero trace id
    "00-4bf92f3577b34da6a3ce929d0e0e4736-" + "0" * 16 + "-01",  # zero parent
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",  # version ff
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00f067aa0ba902b7-01",  # uppercase
    "00-4bf92f3577b34da6-00f067aa0ba902b7-01",      # short trace id
    _VALID_TP + "-extra",                           # version 00: no extras
])
def test_invalid_traceparent_is_ignored_not_rejected(served, bad):
  svc, port = served
  status, headers, _ = _post(port, _good_body(),
                             headers={"traceparent": bad})
  assert status == 200  # never reject a render over tracing garbage
  tid = headers["X-Trace-Id"]
  assert tid and tid != (bad.split("-")[1] if bad.count("-") >= 2 else bad)


def test_inbound_trace_id_parser_unit():
  assert _inbound_trace_id({"traceparent": _VALID_TP}) == _VALID_TP.split("-")[1]
  assert _inbound_trace_id({}) is None


def test_traceparent_future_version_with_extra_fields_is_honored():
  """W3C versioning: receivers parse versions > 00 by the version-00
  prefix, tolerating appended dash-separated fields — a proxy upgrade
  must not silently break trace stitching."""
  want = _VALID_TP.split("-")[1]
  future = "01-" + _VALID_TP[3:] + "-0badc0ffee"
  assert _inbound_trace_id({"traceparent": future}) == want
  # ... but version 00 is exactly four fields, and ff stays invalid.
  assert _inbound_trace_id({"traceparent": _VALID_TP + "-x"}) is None
  assert _inbound_trace_id(
      {"traceparent": "ff-" + _VALID_TP[3:] + "-x"}) is None


def test_traced_service_records_inbound_id(tmp_path):
  """With tracing on, the recorded trace carries the proxy's id."""
  from mpi_vision_tpu_torch.obs import Tracer

  svc = RenderService(device="cpu", max_batch=2, max_wait_ms=0.5,
                      resilience=None,
                      tracer=Tracer())
  svc.add_synthetic_scenes(1, height=16, width=16, planes=2)
  httpd = make_http_server(svc, port=0)
  threading.Thread(target=httpd.serve_forever, daemon=True).start()
  try:
    port = httpd.server_address[1]
    status, headers, _ = _post(port, _good_body(),
                               headers={"traceparent": _VALID_TP})
    assert status == 200
    want = _VALID_TP.split("-")[1]
    assert headers["X-Trace-Id"] == want
    recorded = [t["trace_id"] for t in svc.tracer.snapshot()["recent"]]
    assert want in recorded
  finally:
    httpd.shutdown()
    svc.close()
