"""The port's streaming sessions (``serve/session/``) against the JAX tier.

The port's ``protocol.py``, ``predictor.py`` and ``manager.py`` are copies
of the JAX modules, so the same bytes go on the wire and the same poses
predict the same path. The service cases port
``tests/serve/test_session.py``'s: frames arrive in pose order and equal
the port's unbatched renders bit for bit (fusion changes scheduling,
never pixels), and lie within 1e-4 (``tests/test_render_pallas.py``'s
render tolerance) of the JAX service's frames of the same seeded scene
and poses; hostile pose streams close their session cleanly; opens past
the bound get 503 + Retry-After; idle sessions reap on the manager's
clock; brownout L3+ mutes the predictor. One departure is pinned: the JAX
client refuses a 1080p f32 frame (its 16 MiB cap), the port's reads it.
"""

import http.client
import io
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest

from mpi_vision_tpu.serve import RenderService as JRenderService
from mpi_vision_tpu.serve.server import synthetic_scene as jsynthetic_scene
from mpi_vision_tpu.serve.session import predictor as jpredictor
from mpi_vision_tpu.serve.session import protocol as jprotocol
from mpi_vision_tpu_torch.obs.attrib import AttribConfig
from mpi_vision_tpu_torch.serve import RenderService, make_http_server
from mpi_vision_tpu_torch.serve.metrics import ServeMetrics
from mpi_vision_tpu_torch.serve.session import (
    SessionClient,
    SessionConfig,
    SessionManager,
    SessionOpenError,
    TrajectoryPredictor,
    protocol,
)
from mpi_vision_tpu_torch.serve.session.manager import SessionLimitError

H = W = 16
P = 2


def _scene():
  return jsynthetic_scene("scene_000", H, W, P, seed=0)


@pytest.fixture(scope="module")
def served():
  # Edge cache off: every session frame is a real render. Attribution on:
  # session frames must land in the ledger and keep conservation true.
  svc = RenderService(device="cpu", max_batch=4, max_wait_ms=0.5,
                      resilience=None, attrib=AttribConfig(),
                      session=SessionConfig(max_sessions=2, fuse_max=2,
                                            prefetch_horizon=0))
  svc.add_scene("scene_000", *_scene())
  httpd = make_http_server(svc, port=0)
  threading.Thread(target=httpd.serve_forever, daemon=True).start()
  try:
    yield svc, httpd.server_address[1]
  finally:
    httpd.shutdown()
    httpd.server_close()
    svc.close()


def _poses(n):
  out = []
  for i in range(n):
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3] = 0.05 * i
    pose[2, 3] = 2.0 + 0.02 * i
    out.append(pose)
  return out


def _post(port, body: bytes, path="/render"):
  conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
  try:
    conn.request("POST", path, body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, dict(resp.getheaders()), resp.read()
  finally:
    conn.close()


def _render_body():
  return json.dumps({"scene_id": "scene_000",
                     "pose": np.eye(4).tolist()}).encode()


def _drain_events(client):
  events = []
  while True:
    event = client.read_event()
    if event is None:
      return events
    events.append(event)
    if event[0] == protocol.KIND_END:
      return events


# -- the copied host modules against JAX's --------------------------------


def test_protocol_encodes_the_same_bytes_as_jax():
  rng = np.random.default_rng(0)
  pose = rng.standard_normal((4, 4)).astype(np.float32)
  img = rng.random((3, 5, 3)).astype(np.float32)
  for name, args in (("pack_pose", (pose,)),
                     ("pack_hello", ("s-000001", "scene_000", (3, 5, 3))),
                     ("pack_image", (7, img)),
                     ("pack_error", (3, "QueueFullError: full", True)),
                     ("pack_frame", (protocol.KIND_END,))):
    assert getattr(protocol, name)(*args) == getattr(jprotocol, name)(*args)
  payload = protocol.pack_image(7, img)[5:]
  seq, got = protocol.unpack_image(payload, (3, 5, 3))
  jseq, want = jprotocol.unpack_image(payload, (3, 5, 3))
  assert seq == jseq == 7
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(
      protocol.unpack_pose(protocol.pack_pose(pose)[5:]), pose)


def test_predictor_matches_jax():
  ours, theirs = TrajectoryPredictor(0.5), jpredictor.TrajectoryPredictor(0.5)
  for i, pose in enumerate(_poses(5)):
    c, s = np.cos(0.03 * i), np.sin(0.03 * i)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    ours.observe(pose)
    theirs.observe(pose)
  for a, b in zip(ours.predict(4), theirs.predict(4)):
    np.testing.assert_array_equal(a, b)


class _OneFrameServer:
  """A socket that answers ``POST /session`` like the service, with a
  hello of ``shape`` and one all-zero image frame: the client's cap is
  the thing under test, so nothing renders."""

  def __init__(self, shape):
    self.shape = shape
    self.sock = socket.create_server(("127.0.0.1", 0))
    self.port = self.sock.getsockname()[1]
    self.thread = threading.Thread(target=self._serve, daemon=True)
    self.thread.start()

  def _serve(self):
    conn, _ = self.sock.accept()
    with conn:
      rfile = conn.makefile("rb")
      while rfile.readline() not in (b"\r\n", b""):
        pass
      rfile.read(len(json.dumps({"scene_id": "big"})))
      img = np.zeros(self.shape, np.float32)
      conn.sendall(b"HTTP/1.1 200 OK\r\nX-Session-Id: s-000001\r\n\r\n"
                   + protocol.pack_hello("s-000001", "big", self.shape)
                   + protocol.pack_image(0, img)
                   + protocol.pack_frame(protocol.KIND_END))
      rfile.close()

  def close(self):
    self.thread.join(10)
    self.sock.close()


def test_a_1080p_frame_is_refused_by_jax_and_read_by_the_port():
  shape = (1080, 1920, 3)
  frame = protocol.pack_image(0, np.zeros(shape, np.float32))
  assert len(frame) - 5 == 4 + 1080 * 1920 * 3 * 4 > jprotocol.MAX_PAYLOAD
  with pytest.raises(jprotocol.ProtocolError, match="exceeds cap"):
    jprotocol.read_frame(io.BytesIO(frame))
  server = _OneFrameServer(shape)
  try:
    with SessionClient("127.0.0.1", server.port, "big") as client:
      assert client.shape == shape
      frames = list(client.frames())
  finally:
    server.close()
  assert len(frames) == 1 and frames[0][0] == 0
  assert frames[0][1].shape == shape and not frames[0][1].any()
  # Only an image frame of exactly the session's size passes the cap.
  oversize = protocol.pack_frame(protocol.KIND_FRAME, b"\0" * (len(frame) - 4))
  with pytest.raises(protocol.ProtocolError, match="exceeds cap"):
    protocol.read_frame(io.BytesIO(oversize), frame_payload=len(frame) - 5)
  error = protocol.pack_frame(protocol.KIND_ERROR, b"\0" * (len(frame) - 5))
  with pytest.raises(protocol.ProtocolError, match="exceeds cap"):
    protocol.read_frame(io.BytesIO(error), frame_payload=len(frame) - 5)


# -- happy path -----------------------------------------------------------


def test_session_streams_frames_in_pose_order(served):
  svc, port = served
  poses = _poses(5)
  with SessionClient("127.0.0.1", port, "scene_000") as client:
    assert client.session_id
    assert client.shape == (H, W, 3)
    for pose in poses:
      client.send_pose(pose)
    client.end()
    frames = list(client.frames())
  assert [seq for seq, _ in frames] == list(range(len(poses)))
  for _, img in frames:
    assert img.shape == (H, W, 3) and img.dtype == np.float32
    assert np.all(np.isfinite(img))
  assert svc.scheduler.dispatcher_alive()


def test_session_frames_equal_unbatched_renders_and_jax(served):
  svc, port = served
  poses = _poses(4)
  with SessionClient("127.0.0.1", port, "scene_000") as client:
    for pose in poses:
      client.send_pose(pose)
    client.end()
    frames = dict(client.frames())
  assert len(frames) == len(poses)
  jax_svc = JRenderService(max_batch=1, max_wait_ms=0.5, use_mesh=False,
                           resilience=None)
  try:
    jax_svc.add_scene("scene_000", *_scene())
    for seq, pose in enumerate(poses):
      np.testing.assert_array_equal(frames[seq],
                                    svc.render("scene_000", pose))
      np.testing.assert_allclose(
          frames[seq], np.asarray(jax_svc.render("scene_000", pose)),
          atol=1e-4, rtol=0)
  finally:
    jax_svc.close()
  # Fusion: the flushes took more than one pose on average.
  assert svc.stats()["session"]["mean_flush_size"] > 1


def test_stats_and_metrics_expose_the_session_block(served):
  svc, port = served
  with SessionClient("127.0.0.1", port, "scene_000") as client:
    client.send_pose(np.eye(4))
    client.end()
    assert len(list(client.frames())) == 1
  block = svc.stats()["session"]
  assert block["enabled"] is True
  assert block["max_sessions"] == 2 and block["fuse_max"] == 2
  assert block["opened"] >= 1 and block["closed"] >= 1
  assert block["frames"] >= 1 and block["frame_errors"] == 0
  assert block["flushes"] >= 1 and block["active"] == 0
  text = svc.metrics_text()
  assert f"mpi_serve_session_frames_total {block['frames']}" in text


def test_attrib_conservation_holds_with_session_frames(served):
  svc, port = served
  with SessionClient("127.0.0.1", port, "scene_000") as client:
    for pose in _poses(3):
      client.send_pose(pose)
    client.end()
    assert len(list(client.frames())) == 3
  attrib = svc.stats()["attrib"]
  assert attrib["conservation"]["ok"], attrib["conservation"]
  assert attrib["totals"]["requests"] >= 3


# -- hello validation -----------------------------------------------------


@pytest.mark.parametrize("body", [
    b"",
    b"not json at all",
    b"[1, 2, 3]",
    b"{\"scene_id\": 7}",
    json.dumps({"scene_id": "scene_000\x1ft0,0"}).encode(),
], ids=["empty", "notjson", "array", "intid", "ctrlchar"])
def test_malformed_hello_is_400(served, body):
  svc, port = served
  status, headers, payload = _post(port, body, path="/session")
  assert status == 400, payload
  assert "error" in json.loads(payload)
  assert headers.get("X-Trace-Id")
  assert svc.scheduler.dispatcher_alive()


def test_unknown_scene_hello_is_404(served):
  svc, port = served
  status, _, payload = _post(port, json.dumps({"scene_id": "nope"}).encode(),
                             path="/session")
  assert status == 404, payload
  assert svc.scheduler.dispatcher_alive()


def test_sessions_disabled_is_503():
  svc = RenderService(device="cpu", max_batch=2, max_wait_ms=0.5,
                      resilience=None)
  httpd = make_http_server(svc, port=0)
  threading.Thread(target=httpd.serve_forever, daemon=True).start()
  try:
    port = httpd.server_address[1]
    status, _, payload = _post(port, json.dumps({"scene_id": "x"}).encode(),
                               path="/session")
    assert status == 503
    assert "disabled" in json.loads(payload)["error"]
    with pytest.raises(SessionOpenError) as err:
      SessionClient("127.0.0.1", port, "x")
    assert err.value.status == 503
  finally:
    httpd.shutdown()
    httpd.server_close()
    svc.close()


# -- pose-stream fuzz -----------------------------------------------------

_FUZZ_STREAMS = [
    ("unknown_kind", struct.pack("<cI", b"Z", 0)),
    ("server_only_kind", struct.pack("<cI", b"F", 4) + b"\x00" * 4),
    ("oversize_length", struct.pack("<cI", b"P", 1 << 20)),
    ("short_pose", struct.pack("<cI", b"P", 10) + b"\x00" * 10),
    ("nonfinite_pose",
     struct.pack("<cI", b"P", protocol.POSE_BYTES)
     + np.full((4, 4), np.nan, dtype="<f4").tobytes()),
    ("truncated_payload", struct.pack("<cI", b"P", protocol.POSE_BYTES)
     + b"\x00" * 10),
]


@pytest.mark.parametrize("raw", [r for _, r in _FUZZ_STREAMS],
                         ids=[n for n, _ in _FUZZ_STREAMS])
def test_hostile_pose_stream_closes_cleanly(served, raw):
  svc, port = served
  with SessionClient("127.0.0.1", port, "scene_000") as client:
    client.send_pose(np.eye(4))  # a good pose first: its frame must land
    client.send_raw(raw)
    client.sock.shutdown(socket.SHUT_WR)
    events = _drain_events(client)
  kinds = [kind for kind, _ in events]
  assert kinds, "server closed without an end frame"
  assert kinds[0] == protocol.KIND_FRAME
  assert kinds[-1] == protocol.KIND_END
  assert protocol.KIND_ERROR in kinds
  error = next(parsed for kind, parsed in events
               if kind == protocol.KIND_ERROR)
  assert "bad pose stream" in error["error"]
  assert set(kinds) <= {protocol.KIND_FRAME, protocol.KIND_ERROR,
                        protocol.KIND_END}
  assert svc.scheduler.dispatcher_alive()
  status, _, _ = _post(port, _render_body())
  assert status == 200
  assert svc.stats()["session"]["active"] == 0


def test_midstream_disconnect_does_not_kill_the_service(served):
  svc, port = served
  client = SessionClient("127.0.0.1", port, "scene_000")
  client.send_pose(np.eye(4))
  client.close()  # vanish without an end frame
  status, _, _ = _post(port, _render_body())
  assert status == 200
  assert svc.scheduler.dispatcher_alive()


# -- session bound --------------------------------------------------------


def test_opens_past_the_bound_shed_503_with_retry_after(served):
  svc, port = served
  held = [SessionClient("127.0.0.1", port, "scene_000") for _ in range(2)]
  try:
    status, headers, payload = _post(
        port, json.dumps({"scene_id": "scene_000"}).encode(), path="/session")
    assert status == 503, payload
    assert int(headers["Retry-After"]) >= 1
    assert json.loads(payload)["retry_after_s"] == pytest.approx(1.0)
    with pytest.raises(SessionOpenError) as err:
      SessionClient("127.0.0.1", port, "scene_000")
    assert err.value.status == 503
  finally:
    for client in held:
      client.end()
      _drain_events(client)
      client.close()
  assert svc.stats()["session"]["rejected"] >= 2
  with SessionClient("127.0.0.1", port, "scene_000") as client:
    client.send_pose(np.eye(4))
    client.end()
    assert len(list(client.frames())) == 1


# -- manager units: idle reap on a fake clock, brownout prefetch mute -----


class _StubService:
  """The slice of RenderService the manager touches in these units."""

  def __init__(self):
    self.metrics = ServeMetrics()
    self.edge = None
    self.brownout = None

  def edge_cell_resident(self, scene_id, pose):
    return None, False


def test_idle_sessions_reap_on_the_injected_clock():
  t = [100.0]
  svc = _StubService()
  mgr = SessionManager(SessionConfig(max_sessions=1, idle_timeout_s=5.0),
                       service=svc, clock=lambda: t[0])
  session = mgr.open("scene_000")
  assert mgr.active == 1
  with pytest.raises(SessionLimitError):
    mgr.open("scene_000")
  t[0] += 4.0
  assert mgr.reap_idle() == []
  t[0] += 2.0
  assert mgr.reap_idle() == [session.session_id]
  assert session.closed and session.close_reason == "idle"
  assert mgr.active == 0
  snap = svc.metrics.snapshot()["session"]
  assert snap["idle_reaped"] == 1 and snap["closed"] == 1
  t[0] += 100.0
  replacement = mgr.open("scene_000")
  assert mgr.active == 1
  replacement.close()


def test_brownout_l3_mutes_the_prefetch_predictor():
  svc = _StubService()
  svc.edge = object()

  class _Brownout:
    level = 3

  svc.brownout = _Brownout()
  mgr = SessionManager(SessionConfig(prefetch_horizon=2), service=svc)
  session = mgr.open("scene_000")
  try:
    for pose in _poses(4):
      session._maybe_prefetch([pose])
    snap = svc.metrics.snapshot()["session"]["prefetch"]
    assert snap["issued"] == 0
    assert snap["suppressed"] == 4
    svc.brownout.level = 2
    for pose in _poses(4):
      session._maybe_prefetch([pose])
    snap = svc.metrics.snapshot()["session"]["prefetch"]
    assert snap["suppressed"] == 4
  finally:
    session.close()
    mgr.close_all()


def test_prefetch_warms_the_edge_cache_on_a_pan():
  """With the edge cache on, a steady pan makes the predictor issue
  prefetch-class renders for cells ahead of the camera, and later poses
  of the session land on them (chip_smoke phase 14 (a)'s check)."""
  from mpi_vision_tpu_torch.serve.edge import EdgeConfig

  svc = RenderService(device="cpu", max_batch=4, max_wait_ms=0.5,
                      resilience=None,
                      edge=EdgeConfig(trans_cell=0.02, rot_bucket_deg=2.0,
                                      warp_max_trans=0.0,
                                      warp_max_rot_deg=0.0),
                      session=SessionConfig(fuse_max=1, prefetch_horizon=3))
  svc.add_scene("scene_000", *_scene())
  httpd = make_http_server(svc, port=0)
  threading.Thread(target=httpd.serve_forever, daemon=True).start()
  try:
    with SessionClient("127.0.0.1", httpd.server_address[1],
                       "scene_000") as client:
      for i in range(12):
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = 0.02 * i
        client.send_pose(pose)
        seq, _ = next(client.frames())
        assert seq == i
        # A viewer sends poses at its frame rate: the speculative render
        # of a predicted cell races the next real pose, so pace the pan.
        time.sleep(0.02)
      client.end()
      assert list(client.frames()) == []
    prefetch = svc.stats()["session"]["prefetch"]
    assert prefetch["issued"] > 0 and prefetch["hits"] > 0, prefetch
  finally:
    httpd.shutdown()
    httpd.server_close()
    svc.close()
