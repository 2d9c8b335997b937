"""Wire framing for pose-in / frame-out streaming sessions.

PyTorch-package copy of ``mpi_vision_tpu/serve/session/protocol.py``
(host-only). One departure: the JAX client reads every server frame under
the 16 MiB ``MAX_PAYLOAD`` cap, so it refuses a 1080p f32 frame
(4 + 1080 * 1920 * 3 * 4 = 24,883,204 bytes). ``SessionClient`` here
admits an ``F`` frame of exactly its seq header plus the hello's shape in
f32; every other frame keeps the cap, and a pose is still exactly 64
bytes.

A session rides ONE long-lived HTTP exchange on the stdlib server: the
client sends ``POST /session`` with a small JSON hello body (scene id,
options), the server answers ``200`` with no ``Content-Length`` and then
both directions switch to length-prefixed binary frames on the same
socket — poses flow in on the request side after the hello body, frames
flow out on the response side until an end frame.

Every frame is ``<1-byte kind><u32 LE payload length><payload>``:

  client -> server   ``P`` pose (exactly 64 bytes: 4x4 float32 LE,
                     row-major camera-to-world), ``E`` end-of-input.
  server -> client   ``H`` hello (JSON: session_id/scene_id/shape/dtype),
                     ``F`` frame (u32 LE seq + raw float32 pixels),
                     ``X`` error (JSON: seq/error/transient),
                     ``E`` end-of-stream.

Anything else — unknown kind, oversize length, truncated payload, a pose
that is not 64 finite bytes — is a ``ProtocolError``: the server closes
the session cleanly (error frame then end), never a 500 and never a dead
dispatcher.
"""

from __future__ import annotations

import json
import socket
import struct

import numpy as np

KIND_POSE = b"P"
KIND_HELLO = b"H"
KIND_FRAME = b"F"
KIND_ERROR = b"X"
KIND_END = b"E"

_KNOWN_KINDS = frozenset((KIND_POSE, KIND_HELLO, KIND_FRAME, KIND_ERROR, KIND_END))

_HEADER = struct.Struct("<cI")
_SEQ = struct.Struct("<I")

POSE_BYTES = 64  # 4x4 float32 LE
# Largest payload either side may send, apart from an image frame of the
# session's own shape (``read_frame``'s ``frame_payload``); anything
# bigger is a framing error, not a frame.
MAX_PAYLOAD = 1 << 24


class ProtocolError(ValueError):
    """Malformed session framing (unknown kind, bad length, bad pose)."""


def pack_frame(kind: bytes, payload: bytes = b"") -> bytes:
    return _HEADER.pack(kind, len(payload)) + payload


def read_exact(rfile, n: int) -> bytes:
    """Read exactly ``n`` bytes; raise ProtocolError on mid-object EOF."""
    chunks = []
    remaining = int(n)
    while remaining > 0:
        chunk = rfile.read(remaining)
        if not chunk:
            raise ProtocolError("truncated frame: stream ended mid-payload")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def read_frame(rfile, max_payload: int = MAX_PAYLOAD,
               frame_payload: int | None = None):
    """Read one frame; None on clean EOF *between* frames.

    ``frame_payload`` admits an ``F`` frame of exactly that many payload
    bytes past ``max_payload`` (a session's full-size image). Raises
    ProtocolError for unknown kinds, oversize payloads, or EOF in the
    middle of a frame.
    """
    head = rfile.read(_HEADER.size)
    if not head:
        return None
    if len(head) < _HEADER.size:
        raise ProtocolError("truncated frame: stream ended mid-header")
    kind, length = _HEADER.unpack(head)
    if kind not in _KNOWN_KINDS:
        raise ProtocolError(f"unknown frame kind {kind!r}")
    if length > max_payload and not (kind == KIND_FRAME
                                     and length == frame_payload):
        raise ProtocolError(f"frame payload {length} exceeds cap {max_payload}")
    payload = read_exact(rfile, length) if length else b""
    return kind, payload


def pack_pose(pose) -> bytes:
    arr = np.ascontiguousarray(np.asarray(pose, dtype=np.float32))
    if arr.shape != (4, 4):
        raise ProtocolError(f"pose must be 4x4, got {arr.shape}")
    return pack_frame(KIND_POSE, arr.astype("<f4").tobytes())


def unpack_pose(payload: bytes) -> np.ndarray:
    if len(payload) != POSE_BYTES:
        raise ProtocolError(f"pose payload must be {POSE_BYTES} bytes, got {len(payload)}")
    pose = np.frombuffer(payload, dtype="<f4").reshape(4, 4).astype(np.float32)
    if not np.all(np.isfinite(pose)):
        raise ProtocolError("pose contains non-finite values")
    return pose


def pack_hello(session_id: str, scene_id: str, shape) -> bytes:
    body = json.dumps(
        {
            "session_id": str(session_id),
            "scene_id": str(scene_id),
            "shape": [int(d) for d in shape],
            "dtype": "<f4",
        }
    ).encode("utf-8")
    return pack_frame(KIND_HELLO, body)


def pack_image(seq: int, img) -> bytes:
    arr = np.ascontiguousarray(np.asarray(img, dtype=np.float32))
    return pack_frame(KIND_FRAME, _SEQ.pack(int(seq)) + arr.astype("<f4").tobytes())


def unpack_image(payload: bytes, shape):
    if len(payload) < _SEQ.size:
        raise ProtocolError("frame payload shorter than its seq header")
    (seq,) = _SEQ.unpack(payload[: _SEQ.size])
    flat = np.frombuffer(payload[_SEQ.size :], dtype="<f4")
    expected = int(np.prod(shape))
    if flat.size != expected:
        raise ProtocolError(f"frame has {flat.size} values, expected {expected}")
    return seq, flat.reshape(tuple(int(d) for d in shape)).astype(np.float32)


def pack_error(seq: int, message: str, transient: bool) -> bytes:
    body = json.dumps(
        {"seq": int(seq), "error": str(message), "transient": bool(transient)}
    ).encode("utf-8")
    return pack_frame(KIND_ERROR, body)


class SessionOpenError(RuntimeError):
    """Server refused the session open (non-200 on POST /session)."""

    def __init__(self, status: int, body: str = ""):
        super().__init__(f"session open failed: HTTP {status} {body}".strip())
        self.status = int(status)
        self.body = body


class SessionClient:
    """Minimal blocking client for benches and tests.

    Opens the socket, performs the POST /session hello, then exposes
    ``send_pose`` / ``end`` / ``read_event``. Not a general HTTP client —
    it assumes the session server's exact response shape.
    """

    def __init__(
        self,
        host: str,
        port: int,
        scene_id: str,
        *,
        request_class: str | None = None,
        pose=None,
        timeout: float = 60.0,
    ):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        # Poses are 69-byte frames on an interactive stream; Nagle +
        # delayed ACK would stall them for tens of milliseconds.
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.rfile = self.sock.makefile("rb")
        self.wfile = self.sock.makefile("wb")
        hello: dict = {"scene_id": str(scene_id)}
        if pose is not None:
            # An initial pose rides the hello so a fronting cluster router
            # can place the session cell-affine before any frame flows.
            hello["pose"] = np.asarray(pose, dtype=np.float32).tolist()
        body = json.dumps(hello).encode("utf-8")
        headers = [
            b"POST /session HTTP/1.1",
            b"Host: %s:%d" % (host.encode("ascii"), port),
            b"Content-Type: application/json",
            b"Content-Length: %d" % len(body),
        ]
        if request_class is not None:
            headers.append(b"X-Request-Class: %s" % request_class.encode("ascii"))
        self.wfile.write(b"\r\n".join(headers) + b"\r\n\r\n" + body)
        self.wfile.flush()
        status, http_headers = self._read_http_head()
        if status != 200:
            length = int(http_headers.get("content-length", "0") or "0")
            text = self.rfile.read(length).decode("utf-8", "replace") if length else ""
            self.close()
            raise SessionOpenError(status, text)
        self.headers = http_headers
        self.session_id = http_headers.get("x-session-id", "")
        frame = read_frame(self.rfile)
        if frame is None or frame[0] != KIND_HELLO:
            self.close()
            raise ProtocolError("expected hello frame after 200")
        self.hello = json.loads(frame[1].decode("utf-8"))
        self.shape = tuple(int(d) for d in self.hello["shape"])
        # An image frame is its seq header plus the f32 pixels of this
        # shape, whatever the cap (a 1080p frame is ~24.9 MB).
        self.frame_payload = _SEQ.size + 4 * int(np.prod(self.shape))

    def _read_http_head(self):
        line = self.rfile.readline()
        parts = line.split()
        if len(parts) < 2 or not parts[0].startswith(b"HTTP/"):
            raise ProtocolError(f"bad HTTP status line {line!r}")
        status = int(parts[1])
        headers: dict[str, str] = {}
        while True:
            raw = self.rfile.readline()
            if raw in (b"\r\n", b"\n", b""):
                break
            name, _, value = raw.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        return status, headers

    def send_pose(self, pose) -> None:
        self.wfile.write(pack_pose(pose))
        self.wfile.flush()

    def send_raw(self, data: bytes) -> None:
        self.wfile.write(data)
        self.wfile.flush()

    def end(self) -> None:
        self.wfile.write(pack_frame(KIND_END))
        self.wfile.flush()

    def read_event(self):
        """Next server frame as (kind, parsed) — image tuples for ``F``,
        dicts for ``X``, None payloads for ``E``; None on EOF."""
        frame = read_frame(self.rfile, frame_payload=self.frame_payload)
        if frame is None:
            return None
        kind, payload = frame
        if kind == KIND_FRAME:
            return kind, unpack_image(payload, self.shape)
        if kind == KIND_ERROR:
            return kind, json.loads(payload.decode("utf-8"))
        return kind, None

    def frames(self):
        """Yield (seq, img) until the end frame or EOF; raises on error frames."""
        while True:
            event = self.read_event()
            if event is None or event[0] == KIND_END:
                return
            kind, parsed = event
            if kind == KIND_ERROR:
                raise RuntimeError(f"session error frame: {parsed}")
            yield parsed

    def close(self) -> None:
        for closer in (self.wfile.close, self.rfile.close, self.sock.close):
            try:
                closer()
            except OSError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
