"""Open-loop HTTP load generator, run as a child process so that its
interpreter lock is not the server's: ``python -m benchmark.traffic.loadgen``.

Protocol on its standard streams. In: one JSON line ``{"port", "requests":
[[due_s, scene_id, pose 4x4], ...], "keep": [index, ...], "timeout_s",
"workers"}``. Out: ``ready``, once its workers are started. In: ``go``; the
schedule's clock starts there, and each request is handed at its due time
to an idle worker, which sends ``POST /render`` (HTTP/1.0, ``Accept:
application/octet-stream``) whether or not earlier requests have finished.
Out, once every request has finished: one JSON line of records
``[t_send, t_done, status, nbytes, error]`` (seconds from the start), then
``frame <index> <nbytes>`` and that many raw bytes for each kept request,
then ``end``.

A worker reads each body into a buffer it keeps, with the interpreter lock
released, so the generator holds the lock and allocates memory as little
as it can: it shares the host with the server it measures. Standard
library only.
"""

from __future__ import annotations

import json
import queue
import socket
import sys
import threading
import time


def fetch(port: int, body: bytes, buf: bytearray, timeout: float) -> tuple:
  """One ``POST /render``; returns ``(status, body length, buffer)``, the
  body in the buffer's first bytes (a larger buffer when it did not fit)."""
  with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
    s.sendall(b"POST /render HTTP/1.0\r\nContent-Type: application/json\r\n"
              b"Accept: application/octet-stream\r\nContent-Length: "
              + str(len(body)).encode() + b"\r\n\r\n" + body)
    head = b""
    while b"\r\n\r\n" not in head:
      chunk = s.recv(65536)
      if not chunk:
        raise ConnectionError("closed before the response headers")
      head += chunk
    head, _, rest = head.partition(b"\r\n\r\n")
    lines = head.split(b"\r\n")
    status = int(lines[0].split()[1])
    length = next((int(v) for k, _, v in (line.partition(b":")
                                          for line in lines[1:])
                   if k.strip().lower() == b"content-length"), None)
    if length is None:
      raise ConnectionError("response without a Content-Length")
    if len(buf) < length:
      buf = bytearray(length)
    view = memoryview(buf)
    got = len(rest)
    view[:got] = rest
    while got < length:
      n = s.recv_into(view[got:length])
      if not n:
        raise ConnectionError("closed in the middle of the body")
      got += n
    return status, length, buf


def main() -> int:
  spec = json.loads(sys.stdin.readline())
  port, timeout = spec["port"], spec["timeout_s"]
  keep = set(spec["keep"])
  bodies = [json.dumps({"scene_id": sid, "pose": pose}).encode()
            for _, sid, pose in spec["requests"]]
  dues = [r[0] for r in spec["requests"]]
  records = [None] * len(bodies)
  frames = {}
  work = queue.SimpleQueue()
  box = {}

  def worker() -> None:
    buf = bytearray()
    while True:
      i = work.get()
      if i is None:
        return
      t_send = time.perf_counter() - box["t0"]
      status, n, err = -1, 0, None
      try:
        status, n, buf = fetch(port, bodies[i], buf, timeout)
      except (OSError, ValueError, IndexError) as e:
        err = repr(e)
      records[i] = [t_send, time.perf_counter() - box["t0"], status, n, err]
      if i in keep and status == 200:
        frames[i] = bytes(buf[:n])

  threads = [threading.Thread(target=worker, daemon=True)
             for _ in range(spec["workers"])]
  for th in threads:
    th.start()
  out = sys.stdout.buffer
  out.write(b"ready\n")
  out.flush()
  sys.stdin.readline()
  t0 = box["t0"] = time.perf_counter()
  for i, due in enumerate(dues):
    delay = t0 + due - time.perf_counter()
    if delay > 0:
      time.sleep(delay)
    work.put(i)
  for _ in threads:
    work.put(None)
  for th in threads:
    th.join(timeout + 30)
  out.write(json.dumps(records).encode() + b"\n")
  out.flush()
  for i, data in sorted(frames.items()):
    out.write(f"frame {i} {len(data)}\n".encode())
    out.write(data)
  out.write(b"end\n")
  out.flush()
  return 0


if __name__ == "__main__":
  sys.exit(main())
