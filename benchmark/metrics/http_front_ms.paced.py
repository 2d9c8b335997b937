"""What the HTTP front adds to a request: the client's median latency
(send to the whole body received) less the service's own median request
latency (``ServeMetrics``: queue to frame), over the window's requests."""

from benchmark import readers


def read(data):
  client = data.get("client") or {}
  svc = data.get("service") or {}
  mine = readers.median_ms(client.get("latency_send_s", []))
  if mine is None or svc.get("latency_p50_s") is None:
    return None
  return mine - 1e3 * svc["latency_p50_s"]
