"""The 95th percentile over every request of the window, from the send to
the whole frame in the client's hands (host clock)."""


def read(data):
  return (data.get("e2e") or {}).get("latency_p95_ms") or None
