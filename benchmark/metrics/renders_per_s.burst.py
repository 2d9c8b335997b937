"""Frames completed inside the window over its seconds (host clock): the
burst cell's throughput, which the host's shared memory bandwidth sets."""


def read(data):
  return (data.get("e2e") or {}).get("renders_per_s") or None
