"""Median of the service tracer's ``queue_wait`` spans (submit to the
flight that claims the request, ``serve/scheduler.py``) in the window."""

from benchmark import readers


def read(data):
  return readers.median_ms(data.get("queue_wait_s") or [])
