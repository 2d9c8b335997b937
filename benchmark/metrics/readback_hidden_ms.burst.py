"""Device milliseconds a served frame during which the frame readback ran
under the render: the engine's ``readback_hidden`` phase (``serve/
engine.py``: a flight's row bands are read back on the copy stream while
the later bands render), summed over the window, over the requests served.
None where the program reports no such phase, or hid nothing (one-band
flights, the CPU)."""


def read(data):
  svc = data.get("service") or {}
  hidden = svc.get("phase_s", {}).get("readback_hidden")
  if not svc.get("requests") or not hidden:
    return None
  return 1e3 * hidden / svc["requests"]
