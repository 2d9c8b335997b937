"""Device milliseconds of frame readback a served frame: the engine's
CUDA-event phase split (``serve/engine.py``, ``device_phase_seconds``)
summed over the window, over the requests served."""


def read(data):
  svc = data.get("service") or {}
  if not svc.get("requests") or not svc.get("phase_s", {}).get("readback"):
    return None
  return 1e3 * svc["phase_s"]["readback"] / svc["requests"]
