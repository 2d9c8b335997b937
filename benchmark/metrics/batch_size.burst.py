"""Views a flight carried in the window: requests over batches, from the
scheduler's own counters (``serve/scheduler.py`` via ``ServeMetrics``)."""


def read(data):
  svc = data.get("service") or {}
  if not svc.get("batches"):
    return None
  return svc["requests"] / svc["batches"]
