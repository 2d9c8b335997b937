"""Reductions that several per-layer metrics share. Each returns None
where the run gave it nothing to read, never 0 for a share of a peak."""

from __future__ import annotations

from benchmark import common, counts


def idle_share(data: dict) -> float | None:
  """Per cent of the traced window in which no operation ran on the card,
  averaged over the cards the cell uses."""
  trace = data.get("trace")
  if not trace or not trace["busy_s"] or not trace["window_s"]:
    return None
  busy = sum(trace["busy_s"]) / len(trace["busy_s"])
  if busy <= 0:
    return None
  return 100.0 * (1.0 - busy / trace["window_s"])


def kernel_seconds(data: dict, *fragments: str) -> tuple[float, int]:
  """Device seconds and launches of the kernels whose names hold any of
  ``fragments``."""
  trace = data.get("trace") or {"kernel_s": {}, "kernel_n": {}}
  secs = sum(v for k, v in trace["kernel_s"].items()
             if any(f in k for f in fragments))
  n = sum(v for k, v in trace["kernel_n"].items()
          if any(f in k for f in fragments))
  return secs, n


def render_least_s(data: dict, per_frame: bool = False) -> float:
  """The fused render's least time over the window's launches, from the
  flights the service dispatched; ``per_frame`` counts only live views,
  each at its flight's least time per view."""
  cfg = data["config"]
  total = 0.0
  for f in data["flights"]:
    least, _ = counts.render(f["views_per_launch"], cfg["planes"],
                             cfg["height"], cfg["width"])
    if per_frame:
      total += f["count"] * f["live"] * least / f["views_per_launch"]
    else:
      total += f["count"] * f["launches"] * least
  return total


def median_ms(values) -> float | None:
  return common.quantile_ms(values, 0.5)
