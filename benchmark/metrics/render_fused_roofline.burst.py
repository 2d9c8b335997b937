"""The fused render kernel's share of its roofline: the least time of the
window's launches (``benchmark/counts.py``, at each launch's views) over
the kernel's device time summed by name in the profiler's trace."""

from benchmark import readers


def read(data):
  secs, n = readers.kernel_seconds(data, "render_fused_kernel")
  if secs <= 0 or n == 0:
    return None
  return 100.0 * readers.render_least_s(data) / secs
