"""Shared pieces of the harness: the run's clock and set-up split, the
device trace and its reduction, and small statistics.

Nothing here imports the measured program.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import resource
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "mpi_vision_tpu")


def log(*parts) -> None:
  print(*parts, file=sys.stderr, flush=True)


def process_age_s() -> float:
  """Seconds since this process started, from the kernel's record of its
  start (``/proc``), or since this module loaded where there is none."""
  try:
    with open("/proc/self/stat") as f:
      fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started
  except (OSError, ValueError, IndexError, AttributeError):
    return time.perf_counter() - _LOADED


_LOADED = time.perf_counter()


class Setup:
  """Set-up time by part: process start to the first timed request."""

  def __init__(self):
    self.parts: dict[str, float] = {"process_start": process_age_s()}

  @contextlib.contextmanager
  def part(self, name: str):
    t0 = time.perf_counter()
    try:
      yield
    finally:
      self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t0

  def close(self) -> float:
    """Seconds since process start, now (the window opens here)."""
    self.total = process_age_s()
    self.parts["other"] = self.total - sum(self.parts.values())
    return self.total


class HostWindow:
  """This process's CPU seconds over a window, to standard error: the
  host side of a run that is bound by its host."""

  def __enter__(self):
    self._a = (time.perf_counter(), resource.getrusage(resource.RUSAGE_SELF))
    return self

  def __exit__(self, *exc):
    t1, b = time.perf_counter(), resource.getrusage(resource.RUSAGE_SELF)
    t0, a = self._a
    user, system = b.ru_utime - a.ru_utime, b.ru_stime - a.ru_stime
    log("host over the window: " + json.dumps(
        {"window_s": round(t1 - t0, 3), "cpu_s": round(user + system, 3),
         "sys_s": round(system, 3), "cpus": os.cpu_count()}))
    return False


def forbidden_modules() -> list[str]:
  """Loaded modules whose top-level name is JAX's, flax's or the JAX
  package's (compared whole: the port's own name only begins alike)."""
  return sorted(m for m in list(sys.modules)
                if m.split(".")[0] in FORBIDDEN)


def quantile(values, q: float) -> float | None:
  """The ``q`` quantile (0..1) of ``values``, linear between ranks."""
  v = sorted(values)
  if not v:
    return None
  pos = (len(v) - 1) * q
  lo = int(pos)
  hi = min(lo + 1, len(v) - 1)
  return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def quantile_ms(values, q: float) -> float | None:
  """``quantile`` of seconds, in milliseconds."""
  v = quantile(values, q)
  return None if v is None else 1e3 * v


def sync(torch, devices) -> None:
  for d in devices:
    if torch.device(d).type == "cuda":
      torch.cuda.synchronize(d)


def short_name(name: str) -> str:
  """A kernel's name without its return type, namespace noise and
  argument list."""
  s = name.replace("(anonymous namespace)::", "")
  if s.startswith("void "):
    s = s[5:]
  return s.split("(")[0].strip()[:96] or name[:96]


class DeviceTrace:
  """``torch.profiler`` over the measured window (CUDA activity only), or
  nothing when off. After the block: ``window_s`` (host clock), and
  ``summary()`` reduces the trace."""

  def __init__(self, torch, devices, enabled: bool):
    self.torch, self.devices = torch, list(devices)
    self.enabled = enabled and any(torch.device(d).type == "cuda"
                                   for d in devices)
    self.window_s = None
    self._prof = None

  def __enter__(self):
    if self.enabled:
      from torch.profiler import ProfilerActivity, profile

      self._prof = profile(activities=[ProfilerActivity.CUDA])
      self._prof.__enter__()
    self._ns0 = time.time_ns()
    self._t0 = time.perf_counter()
    return self

  def __exit__(self, *exc):
    sync(self.torch, self.devices)
    self.window_s = time.perf_counter() - self._t0
    self._ns1 = time.time_ns()
    if self._prof is not None:
      t0 = time.perf_counter()
      self._prof.__exit__(*exc)
      log(f"device trace: the profiler took {time.perf_counter() - t0:.3f} s "
          f"to stop")
    return False

  def _events(self):
    """``(device events, host CUDA-call events)``: ``(index, start_ns,
    end_ns, name)`` and ``(start_ns, end_ns, name)``."""
    # The profiler's raw results, read once, without its event tree.
    cuda = self.torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in self._prof.profiler.kineto_results.events():
      t0 = e.start_ns()
      if e.device_type() == cuda:
        dev.append((e.device_index(), t0, t0 + e.duration_ns(), e.name()))
      elif e.name().startswith("cuda"):
        host.append((t0, t0 + e.duration_ns(), e.name()))
    return dev, host

  def summary(self, top: int = 10) -> dict | None:
    """Busy seconds per card (the union of its device intervals inside the
    window), device seconds and launches by kernel, and the breakdown:
    the device operations that took most time and the longest idle gaps
    on the first card, each named by the CUDA call the host was in, else
    by the device operation that ended it."""
    if self._prof is None:
      return None
    t0 = time.perf_counter()
    dev, host = self._events()
    log(f"device trace: {len(dev)} device and {len(host)} host events read "
        f"in {time.perf_counter() - t0:.3f} s")
    lo, hi = self._ns0, self._ns1
    if dev:  # the profiler's clock may sit a little off the host's
      lo, hi = min(lo, min(e[1] for e in dev)), max(hi, max(e[2] for e in dev))
    indices = sorted({self.torch.device(d).index or 0 for d in self.devices})
    busy, merged0 = [], []
    for idx in indices:
      spans = sorted((t0, t1) for i, t0, t1, _ in dev if i == idx)
      merged = []
      for t0, t1 in spans:
        if merged and t0 <= merged[-1][1]:
          merged[-1][1] = max(merged[-1][1], t1)
        else:
          merged.append([t0, t1])
      busy.append(sum(t1 - t0 for t0, t1 in merged) * 1e-9)
      if idx == indices[0]:
        merged0 = merged
    kernel_s, kernel_n = {}, {}
    for _, t0, t1, name in dev:
      key = short_name(name)
      kernel_s[key] = kernel_s.get(key, 0.0) + (t1 - t0) * 1e-9
      kernel_n[key] = kernel_n.get(key, 0) + 1
    first = sorted((t0, n) for i, t0, _, n in dev if i == indices[0])
    starts = [t for t, _ in first]
    edges = [lo] + [x for m in merged0 for x in m] + [hi]
    longest = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2])
                      if b > a), reverse=True)[:top]
    gaps = []
    for length, a, b in longest:
      over = max(((min(b, t1) - max(a, t0), n) for t0, t1, n in host
                  if t1 > a and t0 < b), default=(0, None))
      if over[1] is not None and over[0] > 0.5 * length:
        label = f"host in {over[1]}"
      else:
        j = bisect.bisect_left(starts, b)
        label = (f"host, then {short_name(first[j][1])}" if j < len(first)
                 else "host, to window end")
      gaps.append([label, length * 1e-9])
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy, "window_s": self.window_s,
            "kernel_s": kernel_s, "kernel_n": kernel_n,
            "breakdown": {"device_ops": [[k, v] for k, v in ops],
                          "idle_gaps": gaps}}
