"""Observability and numeric-safety hooks.

PyTorch counterpart of ``mpi_vision_tpu/debug.py``:

  * ``named_scope(name)`` — a context manager that marks a stage of the
    render or the loss as an NVTX range (when PyTorch has a CUDA device)
    and a ``torch.profiler.record_function`` range, so device profiles and
    Nsight timelines read ``render/warp``, ``render/composite``,
    ``loss/vgg`` instead of a flat op soup. Neither adds a device
    synchronise: both only stamp host-side markers.
  * ``trace(logdir)`` — a ``torch.profiler`` context recording CPU and
    CUDA activity of every thread in the process, written as a Chrome
    trace (``trace.json``) into ``logdir`` when it exits. The serving
    stack's on-demand profiler (``obs.profile.DeviceProfiler``,
    ``/debug/profile``) wraps exactly this entry point.
  * ``checked(fn)`` — wraps ``fn`` so a NaN or infinity in any of its
    floating outputs raises ``FloatingPointError``: the counterpart of the
    JAX package's checkify float checks, as far as eager PyTorch can go
    (the check reads the outputs, so it synchronises the device).
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Callable

import torch


# The profiler range: ``record_function``'s C++ counterpart where this
# PyTorch has it, ~1 us a range on a host CPU against ~14 us (the serving
# stack's host spans open one around every frame it copies). Its ranges
# show as ``cpu_op`` events where ``record_function``'s are
# ``user_annotation``; both sit on their thread's lane.
_profiler_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                          torch.profiler.record_function)


@contextlib.contextmanager
def named_scope(name: str):
  """NVTX range + profiler (``record_function``) range named ``name``.

  A profiler started while the range is open (``/debug/profile`` under
  load) leaves it out of the capture instead of failing the caller: the
  fast range asserts on exit that it opened something, which it did not.
  """
  nvtx = torch.cuda.is_available()
  if nvtx:
    torch.cuda.nvtx.range_push(name)
  profiler_range = _profiler_range(name)
  profiler_range.__enter__()
  try:
    yield
  finally:
    try:
      profiler_range.__exit__(None, None, None)
    except RuntimeError as e:
      if "no guard is set" not in str(e):
        raise
    finally:
      if nvtx:
        torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(logdir: str):
  """Profile the enclosed region into ``logdir/trace.json`` (Chrome trace).

  Records CPU activity, and CUDA activity when PyTorch has a device; the
  profiler flushes the device's activity buffers when it stops.
  """
  os.makedirs(logdir, exist_ok=True)
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  # Every thread's ranges: the serving stack renders on worker threads.
  prof = torch.profiler.profile(
      activities=activities,
      experimental_config=torch._C._profiler._ExperimentalConfig(
          profile_all_threads=True))
  prof.start()
  try:
    yield prof
  finally:
    prof.stop()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _non_finite(out, path: str = "output"):
  """The path of the first floating tensor in ``out`` holding a NaN or an
  infinity, else None."""
  if isinstance(out, torch.Tensor):
    if out.is_floating_point() and not bool(torch.isfinite(out).all()):
      return path
    return None
  if isinstance(out, dict):
    items = out.items()
  elif isinstance(out, (tuple, list)):
    items = enumerate(out)
  else:
    return None
  for key, value in items:
    found = _non_finite(value, f"{path}[{key!r}]")
    if found is not None:
      return found
  return None


def checked(fn: Callable) -> Callable:
  """Wrap ``fn`` so a NaN/inf in any floating output raises
  ``FloatingPointError`` naming the function and the output.

  Example::

      render = debug.checked(functools.partial(render_mpi, method="fused"))
      out = render(mpi, pose, depths, k)   # raises if any NaN comes out
  """

  @functools.wraps(fn)
  def wrapper(*args, **kwargs):
    out = fn(*args, **kwargs)
    bad = _non_finite(out)
    if bad is not None:
      name = getattr(fn, "__name__", type(fn).__name__)
      raise FloatingPointError(
          f"{name}: non-finite value (nan or inf) in {bad}")
    return out

  return wrapper
