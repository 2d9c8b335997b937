"""Faults planted under the timed path, to show that the check catches them.

Each is a context manager that breaks the measured program underneath a
run and restores it on exit: the CPU tests run cells with them and expect
``correct`` to come out false, and ``calibrate.py`` reads on the card how
far each moves a cell's check readings.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name: str, make):
  original = getattr(owner, name)
  setattr(owner, name, make(original))
  try:
    yield
  finally:
    setattr(owner, name, original)


def altered_answer():
  """The render kernel's frames altered where they are produced: the red
  channel of every view raised by 0.05."""
  from mpi_vision_tpu_torch.kernels import render_fused

  def make(launch):
    def launch_altered(planes, homs):
      out = launch(planes, homs)
      out[..., 0] += 0.05
      return out
    return launch_altered

  return _patched(render_fused, "_launch", make)


def half_batch():
  """Half of each launch's views left out: the kernel renders the first
  half and the rest repeat it."""
  from mpi_vision_tpu_torch.kernels import render_fused

  def make(launch):
    def launch_half(planes, homs):
      views = homs.shape[0]
      if views < 2:
        return launch(planes, homs)
      keep = views // 2
      part = launch(planes if planes.dim() == 4 else planes[:keep],
                    homs[:keep].contiguous())
      return part.repeat((views + keep - 1) // keep, 1, 1, 1)[:views]
    return launch_half

  return _patched(render_fused, "_launch", make)


def state_unchanged():
  """A training step that returns its state unchanged: Adam's update
  skipped."""
  import torch

  return _patched(torch.optim.Adam, "step", lambda step: (
      lambda self, closure=None: None))


def exchange_left_out():
  """The exchange between cards left out: a sharded batch returns only
  the first card's views; the other cards' slices stay zero."""
  from mpi_vision_tpu_torch.serve.engine import RenderEngine

  def make(wait):
    def wait_first_shard(self, handle):
      frames = wait(self, handle)
      if self.use_mesh and len(self.devices) > 1:
        k = handle.out.shape[0] // len(self.devices)
        frames = frames.copy()
        frames[k:] = 0.0
      return frames
    return wait_first_shard

  return _patched(RenderEngine, "wait", make)


FAULTS = {"altered_answer": altered_answer, "half_batch": half_batch,
          "state_unchanged": state_unchanged,
          "exchange_left_out": exchange_left_out}
