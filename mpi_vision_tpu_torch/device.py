"""Device selection for the port's entry points.

Every entry point (``RenderEngine``, ``RenderService``, ``bake_scene``, the
CLI) runs on the card unless its caller asks for the CPU by name. With no
CUDA device and no explicit ``"cpu"``, ``resolve_device`` raises: a serving
process that quietly rendered on the host would answer at a fraction of
the rate its operator sized it for, with nothing in its output to say so.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
  """``device`` as a ``torch.device`` (default ``"cuda"``).

  A CUDA device without an index resolves to the current one, so the
  engine's stream, the baked scenes and the kernel launch all name the
  same card. Raises ``RuntimeError`` for a CUDA device when PyTorch sees
  none, and ``ValueError`` for a device type other than cuda or cpu.
  """
  dev = torch.device(DEFAULT_DEVICE if device is None else device)
  if dev.type == "cpu":
    return dev
  if dev.type != "cuda":
    raise ValueError(f"device must be cuda or cpu, got {dev}")
  if not torch.cuda.is_available():
    raise RuntimeError(
        f"device {str(dev)!r} requested but PyTorch sees no CUDA device; "
        "pass device='cpu' to run on the host")
  if dev.index is None:
    dev = torch.device("cuda", torch.cuda.current_device())
  return dev
