"""The port stands alone: no JAX, nothing of the JAX package, no quiet CPU.

``mpi_vision_tpu_torch`` and ``chip_smoke.py`` import ``torch``, numpy and
the standard library only (the JAX package is the reference the port is
held to, never a dependency of it), and its entry points run on the card
unless the caller asks for the CPU by name.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi_vision_tpu_torch import device as device_mod
from mpi_vision_tpu_torch.serve import (
    RenderEngine,
    RenderService,
    bake_scene,
    synthetic_scene,
)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "mpi_vision_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "mpi_vision_tpu")


def _port_modules() -> list[str]:
  mods = []
  for path in sorted(PORT.rglob("*.py")):
    rel = path.relative_to(ROOT).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__main__":
      continue
    if parts[-1] == "__init__":
      parts = parts[:-1]
    mods.append(".".join(parts))
  return mods


def _forbidden(name: str) -> bool:
  return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_scan_covers_the_training_slice():
  mods = set(_port_modules())
  for name in ("mpi_vision_tpu_torch.config",
               "mpi_vision_tpu_torch.core.sweep",
               "mpi_vision_tpu_torch.models.stereo_mag",
               "mpi_vision_tpu_torch.train.vgg",
               "mpi_vision_tpu_torch.train.loss",
               "mpi_vision_tpu_torch.train.loop",
               "mpi_vision_tpu_torch.data.realestate",
               "mpi_vision_tpu_torch.kernels.render_fused_bwd"):
    assert name in mods


def test_scan_covers_the_tiled_serving_slice():
  mods = set(_port_modules())
  for name in ("mpi_vision_tpu_torch.kernels.compose_over",
               "mpi_vision_tpu_torch.serve.tiles",
               "mpi_vision_tpu_torch.serve.server",
               "mpi_vision_tpu_torch.serve.scheduler"):
    assert name in mods


def test_every_module_imports_with_jax_and_the_jax_package_blocked():
  code = (
      "import sys\n"
      "def loaded():\n"
      "  return {m for m, mod in sys.modules.items() if mod is not None\n"
      "          and m.split('.')[0] in ('jax', 'jaxlib', 'mpi_vision_tpu')}\n"
      "before = loaded()\n"
      "for name in ('jax', 'jaxlib', 'mpi_vision_tpu'):\n"
      "  sys.modules[name] = None\n"
      "import importlib\n"
      f"names = {_port_modules()!r}\n"
      "for name in names:\n"
      "  importlib.import_module(name)\n"
      "import chip_smoke\n"
      "bad = sorted(loaded() - before)\n"
      "assert not bad, bad\n"
      "print('ok', len(names))\n")
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  env["PYTHONPATH"] = str(ROOT)
  proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=240)
  assert proc.returncode == 0, proc.stderr[-4000:]
  assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in list(PORT.rglob("*.py"))
    + [ROOT / "chip_smoke.py"]))
def test_no_jax_import_in_source(path):
  tree = ast.parse((ROOT / path).read_text(), filename=path)
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      names = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom):
      names = [node.module or ""] if node.level == 0 else []
    else:
      continue
    bad = [n for n in names if _forbidden(n)]
    assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_entry_points_refuse_to_run_on_the_cpu_unasked(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    RenderEngine()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    RenderService()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    RenderService(tile=8)
  rgba, depths, k = synthetic_scene("s", 8, 8, 2)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    bake_scene("s", rgba, depths, k)
  with pytest.raises(ValueError, match="cuda or cpu"):
    device_mod.resolve_device("meta")
  assert RenderEngine(device="cpu").platform == "cpu"
  assert bake_scene("s", rgba, depths, k, device="cpu").planes.device.type \
      == "cpu"
  assert np.isfinite(RenderEngine(device="cpu").render_one(
      bake_scene("s", rgba, depths, k, device="cpu"),
      np.eye(4, dtype=np.float32))).all()


def test_train_entry_refuses_to_run_on_the_cpu_unasked(monkeypatch, tmp_path):
  from mpi_vision_tpu_torch import cli, config
  from mpi_vision_tpu_torch.data import realestate
  from mpi_vision_tpu_torch.train import loop

  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  cfg = config.TrainConfig()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    cfg.make_train_state()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    cfg.make_vgg()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    loop.create_train_state()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    cfg.data.make_dataset()
  with pytest.raises(RuntimeError, match="no CUDA device"):
    realestate.RealEstateDataset(str(tmp_path))
  scene = realestate.Scene("v", [0, 1, 2], np.zeros((3, 4), np.float32),
                           np.zeros((3, 4, 4), np.float32))
  with pytest.raises(RuntimeError, match="no CUDA device"):
    realestate.make_example(str(tmp_path), scene, [0, 1, 2])
  args = ["train", "--synthetic", "--synthetic-scenes", "2", "--img-size",
          "16", "--num-planes", "2", "--epochs", "1", "--no-vgg-loss",
          "--dataset", str(tmp_path)]
  with pytest.raises(RuntimeError, match="no CUDA device"):
    cli.main(args)
  assert not any(tmp_path.iterdir()), "failed after writing data"
  state = cfg.make_train_state(device="cpu")
  assert next(state.model.parameters()).device.type == "cpu"


def test_kernel_build_is_lazy():
  """Importing the kernel modules builds nothing; the library path is
  keyed by the source and the flags."""
  from mpi_vision_tpu_torch.kernels import _build

  from mpi_vision_tpu_torch.kernels import compose_over

  assert {"render_fused", "render_fused_bwd", "compose_over"} <= set(
      _build.sources())
  for name in ("render_fused", "compose_over"):
    path = _build.library_path(name)
    assert path.parent == _build.BUILD_DIR and path.name.endswith(".so")
  # A CPU call runs the plain version and loads no library.
  compose_over.over_composite_pallas(torch.zeros(2, 4, 4, 4))
  assert "compose_over" not in _build._libs
  assert "-fmad=false" in _build.NVCC_FLAGS
  assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
