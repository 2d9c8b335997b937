"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (seconds to build;
an extension that includes PyTorch's headers takes minutes). Nothing runs
at import: the first CUDA launch builds and loads its library, so the
package imports on a machine with no ``nvcc`` and no card, where the CPU
paths never reach this module's loaders.

Libraries land in ``kernels/build/`` (git-ignored), named by a hash of the
source, the shared headers and the flags, so an edited source rebuilds and
a stale library is never loaded. A missing ``nvcc`` or a failed build raises; nothing falls
back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# -fmad=false: no multiply-add contraction, so each kernel rounds where its
# plain PyTorch version does (see the source notes).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# Compiler output (ptxas register and spill report) of each build in this
# process, by kernel name.
build_logs: dict[str, str] = {}


def find_nvcc() -> str:
  """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or /usr/local/cuda."""
  found = shutil.which("nvcc")
  if found:
    return found
  for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
    if root and Path(root, "bin", "nvcc").is_file():
      return str(Path(root, "bin", "nvcc"))
  raise RuntimeError(
      "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA kernels "
      "are built from kernels/csrc/ at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
  """Where ``csrc/<name>.cu`` builds to: keyed by the source, the shared
  headers (``csrc/*.cuh``) and the flags."""
  digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
  for header in sorted(CSRC.glob("*.cuh")):
    digest.update(header.read_bytes())
  digest.update(" ".join(NVCC_FLAGS).encode())
  return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> dict[str, float]:
  """Compile every named source not yet built, all ``nvcc``s at once.

  Returns seconds per compiled name (already-built names are skipped).
  Raises ``RuntimeError`` naming each source that failed to compile.
  """
  todo = [n for n in names if not library_path(n).exists()]
  if not todo:
    return {}
  nvcc = find_nvcc()
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  procs = {}
  t0 = time.perf_counter()
  for name in todo:
    tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    procs[name] = (tmp, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
  seconds, failed = {}, []
  for name, (tmp, proc) in procs.items():
    log, _ = proc.communicate()
    seconds[name] = time.perf_counter() - t0
    build_logs[name] = log
    if proc.returncode != 0:
      failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
      tmp.unlink(missing_ok=True)
      continue
    os.replace(tmp, library_path(name))  # atomic: no half-written library
  if failed:
    raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
  return seconds


def load(name: str, signatures: dict) -> ctypes.CDLL:
  """The loaded library of ``csrc/<name>.cu``, building it on first use.

  ``signatures`` maps each C function to ``(argtypes, restype)``; they are
  declared once, when the library loads (a pointer passed without its
  ``argtypes`` would be cut to 32 bits).
  """
  with _lock:
    lib = _libs.get(name)
    if lib is None:
      build([name])
      lib = ctypes.CDLL(str(library_path(name)))
      for fn_name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, restype
      _libs[name] = lib
    return lib


def sources() -> list[str]:
  """Names of every kernel source under ``csrc/``."""
  return sorted(p.stem for p in CSRC.glob("*.cu"))
