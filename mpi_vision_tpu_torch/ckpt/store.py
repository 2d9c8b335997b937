"""Atomic, manifest'd, self-verifying checkpoint store.

A checkpoint is a directory ``<root>/step_<N>/`` holding exactly two
files:

  * ``arrays.npz``    — every leaf of a nested dict (or list) of tensors
    and arrays as one npz entry, keyed by its path in the ``['a']['b']``
    syntax (the JAX package's ``jax.tree_util.keystr``, so each package's
    store reads a flat checkpoint the other wrote); raw array bytes, no
    compression.
  * ``manifest.json`` — the integrity contract: per-array shape, dtype,
    and sha256 content hash, plus the step number and a free-form
    ``meta`` dict (data cursor, model config, preemption tag, ...).

Writes are crash-atomic: everything lands in a ``.tmp-*`` staging dir,
both files are fsynced, the staging dir is fsynced, and a single
``os.rename`` publishes the checkpoint (then the parent dir is fsynced
so the rename itself survives power loss). A process killed at ANY
point leaves either the previous checkpoint set intact or a stale
``.tmp-*`` dir, which the next ``CheckpointStore`` construction sweeps.

Leaves are copied to host arrays the checkpoint owns when the tree is
flattened (``flatten_arrays``): PyTorch updates parameters and optimizer
moments in place, and ``.numpy()`` of a CPU tensor shares its storage, so
a save that kept references would write whatever the next step left
there.

Reads are paranoid: a checkpoint only restores if its manifest parses,
every array the restore consults is present, and its content hash
matches (all arrays without a template; exactly the template's arrays
with one — a params-only restore never reads the Adam moments).
Anything else —
truncated npz, flipped bits, missing manifest — is *quarantined* (the
dir is renamed into ``<root>/quarantine/`` with the failure reason in
its name) and ``restore()`` automatically falls back to the next-newest
good checkpoint. Keep-last-K GC bounds disk usage; quarantined dirs are
never GC'd (they are evidence).

Wall-clock timestamps in manifests come from an injectable ``clock``.
"""

from __future__ import annotations

import dataclasses
import errno
import hashlib
import json
import os
import re
import shutil
import time
from typing import Callable, Mapping

import numpy as np
import torch

FORMAT = "mpi-ckpt-v1"
_STEP_RE = re.compile(r"^step_(\d{10})$")
_ARRAYS = "arrays.npz"
_MANIFEST = "manifest.json"

# Environmental read failures (fd exhaustion, interrupted syscall,
# memory pressure) say nothing about the bytes on disk: re-raised as-is
# so a healthy checkpoint is never quarantined over a transient
# condition. Everything else an open/read raises is treated as decay.
_TRANSIENT_ERRNOS = frozenset(
    {errno.EINTR, errno.EAGAIN, errno.EMFILE, errno.ENFILE, errno.ENOMEM})


def _raise_if_transient(e: BaseException) -> None:
  if isinstance(e, OSError) and e.errno in _TRANSIENT_ERRNOS:
    raise e

# npz entries these numpy kinds round-trip without pickle; anything else
# (e.g. ml_dtypes' bfloat16) is stored as raw uint8 bytes and re-viewed
# on restore using the dtype recorded in the manifest.
_NATIVE_KINDS = frozenset("biufc")


class CorruptCheckpointError(RuntimeError):
  """A checkpoint failed integrity validation (reason in the message)."""

  def __init__(self, path: str, reason: str):
    super().__init__(f"corrupt checkpoint at {path}: {reason}")
    self.path = path
    self.reason = reason


def _leaf_paths(tree, prefix: str = ""):
  """``(keystr path, leaf)`` for every leaf of a nested dict / list /
  tuple, dict keys in sorted order (as JAX flattens a dict)."""
  if isinstance(tree, Mapping):
    for key in sorted(tree):
      yield from _leaf_paths(tree[key], f"{prefix}[{key!r}]")
  elif isinstance(tree, (list, tuple)):
    for i, sub in enumerate(tree):
      yield from _leaf_paths(sub, f"{prefix}[{i}]")
  else:
    yield prefix, tree


def _owned_host_array(leaf) -> np.ndarray:
  """A C-ordered host copy of a leaf that nothing else writes to: a
  tensor is copied off its device (or out of its CPU storage), anything
  else through ``np.array`` (a Python float becomes a 0-d float64)."""
  if isinstance(leaf, torch.Tensor):
    return leaf.detach().to("cpu", memory_format=torch.contiguous_format,
                            copy=True).numpy()
  return np.array(leaf, order="C", copy=True)


def tree_keys(tree) -> set[str]:
  """The keystr paths of ``tree``'s leaves (nothing is copied)."""
  return {key for key, _ in _leaf_paths(tree)}


def flatten_arrays(tree) -> dict[str, np.ndarray]:
  """Nested dict / list of tensors and arrays -> ``{keystr_path: owned
  host ndarray}`` (stable, content-addressed keys shared by save and
  restore). Every leaf is copied, so later in-place updates of the
  tensors cannot reach the result."""
  out = {}
  n = 0
  for key, leaf in _leaf_paths(tree):
    out[key] = _owned_host_array(leaf)
    n += 1
  if len(out) != n:
    raise ValueError("duplicate keystr paths while flattening checkpoint")
  return out


def unflatten_arrays(arrays: Mapping[str, np.ndarray], template,
                     prefix: str = ""):
  """Rebuild ``template``'s structure (dicts, lists, tuples) from a flat
  array dict.

  Only the template's keys are consulted, so a params-only template can
  restore from a full train-state checkpoint (extra keys are ignored).
  """
  if isinstance(template, Mapping):
    return {key: unflatten_arrays(arrays, sub, f"{prefix}[{key!r}]")
            for key, sub in template.items()}
  if isinstance(template, (list, tuple)):
    return type(template)(unflatten_arrays(arrays, sub, f"{prefix}[{i}]")
                          for i, sub in enumerate(template))
  if prefix not in arrays:
    raise KeyError(
        f"checkpoint is missing array {prefix!r} required by the restore "
        "template (model/optimizer structure mismatch?)")
  return arrays[prefix]


def _sha256(arr: np.ndarray) -> str:
  return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _sha256_many(arrays: Mapping[str, np.ndarray]) -> dict[str, str]:
  """Per-array sha256 over a flat dict, hashed in parallel.

  ``hashlib`` releases the GIL on large buffers, so a small thread pool
  hashes a multi-hundred-MB train state in parallel instead of pinning
  one core for the whole save (the step-loop stall the background saver
  exists to remove). Serial for trivial inputs — pool spin-up would cost
  more than it saves.
  """
  keys = list(arrays)
  total_bytes = sum(a.nbytes for a in arrays.values())
  if len(keys) < 2 or total_bytes < (1 << 20):
    return {k: _sha256(arrays[k]) for k in keys}
  from concurrent.futures import ThreadPoolExecutor

  workers = min(len(keys), os.cpu_count() or 2, 8)
  with ThreadPoolExecutor(max_workers=workers,
                          thread_name_prefix="mpi-ckpt-hash") as pool:
    digests = pool.map(_sha256, (arrays[k] for k in keys))
    return dict(zip(keys, digests))


def _pid_alive(pid: int) -> bool:
  try:
    os.kill(pid, 0)
  except ProcessLookupError:
    return False
  except PermissionError:  # pragma: no cover - alive, other user
    return True
  return True


def _proc_start(pid: int) -> str | None:
  """The process's kernel start time (/proc, Linux) — pid recycling
  detector. None where /proc is unavailable."""
  try:
    with open(f"/proc/{pid}/stat", "rb") as fh:
      data = fh.read()
    # Field 22 (starttime), counted after the comm field — comm may
    # itself contain spaces/parens, so split after the LAST ')'.
    return data.rsplit(b")", 1)[1].split()[19].decode()
  except (OSError, IndexError):  # pragma: no cover - non-Linux
    return None


def _writer_alive(pid: int, start: str | None) -> bool:
  """Is the working dir's writer still the SAME process?

  A bare pid match is not enough: after a reboot (power loss mid-save —
  the exact crash this store defends against) the recorded pid is
  usually recycled by an unrelated live process, which would make the
  sweep skip the stale dir forever. The recorded start time disambiguates;
  legacy names without one (or platforms without /proc) fall back to
  pid existence."""
  if not _pid_alive(pid):
    return False
  if start is None:
    return True
  actual = _proc_start(pid)
  return actual is None or actual == start


def _fsync_dir(path: str) -> None:
  try:
    fd = os.open(path, os.O_RDONLY)
  except OSError:  # pragma: no cover - exotic filesystems
    return
  try:
    os.fsync(fd)
  except OSError:  # pragma: no cover - fsync on dirs unsupported
    pass
  finally:
    os.close(fd)


@dataclasses.dataclass(frozen=True)
class Restored:
  """One validated checkpoint: flat arrays + manifest metadata."""

  step: int
  arrays: dict[str, np.ndarray]
  meta: dict
  manifest: dict
  path: str

  def tree(self, template):
    """The arrays in ``template``'s structure (nested dicts / lists)."""
    return unflatten_arrays(self.arrays, template)


class CheckpointStore:
  """Atomic checkpoint lifecycle over one root directory.

  Args:
    root: checkpoint directory (created on first use).
    keep: newest checkpoints retained by GC (quarantine never GC'd).
    clock: wall-clock source for manifest timestamps (injectable).
    fault_hook: test seam — called as ``fault_hook(stage, path)`` with
      stage ``"pre_rename"`` (staging dir fully written and fsynced) and
      ``"post_rename"`` (checkpoint published). ``TrainFaultSource``
      plugs in here to simulate kill-mid-save and corrupt-after-write.
    events: optional ``obs.events.EventLog`` — the store emits its
      lifecycle (``ckpt_save``, ``ckpt_restore``, ``ckpt_quarantine``) at
      the source, as the JAX package's store does.
  """

  def __init__(self, root: str, keep: int = 3,
               clock: Callable[[], float] = time.time,
               fault_hook: Callable[[str, str], None] | None = None,
               events=None):
    if keep < 1:
      raise ValueError(f"keep must be >= 1, got {keep}")
    self.root = os.path.abspath(root)
    self.keep = int(keep)
    self.clock = clock
    self._fault_hook = fault_hook
    self.events = events
    # Cost of the newest PUBLISHED save (wall clock, same base as the
    # manifest timestamps).
    self.last_save_s = 0.0
    self.last_save_bytes = 0
    self._seq = 0
    # Writer identity for working-dir names: pid alone is ambiguous
    # after a reboot (recycled pids), so append the process start time
    # where /proc provides one.
    start = _proc_start(os.getpid())
    self._wtoken = (f"{os.getpid()}.{start}" if start is not None
                    else str(os.getpid()))
    self.saves = 0
    self.quarantined = 0
    os.makedirs(self.root, exist_ok=True)
    self._sweep_stale()

  # -- paths --------------------------------------------------------------

  def _step_dir(self, step: int) -> str:
    return os.path.join(self.root, f"step_{step:010d}")

  def _quarantine_root(self) -> str:
    return os.path.join(self.root, "quarantine")

  def _sweep_stale(self) -> None:
    """Repair after a process killed mid-save.

    ``.tmp-*`` (unpublished staging) and ``.rm-*`` (mid-deletion by
    gc/clear) dirs are removed. A ``.old-*`` dir is a published
    checkpoint moved aside by a same-step re-save: if the kill landed
    BETWEEN the move-aside and the publish rename, the aside copy is
    the only surviving copy — restore it; otherwise the replacement
    published and the aside is garbage.

    Working dirs embed their writer's pid + process start time, and a
    dir whose writer is STILL ALIVE is left alone: a read-only consumer
    (``serve --ckpt``, a digest check) constructed against a store that
    a live trainer is writing must not delete the trainer's in-flight
    staging. The start time guards against pid recycling (after a
    reboot a dead writer's pid usually names an unrelated live
    process). Our own pid counts as dead — this store was just
    constructed, so any same-pid leftover is not an in-flight save.
    """
    for name in os.listdir(self.root):
      if not name.startswith((".tmp-", ".rm-", ".old-")):
        continue
      m = re.match(r"^\.(?:tmp|rm|old)-(step_\d{10})-(\d+)(?:\.(\d+))?-",
                   name)
      if m is not None:
        pid = int(m.group(2))
        if pid != os.getpid() and _writer_alive(pid, m.group(3)):
          continue  # a live writer's working dir — not ours to touch
      path = os.path.join(self.root, name)
      if name.startswith(".old-") and m is not None:
        published = os.path.join(self.root, m.group(1))
        if not os.path.exists(published):
          os.rename(path, published)
          _fsync_dir(self.root)
          continue
      shutil.rmtree(path, ignore_errors=True)

  def steps(self) -> list[int]:
    """Published checkpoint steps, ascending (validity not yet checked)."""
    out = []
    for name in os.listdir(self.root):
      m = _STEP_RE.match(name)
      if m and os.path.isdir(os.path.join(self.root, name)):
        out.append(int(m.group(1)))
    return sorted(out)

  def latest_step(self) -> int | None:
    steps = self.steps()
    return steps[-1] if steps else None

  # -- save ---------------------------------------------------------------

  def save(self, step: int, tree, meta: dict | None = None) -> str:
    """Atomically publish ``tree`` as checkpoint ``step``; returns its dir.

    Re-saving an existing step replaces it atomically (rename-aside,
    publish, delete) — re-running a job over an old store must not wedge.
    Crash-atomic, but not invisible to CONCURRENT readers: between the
    move-aside and the publish rename the step is briefly unlisted, so a
    reader racing a same-step re-save can fall back one checkpoint (POSIX
    has no atomic directory exchange; renameat2(RENAME_EXCHANGE) is
    Linux-only). Readers that must not regress should retry or pin
    ``restore(step=...)``.

    Every leaf is copied to the host before ``save`` returns.
    """
    t_save = self.clock()
    return self.save_arrays(step, flatten_arrays(tree), meta, t_save)

  def save_arrays(self, step: int, arrays: Mapping[str, np.ndarray],
                  meta: dict | None = None,
                  t_save: float | None = None) -> str:
    """``save`` of an already flattened ``{keystr: ndarray}`` whose arrays
    the caller no longer writes (``flatten_arrays`` output): the half of a
    save that ``BackgroundSaver`` runs on its worker thread. ``t_save``
    is when the save began, for ``last_save_s`` (default now)."""
    step = int(step)
    if step < 0:
      raise ValueError(f"step must be >= 0, got {step}")
    if t_save is None:
      t_save = self.clock()
    self._seq += 1
    final = self._step_dir(step)
    tmp = os.path.join(
        self.root, f".tmp-step_{step:010d}-{self._wtoken}-{self._seq}")
    os.makedirs(tmp)
    aside = None
    try:
      # NOT ascontiguousarray: that promotes 0-d scalars (the step
      # counter) to 1-d, silently changing the restored tree's shapes.
      arrays = {k: np.asarray(a, order="C") for k, a in arrays.items()}
      digests = _sha256_many(arrays)
      entries = {}
      stored = {}
      for key, arr in arrays.items():
        entry = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                 "sha256": digests[key]}
        if arr.dtype.kind not in _NATIVE_KINDS:
          # Non-native dtype (bf16 & friends): ship raw bytes, re-view on
          # restore from the manifest dtype. npz would pickle these.
          entry["stored_as"] = "u1"
          # reshape BEFORE view: numpy rejects re-viewing a 0-d array
          # (itemsize change), and restore reshapes from the manifest
          # shape anyway.
          arr = arr.reshape(-1).view(np.uint8)
        entries[key] = entry
        stored[key] = arr
      with open(os.path.join(tmp, _ARRAYS), "wb") as fh:
        np.savez(fh, **stored)
        fh.flush()
        os.fsync(fh.fileno())
      manifest = {
          "format": FORMAT,
          "step": step,
          "saved_unix_s": float(self.clock()),
          "arrays": entries,
          "meta": dict(meta or {}),
      }
      with open(os.path.join(tmp, _MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.flush()
        os.fsync(fh.fileno())
      _fsync_dir(tmp)
      if self._fault_hook is not None:
        self._fault_hook("pre_rename", tmp)
      if os.path.exists(final):
        aside = os.path.join(
            self.root, f".old-step_{step:010d}-{self._wtoken}-{self._seq}")
        os.rename(final, aside)
      os.rename(tmp, final)
      _fsync_dir(self.root)
      if aside is not None:
        shutil.rmtree(aside, ignore_errors=True)
    except BaseException:
      # Leave no half-published state: drop the staging dir, and if a
      # same-step replacement died between move-aside and publish, put
      # the moved-aside original back (a killed process can't run this
      # — the init-time sweep restores ``.old-*`` dirs for that case).
      shutil.rmtree(tmp, ignore_errors=True)
      if (aside is not None and os.path.exists(aside)
          and not os.path.exists(final)):
        os.rename(aside, final)
      raise
    self.saves += 1
    self.last_save_s = max(self.clock() - t_save, 0.0)
    self.last_save_bytes = sum(a.nbytes for a in arrays.values())
    if self.events is not None:
      self.events.emit("ckpt_save", step=step,
                       bytes=self.last_save_bytes,
                       seconds=round(self.last_save_s, 6),
                       reason=str((meta or {}).get("reason", "")))
    if self._fault_hook is not None:
      self._fault_hook("post_rename", final)
    self.gc()
    return final

  def clear(self) -> list[int]:
    """Remove every published checkpoint (quarantine untouched).

    A fresh run over a used store (``fit_resumable(resume='never')``)
    must clear history first: otherwise a NaN rollback could "restore"
    a stale newer-step checkpoint from the previous run.
    """
    removed = []
    for step in self.steps():
      aside = os.path.join(
          self.root, f".rm-step_{step:010d}-{self._wtoken}-clear")
      os.rename(self._step_dir(step), aside)
      shutil.rmtree(aside, ignore_errors=True)
      removed.append(step)
    if removed:
      _fsync_dir(self.root)
    return removed

  def gc(self) -> list[int]:
    """Delete all but the newest ``keep`` checkpoints; returns removed
    steps. Quarantined checkpoints are evidence and never collected."""
    steps = self.steps()
    removed = []
    for step in steps[:-self.keep] if len(steps) > self.keep else []:
      doomed = self._step_dir(step)
      # Rename-then-delete so a reader never sees a half-deleted dir
      # under the published name.
      aside = os.path.join(
          self.root, f".rm-step_{step:010d}-{self._wtoken}-gc")
      try:
        os.rename(doomed, aside)
      except OSError:  # pragma: no cover - concurrent GC
        continue
      shutil.rmtree(aside, ignore_errors=True)
      removed.append(step)
    return removed

  # -- restore ------------------------------------------------------------

  def _load(self, path: str, keys=None
            ) -> tuple[dict, dict[str, np.ndarray]]:
    """Validate + load one checkpoint dir -> (manifest, arrays).

    ``keys`` (a set of keystr paths) restricts reading and hash
    verification to those manifest entries — a params-only restore
    (``serve --ckpt``) skips decompressing and hashing the optimizer
    moments, ~2/3 of the payload. Structural checks (manifest parse,
    member presence, unmanifested-array detection) still span the whole
    checkpoint.
    """
    mpath = os.path.join(path, _MANIFEST)
    try:
      with open(mpath) as fh:
        manifest = json.load(fh)
    except (OSError, ValueError) as e:
      _raise_if_transient(e)
      raise CorruptCheckpointError(path, f"manifest unreadable ({e})")
    if not isinstance(manifest, dict) or manifest.get("format") != FORMAT:
      raise CorruptCheckpointError(
          path, f"unknown format {manifest.get('format') if isinstance(manifest, dict) else manifest!r}")
    entries = manifest.get("arrays")
    if not isinstance(entries, dict):
      raise CorruptCheckpointError(path, "manifest has no arrays table")
    try:
      # Top-level fields can be mangled just like per-array entries; a
      # missing/garbled step must quarantine-and-fall-back, not crash
      # restore() with a bare KeyError.
      mstep = int(manifest["step"])
    except (KeyError, TypeError, ValueError) as e:
      raise CorruptCheckpointError(path, f"manifest step invalid ({e})")
    m = _STEP_RE.match(os.path.basename(path))
    if m is not None and mstep != int(m.group(1)):
      # A garbled-but-parseable step (per-array hashes don't cover it)
      # would desync Restored.step from the directory it came from —
      # wrong loss truncation on NaN rollback and a newest-is-bad check
      # that never matches its own checkpoint.
      raise CorruptCheckpointError(
          path, f"manifest step {mstep} != directory step {int(m.group(1))}")
    wanted = [k for k in entries if keys is None or k in keys]
    try:
      with np.load(os.path.join(path, _ARRAYS),
                   allow_pickle=False) as npz:
        names = set(npz.files)
        raw = {k: npz[k] for k in wanted if k in names}
    except Exception as e:  # noqa: BLE001 - any zip/IO decay is corruption
      _raise_if_transient(e)
      raise CorruptCheckpointError(path, f"arrays unreadable ({e})")
    arrays = {}
    for key in wanted:
      entry = entries[key]
      if key not in raw:
        raise CorruptCheckpointError(path, f"array {key!r} missing")
      arr = raw[key]
      try:
        # A manifest that parses as JSON can still be mangled (entry not
        # a dict, fields missing, dtype garbage): ANY malformed entry is
        # corruption and must take the quarantine-and-fallback path, not
        # crash restore() with a bare KeyError.
        dtype = np.dtype(entry["dtype"])
        shape = list(entry["shape"])
        sha = entry["sha256"]
        stored_as = entry.get("stored_as")
      except (KeyError, TypeError, AttributeError, ValueError) as e:
        raise CorruptCheckpointError(
            path, f"array {key!r} has a malformed manifest entry ({e})")
      if stored_as == "u1":
        want_bytes = int(np.prod(shape)) * dtype.itemsize
        if arr.dtype != np.uint8 or arr.size != want_bytes:
          raise CorruptCheckpointError(
              path, f"array {key!r} raw payload is {arr.size} bytes, "
                    f"manifest says {want_bytes}")
        arr = arr.view(dtype).reshape(shape)
      elif list(arr.shape) != shape or str(arr.dtype) != entry["dtype"]:
        raise CorruptCheckpointError(
            path, f"array {key!r} is {arr.dtype}{list(arr.shape)}, "
                  f"manifest says {entry['dtype']}{shape}")
      if _sha256(arr) != sha:
        raise CorruptCheckpointError(path, f"array {key!r} hash mismatch")
      arrays[key] = arr
    extra = names - set(entries)
    if extra:
      raise CorruptCheckpointError(
          path, f"unmanifested arrays {sorted(extra)}")
    return manifest, arrays

  def quarantine(self, step: int, reason: str) -> str | None:
    """Move a bad checkpoint into ``quarantine/`` (kept for forensics)."""
    src = self._step_dir(step)
    if not os.path.exists(src):
      return None
    qroot = self._quarantine_root()
    os.makedirs(qroot, exist_ok=True)
    slug = re.sub(r"[^a-zA-Z0-9._-]+", "_", reason)[:48] or "bad"
    base = os.path.join(qroot, f"step_{step:010d}.{slug}")
    dst = base
    n = 0
    while os.path.exists(dst):
      n += 1
      dst = f"{base}.{n}"
    os.rename(src, dst)
    _fsync_dir(self.root)
    self.quarantined += 1
    if self.events is not None:
      self.events.emit("ckpt_quarantine", step=int(step), reason=reason)
    return dst

  # -- cross-store publish --------------------------------------------------

  def publish_from(self, src_root: str, meta_extra: dict | None = None
                   ) -> tuple[int, int]:
    """Copy ``src_root``'s newest GOOD checkpoint into this store under
    the next free step number; returns ``(published_step, source_step)``.

    The training-queue ingest edge: a completed job's private store is
    republished into the fleet's watch directory (the ``serve
    --reload-ckpt-s`` store) as a monotonically newer step, so the
    ``CheckpointWatcher`` fires exactly once per publish. The arrays
    file is copied byte-for-byte (the per-array hashes stay valid, so
    the published params are provably bit-identical to what the job
    trained); only the manifest's ``step`` and ``meta`` are rewritten.
    The source is fully validated first — a corrupt newest checkpoint
    quarantines (in the SOURCE store) and the next-newest good one
    publishes instead, the standard rollback.
    """
    src = CheckpointStore(src_root, clock=self.clock)
    restored = src.restore()
    if restored is None:
      raise FileNotFoundError(
          f"no restorable checkpoint under {src_root} to publish")
    latest = self.latest_step()  # NOT `or -1`: step 0 is falsy
    step = 0 if latest is None else latest + 1
    self._seq += 1
    tmp = os.path.join(
        self.root, f".tmp-step_{step:010d}-{self._wtoken}-{self._seq}")
    os.makedirs(tmp)
    try:
      shutil.copyfile(os.path.join(restored.path, _ARRAYS),
                      os.path.join(tmp, _ARRAYS))
      with open(os.path.join(tmp, _ARRAYS), "rb") as fh:
        os.fsync(fh.fileno())
      manifest = dict(restored.manifest)
      manifest["step"] = step
      manifest["meta"] = {**restored.meta,
                          "published_from_step": restored.step,
                          **(meta_extra or {})}
      with open(os.path.join(tmp, _MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.flush()
        os.fsync(fh.fileno())
      _fsync_dir(tmp)
      os.rename(tmp, self._step_dir(step))
      _fsync_dir(self.root)
    except BaseException:
      shutil.rmtree(tmp, ignore_errors=True)
      raise
    self.saves += 1
    self.last_save_bytes = sum(a.nbytes for a in restored.arrays.values())
    if self.events is not None:
      self.events.emit("ckpt_publish", step=step,
                       source_step=restored.step,
                       bytes=self.last_save_bytes)
    self.gc()
    return step, restored.step

  def restore(self, step: int | None = None, template=None,
              on_quarantine: Callable[[int, str], None] | None = None
              ) -> Restored | None:
    """The newest checkpoint that passes validation (or exactly ``step``).

    Corrupted checkpoints encountered on the way are quarantined and the
    search falls back to the next-newest good one — the automatic
    rollback path. Returns None when the store holds no restorable
    checkpoint. With ``template``, ``Restored.arrays`` is additionally
    checked to cover the template (fail fast on structure mismatch),
    and loading + hash verification are RESTRICTED to the template's
    arrays — a params-only template never reads the optimizer moments
    off disk (the ``serve --ckpt`` startup path).

    Args:
      step: restore exactly this step (corruption then raises after
        quarantining instead of falling back).
      template: optional nested dict / list whose structure the checkpoint must
        cover; validated by running ``unflatten_arrays`` once, and the
        only arrays loaded/verified when given.
      on_quarantine: optional ``(step, reason)`` callback per fallback.
    """
    keys = None
    if template is not None:
      keys = tree_keys(template)
    candidates = [step] if step is not None else sorted(
        self.steps(), reverse=True)
    for cand in candidates:
      path = self._step_dir(cand)
      try:
        manifest, arrays = self._load(path, keys=keys)
      except CorruptCheckpointError as e:
        self.quarantine(cand, e.reason)
        if on_quarantine is not None:
          on_quarantine(cand, e.reason)
        if step is not None:
          raise
        continue
      restored = Restored(step=int(manifest["step"]), arrays=arrays,
                          meta=dict(manifest.get("meta", {})),
                          manifest=manifest, path=path)
      if template is not None:
        restored.tree(template)  # raises KeyError on structure mismatch
      if self.events is not None:
        self.events.emit("ckpt_restore", step=restored.step)
      return restored
    return None
