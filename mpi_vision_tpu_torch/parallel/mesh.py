"""Device-mesh parallelism for MPI rendering, compositing and training.

PyTorch counterpart of ``mpi_vision_tpu/parallel/mesh.py``, with its names
and semantics. The JAX mesh is single-process: ``make_mesh`` takes the
devices one process sees and ``shard_map`` runs a function per device.
This module is the same single controller without ``shard_map``: one
process holds a ``Mesh`` of devices, splits the work over a mesh axis, and
runs each device's piece itself, in shard order.

  * **views** — ``render_views_sharded`` replicates one MPI and splits a
    batch of target poses over the ``data`` axis; every device renders its
    views with ``core.render.render_views`` (under
    ``method="fused_pallas"``, one ``render_fused`` launch per shard), and
    the frames are gathered on the mesh's first device.
  * **planes** — each plane is the affine map ``out -> rgb*a + (1-a)*out``
    and affine maps compose associatively (core/compose.py), so
    ``over_composite_planes_sharded`` splits the planes over the
    ``planes`` axis: every device folds its planes into ONE ``(A, B)``
    pair, the pairs are gathered on the first device (the JAX
    ``all_gather``, done as copies) and folded there in shard order.
    ``render_views_planes_sharded`` combines both on a 2-D mesh.

A mesh may repeat a device: ``make_mesh(devices=["cpu"] * 8)`` is the
counterpart of the JAX tests' virtual 8-device CPU mesh, and
``[cuda:0] * 2`` runs a real 2-way split on one card. Where devices
repeat, copies are shared, not duplicated. Where the mesh holds distinct
CUDA devices, each shard's work is enqueued on its own device's current
stream before anything waits on it (the gather's device-to-device copies
are stream-ordered). The shard order is fixed by the mesh's layout, so two
runs agree to the bit.

``make_mesh()`` with no devices named takes every visible CUDA device and
raises without one; ``devices=["cpu", ...]`` is how a caller asks for the
host.
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from mpi_vision_tpu_torch.core import compose, render
from mpi_vision_tpu_torch.core.sampling import Convention
from mpi_vision_tpu_torch.device import resolve_device


class PartitionSpec(tuple):
  """How one leaf lies on a mesh: ``P("data")`` split over ``data``, ``P()``
  replicated — a tuple of axis names, as JAX's ``PartitionSpec``."""

  def __new__(cls, *names):
    return super().__new__(cls, names)

  def __repr__(self) -> str:
    return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
  """Devices laid out on named axes.

  ``devices`` is a numpy object array of ``torch.device`` shaped like the
  mesh; ``axis_names`` names its axes; ``shape[axis]`` is an axis' size,
  as in ``jax.sharding.Mesh``. A device may appear more than once.
  """

  def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
    devices = np.asarray(devices, dtype=object)
    axis_names = tuple(axis_names)
    if devices.ndim != len(axis_names):
      raise ValueError(f"mesh of rank {devices.ndim} needs as many axis "
                       f"names, got {axis_names}")
    if len(set(axis_names)) != len(axis_names):
      raise ValueError(f"axis names repeat: {axis_names}")
    types = {d.type for d in devices.flat}
    if len(types) > 1:
      raise ValueError(f"a mesh is all cuda or all cpu, got {sorted(types)}")
    self.devices = devices
    self.axis_names = axis_names

  @property
  def shape(self) -> dict[str, int]:
    return dict(zip(self.axis_names, self.devices.shape))

  @property
  def first(self) -> torch.device:
    """The device results are gathered on."""
    return self.devices.flat[0]

  @property
  def distinct_devices(self) -> list[torch.device]:
    """Each device once, in mesh order."""
    return list(dict.fromkeys(self.devices.flat))

  def grid(self, *axes: str) -> np.ndarray:
    """The devices along ``axes`` (in that order), every other axis at
    its first position — the devices a ``shard_map`` over ``axes`` splits
    work across; the other axes replicate it."""
    missing = [a for a in axes if a not in self.axis_names]
    if missing:
      raise KeyError(f"mesh axes {self.axis_names} have no {missing}")
    idx = [self.axis_names.index(a) for a in axes]
    arr = np.moveaxis(self.devices, idx, list(range(len(idx))))
    while arr.ndim > len(axes):
      arr = arr[..., 0]
    return arr

  def axis_devices(self, axis: str) -> list[torch.device]:
    """The devices along one axis, by mesh position."""
    return list(self.grid(axis))

  def __repr__(self) -> str:
    return (f"Mesh({self.shape}, devices="
            f"{[str(d) for d in self.devices.flat]})")


def make_mesh(axis_names: tuple[str, ...] = ("data",),
              shape: tuple[int, ...] | None = None,
              devices=None) -> Mesh:
  """A device mesh over every visible CUDA device (or the given devices).

  Defaults to a 1-D ``('data',)`` mesh; pass ``shape`` for multi-axis
  layouts, e.g. ``axis_names=('data', 'planes'), shape=(2, 4)``.
  ``devices`` may name a device more than once (``["cpu"] * 8``). With no
  ``devices`` and no CUDA device this raises: it never turns to the CPU
  unasked.
  """
  if devices is None:
    if not torch.cuda.is_available():
      raise RuntimeError(
          "make_mesh: PyTorch sees no CUDA device; pass devices=['cpu', ...] "
          "to build a mesh on the host")
    devices = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
  else:
    devices = [resolve_device(d) for d in devices]
  if not devices:
    raise ValueError("make_mesh: no devices")
  if shape is None:
    shape = (len(devices),) + (1,) * (len(axis_names) - 1)
  arr = np.empty(len(devices), dtype=object)
  arr[:] = devices
  return Mesh(arr.reshape(tuple(shape)), axis_names)


def _on(device: torch.device):
  """Make ``device`` current for the work inside (CUDA); a no-op on the
  host."""
  return (torch.cuda.device(device) if device.type == "cuda"
          else contextlib.nullcontext())


def _to(x, device: torch.device):
  """``x`` on ``device``: the same tensor when it is already there."""
  if x is None or x.device == device:
    return x
  return x.to(device, non_blocking=True)


def render_views_sharded(
    rgba_layers: torch.Tensor,
    tgt_poses: torch.Tensor,
    depths: torch.Tensor,
    intrinsics: torch.Tensor,
    mesh: Mesh,
    axis: str = "data",
    convention: Convention = Convention.REF_HOMOGRAPHY,
    method: str = "fused",
    tgt_intrinsics: torch.Tensor | None = None,
    out_hw: tuple[int, int] | None = None,
    **render_kwargs,
) -> torch.Tensor:
  """Render a batch of V target views, views sharded over a mesh axis.

  The MPI (one scene) is replicated; each device renders ``V / n`` views
  with ``core.render.render_views`` — one ``render_fused`` launch per
  shard under ``method="fused_pallas"``, which covers every pose, so the
  JAX package's planning step has no counterpart. V must be divisible by
  the axis size.

  Args:
    rgba_layers: ``[H, W, P, 4]`` single-scene MPI, back-to-front.
    tgt_poses: ``[V, 4, 4]`` source-cam -> target-cam transforms.
    depths: ``[P]`` descending plane depths.
    intrinsics: ``[3, 3]`` shared camera intrinsics.
    tgt_intrinsics / out_hw: the rendered frame's camera and dims, when
      they differ from the source's (``core.render.render_views``).
    **render_kwargs: forwarded to ``core.render.render_views``
      (``src_window`` for tile crops).

  Returns:
    ``[V, H, W, 3]`` rendered views on the mesh's first device, each
    bit-identical to an unsharded render of the same pose.
  """
  n = mesh.shape[axis]
  v = tgt_poses.shape[0]
  if v % n:
    raise ValueError(f"view count {v} not divisible by mesh axis {axis}={n}")
  k = v // n
  copies: dict[torch.device, tuple] = {}
  outs = []
  for i, dev in enumerate(mesh.axis_devices(axis)):
    if dev not in copies:
      copies[dev] = tuple(_to(t, dev) for t in (
          rgba_layers, depths, intrinsics, tgt_intrinsics))
    mpi, dep, k_s, k_t = copies[dev]
    kw = dict(render_kwargs)
    if tgt_intrinsics is not None or out_hw is not None:
      kw.update(tgt_intrinsics=k_t, out_hw=out_hw)
    with _on(dev):
      outs.append(render.render_views(
          mpi, _to(tgt_poses[i * k:(i + 1) * k], dev), dep, k_s,
          convention=convention, method=method, **kw))
  return torch.cat([_to(o, mesh.first) for o in outs])


def _fold_plane_shard(shard: torch.Tensor, first: bool
                      ) -> tuple[torch.Tensor, torch.Tensor]:
  """One device's plane shard ``[P/n, ..., 4]`` (back-to-front) as ONE
  affine map ``(A [..., 1], B [..., 3])``.

  ``first`` says the shard holds GLOBAL plane 0 — by its position on the
  mesh axis, never by its device, which may repeat — and only that shard
  gets the reference's first-opaque treatment. The planes fold in order,
  farthest first. Shared by the 1-D and 2-D mesh composites so the
  first-plane and fold-order semantics cannot drift between them.
  """
  coeff, offset = compose.plane_affine(shard, first_opaque=first)
  a, b = coeff[0], offset[0]
  for j in range(1, shard.shape[0]):
    a, b = compose.combine_affine((a, b), (coeff[j], offset[j]))
  return a, b


def _gather_fold(pairs, device: torch.device) -> torch.Tensor:
  """Gather every shard's ``(A, B)`` on ``device`` and fold them in shard
  order: the JAX ``all_gather`` and ordered fold, done as copies."""
  a_all = [_to(a, device) for a, _ in pairs]
  b_all = [_to(b, device) for _, b in pairs]
  out = b_all[0]
  for i in range(1, len(pairs)):
    out = b_all[i] + a_all[i] * out
  return out


def over_composite_planes_sharded(
    rgba: torch.Tensor,
    mesh: Mesh,
    axis: str = "planes",
) -> torch.Tensor:
  """Back-to-front composite with the plane axis sharded across devices.

  ``rgba``: ``[P, ..., 4]`` back-to-front; the axis size must divide P.
  Same contract as ``core.compose.over_composite`` (farthest plane's alpha
  ignored). O(P/n) work per device, then one gather of 4-channel images
  to the mesh's first device (see ``_fold_plane_shard``). Returns
  ``[..., 3]`` there.
  """
  p = rgba.shape[0]
  n = mesh.shape[axis]
  if p % n:
    raise ValueError(f"plane count {p} not divisible by mesh axis {axis}={n}")
  m = p // n
  pairs = []
  for i, dev in enumerate(mesh.axis_devices(axis)):
    with _on(dev):
      pairs.append(_fold_plane_shard(_to(rgba[i * m:(i + 1) * m], dev),
                                     first=i == 0))
  return _gather_fold(pairs, mesh.first)


def replicate(x, mesh: Mesh):
  """Place ``x`` on every device of ``mesh``: a ``Replicated``.

  Each distinct device gets its copy (a device that repeats shares one).
  Tensors, modules and dicts/lists/tuples of them are copied. A train
  state (``train.loop.TrainState``) must live on the mesh's first device:
  it stays the master, with its Adam state, and every other device gets a
  copy of its model's parameters and buffers only.
  """
  copies = {}
  for dev in mesh.distinct_devices:
    copies[dev] = _replica_on(x, dev, master=dev == mesh.first)
  return Replicated(mesh, copies)


def _replica_on(x, dev: torch.device, master: bool):
  from mpi_vision_tpu_torch.train.loop import TrainState

  if isinstance(x, TrainState):
    here = next(x.model.parameters()).device
    if master:
      if here != dev:
        raise ValueError(f"replicate: the train state lives on {here}, the "
                         f"mesh's first device is {dev}")
      return x
    return TrainState(model=copy.deepcopy(x.model).to(dev), optimizer=None,
                      step=x.step)
  if isinstance(x, torch.nn.Module):
    here = next(x.parameters(), torch.empty(0, device=dev)).device
    return x if here == dev else copy.deepcopy(x).to(dev)
  if isinstance(x, torch.Tensor):
    return _to(x, dev)
  if isinstance(x, dict):
    return {k: _replica_on(v, dev, master) for k, v in x.items()}
  if isinstance(x, (list, tuple)):
    return type(x)(_replica_on(v, dev, master) for v in x)
  return x


class Replicated:
  """A value with one copy on each distinct device of a mesh (``replicate``).

  ``copies[device]`` is that device's copy; ``value`` is the first
  device's (for a train state, the master).
  """

  def __init__(self, mesh: Mesh, copies: dict):
    self.mesh = mesh
    self.copies = copies

  @property
  def value(self):
    return self.copies[self.mesh.first]

  def on(self, device: torch.device):
    return self.copies[device]

  def refresh(self) -> None:
    """Copy a replicated train state's master model (parameters and
    buffers) and step count into every other device's copy, after an
    optimizer step on the master."""
    master = self.value
    with torch.no_grad():
      for dev, other in self.copies.items():
        if dev == self.mesh.first:
          continue
        other.step = master.step
        for dst, s in zip(other.model.parameters(),
                          master.model.parameters()):
          dst.copy_(s, non_blocking=True)
        for dst, s in zip(other.model.buffers(), master.model.buffers()):
          dst.copy_(s, non_blocking=True)


def batch_spec(a, mesh: Mesh, axis: str = "data") -> PartitionSpec:
  """Partition spec for one batch leaf.

  Rank >= 2 leaves with a divisible leading dim are batch-sharded; rank <= 1
  leaves are treated as shared per-scene constants (``mpi_planes [P]``) and
  replicated — a divisibility test alone would mis-shard such constants
  whenever P happens to divide the device count. Known limitation, as in
  the JAX package: a genuine rank-1 per-sample leaf is also replicated.
  """
  shardable = (getattr(a, "ndim", 0) >= 2
               and a.shape[0] % mesh.shape[axis] == 0)
  return P(axis) if shardable else P()


class Sharded:
  """A pytree laid out over one mesh axis (``shard_batch``).

  ``shards[i]`` is the pytree mesh position ``i`` along ``axis`` holds,
  on its device: a ``P(axis)`` leaf's slice ``i``, or the whole of a
  ``P()`` leaf (shared by the positions on one device). ``specs`` is the
  pytree of ``PartitionSpec``s.
  """

  def __init__(self, mesh: Mesh, axis: str, shards: list, specs):
    self.mesh = mesh
    self.axis = axis
    self.shards = shards
    self.specs = specs


def shard_batch(x, mesh: Mesh, axis: str = "data") -> Sharded:
  """Split a pytree's leaves over ``axis`` (leaves that don't divide the
  axis size, and rank <= 1 leaves, are replicated — see ``batch_spec``).
  Leaves are tensors or numpy arrays."""
  n = mesh.shape[axis]
  devs = mesh.axis_devices(axis)

  def leaf(a):
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))

  def specs(t):
    if isinstance(t, dict):
      return {k: specs(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
      return type(t)(specs(v) for v in t)
    return batch_spec(leaf(t), mesh, axis)

  shared: dict = {}

  def piece(t, spec, i, path):
    if isinstance(spec, dict):
      return {k: piece(t[k], spec[k], i, path + (k,)) for k in spec}
    if not isinstance(spec, PartitionSpec):
      return type(spec)(piece(t[j], s, i, path + (j,))
                        for j, s in enumerate(spec))
    a, dev = leaf(t), devs[i]
    if spec:
      m = a.shape[0] // n
      return _to(a[i * m:(i + 1) * m], dev)
    key = (path, dev)
    if key not in shared:
      shared[key] = _to(a, dev)
    return shared[key]

  tree_specs = specs(x)
  return Sharded(mesh, axis, [piece(x, tree_specs, i, ()) for i in range(n)],
                 tree_specs)


def render_views_planes_sharded(
    rgba_layers: torch.Tensor,
    tgt_poses: torch.Tensor,
    depths: torch.Tensor,
    intrinsics: torch.Tensor,
    mesh: Mesh,
    view_axis: str = "data",
    plane_axis: str = "planes",
    convention: Convention = Convention.REF_HOMOGRAPHY,
) -> torch.Tensor:
  """Render a view batch on a 2-D (views x planes) mesh.

  Views split over ``view_axis`` as in ``render_views_sharded``; the
  plane axis — the depth scan the composite is sequential over — splits
  over ``plane_axis``. Each device warps only its planes for its views
  (``core.render.warp_planes``), folds them into ONE affine ``(A, B)``
  pair, and the pairs of each view shard are gathered on the mesh's first
  device and folded in plane-shard order, as in
  ``over_composite_planes_sharded``.

  ``rgba_layers``: ``[H, W, P, 4]`` back-to-front; ``tgt_poses``
  ``[V, 4, 4]``; ``depths`` ``[P]`` descending; ``intrinsics`` ``[3, 3]``.
  The mesh axis sizes must divide V and P respectively. Returns
  ``[V, H, W, 3]`` on the mesh's first device.
  """
  n_v, n_p = mesh.shape[view_axis], mesh.shape[plane_axis]
  v, p = tgt_poses.shape[0], rgba_layers.shape[2]
  if v % n_v or p % n_p:
    raise ValueError(
        f"views {v} / planes {p} not divisible by mesh axes "
        f"{view_axis}={n_v} / {plane_axis}={n_p}")
  kv, kp = v // n_v, p // n_p
  h, w = rgba_layers.shape[:2]
  grid = mesh.grid(view_axis, plane_axis)
  rows = []
  for i in range(n_v):
    pairs = []
    for j in range(n_p):
      dev = grid[i, j]
      with _on(dev):
        planes = _to(rgba_layers[:, :, j * kp:(j + 1) * kp], dev)
        planes = planes.movedim(2, 0)[:, None].expand(kp, kv, h, w, 4)
        k = _to(intrinsics, dev)
        warped = render.warp_planes(
            planes, _to(tgt_poses[i * kv:(i + 1) * kv], dev),
            _to(depths[j * kp:(j + 1) * kp], dev), k[None].expand(kv, 3, 3),
            convention=convention)                   # [P/np, V/nv, H, W, 4]
        pairs.append(_fold_plane_shard(warped, first=j == 0))
    rows.append(_gather_fold(pairs, mesh.first))
  return torch.cat(rows)
