"""The port's render backward against the JAX package's.

``mpi_vision_tpu_torch.kernels.render_fused_bwd`` on CPU tensors runs the
plain versions of its two CUDA kernels (re-warp + composite VJP, and the
warp transpose); ``chip_smoke.py`` holds the kernels to them on the card.
The JAX side runs its Pallas backward kernels in interpret mode for a few
cases (they are slow: the re-warp at 1, 4, 10 and 17 planes, the whole
backward once), the XLA warp for the re-warp at 33 planes, and its XLA
oracle, ``jax.vjp`` of ``_reference_render_batch``, for the rest.

Tolerances are the JAX package's own for the same functions
(``tests/test_render_pallas_bwd.py``): atol 1e-5 for the separable re-warp
+ composite VJP and 1e-3 for the general one (the Pallas shared-gather
warp floors an ulp apart from the XLA warp near tap boundaries); atol 2e-4
for ``d planes`` on separable poses and 1e-3 on general ones; rtol/atol
1e-3 for ``d homs``. On the seam poses the JAX Pallas backward misses
(xfailed there), the port is held to the XLA oracle only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_vision_tpu.core import geometry as jgeometry
from mpi_vision_tpu.core import sampling as jsampling
from mpi_vision_tpu.core.camera import inv_depths as jinv_depths
from mpi_vision_tpu.kernels import render_pallas as rp
from mpi_vision_tpu.kernels import render_pallas_bwd as rpb
from mpi_vision_tpu_torch.core import render as trender
from mpi_vision_tpu_torch.core.sampling import Convention as TConvention
from mpi_vision_tpu_torch.kernels import render_fused as rf
from mpi_vision_tpu_torch.kernels import render_fused_bwd as rb

TRANSLATION = dict(tx=0.06, ty=-0.03, tz=-0.04)
ZOOM = dict(tz=0.25)
ROTATION = dict(tx=0.04, ty=0.02, tz=0.03, rx=0.006, ry=-0.008)
# ~29 degrees of yaw: past the banded tier, which has no Pallas backward.
PAST_BANDED = dict(tx=0.05, ry=0.5)
# The pose whose Pallas adjoint misses at window seams (xfailed in JAX).
SEAM = dict(ry=0.004, tx=0.03)
# ~63 degrees of yaw: planes cross the camera's plane (JAX: den_ok False).
CROSSING = dict(tx=0.05, ry=1.1)


def _t(a):
  return torch.from_numpy(np.array(a, np.float32))


def _pose(tx=0.0, ty=0.0, tz=0.0, rx=0.0, ry=0.0):
  pose = np.eye(4, dtype=np.float32)
  cx, sx = np.cos(rx), np.sin(rx)
  cy, sy = np.cos(ry), np.sin(ry)
  rot_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float32)
  rot_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
  pose[:3, :3] = rot_y @ rot_x
  pose[:3, 3] = [tx, ty, tz]
  return pose[None]


def _homs(pose_kw, p, h, w):
  """Pixel homographies from the JAX package: ``[P, 3, 3]`` numpy (one
  plane: the farthest of ``inv_depths``, which always holds both ends)."""
  k = np.array([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2], [0, 0, 1]],
               np.float32)[None]
  return np.asarray(rp.pixel_homographies(
      jnp.asarray(_pose(**pose_kw)), jinv_depths(1.0, 100.0, p)[:p],
      jnp.asarray(k), h, w))[:, 0]


def _inputs(rng, pose_kw, p=4, h=32, w=256, views=1):
  """Planar numpy planes ``[P, 4, H, W]``, homs ``[V, P, 3, 3]`` and
  ``g [V, 3, H, W]`` (the JAX layouts)."""
  planes = rng.uniform(0, 1, (p, 4, h, w)).astype(np.float32)
  homs = np.stack([_homs(pose_kw, p, h, w)] * views)
  g = rng.normal(size=(views, 3, h, w)).astype(np.float32)
  return planes, homs, g


def _port(planes, homs, g):
  """The port's layouts: ``[P, H, W, 4]``, ``[V, P, 3, 3]``, ``[V, H, W, 3]``."""
  return (_t(planes).permute(0, 2, 3, 1).contiguous(), _t(homs),
          _t(g).permute(0, 2, 3, 1).contiguous())


@jax.jit
def _reference_vjp_batch(batch, homs, g):
  _, vjp = jax.vjp(rp._reference_render_batch, batch, homs)
  return vjp(g)[0]


def _reference_vjp(planes, homs, g):
  """``d planes`` of ``_reference_render_batch`` for one shared scene:
  ``[P, 4, H, W]`` numpy."""
  views = homs.shape[0]
  batch = jnp.broadcast_to(jnp.asarray(planes), (views,) + planes.shape)
  want = _reference_vjp_batch(batch, jnp.asarray(homs), jnp.asarray(g))
  return np.asarray(want).sum(0)


def _planar(dplanes):
  return dplanes.permute(0, 3, 1, 2).numpy()


@jax.jit
def _xla_warp(planes, homs):
  """The XLA warp of ``core/render.py`` (``warp_planes``'s gather) on one
  view's pixel homographies ``[P, 3, 3]``: planar ``[1, P, 4, H, W]``."""
  h, w = planes.shape[-2:]
  grid = jnp.moveaxis(jgeometry.homogeneous_grid(h, w), 0, -1)
  xy = jgeometry.from_homogeneous(
      jgeometry.apply_homography(grid, homs[:, None]))
  coords = (xy + 0.5) / jnp.array([w, h], xy.dtype)
  nhwc = jnp.moveaxis(planes, 1, -1)[:, None]
  return jnp.moveaxis(jsampling.bilinear_sample(nhwc, coords)[:, 0], -1,
                      1)[None]


# Kernel A's cases: (pose, separable, atol, planes, H, W, warp). The plane
# counts fall on each of its paths (P <= 16 registers, 17-64 shared memory)
# on the port's side; the JAX side re-warps with its Pallas kernels in
# interpret mode ("pallas") or, at 33 planes, with the XLA warp ("xla"),
# whose tolerance is the general pose's.
REWARP_CASES = [
    pytest.param(TRANSLATION, True, 1e-5, 4, 32, 256, "pallas",
                 id="pose_kw0-True-1e-05"),
    pytest.param(ROTATION, False, 1e-3, 4, 32, 256, "pallas",
                 id="pose_kw1-False-0.001"),
    pytest.param(TRANSLATION, True, 1e-5, 1, 24, 128, "pallas", id="p1"),
    pytest.param(TRANSLATION, True, 1e-5, 10, 24, 128, "pallas", id="p10"),
    pytest.param(ROTATION, False, 1e-3, 17, 24, 128, "pallas", id="p17"),
    pytest.param(ROTATION, False, 1e-3, 33, 24, 128, "xla", id="p33"),
]


@pytest.mark.parametrize("pose_kw,separable,atol,p,h,w,warp", REWARP_CASES)
def test_rewarp_composite_vjp_vs_pallas_interpret(rng, pose_kw, separable,
                                                  atol, p, h, w, warp):
  """Kernel A's plain version vs the JAX re-warp kernel (interpret mode)
  or the XLA warp, followed by its XLA composite VJP."""
  planes, homs, g = _inputs(rng, pose_kw, p, h, w)
  assert rp.is_separable(homs) == separable
  if warp == "xla":
    warped = _xla_warp(jnp.asarray(planes), jnp.asarray(homs[0]))
  else:
    plan = (rp._sep_windows_needed(homs, h, w) if separable
            else rp._plan_shared(homs[0], h, w))
    warped = rpb.warp_planes_fused(jnp.asarray(planes)[None],
                                   jnp.asarray(homs), separable, plan)
  want = np.asarray(rpb._composite_bwd(warped, jnp.asarray(g)))[0]
  got = rb.rewarp_composite_vjp(*_port(planes, homs, g))[0]
  np.testing.assert_allclose(got.permute(0, 3, 1, 2).numpy(), want,
                             atol=atol, rtol=0)


def test_backward_planes_vs_pallas_interpret(rng):
  """The whole ``d planes`` vs the JAX Pallas backward (interpret mode)."""
  p, h, w = 4, 32, 256
  planes, homs, g = _inputs(rng, TRANSLATION, p, h, w)
  n_windows = rp._sep_windows_needed(homs, h, w)
  adj_plan = rpb.plan_adjoint_sep(homs, h, w)
  want = rpb.backward_planes(jnp.asarray(planes)[None], jnp.asarray(homs),
                             jnp.asarray(g), True, n_windows, adj_plan)
  got = rb.backward_planes(*_port(planes, homs, g))
  np.testing.assert_allclose(_planar(got), np.asarray(want)[0], atol=2e-4,
                             rtol=0)


@pytest.mark.parametrize("pose_kw,atol", [
    (TRANSLATION, 2e-4), (ZOOM, 2e-4), (ROTATION, 1e-3)])
def test_adjoint_warp_vs_reference_warp_vjp(rng, pose_kw, atol):
  """Kernel B's plain version alone vs the VJP of the XLA per-plane warp."""
  p, h, w = 4, 32, 256
  planes, homs, _ = _inputs(rng, pose_kw, p, h, w)
  dwarped = rng.normal(size=(p, 4, h, w)).astype(np.float32)

  def warp(pl_):
    nhwc = jnp.moveaxis(pl_, 1, -1)[:, None]
    grid = jnp.moveaxis(jgeometry.homogeneous_grid(h, w), 0, -1)
    xy = jgeometry.from_homogeneous(
        jgeometry.apply_homography(grid, jnp.asarray(homs[0])[:, None]))
    coords = (xy + 0.5) / jnp.array([w, h], xy.dtype)
    return jnp.moveaxis(jsampling.bilinear_sample(nhwc, coords)[:, 0], -1, 1)

  _, vjp = jax.vjp(warp, jnp.asarray(planes))
  (want,) = vjp(jnp.asarray(dwarped))
  got = rb.adjoint_warp(_t(dwarped).permute(0, 2, 3, 1)[None].contiguous(),
                        _t(homs), shared=True)
  np.testing.assert_allclose(_planar(got), np.asarray(want), atol=atol,
                             rtol=0)


@pytest.mark.parametrize("pose_kw,size,atol", [
    (TRANSLATION, (4, 32, 256), 2e-4),
    (ZOOM, (4, 32, 256), 2e-4),
    (ROTATION, (4, 32, 256), 1e-3),
    (PAST_BANDED, (4, 32, 256), 1e-3),
    (SEAM, (4, 32, 256), 1e-3),
    (CROSSING, (3, 16, 24), 1e-3),
], ids=["translation", "zoom", "rotation", "past_banded", "seam", "crossing"])
def test_backward_planes_vs_reference_vjp(rng, pose_kw, size, atol):
  """``d planes`` vs ``jax.vjp(_reference_render_batch)``: every pose,
  including those the JAX Pallas backward does not take (past the banded
  tier, planes crossing the camera's plane) or misses (the seam pose)."""
  p, h, w = size
  planes, homs, g = _inputs(rng, pose_kw, p, h, w)
  crossing = rb.sign_changing_planes(_t(homs), h, w)
  assert crossing == (p if pose_kw is CROSSING else 0)
  got = rb.backward_planes(*_port(planes, homs, g))
  np.testing.assert_allclose(_planar(got), _reference_vjp(planes, homs, g),
                             atol=atol, rtol=0)


def test_dhoms_matches_jax_when_asked(rng):
  p, h, w = 3, 32, 256
  planes, homs, g = _inputs(rng, TRANSLATION, p, h, w)
  tp, th, tg = _port(planes, homs, g)
  th.requires_grad_(True)
  (rf.render_mpi_fused(tp, th) * tg).sum().backward()
  want = jax.jit(jax.grad(lambda hh: jnp.sum(
      rp.reference_render(jnp.asarray(planes), hh)
      * jnp.asarray(g[0]))))(jnp.asarray(homs[0]))
  np.testing.assert_allclose(th.grad[0].numpy(), np.asarray(want),
                             rtol=1e-3, atol=1e-3)


def test_dhoms_not_computed_unless_asked(rng):
  """Poses are data in training: the backward never runs the plain
  forward that ``d homs`` needs."""
  p, h, w = 3, 16, 24
  planes, homs, g = _inputs(rng, ROTATION, p, h, w)
  tp, th, tg = _port(planes, homs, g)
  tp.requires_grad_(True)
  out = rf.render_mpi_fused(tp, th)
  calls = rf.plain_render.calls
  (out * tg).sum().backward()
  assert rf.plain_render.calls == calls
  assert th.grad is None and tp.grad is not None


def test_shared_scene_sums_views(rng):
  """One scene under three views (view stride 0) gets the sum of the three
  single-view gradients; the same views as per-view scene copies get them
  one by one."""
  p, h, w = 3, 24, 40
  planes = _t(rng.uniform(0, 1, (p, h, w, 4)))
  homs = _t(np.stack([_homs(kw, p, h, w)
                      for kw in (TRANSLATION, ROTATION, PAST_BANDED)]))
  g = _t(rng.normal(size=(3, h, w, 3)))
  shared = rb.backward_planes(planes, homs, g)
  singles = [rb.backward_planes(planes, homs[v:v + 1].contiguous(),
                                g[v:v + 1].contiguous()) for v in range(3)]
  per_view = rb.backward_planes(planes.expand(3, p, h, w, 4).contiguous(),
                                homs, g)
  assert shared.shape == (p, h, w, 4) and per_view.shape == (3, p, h, w, 4)
  for v in range(3):
    assert torch.equal(per_view[v], singles[v])
  np.testing.assert_allclose(shared.numpy(), sum(singles).numpy(),
                             atol=1e-5, rtol=0)


def test_backward_bit_identical_across_runs(rng):
  planes, homs, g = _port(*_inputs(rng, ROTATION, 4, 24, 40))
  assert torch.equal(rb.backward_planes(planes, homs, g),
                     rb.backward_planes(planes, homs, g))


def test_candidate_boxes_hold_every_contributor(rng):
  """Brute force over every target pixel: each one whose forward sample
  has source pixel (x, y) among its taps lies in that pixel's box."""
  p, h, w = 2, 12, 16
  for pose_kw in (TRANSLATION, ROTATION, PAST_BANDED, CROSSING, ZOOM):
    for hom in _t(_homs(pose_kw, p, h, w)):
      i_lo, i_hi, j_lo, j_hi, _ = rb.candidate_boxes(hom, h, w)
      grid, scale = rf.pixel_grid(h, w)
      coords = rf.sample_coords(hom, grid, scale)
      px = (coords[..., 0] * w - 0.5).reshape(-1)
      py = (coords[..., 1] * h - 0.5).reshape(-1)
      reach = (px >= -1) & (px < w) & (py >= -1) & (py < h)
      for t in torch.nonzero(reach).reshape(-1).tolist():
        x0, y0 = int(np.floor(float(px[t]))), int(np.floor(float(py[t])))
        ti, tj = divmod(t, w)
        for y in (y0, y0 + 1):
          for x in (x0, x0 + 1):
            if 0 <= x < w and 0 <= y < h:
              s = y * w + x
              assert i_lo[s] <= ti <= i_hi[s] and j_lo[s] <= tj <= j_hi[s]


def _contributors(hom, h, w):
  """Brute force: ``[H * W, H * W]`` bool, source pixel by target pixel,
  of the targets whose forward sample has the source among its taps."""
  *_, x0, y0 = (t.to(torch.int64) for t in rb.forward_taps(hom, h, w))
  hits = torch.zeros((h * w, h * w), dtype=torch.bool)
  for t in torch.nonzero(x0 != rb.NO_TAP).reshape(-1).tolist():
    for y in (int(y0[t]), int(y0[t]) + 1):
      for x in (int(x0[t]), int(x0[t]) + 1):
        if 0 <= x < w and 0 <= y < h:
          hits[y * w + x, t] = True
  return hits


# Chunkings of the tile's preimage: the kernel's, and one small enough that
# every preimage splits across chunks and every row across segments.
CHUNKINGS = {"kernel": {}, "split": dict(chunk=48, max_segs=4, seg_max=16)}


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
@pytest.mark.parametrize("pose_kw", [TRANSLATION, ROTATION, PAST_BANDED,
                                     CROSSING, ZOOM],
                         ids=["translation", "rotation", "past_banded",
                              "crossing", "zoom"])
def test_tile_scan_holds_every_contributor(pose_kw, chunking):
  """Kernel B's tile preimage, chunks, segments and spans (their plain
  mirror, ``tile_scan``) put every target whose forward taps reach a
  source pixel inside what that pixel's thread scans: 40 x 72 source
  pixels are 2 x 3 tiles of 64 x 16, ragged at the right and bottom."""
  p, h, w = 2, 40, 72
  kw = CHUNKINGS[chunking]
  for hom in _t(_homs(pose_kw, p, h, w)):
    hits = _contributors(hom, h, w)
    scanned = rb.tile_scan(hom, h, w, **kw)
    assert int(hits.sum()) > 0
    assert not bool((hits & ~scanned).any())
    if chunking == "split":
      boxes = torch.stack(rb.tile_boxes(hom, h, w)[:4], 1).tolist()
      assert max(len(rb.tile_chunks(b, **kw)) for b in boxes) > 1


def test_tile_preimages_contain_pixel_boxes():
  """Each tile's preimage holds the candidate box of every pixel in it;
  a plane crossing the camera's plane sends some tile to the whole image."""
  h, w = 40, 72
  for pose_kw in (TRANSLATION, ROTATION, CROSSING, ZOOM):
    for hom in _t(_homs(pose_kw, 2, h, w)):
      pix = rb.candidate_boxes(hom, h, w)
      tiles = rb.tile_boxes(hom, h, w)
      tiles_x = -(-w // rb.TILE_B[0])
      for s in range(h * w):
        y, x = divmod(s, w)
        t = (y // rb.TILE_B[1]) * tiles_x + x // rb.TILE_B[0]
        if pix[0][s] > pix[1][s]:
          continue  # an empty box needs nothing
        assert tiles[0][t] <= pix[0][s] and pix[1][s] <= tiles[1][t]
        assert tiles[2][t] <= pix[2][s] and pix[3][s] <= tiles[3][t]
      if pose_kw is CROSSING:
        assert bool(tiles[4].any())


def test_tile_chunks_split_rows_in_order():
  """Segments come in ascending (i, j), cover the box's columns, and each
  chunk holds at most ``chunk`` targets and ``max_segs`` segments."""
  box = (3, 9, 5, 44)   # 7 rows x 40 columns
  chunks = rb.tile_chunks(box, chunk=48, max_segs=4, seg_max=16)
  segs = [s for c in chunks for s in c]
  assert segs == sorted(segs)
  assert all(len(c) <= 4 and sum(s[2] for s in c) <= 48 for c in chunks)
  for i in range(3, 10):
    cols = sorted(j for r, j0, n in segs if r == i for j in range(j0, j0 + n))
    assert cols[:40] == list(range(5, 45)) and len(cols) == 42  # 3 x 14
  assert rb.tile_chunks((1, 0, 1, 0)) == []
  # The kernel's chunking: a 1080p row is 8 segments of 240, six a chunk.
  wide = rb.tile_chunks((0, 2, 0, 1919))
  assert [len(c) for c in wide] == [6, 6, 6, 6]
  assert {s[2] for c in wide for s in c} == {240}
  # A near-identity 64 x 16 tile's preimage is one chunk.
  assert len(rb.tile_chunks((99, 119, 126, 193))) == 1


def test_adjoint_launch_shape():
  shape = rb.adjoint_launch_shape(8, 32, 1080, 1920, shared=True)
  assert shape["grid"] == (30, 68, 32) and shape["block"] == (64, 4)
  # Five blocks to an SM's 227 KiB, each with its 1 KiB reserved.
  assert shape["smem_bytes"] <= (227 * 1024) // 5 - 1024
  assert rb.adjoint_launch_shape(3, 10, 224, 224, False)["grid"] == (4, 14,
                                                                     30)


def test_rewarp_launch_shape():
  """Kernel A's path by plane count: registers up to 16 (buckets of 4, a
  thread per pixel), shared memory up to the cap (a block of 256 threads,
  within the 227 KB opt-in), the global path past it; the first two walk
  (view, 32 x 2 tile) items."""
  for p, bucket in ((1, 4), (4, 4), (5, 8), (10, 12), (16, 16)):
    shape = rb.rewarp_launch_shape(1, p, 1080, 1920)
    assert (shape["path"], shape["bucket"]) == ("registers", bucket)
    assert shape["block"] == (64, 1, 1) and shape["smem_bytes"] == 0
  for p in (17, 32, 33, rb.SMEM_PLANES):
    shape = rb.rewarp_launch_shape(8, p, 1080, 1920)
    assert shape["path"] == "shared" and shape["bucket"] is None
    assert shape["smem_bytes"] == p * (64 * 16 + 36)
    assert shape["smem_bytes"] <= rb.SMEM_OPT_IN <= 227 * 1024
    assert shape["block"] == (256, 1, 1)
    assert shape["items"] == 60 * 540 * 8 == shape["grid"][0]
  # 1080p x 32: six blocks of 34 KB (each with its 1 KiB reserved) fit an
  # SM's shared memory.
  assert 6 * (rb.rewarp_launch_shape(1, 32, 1080, 1920)["smem_bytes"]
              + 1024) <= 227 * 1024
  for p in (rb.SMEM_PLANES + 1, 100, rb.MAX_PLANES):
    shape = rb.rewarp_launch_shape(3, p, 1080, 1920)
    assert shape["path"] == "global" and shape["items"] is None
    assert shape["grid"] == (60, 135, 3) and shape["block"] == (32, 8, 1)
    assert shape["smem_bytes"] == p * 36 <= rb.render_fused.SMEM_LIMIT
  # A grid of more items than gridDim.x holds loops over them.
  big = rb.rewarp_launch_shape(65535, 8, 46340, 46340)
  assert big["items"] > rb.GRID_X_MAX == big["grid"][0]


def test_check_rewarp_launch_takes_every_plane_count():
  """Every plane count the wrapper took before its paths split is taken;
  ``check_rewarp_launch`` rejects only too many planes, views or pixels."""
  paths = [rb.check_rewarp_launch(1, p, 8, 8)["path"]
           for p in range(1, rb.MAX_PLANES + 1)]
  assert paths == (["registers"] * rb.REG_PLANES
                   + ["shared"] * (rb.SMEM_PLANES - rb.REG_PLANES)
                   + ["global"] * (rb.MAX_PLANES - rb.SMEM_PLANES))
  assert rb.MAX_PLANES == 48 * 1024 // 36
  rb.check_rewarp_launch(rb.render_fused.MAX_VIEWS, 32, 1080, 1920)
  rb.check_rewarp_launch(1, 1, 1, rb.render_fused.MAX_PLANE_PIXELS)
  with pytest.raises(ValueError, match="planes exceed"):
    rb.check_rewarp_launch(1, rb.MAX_PLANES + 1, 8, 8)
  with pytest.raises(ValueError, match="views exceed"):
    rb.check_rewarp_launch(rb.render_fused.MAX_VIEWS + 1, 4, 8, 8)
  with pytest.raises(ValueError, match="32-bit"):
    rb.check_rewarp_launch(1, 4, 46341, 46341)


def test_render_mpi_fused_pallas_carries_its_gradient(rng):
  """``render_mpi(method="fused_pallas")`` goes through the autograd
  Function, and its gradient equals the plain per-plane loop's autograd
  gradient (``method="fused"``)."""
  h, w, p = 24, 40, 4
  mpi = rng.uniform(0, 1, (1, h, w, p, 4)).astype(np.float32)
  pose = _pose(**ROTATION)
  depths = _t(jinv_depths(1.0, 100.0, p))
  k = _t(np.array([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2], [0, 0, 1]],
                  np.float32)[None])
  wmat = _t(rng.normal(size=(1, h, w, 3)))
  grads = {}
  for method in ("fused_pallas", "fused"):
    layers = _t(mpi).requires_grad_(True)
    out = trender.render_mpi(layers, _t(pose), depths, k,
                             convention=TConvention.EXACT, method=method)
    if method == "fused_pallas":
      assert type(out.grad_fn).__name__ == "_FusedRenderBackward"
    (out * wmat).sum().backward()
    grads[method] = layers.grad.numpy()
  assert np.abs(grads["fused_pallas"]).max() > 0
  np.testing.assert_allclose(grads["fused_pallas"], grads["fused"],
                             atol=1e-5, rtol=0)


def test_cpu_runs_plain_versions_and_launches_nothing(rng):
  planes, homs, g = _port(*_inputs(rng, TRANSLATION, 2, 8, 16))
  counts = (rb.plain_rewarp_composite_vjp.calls, rb.plain_adjoint_warp.calls,
            rb.rewarp_composite_vjp.launches, rb.adjoint_warp.launches)
  rb.backward_planes(planes, homs, g)
  assert (rb.plain_rewarp_composite_vjp.calls, rb.plain_adjoint_warp.calls,
          rb.rewarp_composite_vjp.launches, rb.adjoint_warp.launches) == (
              counts[0] + 1, counts[1] + 1, counts[2], counts[3])


def test_wrappers_reject_what_the_kernels_do_not_take():
  planes = torch.zeros(3, 8, 8, 4)
  homs = torch.zeros(1, 3, 3, 3)
  g = torch.zeros(1, 8, 8, 3)
  with pytest.raises(TypeError, match="float32"):
    rb.rewarp_composite_vjp(planes, homs, g.double())
  with pytest.raises(ValueError, match="g must be"):
    rb.rewarp_composite_vjp(planes, homs, torch.zeros(1, 8, 8, 4))
  with pytest.raises(ValueError, match="dwarped must be"):
    rb.adjoint_warp(torch.zeros(1, 3, 8, 8, 3), homs, shared=True)
  with pytest.raises(ValueError, match="homs must be"):
    rb.adjoint_warp(torch.zeros(1, 3, 8, 8, 4), torch.zeros(2, 3, 3, 3),
                    shared=True)
  # Not on the CPU and not on CUDA: raises, never falls back.
  with pytest.raises(ValueError, match="CUDA device"):
    rb.rewarp_composite_vjp(planes.to("meta"), homs.to("meta"), g.to("meta"))
  with pytest.raises(ValueError, match="CUDA device"):
    rb.adjoint_warp(torch.zeros(1, 3, 8, 8, 4, device="meta"),
                    homs.to("meta"), shared=True)
  # Kernel B's limits: the grid's z holds scenes x planes; any number of
  # views of one scene (one view's maps are staged at a time).
  rb.check_adjoint_launch(100000, 32, 8, 8, shared=True)
  rb.check_adjoint_launch(2047, 32, 8, 8, shared=False)
  with pytest.raises(ValueError, match="grid"):
    rb.check_adjoint_launch(2048, 32, 8, 8, shared=False)
  with pytest.raises(ValueError, match="32-bit"):
    rb.check_adjoint_launch(1, 1, 46341, 46341, shared=True)
