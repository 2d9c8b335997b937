"""Tile-granular scenes: fixed tile grid, per-tile digests, frustum culling.

Host-only numpy, copied from ``mpi_vision_tpu/serve/tiles.py`` with its
one import rewritten to the port's ``Convention``; the tests hold the two
copies to the same digests, masks, tokens and crop intrinsics. The port's
server renders a crop through its window of the scene
(``core.render.render_mpi``'s ``src_window``) rather than through
``crop_src_intrinsics``, which makes a culled render bit-exact too.

Tiled Multiplane Images (PAPERS.md, arXiv:2309.14291) applied to the
serving stack: a baked scene stops being one monolithic
``[H, W, P, 4]`` blob and becomes a fixed grid of per-tile sub-MPIs,
each with its own content digest (what changed on a live reload), its
own plane-content mask (which depth planes actually hold pixels there —
the per-tile depth range), and its own cache identity (the baked-scene
LRU, the cluster ring, and the edge frame cache all address tiles, not
scenes).

The render path stays the homography path of ``core/render.py``
(``method="pallas"``: the warp, then the CUDA compose kernel, since the
fused kernel takes no cropped sources); what tiling changes is the
*inputs*:

  * **frustum culling** — ``TileMeta.touched`` projects the target
    frame's corners through every plane's inverse homography into
    source-pixel tap space (the exact space ``sampling.bilinear_sample``
    gathers in, per ``Convention``) and marks the tiles any tap can
    land in. Out-of-frustum tiles contribute nothing: the sampler
    zero-pads outside its input, so a source crop covering every
    possible tap is render-equivalent to the full scene.
  * **plane culling** — a plane whose alpha is exactly zero over every
    touched tile is a bitwise no-op under over-compositing
    (``rgb*0 + out*(1-0) == out``), so it is dropped from the scan.
    Plane 0 is always kept (the farthest plane's RGB composites
    unconditionally, alpha ignored — utils.py:152-153).
  * **source cropping** — the touched tiles' bounding box becomes the
    source MPI; an affine correction folded into the *source*
    intrinsics (``crop_src_intrinsics``) makes the cropped render
    sample the same taps the monolithic render would, per convention.
    When the frustum touches every tile the crop is the whole scene,
    the correction is skipped entirely, and the render is **bit-exact**
    to the monolithic path (pinned in tests/serve/test_tiles.py).

Everything here is small host-side numpy on the request path (float64
homography corners — no device work, no jit); the conservative 2-pixel
tap margin absorbs the f32-vs-f64 drift between this test and the
compiled warp.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import math
import threading

import numpy as np

from mpi_vision_tpu_torch.core.sampling import Convention

# Extra source pixels added around every projected tap rectangle: one for
# the bilinear neighbour gather, one for f32-vs-f64 homography drift
# between this host-side test and the compiled warp.
TAP_MARGIN_PX = 2

# Per-TileMeta memo of frustum-cull results keyed by pose bytes: the
# request path culls the same pose twice (render_edge records the
# touched set, then the scheduler's batch keyer plans it), and live
# traffic repeats hot view cells — both become one dict hit.
_TOUCH_MEMO_CAP = 128

# Separates the scene id from a tile/crop token in cache and batch keys.
# \x1f (unit separator) cannot appear in a scene id that came through the
# HTTP layer's JSON string validation.
KEY_SEP = "\x1f"


def tile_cache_key(scene_id: str, row: int, col: int) -> str:
  """The baked-tile cache key: one LRU entry (and one eviction/
  invalidation unit) per ``(scene, tile)``."""
  return f"{scene_id}{KEY_SEP}t{row},{col}"


# ``auto_tile`` targets this many tiles per scene: enough granularity
# that a frustum cull and a tile-diff reload both win (a changed region
# invalidates ~1/64th of the scene, not half of it), few enough that
# per-tile bookkeeping (digests, cache keys, asset manifests) stays
# negligible next to the pixels.
AUTO_TILE_TARGET = 64
AUTO_TILE_MIN = 8


def auto_tile(height: int, width: int,
              target_tiles: int = AUTO_TILE_TARGET) -> int:
  """Derive a tile edge from scene dims (``--tile-size auto``).

  Picks the multiple of 8 whose grid lands closest under
  ``target_tiles`` tiles, clamped to ``[AUTO_TILE_MIN, max(H, W)]`` —
  small scenes degenerate to one tile per scene rather than sub-8px
  tiles (below 8 px the crop-correction affines degenerate; the same
  floor ``RenderService`` enforces for explicit sizes). Deterministic:
  equal dims always pick equal sizes, so two processes syncing a scene
  by manifest diff (``serve/assets``) compute identical grids.
  """
  if height < 1 or width < 1:
    raise ValueError(f"bad scene dims {height}x{width}")
  edge = math.sqrt(height * width / target_tiles)
  edge = max(AUTO_TILE_MIN, int(round(edge / 8)) * 8)
  return min(edge, max(height, width))


@dataclasses.dataclass(frozen=True)
class TileGrid:
  """A fixed tile grid over an ``H x W`` scene (ragged last row/col)."""

  height: int
  width: int
  tile: int

  def __post_init__(self):
    if self.tile < 1:
      raise ValueError(f"tile must be >= 1, got {self.tile}")
    if self.height < 1 or self.width < 1:
      raise ValueError(f"bad grid dims {self.height}x{self.width}")

  @property
  def rows(self) -> int:
    return -(-self.height // self.tile)

  @property
  def cols(self) -> int:
    return -(-self.width // self.tile)

  def __len__(self) -> int:
    return self.rows * self.cols

  def rect(self, row: int, col: int) -> tuple[int, int, int, int]:
    """Pixel rect ``(y0, y1, x0, x1)`` of one tile (half-open)."""
    y0, x0 = row * self.tile, col * self.tile
    return (y0, min(y0 + self.tile, self.height),
            x0, min(x0 + self.tile, self.width))


@dataclasses.dataclass(frozen=True)
class TileSignature:
  """One frustum's render plan against a tiled scene.

  ``crop`` is the touched tiles' bounding box in source pixels (snapped
  to the tile grid); ``planes`` the ascending indices of planes kept by
  the content cull (always including plane 0). The token round-trips
  through the scheduler's batch key, so requests whose frusta produce
  the same plan coalesce into one dispatch — and a request's pixels are
  a pure function of its own signature, never of its batchmates'.
  """

  crop: tuple[int, int, int, int]     # (y0, y1, x0, x1), tile-snapped
  planes: tuple[int, ...]             # ascending; depths stay descending
  tiles_touched: int
  tiles_rendered: int                 # tiles inside the crop bbox
  tiles_total: int

  def token(self) -> str:
    y0, y1, x0, x1 = self.crop
    return (f"{y0}-{y1}-{x0}-{x1}|" + ",".join(str(p) for p in self.planes)
            + f"|{self.tiles_touched}")

  @classmethod
  def parse(cls, token: str, grid: TileGrid) -> "TileSignature":
    crop_part, planes_part, touched = token.split("|")
    y0, y1, x0, x1 = (int(v) for v in crop_part.split("-"))
    planes = tuple(int(p) for p in planes_part.split(","))
    rows = (y1 - 1) // grid.tile - y0 // grid.tile + 1
    cols = (x1 - 1) // grid.tile - x0 // grid.tile + 1
    return cls((y0, y1, x0, x1), planes, int(touched), rows * cols,
               len(grid))


def thin_planes(planes: tuple[int, ...], keep: float) -> tuple[int, ...]:
  """Deterministic plane subset for degraded (brownout L1+) compositing.

  Keeps ``ceil(len * keep)`` of the content-culled plane list: always
  the first entry (plane 0 — the farthest plane's RGB composites
  unconditionally) and the last (the nearest content), evenly strided
  between. Pure and order-preserving, so equal ``(signature, keep)``
  pairs produce equal thinned plans — and therefore equal batch keys —
  on every process.
  """
  n = len(planes)
  k = max(1, math.ceil(n * float(keep)))
  if k >= n:
    return tuple(planes)
  if k == 1:
    return (planes[0],)
  idx = sorted({round(i * (n - 1) / (k - 1)) for i in range(k)})
  return tuple(planes[i] for i in idx)


def _tap_affine(convention: Convention, h: int, w: int,
                ch: int, cw: int, y0: int, x0: int):
  """Per-axis affine ``raw_crop = a * raw_full + b`` mapping the full
  image's raw warp coordinate to the crop coordinate whose sampler tap
  is exactly ``tap_full - offset`` (see ``crop_src_intrinsics``)."""
  if convention is Convention.EXACT:
    return 1.0, float(-x0), 1.0, float(-y0)
  if convention is Convention.REF_HOMOGRAPHY:
    # tap_x = x * w / (h - 1) - 0.5 (the reference's x/height swap).
    ax = (w * (ch - 1)) / ((h - 1) * cw)
    bx = -(x0 * (ch - 1)) / cw
    ay = (h * (cw - 1)) / ((w - 1) * ch)
    by = -(y0 * (cw - 1)) / ch
    return ax, bx, ay, by
  # REF_PROJECTION: tap_x = (x + 0.5) * w / h - 0.5 (same axis swap).
  ax = (w * ch) / (h * cw)
  bx = (0.5 * w / h - x0) * ch / cw - 0.5
  ay = (h * cw) / (w * ch)
  by = (0.5 * h / w - y0) * cw / ch - 0.5
  return ax, bx, ay, by


def _raw_to_taps(xy: np.ndarray, convention: Convention,
                 h: int, w: int) -> np.ndarray:
  """Raw warp coords ``[..., 2]`` -> sampler tap pixel coords (the space
  ``bilinear_sample`` floors and gathers in), matching
  ``sampling.normalize_pixel_coords`` + the ``c * size - 0.5`` map."""
  x, y = xy[..., 0], xy[..., 1]
  if convention is Convention.EXACT:
    return np.stack([x, y], axis=-1)
  if convention is Convention.REF_HOMOGRAPHY:
    return np.stack([x * w / (h - 1) - 0.5, y * h / (w - 1) - 0.5], axis=-1)
  return np.stack([(x + 0.5) * w / h - 0.5, (y + 0.5) * h / w - 0.5],
                  axis=-1)


def _inverse_homographies(poses: np.ndarray, depths: np.ndarray,
                          intrinsics: np.ndarray) -> np.ndarray:
  """float64 twin of ``core.render.plane_homographies`` for the host-side
  frustum test: ``[P, V, 3, 3]`` target-pixel -> source-pixel maps."""
  poses = np.asarray(poses, np.float64)
  depths = np.asarray(depths, np.float64)
  k = np.asarray(intrinsics, np.float64)
  k_inv = np.linalg.inv(k)
  rot_t = np.swapaxes(poses[:, :3, :3], -1, -2)         # [V, 3, 3]
  t = poses[:, :3, 3:]                                  # [V, 3, 1]
  rot_t_t = rot_t @ t                                   # [V, 3, 1]
  n_hat = np.array([[0.0, 0.0, 1.0]])                   # [1, 3]
  homs = np.empty((depths.shape[0], poses.shape[0], 3, 3), np.float64)
  for p, depth in enumerate(depths):
    a = -float(depth)
    denom = a - (n_hat @ rot_t_t)                       # [V, 1, 1]
    denom = denom + 1e-8 * (denom == 0.0)
    numerator = (rot_t_t @ n_hat[None]) @ rot_t         # [V, 3, 3]
    middle = rot_t + numerator / denom
    homs[p] = k @ middle @ k_inv
  return homs


class TileMeta:
  """Host-side tiling metadata for one scene (built once per publish).

  Holds no pixel data — callers keep the full host rgba array (the
  registry entry) and slice tiles out of it; this object carries the
  grid, per-tile sha256 digests (the live-reload diff unit), per-tile
  plane-content masks (the depth-range / plane-cull source), and the
  camera facts the frustum test needs.
  """

  def __init__(self, grid: TileGrid, digests: list[list[str]],
               plane_any: np.ndarray, depths: np.ndarray,
               intrinsics: np.ndarray):
    self.grid = grid
    self.digests = digests              # [rows][cols] sha256 hex
    self.plane_any = plane_any          # bool [rows, cols, P]
    self.depths = np.asarray(depths, np.float32)
    self.intrinsics = np.asarray(intrinsics, np.float32)
    self.planes = int(plane_any.shape[-1])
    self._touch_memo: "collections.OrderedDict[tuple, np.ndarray]" = \
        collections.OrderedDict()
    self._touch_lock = threading.Lock()
    # The whole-scene content token (_edge_put's swap-race guard): it
    # must change whenever ANY input a render depends on changes, so
    # the camera geometry hashes in next to the pixel digests — a
    # depths/intrinsics-only reload invalidates every tile and must
    # not let a racing render cache a frame of the old geometry.
    self.scene_digest = hashlib.sha256(
        ("\n".join(d for row in digests for d in row)).encode()
        + bytes(f"|{grid.height}x{grid.width}x{grid.tile}", "ascii")
        + self.depths.tobytes() + self.intrinsics.tobytes()
    ).hexdigest()[:16]

  @classmethod
  def build(cls, rgba_layers: np.ndarray, depths, intrinsics,
            tile: int) -> "TileMeta":
    rgba = np.asarray(rgba_layers, np.float32)
    if rgba.ndim != 4 or rgba.shape[-1] != 4:
      raise ValueError(f"rgba_layers must be [H, W, P, 4], got {rgba.shape}")
    h, w, p = rgba.shape[0], rgba.shape[1], rgba.shape[2]
    grid = TileGrid(h, w, int(tile))
    alpha_any = rgba[..., 3] > 0.0                      # [H, W, P]
    digests: list[list[str]] = []
    plane_any = np.zeros((grid.rows, grid.cols, p), bool)
    for i in range(grid.rows):
      row_digests = []
      for j in range(grid.cols):
        y0, y1, x0, x1 = grid.rect(i, j)
        row_digests.append(hashlib.sha256(
            np.ascontiguousarray(rgba[y0:y1, x0:x1]).tobytes()).hexdigest())
        # 1-px dilation: a tap at this tile's edge bilinearly reads its
        # neighbour's border pixel, so the cull must see that content.
        plane_any[i, j] = alpha_any[max(y0 - 1, 0):y1 + 1,
                                    max(x0 - 1, 0):x1 + 1].any(axis=(0, 1))
      digests.append(row_digests)
    return cls(grid, digests, plane_any, depths, intrinsics)

  # -- reload diffing -------------------------------------------------------

  def changed_tiles(self, new: "TileMeta") -> list[tuple[int, int]]:
    """Tiles whose bytes differ between this metadata and ``new``.

    A grid/shape/geometry change invalidates everything (every old tile
    id is 'changed'); same-grid publishes diff per tile — the unit a
    live reload ships and swaps.
    """
    if (self.grid != new.grid or self.planes != new.planes
        or not np.array_equal(self.depths, new.depths)
        or not np.array_equal(self.intrinsics, new.intrinsics)):
      return [(i, j) for i in range(self.grid.rows)
              for j in range(self.grid.cols)]
    return [(i, j) for i in range(self.grid.rows)
            for j in range(self.grid.cols)
            if self.digests[i][j] != new.digests[i][j]]

  def depth_range(self, row: int, col: int) -> tuple[float, float] | None:
    """The tile's content depth range ``(near, far)`` (its sub-MPI's
    extent), or None for an empty tile."""
    mask = self.plane_any[row, col]
    if not mask.any():
      return None
    present = self.depths[mask]
    return float(present.min()), float(present.max())

  # -- frustum culling ------------------------------------------------------

  def touched(self, poses: np.ndarray,
              convention: Convention = Convention.REF_HOMOGRAPHY,
              ) -> np.ndarray:
    """Bool ``[rows, cols]``: tiles any of ``poses``' taps can land in
    (memoized per exact pose bytes — a pure function of this metadata).

    Conservative by construction: per plane, the target frame's corner
    pixels map through the inverse homography (a projective map of a
    convex region — the extreme source coordinates are at the corners
    because the homogeneous w is affine over the frame and positive
    throughout whenever it is positive at all four corners); a plane
    whose w dips to/below zero anywhere marks the whole scene touched.
    The corner bbox then widens by ``TAP_MARGIN_PX`` in sampler tap
    space before tiles are marked.
    """
    poses = np.asarray(poses, np.float64)
    if poses.ndim == 2:
      poses = poses[None]
    memo_key = (poses.tobytes(), convention)
    with self._touch_lock:
      hit = self._touch_memo.get(memo_key)
      if hit is not None:
        self._touch_memo.move_to_end(memo_key)
        return hit.copy()  # callers may write into the mask
    out = self._touched_uncached(poses, convention)
    with self._touch_lock:
      self._touch_memo[memo_key] = out.copy()
      self._touch_memo.move_to_end(memo_key)
      while len(self._touch_memo) > _TOUCH_MEMO_CAP:
        self._touch_memo.popitem(last=False)
    return out

  def _touched_uncached(self, poses: np.ndarray,
                        convention: Convention) -> np.ndarray:
    h, w = self.grid.height, self.grid.width
    out = np.zeros((self.grid.rows, self.grid.cols), bool)
    homs = _inverse_homographies(poses, self.depths, self.intrinsics)
    corners = np.array([[0.0, 0.0, 1.0], [w - 1.0, 0.0, 1.0],
                        [0.0, h - 1.0, 1.0], [w - 1.0, h - 1.0, 1.0]])
    for p in range(homs.shape[0]):
      for v in range(homs.shape[1]):
        pts = corners @ homs[p, v].T                    # [4, 3]
        if pts[:, 2].min() <= 1e-9:
          out[:] = True                                 # degenerate: all
          return out
        xy = pts[:, :2] / pts[:, 2:]
        taps = _raw_to_taps(xy, convention, h, w)       # [4, 2]
        x_lo = math.floor(taps[:, 0].min()) - TAP_MARGIN_PX
        x_hi = math.floor(taps[:, 0].max()) + 1 + TAP_MARGIN_PX
        y_lo = math.floor(taps[:, 1].min()) - TAP_MARGIN_PX
        y_hi = math.floor(taps[:, 1].max()) + 1 + TAP_MARGIN_PX
        if x_hi < 0 or y_hi < 0 or x_lo > w - 1 or y_lo > h - 1:
          continue                                      # fully off-scene
        i_lo = max(y_lo, 0) // self.grid.tile
        i_hi = min(y_hi, h - 1) // self.grid.tile
        j_lo = max(x_lo, 0) // self.grid.tile
        j_hi = min(x_hi, w - 1) // self.grid.tile
        out[i_lo:i_hi + 1, j_lo:j_hi + 1] = True
    return out

  def signature(self, touched: np.ndarray) -> TileSignature:
    """The render plan for one touched-tile set: tile-snapped crop bbox
    + the content-culled plane list (plane 0 always kept)."""
    grid = self.grid
    idx = np.argwhere(touched)
    if idx.size == 0:
      # The frustum misses the scene entirely: render the cheapest
      # legal plan (one tile, the farthest plane) — every tap zero-pads
      # either way, so the output is the same black frame.
      return TileSignature((0, grid.rect(0, 0)[1], 0, grid.rect(0, 0)[3]),
                           (0,), 0, 1, len(grid))
    i_lo, j_lo = (int(v) for v in idx.min(axis=0))
    i_hi, j_hi = (int(v) for v in idx.max(axis=0))
    y1 = min((i_hi + 1) * grid.tile, grid.height)
    x1 = min((j_hi + 1) * grid.tile, grid.width)
    # A crop that is just the last row/col's ragged sliver (< 8 px)
    # degenerates the REF-convention tap affine (the ``ch - 1`` /
    # ``cw - 1`` factors hit zero at 1 px); pull in the neighboring
    # tile so every crop keeps both dims >= min(8, scene dim) — tiles
    # themselves are >= 8, so only ragged remainders can get here.
    if y1 - i_lo * grid.tile < 8 and i_lo > 0:
      i_lo -= 1
    if x1 - j_lo * grid.tile < 8 and j_lo > 0:
      j_lo -= 1
    y0, x0 = i_lo * grid.tile, j_lo * grid.tile
    content = self.plane_any[touched].any(axis=0)       # [P]
    planes = tuple(sorted({0} | {int(p) for p in np.flatnonzero(content)}))
    rendered = (i_hi - i_lo + 1) * (j_hi - j_lo + 1)
    return TileSignature((y0, y1, x0, x1), planes, int(idx.shape[0]),
                         rendered, len(grid))

  def plan(self, poses: np.ndarray,
           convention: Convention = Convention.REF_HOMOGRAPHY,
           ) -> TileSignature:
    """``touched`` + ``signature`` in one call (the per-request entry)."""
    return self.signature(self.touched(poses, convention))

  def touched_tile_ids(self, touched: np.ndarray) -> frozenset:
    """The touched set as ``(row, col)`` ids — what an edge frame-cache
    entry records so a tile-granular reload drops only dependent frames."""
    return frozenset((int(i), int(j)) for i, j in np.argwhere(touched))

  # -- crop geometry --------------------------------------------------------

  def crop_tiles(self, crop: tuple[int, int, int, int]
                 ) -> tuple[range, range]:
    """Tile index ranges ``(rows, cols)`` covering a tile-snapped crop."""
    y0, y1, x0, x1 = crop
    return (range(y0 // self.grid.tile, (y1 - 1) // self.grid.tile + 1),
            range(x0 // self.grid.tile, (x1 - 1) // self.grid.tile + 1))

  def crop_src_intrinsics(self, crop: tuple[int, int, int, int],
                          convention: Convention = Convention.REF_HOMOGRAPHY,
                          ) -> np.ndarray:
    """Source intrinsics for a cropped render.

    The inverse homography factors as ``K_s @ M @ K_t^-1``; premultiplying
    ``K_s`` by the per-convention affine correction makes the cropped
    sampler's tap for every target pixel exactly ``tap_full - offset`` —
    the crop samples the same source pixels the monolithic render would.
    A full-coverage crop returns the intrinsics UNCHANGED (no float
    round-trip), which is what makes the all-tiles-touched render
    bit-exact to the monolithic one.
    """
    h, w = self.grid.height, self.grid.width
    y0, y1, x0, x1 = crop
    if (y0, y1, x0, x1) == (0, h, 0, w):
      return self.intrinsics
    ch, cw = y1 - y0, x1 - x0
    ax, bx, ay, by = _tap_affine(convention, h, w, ch, cw, y0, x0)
    correction = np.array([[ax, 0.0, bx],
                           [0.0, ay, by],
                           [0.0, 0.0, 1.0]], np.float64)
    return (correction @ np.asarray(self.intrinsics, np.float64)).astype(
        np.float32)
