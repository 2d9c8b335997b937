"""Tile-granular serving in the port against the JAX package.

``mpi_vision_tpu_torch.serve.tiles`` is a host-only copy of the JAX
module: it must plan exactly as the JAX one does (digests, plane masks,
touched tiles, signature tokens, crop intrinsics). A tiled port service
(``RenderService(tile=8, device="cpu")``, method 'pallas': the warp, then
the compose kernel's plain version) is held against a tiled JAX service
(``method="pallas"``, the Pallas composite in interpret mode) on
``tests/serve/test_tiles.py``'s 16 x 16 x 4 scene and its three poses.

Tolerances: 1e-4 between the port's and JAX's frames (``test_tiles.py``'s
bound: JAX's crop-corrected homography chain rounds differently); every
tiled port frame, full coverage or culled, bit-identical to the untiled
port service's (the port renders a crop through its window of the scene,
with the full render's taps).
"""

import json
import math
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from mpi_vision_tpu.core import camera as jcamera
from mpi_vision_tpu.core.sampling import Convention as JConvention
from mpi_vision_tpu.serve import RenderService as JRenderService
from mpi_vision_tpu.serve import tiles as jtiles
from mpi_vision_tpu.serve.server import (
    synthetic_tiled_scene as jsynthetic_tiled_scene,
)
from mpi_vision_tpu_torch import cli
from mpi_vision_tpu_torch.core import render as trender
from mpi_vision_tpu_torch.core.sampling import Convention as TConvention
from mpi_vision_tpu_torch.kernels import compose_over
from mpi_vision_tpu_torch.serve import RenderService, synthetic_tiled_scene
from mpi_vision_tpu_torch.serve import tiles as ttiles

H = W = 16
P = 4
TILE = 8  # 2x2 grid
CONVENTIONS = [c.name for c in JConvention]


def _scene(seed=3, height=H, width=W, planes=P, regions=2):
  layers, depths, _ = synthetic_tiled_scene(
      "s", height=height, width=width, planes=planes, regions=regions,
      seed=seed)
  # Narrow FOV (fx = 2w): a +-0.35 rad pan views one tile column.
  k = np.asarray(jcamera.intrinsics_matrix(2.0 * width, 2.0 * width,
                                           width / 2.0, height / 2.0),
                 np.float32)
  return layers, depths, k


def _pan(theta):
  c, s = math.cos(theta), math.sin(theta)
  pose = np.eye(4, dtype=np.float32)
  pose[0, 0], pose[0, 2], pose[2, 0], pose[2, 2] = c, s, -s, c
  return pose


POSE_FULL = np.eye(4, dtype=np.float32)
POSE_RIGHT = _pan(-0.35)  # views the right tile column only
POSE_LEFT = _pan(0.35)    # views the left tile column only
POSES = (POSE_FULL, POSE_RIGHT, POSE_LEFT)


def test_synthetic_tiled_scene_matches_the_jax_recipe():
  for got, want in zip(synthetic_tiled_scene("t", 24, 40, 6, regions=3,
                                             seed=2),
                       jsynthetic_tiled_scene("t", 24, 40, 6, regions=3,
                                              seed=2)):
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("height,width,tile", [(16, 16, 8), (20, 28, 8)])
def test_tiles_module_plans_as_the_jax_module(convention, height, width,
                                              tile):
  layers, depths, k = _scene(height=height, width=width)
  tm = ttiles.TileMeta.build(layers, depths, k, tile)
  jm = jtiles.TileMeta.build(layers, depths, k, tile)
  assert tm.grid == ttiles.TileGrid(*jm.grid.__dict__.values())
  assert tm.digests == jm.digests
  assert tm.scene_digest == jm.scene_digest
  np.testing.assert_array_equal(tm.plane_any, jm.plane_any)
  for i in range(tm.grid.rows):
    for j in range(tm.grid.cols):
      assert tm.depth_range(i, j) == jm.depth_range(i, j)
  conv_t, conv_j = TConvention[convention], JConvention[convention]
  for pose in POSES + (_pan(0.1), _pan(-1.2)):
    touched = tm.touched(pose[None], conv_t)
    np.testing.assert_array_equal(touched, jm.touched(pose[None], conv_j))
    sig = tm.signature(touched)
    assert sig.token() == jm.signature(touched).token()
    assert ttiles.TileSignature.parse(sig.token(), tm.grid) == sig
    assert tm.crop_tiles(sig.crop) == jm.crop_tiles(sig.crop)
    np.testing.assert_array_equal(
        tm.crop_src_intrinsics(sig.crop, conv_t),
        jm.crop_src_intrinsics(sig.crop, conv_j))
    assert tm.touched_tile_ids(touched) == jm.touched_tile_ids(touched)
  edited = layers.copy()
  edited[0:tile, 0:tile, :, :3] += 0.125
  assert (tm.changed_tiles(ttiles.TileMeta.build(edited, depths, k, tile))
          == jm.changed_tiles(jtiles.TileMeta.build(edited, depths, k, tile))
          == [(0, 0)])


def test_tiles_module_helpers_match_jax():
  for dims in ((16, 16), (1080, 1920), (512, 512), (7, 300), (4000, 6000)):
    assert ttiles.auto_tile(*dims) == jtiles.auto_tile(*dims)
  planes = tuple(range(0, 31, 2))
  for keep in (0.1, 0.5, 0.9, 1.0):
    assert ttiles.thin_planes(planes, keep) == jtiles.thin_planes(planes,
                                                                  keep)
  assert ttiles.KEY_SEP == jtiles.KEY_SEP
  assert ttiles.tile_cache_key("s", 1, 2) == jtiles.tile_cache_key("s", 1, 2)


@pytest.fixture(scope="module")
def scene_data():
  return _scene()


@pytest.fixture(scope="module")
def tiled_svc(scene_data):
  service = RenderService(device="cpu", max_batch=2, max_wait_ms=2.0,
                          tile=TILE)
  service.add_scene("s", *scene_data)
  yield service
  service.close()


@pytest.fixture(scope="module")
def mono_svc(scene_data):
  service = RenderService(device="cpu", max_batch=2, max_wait_ms=2.0,
                          method="pallas")
  service.add_scene("s", *scene_data)
  yield service
  service.close()


def test_tiled_service_matches_the_jax_tiled_service(scene_data):
  port = RenderService(device="cpu", max_batch=2, max_wait_ms=2.0,
                       tile=TILE)
  jax_svc = JRenderService(max_batch=2, max_wait_ms=2.0, use_mesh=False,
                           tile=TILE, method="pallas")
  try:
    for s in (port, jax_svc):
      s.add_scene("s", *scene_data)
    assert port.engine.method == "pallas"
    for pose in POSES:
      got = port.render("s", pose, timeout=60)
      want = jax_svc.render("s", pose, timeout=60)
      assert got.shape == (H, W, 3)
      assert float(np.abs(got - want).max()) <= 1e-4
    keys = ("tiled_requests", "touched_total", "rendered_total",
            "culled_total", "mean_touched", "tile")
    got_tiles, want_tiles = port.stats()["tiles"], jax_svc.stats()["tiles"]
    assert {k: got_tiles[k] for k in keys} == {k: want_tiles[k] for k in keys}
    assert got_tiles["culled_total"] == 4  # two tiles per pan pose
    # The plane counts of the JAX module's plans, and a cull among them.
    meta = jtiles.TileMeta.build(*scene_data, TILE)
    counts = [len(meta.plan(pose[None]).planes) for pose in POSES]
    assert got_tiles["planes_hist"] == {
        str(n): counts.count(n) for n in sorted(set(counts))}
    assert min(counts) < P
  finally:
    port.close()
    jax_svc.close()


def test_full_coverage_is_bit_exact_and_culled_frames_agree(tiled_svc,
                                                            mono_svc):
  calls = compose_over.plain_composite.calls
  full = tiled_svc.render("s", POSE_FULL, timeout=60)
  assert full.tobytes() == mono_svc.render("s", POSE_FULL,
                                           timeout=60).tobytes()
  for pose in (POSE_RIGHT, POSE_LEFT):
    tiled = tiled_svc.render("s", pose, timeout=60)
    mono = mono_svc.render("s", pose, timeout=60)
    assert tiled.shape == mono.shape == (H, W, 3)
    assert tiled.tobytes() == mono.tobytes()
  # Every frame composited through the kernel's entry (its plain version
  # here), none launched a kernel on the CPU.
  assert compose_over.plain_composite.calls >= calls + 6
  stats = tiled_svc.stats()
  assert stats["tiles"]["culled_total"] >= 4
  assert stats["tile_cache"]["misses"] >= 4  # one bake per tile
  assert stats["tiles"]["crop_memo"]["entries"] >= 3
  # A repeat of a culled pose is one crop-memo hit: no new tile lookups.
  lookups = stats["tile_cache"]["hits"] + stats["tile_cache"]["misses"]
  tiled_svc.render("s", POSE_RIGHT, timeout=60)
  after = tiled_svc.stats()["tile_cache"]
  assert after["hits"] + after["misses"] == lookups


@pytest.mark.parametrize("method", ["pallas", "scan", "fused"])
@pytest.mark.parametrize("convention", CONVENTIONS)
def test_window_render_is_the_full_render_bit_for_bit(rng, method,
                                                      convention):
  """A crop rendered through its window of the scene equals the full
  scene's render wherever every tap lands in the window."""
  layers, depths, k = _scene(height=24, width=40, planes=5, regions=3)
  conv = TConvention[convention]
  meta = ttiles.TileMeta.build(layers, depths, k, 8)
  pose = _pan(-0.3)
  sig = meta.plan(pose[None], conv)
  y0, y1, x0, x1 = sig.crop
  assert (y1 - y0, x1 - x0) != (24, 40)   # a real crop
  crop = torch.from_numpy(layers[y0:y1, x0:x1][None].copy())
  t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
  got = trender.render_mpi(crop, t(pose[None]), t(depths), t(k[None]),
                           conv, method=method,
                           src_window=(y0, x0, 24, 40))
  want = trender.render_mpi(t(layers[None]), t(pose[None]), t(depths),
                            t(k[None]), conv, method=method)
  assert got.shape == want.shape == (1, 24, 40, 3)
  assert torch.equal(got, want)


def test_culled_requests_batch_only_with_their_own_plan(tiled_svc):
  futs = [tiled_svc.render_async("s", p) for p in (POSE_RIGHT, POSE_LEFT,
                                                  POSE_RIGHT, POSE_LEFT)]
  frames = [f.result(60) for f in futs]
  assert frames[0].tobytes() == frames[2].tobytes()
  assert frames[1].tobytes() == frames[3].tobytes()
  assert frames[0].tobytes() == tiled_svc.render("s", POSE_RIGHT,
                                                 timeout=60).tobytes()


def test_concurrent_tiled_requests_lose_no_count(scene_data):
  """More submitters than cores and a short switch interval: the tile
  counters and the crop memo's byte account must add up exactly."""
  svc = RenderService(device="cpu", max_batch=4, max_wait_ms=1.0,
                      tile=TILE)
  poses = [_pan(0.05 * i - 0.4) for i in range(17)]
  meta = ttiles.TileMeta.build(*scene_data, TILE)
  plans = [meta.plan(p[None]) for p in poses]
  n_threads, per_thread = 2 * (os.cpu_count() or 2), 3
  errors, interval = [], sys.getswitchinterval()

  def fire(t):
    try:
      futs = [svc.render_async("s", poses[(t + k) % len(poses)])
              for k in range(per_thread)]
      for f in futs:
        f.result(60)
    except Exception as e:  # noqa: BLE001 - re-raised on the main thread
      errors.append(e)

  sys.setswitchinterval(1e-6)
  try:
    svc.add_scene("s", *scene_data)
    threads = [threading.Thread(target=fire, args=(t,))
               for t in range(n_threads)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:1]
    tiles = svc.stats()["tiles"]
    sent = [plans[(t + k) % len(poses)] for t in range(n_threads)
            for k in range(per_thread)]
    assert tiles["tiled_requests"] == len(sent)
    assert tiles["touched_total"] == sum(p.tiles_touched for p in sent)
    assert tiles["culled_total"] == sum(p.tiles_total - p.tiles_rendered
                                        for p in sent)
    with svc._crop_lock:
      assert svc._crop_memo_bytes == sum(
          m.nbytes for m in svc._crop_memo.values())
  finally:
    sys.setswitchinterval(interval)
    svc.close()


def test_exact_convention_and_auto_tile(scene_data):
  svc_t = RenderService(device="cpu", max_batch=2, tile="auto",
                        convention=TConvention.EXACT)
  svc_m = RenderService(device="cpu", max_batch=2, method="pallas",
                        convention=TConvention.EXACT)
  try:
    for s in (svc_t, svc_m):
      s.add_scene("s", *scene_data)
    assert svc_t.tile_meta("s").grid.tile == ttiles.auto_tile(H, W)
    assert svc_t.render("s", POSE_FULL, timeout=60).tobytes() == \
        svc_m.render("s", POSE_FULL, timeout=60).tobytes()
    assert svc_t.render("s", POSE_RIGHT, timeout=60).tobytes() == \
        svc_m.render("s", POSE_RIGHT, timeout=60).tobytes()
  finally:
    svc_t.close()
    svc_m.close()


def test_reregistration_invalidates_only_changed_tiles(scene_data):
  layers, depths, k = scene_data
  svc = RenderService(device="cpu", max_batch=2, tile=TILE)
  try:
    svc.add_scene("s", layers, depths, k)
    svc.render("s", POSE_FULL, timeout=60)
    assert len(svc._tile_cache) == 4
    edited = layers.copy()
    edited[0:TILE, TILE:W, :, :3] += 0.125  # tile (0, 1) only
    svc.add_scene("s", edited, depths, k)
    assert len(svc._tile_cache) == 3
    assert svc.stats()["tiles"]["crop_memo"]["entries"] == 0
    mono = RenderService(device="cpu", max_batch=2, method="pallas")
    try:
      mono.add_scene("s", edited, depths, k)
      assert svc.render("s", POSE_FULL, timeout=60).tobytes() == \
          mono.render("s", POSE_FULL, timeout=60).tobytes()
    finally:
      mono.close()
  finally:
    svc.close()


def test_tiled_service_guards(scene_data, tiled_svc):
  with pytest.raises(ValueError, match="XLA method"):
    RenderService(device="cpu", tile=TILE, method="fused_pallas")
  with pytest.raises(ValueError, match="tile must be >= 8"):
    RenderService(device="cpu", tile=4)
  with pytest.raises(ValueError, match="tile must be an int"):
    RenderService(device="cpu", tile="big")
  with pytest.raises(ValueError, match="x1f"):
    tiled_svc.add_scene("s" + ttiles.KEY_SEP + "t0,0", *scene_data)
  with pytest.raises(KeyError):
    tiled_svc.render("nope", POSE_FULL, timeout=60)
  for argv, msg in ((["--tile-size", "8"], "require"),
                    (["--tiled", "--tile-size", "4"], ">= 8"),
                    (["--tiled", "--tile-size", "x"], "integer or 'auto'"),
                    (["--tiled", "--method", "fused_pallas"], "XLA method")):
    with pytest.raises(SystemExit, match=msg):
      cli.main(["serve", "--device", "cpu", "--port", "0", "--scenes", "0",
                *argv])


def test_cli_serve_tiled_on_cpu(tmp_path, capsys):
  port_file = str(tmp_path / "port")
  out = {}

  def run():
    out["rc"] = cli.main(["serve", "--tiled", "--tile-size", "8", "--device",
                          "cpu", "--port", "0", "--port-file", port_file,
                          "--duration", "3", "--scenes", "1", "--img-size",
                          "16", "--num-planes", "4"])

  thread = threading.Thread(target=run)
  thread.start()
  deadline = time.monotonic() + 60
  while not os.path.exists(port_file) and time.monotonic() < deadline:
    time.sleep(0.02)
  port = int(open(port_file).read())
  body = json.dumps({"scene_id": "scene_000",
                     "pose": _pan(0.2).tolist()}).encode()
  req = urllib.request.Request(
      f"http://127.0.0.1:{port}/render", data=body,
      headers={"Content-Type": "application/json",
               "Accept": "application/octet-stream"})
  with urllib.request.urlopen(req, timeout=60) as resp:
    frame = np.frombuffer(resp.read(), "<f4").reshape(
        [int(x) for x in resp.headers["X-Image-Shape"].split(",")])
  stats = json.loads(urllib.request.urlopen(
      f"http://127.0.0.1:{port}/stats", timeout=30).read())
  thread.join(60)
  assert out["rc"] == 0
  assert frame.shape == (16, 16, 3) and np.isfinite(frame).all()
  assert stats["engine"]["method"] == "pallas"
  assert stats["tiles"]["tiled_requests"] == 1 and stats["tiles"]["tile"] == 8
  assert stats["tile_cache"]["scenes"] == 4
  summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert summary["method"] == "pallas" and summary["tile"] == 8
  assert summary["tiles"]["tiled_requests"] == 1
