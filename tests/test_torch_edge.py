"""The port's edge frame cache against the JAX package's.

``serve/edge/lattice.py`` and ``cache.py`` are copies: view cells and pose
errors equal JAX's exactly on 1000 seeded poses, and the hit/warp/miss
sequence, ETags and evictions on a seeded pose stream equal JAX's
``EdgeFrameCache``. ``warp.py`` is rewritten (the relative pose in float64
on the host, the resample on the engine's device): within 1e-4 of JAX's
``warp_frame`` on seeded poses (the sampler bound of
``tests/test_torch_core.py``) and within 1e-5 of the frame at zero pose
error (JAX's ``tests/serve/test_edge.py:180``). The service cases port
``tests/serve/test_edge.py``'s (hit bit-identical to the first render,
warp under the threshold, ``swap_scenes`` invalidation, ETag / 304 over
HTTP, the negative TTL) and add the tiled one: a one-tile swap drops only
the frames that sampled the tile.
"""

import json
import math
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mpi_vision_tpu.serve import edge as jedge
from mpi_vision_tpu_torch.serve import RenderService, make_http_server
from mpi_vision_tpu_torch.serve import edge as tedge
from mpi_vision_tpu_torch.serve.scheduler import QueueFullError
from mpi_vision_tpu_torch.serve.server import (
    synthetic_scene,
    synthetic_tiled_scene,
)

H = W = 16
P = 4


def _pose(tx=0.0, ty=0.0, tz=0.0, yaw_deg=0.0):
  pose = np.eye(4, dtype=np.float32)
  if yaw_deg:
    a = np.radians(yaw_deg)
    pose[0, 0] = pose[2, 2] = np.cos(a)
    pose[0, 2], pose[2, 0] = np.sin(a), -np.sin(a)
  pose[:3, 3] = (tx, ty, tz)
  return pose


def _random_poses(rng, n, trans=0.2, angle_deg=8.0):
  """Seeded small rigid motions (axis-angle rotations), float32."""
  out = []
  for _ in range(n):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = math.radians(rng.uniform(0.0, angle_deg))
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    pose = np.eye(4)
    pose[:3, :3] = np.eye(3) + math.sin(a) * kx + (1 - math.cos(a)) * kx @ kx
    pose[:3, 3] = rng.uniform(-trans, trans, 3)
    out.append(pose.astype(np.float32))
  return out


def test_lattice_equals_jax_on_1000_seeded_poses(rng):
  poses = _random_poses(rng, 1000)
  poses += [_pose(), _pose(yaw_deg=179.9), _pose(0.05, 0.05, 0.05)]
  for a, b in zip(poses, poses[1:] + poses[:1]):
    assert np.array_equal(tedge.rotation_vector(a[:3, :3]),
                          jedge.rotation_vector(a[:3, :3]))
    for pitch in ((0.05, 2.0), (0.013, 0.7)):
      assert (tedge.quantize_pose(a, *pitch)
              == jedge.quantize_pose(a, *pitch))
    assert tedge.pose_error(a, b) == jedge.pose_error(a, b)


def _edge_config(mod, **kw):
  base = dict(trans_cell=0.02, rot_bucket_deg=2.0, warp_max_trans=0.06,
              warp_max_rot_deg=4.0, byte_budget=8 * (4 * 4 * 3 * 4 + 100))
  base.update(kw)
  return mod.EdgeConfig(**base)


class _Clock:

  def __init__(self):
    self.t = 100.0

  def __call__(self):
    return self.t


def _stream(mod, poses, clocks):
  cache = mod.EdgeFrameCache(_edge_config(mod, negative_ttl_s=2.0),
                             clock=clocks)
  k = np.eye(3, dtype=np.float32)
  trail = []
  for i, pose in enumerate(poses):
    clocks.t += 0.5
    sid = f"s{i % 2}"
    kind, entry, cell = cache.lookup(sid, "d", pose,
                                     warp_scale=3.0 if i % 7 == 0 else 1.0)
    neg = cache.negative_lookup(sid, "d", pose)
    trail.append((kind, cell, None if entry is None else entry.etag,
                  None if neg is None else round(neg, 9)))
    if kind == "miss":
      if i % 5 == 0:
        cache.negative_put(sid, "d", pose)
      else:
        put = cache.put(sid, "d", cell, pose,
                        np.full((4, 4, 3), i, np.float32), k, 10.0,
                        tiles=frozenset({(i % 3, 0)}))
        trail.append(("put", put.etag, put.cell))
    if i == 60:
      trail.append(("inv", cache.invalidate_tiles("s0", [(1, 0)])))
    if i == 90:
      trail.append(("inv", cache.invalidate_scene("s1")))
    etag = trail[-1][1] if trail[-1][0] == "put" else None
    trail.append(("reval", cache.revalidate(sid, "d", pose, etag)))
  return trail, cache.stats(), len(cache)


def test_cache_stream_equals_jax(rng):
  fresh = _random_poses(rng, 60, trans=0.08, angle_deg=4.0)
  # Every other request revisits an earlier pose: repeat traffic.
  poses = [p for i in range(60) for p in (fresh[i], fresh[i // 2])]
  ours = _stream(tedge, poses, _Clock())
  theirs = _stream(jedge, poses, _Clock())
  assert ours == theirs
  kinds = [t[0] for t in ours[0]]
  assert {"hit", "warp", "miss", "put", "inv"} <= set(kinds)
  assert ours[1]["evictions"] > 0 and ours[1]["negative_hits"] > 0


def test_warp_frame_matches_jax_and_is_exact_at_zero_error(rng):
  frame = rng.uniform(0, 1, (H, 24, 3)).astype(np.float32)
  k = np.asarray([[12.0, 0, 12.0], [0, 12.0, 8.0], [0, 0, 1]], np.float32)
  src = _pose(0.01)
  np.testing.assert_allclose(
      tedge.warp_frame(frame, src, src, k, 10.0, device="cpu"), frame,
      atol=1e-5)
  for tgt in _random_poses(rng, 6, trans=0.05, angle_deg=3.0):
    got = tedge.warp_frame(frame, src, tgt, k, 3.0, device="cpu")
    want = jedge.warp_frame(frame, src, tgt, k, 3.0)
    assert got.dtype == np.float32 and got.shape == frame.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


def test_warp_frame_runs_on_the_card_unless_asked(rng):
  """The resample's default device is the card: without one it raises
  instead of running on the CPU unasked; with one it agrees with the CPU
  warp."""
  frame = rng.uniform(0, 1, (H, 24, 3)).astype(np.float32)
  k = np.asarray([[12.0, 0, 12.0], [0, 12.0, 8.0], [0, 0, 1]], np.float32)
  src, tgt = _pose(0.01), _pose(0.03)
  want = tedge.warp_frame(frame, src, tgt, k, 3.0, device="cpu")
  if torch.cuda.is_available():
    np.testing.assert_allclose(tedge.warp_frame(frame, src, tgt, k, 3.0),
                               want, atol=1e-4, rtol=0)
  else:
    with pytest.raises((AssertionError, RuntimeError)):
      tedge.warp_frame(frame, src, tgt, k, 3.0)


@pytest.fixture(scope="module")
def svc():
  service = RenderService(
      device="cpu", max_batch=4, max_wait_ms=5.0,
      edge=tedge.EdgeConfig(trans_cell=0.02, rot_bucket_deg=2.0,
                            warp_max_trans=0.06, warp_max_rot_deg=4.0,
                            byte_budget=64 << 20))
  service.add_synthetic_scenes(3, height=H, width=W, planes=P)
  yield service
  service.close()


def test_exact_cell_hit_is_bit_identical_to_its_first_render(svc):
  img1, info1 = svc.render_edge("scene_000", _pose(0.001))
  assert info1["edge"] == "miss" and info1["etag"]
  direct = svc.render("scene_000", _pose(0.001))
  assert direct.tobytes() == img1.tobytes()
  img2, info2 = svc.render_edge("scene_000", _pose(0.001))
  assert info2["edge"] == "hit" and info2["etag"] == info1["etag"]
  assert img2.tobytes() == img1.tobytes()
  img3, info3 = svc.render_edge("scene_000", _pose(0.004))
  assert info3["edge"] == "hit" and img3.tobytes() == img1.tobytes()


def test_near_miss_is_warp_served_under_the_threshold(svc):
  base = _pose(0.0, 0.0, 0.3)
  img0, info0 = svc.render_edge("scene_001", base)
  assert info0["edge"] == "miss"
  near = _pose(0.025, 0.0, 0.3)
  dispatches = svc.engine.dispatches
  img1, info1 = svc.render_edge("scene_001", near)
  assert info1["edge"] == "warp" and info1["etag"] is None
  assert svc.engine.dispatches == dispatches  # no render for a warp
  _, intrinsics, plane_depth, _ = svc._edge_meta("scene_001")
  np.testing.assert_array_equal(
      img1, tedge.warp_frame(img0, base, near, intrinsics, plane_depth,
                             device="cpu"))
  assert img1.tobytes() != img0.tobytes()
  _, info2 = svc.render_edge("scene_001", _pose(0.0, 0.0, -0.4))
  assert info2["edge"] == "miss"
  hist = svc.stats()["hist"]["warp_pose_error"]["trans"]
  assert hist["count"] >= 1


def test_swap_scenes_invalidates_and_repopulates_bit_exact(svc):
  pose = _pose(0.002, 0.0, 0.1)
  old, info_old = svc.render_edge("scene_002", pose)
  assert info_old["edge"] == "miss"
  before = svc.events.count("edge_cache_invalidated")
  svc.swap_scenes(
      {"scene_002": synthetic_scene("scene_002", H, W, P, seed=123)})
  assert svc.events.count("edge_cache_invalidated") == before + 1
  new, info_new = svc.render_edge("scene_002", pose)
  assert info_new["edge"] == "miss" and info_new["etag"] != info_old["etag"]
  assert new.tobytes() != old.tobytes()
  assert svc.render("scene_002", pose).tobytes() == new.tobytes()
  assert svc.stats()["edge"]["invalidations"] >= 1


def test_render_edge_unknown_scene_raises_keyerror(svc):
  from mpi_vision_tpu_torch.obs.trace import Tracer

  tracer = Tracer()
  tr = tracer.start_trace("render", scene_id="nope")
  with pytest.raises(KeyError, match="nope"):
    svc.render_edge("nope", _pose(), trace=tr)
  assert tracer.finished == 1
  assert "nope" in tracer.snapshot()["recent"][-1]["error"]
  assert svc.edge_cell_resident("nope", _pose()) == (None, True)


def _post(base, payload, headers=None):
  req = urllib.request.Request(base + "/render",
                               data=json.dumps(payload).encode(),
                               headers=headers or {})
  try:
    with urllib.request.urlopen(req, timeout=60) as resp:
      return resp.status, dict(resp.headers), resp.read()
  except urllib.error.HTTPError as e:
    with e:
      return e.code, dict(e.headers), e.read()


def test_http_304_revalidation_roundtrip(svc):
  httpd = make_http_server(svc)
  threading.Thread(target=httpd.serve_forever, daemon=True).start()
  base = f"http://127.0.0.1:{httpd.server_address[1]}"
  try:
    body = {"scene_id": "scene_000", "pose": _pose(0.0, 0.3, 0.0).tolist()}
    status, headers, payload = _post(base, body)
    assert status == 200 and headers["X-Edge-Cache"] == "miss"
    etag = headers["ETag"]
    assert etag.startswith('"') and headers["Cache-Control"] == "max-age=5"
    assert json.loads(payload)["scene_id"] == "scene_000"
    status, headers, _ = _post(base, body)
    assert status == 200 and headers["X-Edge-Cache"] == "hit"
    assert headers["ETag"] == etag
    revalidations = svc.stats()["edge"]["revalidations"]
    status, headers, payload = _post(base, body, {"If-None-Match": etag})
    assert status == 304 and payload == b""
    assert headers["ETag"] == etag
    assert headers["X-Edge-Cache"] == "revalidated"
    assert svc.stats()["edge"]["revalidations"] == revalidations + 1
    cell, resident = svc.edge_cell_resident("scene_000",
                                            _pose(0.0, 0.3, 0.0))
    assert resident and cell == svc.edge.cell_of(_pose(0.0, 0.3, 0.0))
    svc.swap_scenes(
        {"scene_000": synthetic_scene("scene_000", H, W, P, seed=77)})
    status, headers, payload = _post(base, body, {"If-None-Match": etag})
    assert status == 200 and headers["X-Edge-Cache"] == "miss"
    assert headers["ETag"] != etag and payload
  finally:
    httpd.shutdown()
    httpd.server_close()


def _pan(theta):
  c, s = math.cos(theta), math.sin(theta)
  pose = np.eye(4, dtype=np.float32)
  pose[0, 0], pose[0, 2], pose[2, 0], pose[2, 2] = c, s, -s, c
  return pose


def test_tiled_swap_drops_only_frames_that_sampled_a_changed_tile():
  layers, depths, _ = synthetic_tiled_scene("s", height=H, width=W,
                                            planes=P, regions=2, seed=3)
  k = np.asarray([[2.0 * W, 0, W / 2.0], [0, 2.0 * W, H / 2.0], [0, 0, 1]],
                 np.float32)
  service = RenderService(device="cpu", tile=8, max_batch=2,
                          max_wait_ms=2.0, edge=tedge.EdgeConfig())
  try:
    service.add_scene("s", layers, depths, k)
    right, left = _pan(-0.35), _pan(0.35)  # one tile column each
    img_r, info_r = service.render_edge("s", right)
    img_l, info_l = service.render_edge("s", left)
    assert info_r["edge"] == info_l["edge"] == "miss"
    assert service._touched_tiles("s", right).isdisjoint(
        service._touched_tiles("s", left))
    edited = layers.copy()
    edited[0:8, 0:8, :, :3] += 0.125  # tile (0, 0): the left column
    service.swap_scenes({"s": (edited, depths, k)})
    again_r, info = service.render_edge("s", right)
    assert info["edge"] == "hit" and info["etag"] == info_r["etag"]
    assert again_r.tobytes() == img_r.tobytes()
    new_l, info = service.render_edge("s", left)
    assert info["edge"] == "miss" and info["etag"] != info_l["etag"]
    assert new_l.tobytes() != img_l.tobytes()
    swaps = service.events.snapshot(kind="scene_swap")["events"]
    assert swaps[-1]["tiles_changed"] == {"s": 1}
  finally:
    service.close()


def test_render_edge_negative_caches_queue_full_and_sheds_fast():
  service = RenderService(
      device="cpu", max_batch=4, max_wait_ms=5.0,
      edge=tedge.EdgeConfig(trans_cell=0.02, rot_bucket_deg=2.0,
                            warp_max_trans=0.06, warp_max_rot_deg=4.0,
                            byte_budget=1 << 20, negative_ttl_s=30.0))
  try:
    service.add_synthetic_scenes(1, height=H, width=W, planes=P)
    calls = []

    def full_render(scene_id, pose, timeout=60.0, trace=None, **kwargs):
      calls.append(scene_id)
      raise QueueFullError("request queue full (64 waiting)")

    service.scheduler.render = full_render
    pose = _pose(0.4)
    with pytest.raises(QueueFullError) as e1:
      service.render_edge("scene_000", pose)
    assert e1.value.retry_after_s == 30.0
    with pytest.raises(QueueFullError, match="negative-cached") as e2:
      service.render_edge("scene_000", pose)
    assert 0 < e2.value.retry_after_s <= 30.0
    assert calls == ["scene_000"]
    edge = service.stats()["edge"]
    assert edge["negative_hits"] == 1 and edge["negative_entries"] == 1
  finally:
    service.close()
