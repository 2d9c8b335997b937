"""The port's serving stack (``mpi_vision_tpu_torch.serve``) on the CPU.

``RenderService(device="cpu")`` against the JAX ``RenderService(use_mesh=
False)`` on the same ``synthetic_scene``: the port serves through
``method="fused_pallas"`` (the kernel's plain version on the CPU), the JAX
service through XLA's 'fused' scan, so the tolerances are the kernel's:
atol 1e-4 under EXACT, 2e-3 under the reference conventions. The serving
invariant — a request's frame is bit-identical whatever batch it lands
in — is pinned exactly.
"""

import base64
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mpi_vision_tpu.core.sampling import Convention as JConvention
from mpi_vision_tpu.serve import RenderEngine as JRenderEngine
from mpi_vision_tpu.serve import RenderService as JRenderService
from mpi_vision_tpu.serve import bake_scene as jbake_scene
from mpi_vision_tpu.serve import synthetic_scene as jsynthetic_scene
from mpi_vision_tpu.serve.engine import upsample_nearest as jupsample_nearest
from mpi_vision_tpu_torch import cli
from mpi_vision_tpu_torch.core.sampling import Convention as TConvention
from mpi_vision_tpu_torch.kernels import render_fused
from mpi_vision_tpu_torch.serve.engine import upsample_nearest
from mpi_vision_tpu_torch.serve import (
    RenderEngine,
    RenderService,
    SceneCache,
    bake_scene,
    make_http_server,
    synthetic_scene,
)

H, W, P = 32, 48, 4


def _pose(tx=0.0, tz=0.0, ry=0.0):
  pose = np.eye(4, dtype=np.float32)
  c, s = np.cos(ry), np.sin(ry)
  pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
  pose[0, 3], pose[2, 3] = tx, tz
  return pose


POSES = [_pose(0.02 * i, -0.01 * i, 0.01 * i) for i in range(4)]


@pytest.fixture(scope="module")
def svc():
  service = RenderService(device="cpu", max_batch=4, max_wait_ms=250.0,
                          convention=TConvention.EXACT)
  service.add_synthetic_scenes(2, height=H, width=W, planes=P)
  yield service
  service.close()


def test_synthetic_scene_matches_the_jax_recipe():
  for got, want in zip(synthetic_scene("scene_007", H, W, P, seed=3),
                       jsynthetic_scene("scene_007", H, W, P, seed=3)):
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("convention,atol", [("EXACT", 1e-4),
                                             ("REF_HOMOGRAPHY", 2e-3)])
def test_service_matches_jax_service(convention, atol):
  port = RenderService(device="cpu", max_batch=4, max_wait_ms=1.0,
                       convention=TConvention[convention])
  jax_svc = JRenderService(max_batch=4, max_wait_ms=1.0, use_mesh=False,
                           convention=JConvention[convention])
  try:
    for s in (port, jax_svc):
      s.add_synthetic_scenes(1, height=H, width=W, planes=P, seed=5)
    for pose in POSES[:2]:
      got = port.render("scene_000", pose)
      want = jax_svc.render("scene_000", pose)
      assert got.shape == (H, W, 3) and got.dtype == np.float32
      np.testing.assert_allclose(got, want, atol=atol, rtol=0)
  finally:
    port.close()
    jax_svc.close()


def test_bake_scene_from_jax_baked_scene_renders_like_jax():
  """A JAX ``BakedScene``'s arrays, through ``np.asarray``, bake into the
  port and render what the JAX engine renders."""
  jscene = jbake_scene("s", *jsynthetic_scene("s", H, W, P))
  scene = bake_scene("s", np.asarray(jscene.rgba_layers),
                     np.asarray(jscene.depths),
                     np.asarray(jscene.intrinsics), device="cpu")
  assert scene.planes.shape == (P, H, W, 4) and scene.planes.is_contiguous()
  assert torch.equal(scene.rgba_layers, torch.from_numpy(
      np.array(jscene.rgba_layers)))
  assert scene.nbytes == (P * H * W * 4 + P + 9) * 4
  poses = np.stack(POSES[1:])
  got = RenderEngine(device="cpu", convention=TConvention.EXACT
                     ).render_batch(scene, poses)
  want = JRenderEngine(use_mesh=False, convention=JConvention.EXACT
                       ).render_batch(jscene, poses)
  np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_bake_scene_validates_and_copies():
  rgba, depths, k = synthetic_scene("s", H, W, P)
  with pytest.raises(ValueError, match="rgba_layers"):
    bake_scene("s", rgba[..., :3], depths, k, device="cpu")
  with pytest.raises(ValueError, match="depths"):
    bake_scene("s", rgba, depths[:-1], k, device="cpu")
  with pytest.raises(ValueError, match="intrinsics"):
    bake_scene("s", rgba, depths, k[:2], device="cpu")
  scene = bake_scene("s", rgba[:, :, :1], depths[:1], k, device="cpu")
  rgba[:] = 7.0  # the caller's array is not the baked scene
  assert float(scene.planes.max()) <= 1.0


def test_cache_lru_eviction_and_counters():
  def baked(sid):
    return bake_scene(sid, *synthetic_scene(sid, H, W, P), device="cpu")

  cache = SceneCache(byte_budget=2 * baked("a").nbytes)
  for sid in ("a", "b", "c"):
    assert cache.get(sid) is None
    cache.put(baked(sid))
  assert len(cache) == 2 and "a" not in cache
  assert cache.get("c").scene_id == "c"
  stats = cache.stats()
  assert stats["evictions"] == 1 and stats["misses"] == 3
  assert stats["bytes"] <= stats["byte_budget"]


def test_engine_buckets_pads_and_streams(svc):
  engine = svc.engine
  scene = svc._get_scene("scene_000")
  assert [engine.batch_bucket(v) for v in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
  handle = engine.submit(scene, np.stack(POSES[:3]))
  assert handle.out.shape[0] == 4 and engine.poll(handle)
  out = engine.wait(handle)
  assert out.shape == (3, H, W, 3) and engine.inflight == 0
  assert set(handle.timings) == {"h2d_s", "compute_s", "readback_s"}
  np.testing.assert_array_equal(out, engine.render_batch(
      scene, np.stack(POSES[:3])))


def test_concurrent_requests_coalesce_and_match_unbatched(svc):
  """>= 2 concurrent same-scene requests ride ONE dispatch and each frame
  is bit-identical to its unbatched render."""
  before = svc.engine.dispatches
  futs = [svc.render_async("scene_000", p) for p in POSES]
  outs = [f.result(120) for f in futs]
  assert svc.engine.dispatches - before == 1
  for pose, out in zip(POSES, outs):
    np.testing.assert_array_equal(out, svc.render("scene_000", pose))
  assert svc.render("scene_001", POSES[0]).shape == (H, W, 3)


def _post(port, body, octet=False):
  req = urllib.request.Request(
      f"http://127.0.0.1:{port}/render", data=json.dumps(body).encode(),
      headers={"Content-Type": "application/json",
               **({"Accept": "application/octet-stream"} if octet else {})})
  with urllib.request.urlopen(req, timeout=120) as resp:
    data = resp.read()
    assert resp.headers["X-Trace-Id"]
    if octet:
      shape = [int(x) for x in resp.headers["X-Image-Shape"].split(",")]
      return np.frombuffer(data, "<f4").reshape(shape)
    payload = json.loads(data)
    return np.frombuffer(base64.b64decode(payload["image_b64"]),
                         "<f4").reshape(payload["shape"])


def test_http_round_trip(svc):
  httpd = make_http_server(svc, port=0)
  port = httpd.server_address[1]
  thread = threading.Thread(target=httpd.serve_forever, daemon=True)
  thread.start()
  try:
    outs = [None] * len(POSES)

    def fire(i):
      outs[i] = _post(port, {"scene_id": "scene_000",
                             "pose": POSES[i].tolist()}, octet=True)

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(POSES))]
    for t in threads:
      t.start()
    for t in threads:
      t.join(120)
    assert all(o is not None for o in outs)
    as_json = _post(port, {"scene_id": "scene_000",
                           "pose": POSES[2].tolist()})
    np.testing.assert_array_equal(as_json, outs[2])
    np.testing.assert_array_equal(outs[1], svc.render("scene_000", POSES[1]))
    health = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/healthz", timeout=30).read())
    assert health["status"] == "ok" and health["platform"] == "cpu"
    stats = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/stats", timeout=30).read())
    assert stats["engine"]["platform"] == "cpu"
    assert stats["engine"]["method"] == "fused_pallas"
    assert any(int(b) >= 2 for b in stats["batch_size_hist"])
    for body, code in (({"scene_id": "nope", "pose": POSES[0].tolist()}, 404),
                       ({"scene_id": "scene_000", "pose": [[1, 2]]}, 400)):
      with pytest.raises(urllib.error.HTTPError) as err:
        _post(port, body)
      assert err.value.code == code
  finally:
    httpd.shutdown()
    httpd.server_close()
    thread.join(10)
  assert not thread.is_alive()


def test_no_kernel_launch_and_plain_version_on_cpu(svc):
  launches = render_fused.render_mpi_fused.launches
  calls = render_fused.plain_render.calls
  svc.render("scene_001", POSES[3])
  assert render_fused.render_mpi_fused.launches == launches
  assert render_fused.plain_render.calls > calls


def test_cli_serve_on_cpu(capsys):
  assert cli.main(["serve", "--device", "cpu", "--port", "0", "--duration",
                   "0.2", "--scenes", "1", "--img-size", "16",
                   "--num-planes", "3"]) == 0
  summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert summary["platform"] == "cpu" and summary["health"] == "ok"
  assert summary["method"] == "fused_pallas"
  args = cli.build_parser().parse_args(["serve"])
  assert (args.device, args.method) == ("cuda", "fused_pallas")


def test_upsample_nearest_matches_jax(rng):
  frames = rng.uniform(0, 1, (2, 6, 9, 3)).astype(np.float32)
  np.testing.assert_array_equal(upsample_nearest(frames, (12, 17)),
                                jupsample_nearest(frames, (12, 17)))
  assert upsample_nearest(frames, (6, 9)) is frames
