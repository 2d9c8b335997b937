"""Sharded serving on the port: the counterpart of
``tests/serve/test_serve_sharded.py``.

``RenderService(use_mesh=True, devices=["cpu"] * 8)`` coalesces 8
concurrent requests into one dispatch whose views split over the 8 mesh
positions, every batched frame bit-identical to the same request served
alone, and within 1e-5 of the JAX ``RenderService(use_mesh=True)`` on the
suite's 8-device CPU mesh (``test_serve_sharded.py``'s tolerance, square
frames). ``describe()`` carries the JAX engine's keys; ``FaultyEngine``
delegates ``use_mesh``; ``serve --sharded`` has the JAX default, choices
and mapping, and ``--sharded on --device cpu`` serves from a one-device
mesh. A tiled sharded service equals the unsharded one to the bit, and a
mesh of two distinct devices (``cpu``, ``cpu:0``) keeps its second
device's scene replica on the bake it copies, so a swap serves the new
scene everywhere.
"""

import json
import os
import signal
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from mpi_vision_tpu import cli as jcli
from mpi_vision_tpu import serve as jserve
from mpi_vision_tpu.serve import RenderService as JRenderService
from mpi_vision_tpu_torch import cli
from mpi_vision_tpu_torch import serve as tserve
from mpi_vision_tpu_torch.serve import (
    FaultyEngine,
    RenderEngine,
    RenderService,
    synthetic_scene,
)

HW, P = 16, 4
CPU8 = ["cpu"] * 8


def _pose(i):
  p = np.eye(4, dtype=np.float32)
  p[0, 3], p[2, 3] = 0.01 * i, -0.005 * i
  return p


POSES = [_pose(i) for i in range(8)]


@pytest.fixture(scope="module")
def sharded():
  svc = RenderService(max_batch=8, max_wait_ms=500.0, use_mesh=True,
                      devices=CPU8)
  svc.add_synthetic_scenes(1, height=HW, width=HW, planes=P)
  yield svc
  svc.close()


def test_concurrent_requests_coalesce_into_one_sharded_dispatch(sharded):
  svc = sharded
  assert svc.engine.describe()["devices"] == 8
  assert svc.engine.batch_bucket(1) == 8 and svc.engine.batch_bucket(9) == 16
  before = svc.engine.dispatches
  futs = [svc.render_async("scene_000", p) for p in POSES]
  outs = [f.result(120) for f in futs]
  assert svc.engine.dispatches - before == 1
  hist = svc.stats()["batch_size_hist"]
  assert max(int(k) for k in hist) >= 2, hist
  # Bit for bit: batched == per-request through the same engine (a solo
  # request pads to the 8-view bucket), and == the unsharded engine on
  # the same bake.
  assert np.array_equal(outs[5], svc.render("scene_000", POSES[5]))
  single = RenderEngine(device="cpu")
  scene = svc.cache.get("scene_000")
  for pose, out in zip(POSES, outs):
    assert out.dtype == np.float32 and out.shape == (HW, HW, 3)
    assert np.array_equal(out, svc.engine.render_one(scene, pose))
    assert np.array_equal(out, single.render_one(scene, pose))


def test_frames_match_the_jax_sharded_service(sharded):
  jsvc = JRenderService(max_batch=8, max_wait_ms=500.0, use_mesh=True)
  try:
    jsvc.add_synthetic_scenes(1, height=HW, width=HW, planes=P)
    assert jsvc.engine.describe()["devices"] == 8
    jfuts = [jsvc.render_async("scene_000", p) for p in POSES]
    futs = [sharded.render_async("scene_000", p) for p in POSES]
    for f, jf in zip(futs, jfuts):
      np.testing.assert_allclose(f.result(120), jf.result(600), atol=1e-5,
                                 rtol=0)
    # describe() carries every key of the JAX engine's, the mesh ones
    # with the same values.
    desc, jdesc = sharded.engine.describe(), jsvc.engine.describe()
    assert set(jdesc) <= set(desc)
    assert (desc["sharded"], desc["devices"]) == (jdesc["sharded"],
                                                  jdesc["devices"])
    stats, health = sharded.stats(), sharded.healthz()
    assert stats["engine"]["sharded"] is True
    assert stats["engine"]["devices"] == health["devices"] == 8
  finally:
    jsvc.close()


@pytest.mark.parametrize("devices,use_mesh,want", [
    (CPU8[:2], None, (True, 2)), (CPU8[:2], False, (False, 2)),
    (["cpu"], True, (True, 1)), (["cpu"], None, (False, 1))])
def test_use_mesh_routing_and_faulty_engine_delegate(devices, use_mesh,
                                                     want):
  engine = RenderEngine(devices=devices, use_mesh=use_mesh)
  desc = engine.describe()
  assert (desc["sharded"], desc["devices"]) == want
  faulty = FaultyEngine(engine)
  assert faulty.use_mesh is engine.use_mesh is want[0]
  assert faulty.devices == engine.devices
  # The fallback engine stays one unsharded CPU device.
  fallback = faulty.cpu_fallback()
  assert (fallback.use_mesh, len(fallback.devices)) == (False, 1)
  rgba, depths, k = synthetic_scene("s", HW, HW, P)
  baked = tserve.bake_scene("s", rgba, depths, k, device="cpu")
  frames = faulty.render_batch(baked, np.stack(POSES[:3]))
  assert frames.shape == (3, HW, HW, 3)
  assert np.array_equal(frames, RenderEngine(device="cpu").render_batch(
      baked, np.stack(POSES[:3])))


def test_a_mesh_mixing_cpu_and_cuda_is_refused():
  with pytest.raises((ValueError, RuntimeError)):
    RenderEngine(devices=["cpu", "cuda"])


def test_serve_sharded_flag_has_the_jax_default_and_choices():
  def action(parser):
    sub = next(a for a in parser._actions
               if getattr(a, "choices", None) and "serve" in a.choices)
    return next(a for a in sub.choices["serve"]._actions
                if a.dest == "sharded")

  port, ref = action(cli.build_parser()), action(jcli.build_parser())
  assert port.default == ref.default == "auto"
  assert tuple(port.choices) == tuple(ref.choices)
  assert port.option_strings == ref.option_strings
  assert port.help == ref.help


class _Built(Exception):
  """Raised by the stand-in service once it has seen its kwargs."""


def _service_kwargs(monkeypatch, module, cli_mod, argv):
  seen = {}

  def fake_service(**kwargs):
    seen.update(kwargs)
    raise _Built

  monkeypatch.setattr(module, "RenderService", fake_service)
  args = cli_mod.build_parser().parse_args(["serve", *argv])
  with pytest.raises(_Built):
    cli_mod.cmd_serve(args)
  return seen


@pytest.mark.parametrize("flag", ["auto", "on", "off"])
def test_serve_sharded_maps_as_jax_does(monkeypatch, flag):
  argv = ["--sharded", flag]
  port = _service_kwargs(monkeypatch, tserve, cli, argv)
  ref = _service_kwargs(monkeypatch, jserve, jcli, argv)
  assert port["use_mesh"] is ref["use_mesh"]
  assert port["use_mesh"] is {"auto": None, "on": True, "off": False}[flag]


def test_serve_sharded_on_cpu_answers_from_a_one_device_mesh(tmp_path):
  port_file = tmp_path / "port"
  seen = {}

  def client():
    try:
      deadline = time.monotonic() + 60
      while not port_file.exists() and time.monotonic() < deadline:
        time.sleep(0.02)
      port = int(port_file.read_text())
      body = json.dumps({"scene_id": "scene_000",
                         "pose": POSES[3].tolist()}).encode()
      req = urllib.request.Request(
          f"http://127.0.0.1:{port}/render", data=body,
          headers={"Content-Type": "application/json",
                   "Accept": "application/octet-stream"})
      with urllib.request.urlopen(req, timeout=60) as resp:
        shape = tuple(int(x) for x in
                      resp.headers["X-Image-Shape"].split(","))
        seen["frame"] = np.frombuffer(resp.read(), "<f4").reshape(shape)
      seen["stats"] = json.loads(urllib.request.urlopen(
          f"http://127.0.0.1:{port}/stats", timeout=60).read())
    finally:
      # Only ever at the serve CLI's own handler (never the default,
      # which would end the test process).
      if getattr(signal.getsignal(signal.SIGTERM), "__name__",
                 "") == "_on_signal":
        os.kill(os.getpid(), signal.SIGTERM)

  helper = threading.Thread(target=client, daemon=True)
  helper.start()
  summary = cli.cmd_serve(cli.build_parser().parse_args([
      "serve", "--device", "cpu", "--sharded", "on", "--port", "0",
      "--port-file", str(port_file), "--scenes", "1", "--img-size",
      str(HW), "--num-planes", str(P), "--no-warmup", "--duration", "60"]))
  helper.join(30)
  assert not helper.is_alive()
  assert summary["sharded"] is True and summary["devices"] == 1
  assert seen["stats"]["engine"]["sharded"] is True
  assert seen["stats"]["engine"]["devices"] == 1
  rgba, depths, k = synthetic_scene("scene_000", HW, HW, P)
  want = RenderEngine(device="cpu").render_one(
      tserve.bake_scene("scene_000", rgba, depths, k, device="cpu"),
      POSES[3])
  assert np.array_equal(seen["frame"], want)


def test_tiled_sharded_service_equals_the_unsharded_one():
  rgba, depths, _ = tserve.synthetic_tiled_scene("t", HW, HW, P, regions=2)
  # Narrow FOV (fx = 2w): a +-0.35 rad pan views one tile column of 2 x 2.
  k = np.array([[2.0 * HW, 0, HW / 2], [0, 2.0 * HW, HW / 2], [0, 0, 1]],
               np.float32)
  kw = dict(max_batch=4, max_wait_ms=1.0, tile=8, method="pallas")
  mesh_svc = RenderService(use_mesh=True, devices=CPU8[:4], **kw)
  flat = RenderService(device="cpu", **kw)
  try:
    for svc in (mesh_svc, flat):
      svc.add_scene("t", rgba, depths, k)
    assert mesh_svc.engine.describe()["sharded"] is True
    poses = [_pose(i) for i in range(3)]
    for ry in (0.35, -0.35):  # views that cull tiles
      pose = np.eye(4, dtype=np.float32)
      c, s = np.cos(ry), np.sin(ry)
      pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
      poses.append(pose)
    futs = [mesh_svc.render_async("t", p) for p in poses]
    for pose, fut in zip(poses, futs):
      assert np.array_equal(fut.result(120), flat.render("t", pose))
    assert mesh_svc.stats()["tiles"]["culled_total"] > 0
  finally:
    mesh_svc.close()
    flat.close()


def test_replicas_follow_the_bake_through_a_swap():
  """On two distinct mesh devices the second renders from a replica held
  by the bake it copies; ``swap_scenes`` makes a new bake, which gets its
  own replica, and every frame after the swap is the new scene's."""
  svc = RenderService(max_batch=2, max_wait_ms=1.0, use_mesh=True,
                      devices=["cpu", "cpu:0"])
  try:
    old = synthetic_scene("s", HW, HW, P, seed=1)
    new = synthetic_scene("s", HW, HW, P, seed=2)
    svc.add_scene("s", *old)
    futs = [svc.render_async("s", p) for p in POSES[:2]]
    before = [f.result(60) for f in futs]
    baked = svc.cache.get("s")
    assert list(baked.replicas) == [torch.device("cpu", 0)]
    svc.swap_scenes({"s": new})
    futs = [svc.render_async("s", p) for p in POSES[:2]]
    after = [f.result(60) for f in futs]
    rebaked = svc.cache.get("s")
    assert rebaked is not baked
    assert list(rebaked.replicas) == [torch.device("cpu", 0)]
    assert rebaked.replicas[torch.device("cpu", 0)][0] is not \
        baked.replicas[torch.device("cpu", 0)][0]
    engine = RenderEngine(device="cpu")
    for pose, b, a in zip(POSES, before, after):
      assert np.array_equal(b, engine.render_one(
          tserve.bake_scene("s", *old, device="cpu"), pose))
      assert np.array_equal(a, engine.render_one(
          tserve.bake_scene("s", *new, device="cpu"), pose))
  finally:
    svc.close()
