"""The port's brownout ladder against the JAX package's.

``serve/brownout.py`` is a copy of the JAX module: on a scripted burn and
queue trace under a fake clock, the level sequence, the sheds by class
and the hysteresis equal JAX's ``BrownoutController``. The service cases
port ``tests/serve/test_brownout.py``'s: L0 frames bit-identical to a
service without brownout (``test_brownout.py:270``), degraded frames
labelled, full-shape, never cached at the edge and never counted bad by
the SLO. The port renders brownout through ``method="pallas"`` (the warp,
then the compose kernel; the fused kernel takes no target override): its
L1 and L2 frames are held within 1e-4 of the JAX service's
(``method="fused"``), untiled and tiled (``tests/test_torch_tiles.py``'s
bound: JAX's crop-corrected intrinsics round a tap differently). Then the
``serve`` CLI's new flags.
"""

import json
import math
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mpi_vision_tpu.obs import SloConfig as JSloConfig
from mpi_vision_tpu.serve import RenderService as JRenderService
from mpi_vision_tpu.serve import brownout as jbrownout
from mpi_vision_tpu_torch import cli
from mpi_vision_tpu_torch.core import render as trender
from mpi_vision_tpu_torch.serve import RenderService, make_http_server
from mpi_vision_tpu_torch.serve import brownout as tbrownout
from mpi_vision_tpu_torch.serve import tiles as ttiles
from mpi_vision_tpu_torch.serve.edge import EdgeConfig
from mpi_vision_tpu_torch.serve.engine import upsample_nearest
from mpi_vision_tpu_torch.serve.server import synthetic_tiled_scene

H = W = 16
P = 4


class _Clock:

  def __init__(self, t=100.0):
    self.t = t

  def __call__(self):
    return self.t


def _pose(tx=0.0):
  pose = np.eye(4, dtype=np.float32)
  pose[0, 3] = tx
  return pose


def _pan(theta):
  c, s = math.cos(theta), math.sin(theta)
  pose = np.eye(4, dtype=np.float32)
  pose[0, 0], pose[0, 2], pose[2, 0], pose[2, 2] = c, s, -s, c
  return pose


def test_key_helpers_and_config_equal_jax():
  assert tbrownout.REQUEST_CLASSES == jbrownout.REQUEST_CLASSES
  for cls in (None, "Background ", "prefetch", "bogus", "interactive"):
    assert tbrownout.normalize_class(cls) == jbrownout.normalize_class(cls)
    assert tbrownout.shed_level(cls) == jbrownout.shed_level(cls)
  key = "s" + ttiles.KEY_SEP + "tok"
  assert tbrownout.half_res_key(key) == jbrownout.half_res_key(key)
  assert (tbrownout.split_degrade_key(tbrownout.half_res_key(key))
          == jbrownout.split_degrade_key(jbrownout.half_res_key(key))
          == (key, True))
  for bad in (dict(recover_burn=3.0), dict(recover_queue=0.6),
              dict(plane_keep=0.0), dict(l3_warp_scale=0.5),
              dict(max_level=5), dict(step_dwell_s=-1.0)):
    for mod in (tbrownout, jbrownout):
      with pytest.raises(ValueError):
        mod.BrownoutConfig(**bad)


def _ladder_trace(mod, seed):
  rng = np.random.default_rng(seed)
  clock = _Clock()
  sig = {"burn": 0.0, "queue": 0.0}
  moves = []
  ctl = mod.BrownoutController(
      mod.BrownoutConfig(step_dwell_s=2.0, recover_dwell_s=5.0,
                         eval_interval_s=0.25, max_level=4),
      burn_fn=lambda: sig["burn"], queue_fn=lambda: sig["queue"],
      on_transition=lambda *t: moves.append(t), clock=clock)
  trail = []
  for step in range(400):
    clock.t += float(rng.choice([0.1, 0.5, 1.0]))
    phase = (step // 60) % 5  # calm, burn, band, queue, recovery
    sig["burn"] = float({0: 0.2, 1: 9.0, 2: 1.5, 3: 0.5, 4: 0.1}[phase]
                        + rng.uniform(0, 0.3))
    sig["queue"] = float({3: 0.8}.get(phase, 0.05))
    cls = rng.choice(["interactive", "prefetch", "background", None])
    try:
      trail.append(("admit", ctl.admit(cls)))
    except mod.BrownoutShedError as e:
      trail.append(("shed", e.request_class, e.level, e.retry_after_s,
                    str(e)))
  snap = ctl.snapshot()
  ctl.reset_counters()
  return trail, moves, snap, ctl.snapshot()


@pytest.mark.parametrize("seed", [0, 3])
def test_ladder_trace_equals_jax(seed):
  ours, theirs = _ladder_trace(tbrownout, seed), _ladder_trace(jbrownout,
                                                               seed)
  assert ours == theirs
  levels = {t[1] for t in ours[0] if t[0] == "admit"}
  assert levels == {0, 1, 2, 3}  # interactive sheds only at 4
  shed_classes = {t[1] for t in ours[0] if t[0] == "shed"}
  assert shed_classes == {"interactive", "prefetch", "background"}
  assert {m[2] for m in ours[1]} == {"overload", "recover"}


def _arm(svc, level, mod=tbrownout):
  """Pin the service's ladder at ``level``: climb on a saturated burn,
  then hold in the hysteresis band."""
  sig = {"burn": 10.0}
  ctl = mod.BrownoutController(
      mod.BrownoutConfig(step_dwell_s=0.0, recover_dwell_s=3600.0,
                         eval_interval_s=0.0),
      burn_fn=lambda: sig["burn"], queue_fn=lambda: 0.0)
  for _ in range(level):
    ctl.tick()
  sig["burn"] = 1.5
  assert ctl.level == level
  svc.brownout = ctl
  return ctl


@pytest.fixture(scope="module")
def svc_bo():
  svc = RenderService(device="cpu", max_batch=2, max_wait_ms=1.0,
                      brownout=tbrownout.BrownoutConfig())
  svc.add_synthetic_scenes(1, height=H, width=W, planes=P)
  yield svc
  svc.close()


def test_brownout_needs_slo_and_a_target_taking_method():
  with pytest.raises(ValueError, match="requires SLO"):
    RenderService(device="cpu", slo=None,
                  brownout=tbrownout.BrownoutConfig())
  with pytest.raises(ValueError, match="fused_pallas"):
    RenderService(device="cpu", method="fused_pallas",
                  brownout=tbrownout.BrownoutConfig())


def test_l0_bit_identical_to_a_service_without_brownout(svc_bo):
  assert svc_bo.engine.method == "pallas"
  plain = RenderService(device="cpu", max_batch=2, max_wait_ms=1.0,
                        method="pallas")
  try:
    plain.add_synthetic_scenes(1, height=H, width=W, planes=P)
    _arm(svc_bo, 0)
    pose = _pose(0.01)
    img, info = svc_bo.render_request("scene_000", pose,
                                      request_class="interactive")
    assert info["level"] == 0 and info["degraded"] is False
    np.testing.assert_array_equal(img, plain.render("scene_000", pose))
  finally:
    plain.close()


def _jax_service(tile=None):
  return JRenderService(max_batch=2, max_wait_ms=1.0, use_mesh=False,
                        method="fused", tile=tile, slo=JSloConfig(),
                        brownout=jbrownout.BrownoutConfig())


def test_degraded_frames_agree_with_jax_untiled(svc_bo):
  jax_svc = _jax_service()
  try:
    jax_svc.add_synthetic_scenes(1, height=H, width=W, planes=P)
    pose = _pose(0.02)
    for level in (0, 1, 2):
      _arm(svc_bo, level)
      _arm(jax_svc, level, jbrownout)
      got, info = svc_bo.render_request("scene_000", pose)
      want, jinfo = jax_svc.render_request("scene_000", pose)
      assert (info["level"], info["degraded"]) == (jinfo["level"],
                                                   jinfo["degraded"])
      assert got.shape == (H, W, 3)
      np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # L2 is a half-resolution render, upsampled: a direct render of the
    # halved target, then upsample_nearest.
    scene = svc_bo._get_scene("scene_000")
    k = scene.intrinsics * torch.tensor([[0.5], [0.5], [1.0]])
    direct = trender.render_views(
        scene.rgba_layers, torch.from_numpy(pose[None]), scene.depths,
        scene.intrinsics, method="pallas", tgt_intrinsics=k,
        out_hw=(H // 2, W // 2))[0].numpy()
    _arm(svc_bo, 2)
    got, _ = svc_bo.render_request("scene_000", pose)
    np.testing.assert_array_equal(got, upsample_nearest(direct, (H, W)))
    assert svc_bo.metrics.snapshot()["brownout"]["degraded"]["2"] >= 2
  finally:
    jax_svc.close()


def test_degraded_frames_agree_with_jax_tiled():
  layers, depths, _ = synthetic_tiled_scene("s", height=H, width=W,
                                            planes=8, regions=2, seed=3)
  k = np.asarray([[2.0 * W, 0, W / 2.0], [0, 2.0 * W, H / 2.0], [0, 0, 1]],
                 np.float32)
  port = RenderService(device="cpu", tile=8, max_batch=2, max_wait_ms=1.0,
                       brownout=tbrownout.BrownoutConfig())
  jax_svc = _jax_service(tile=8)
  try:
    for s in (port, jax_svc):
      s.add_scene("s", layers, depths, k)
    for level in (0, 1, 2):
      _arm(port, level)
      _arm(jax_svc, level, jbrownout)
      for pose in (np.eye(4, dtype=np.float32), _pan(-0.35)):
        got, info = port.render_request("s", pose)
        want, jinfo = jax_svc.render_request("s", pose)
        assert info["degraded"] == jinfo["degraded"] == (level > 0)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    full = port.tile_meta("s").plan(np.eye(4, dtype=np.float32)[None],
                                    port.engine.convention).planes
    thinned = ttiles.thin_planes(full, port.brownout.config.plane_keep)
    assert len(thinned) < len(full)
    # L1 and L2 full-coverage requests composited the thinned set.
    assert port.stats()["tiles"]["planes_hist"][str(len(thinned))] >= 2
  finally:
    port.close()
    jax_svc.close()


def test_degrade_batch_keys_never_coalesce(svc_bo):
  pose = _pose()
  k0, _ = svc_bo._tile_batch_key("scene_000", pose, degrade=0)
  k2, _ = svc_bo._tile_batch_key("scene_000", pose, degrade=2)
  assert k0 != k2
  assert tbrownout.split_degrade_key(k2) == (k0, True)


def test_shed_counts_in_brownout_families_never_slo_bad(svc_bo):
  _arm(svc_bo, 4)
  bad_before = svc_bo.slo.snapshot()[
      "objectives"]["availability"]["slow"]["bad"]
  sheds_before = svc_bo.metrics.snapshot()["brownout"]["sheds"]
  with pytest.raises(tbrownout.BrownoutShedError) as err:
    svc_bo.render_request("scene_000", _pose(), request_class="prefetch")
  assert err.value.level == 4 and err.value.retry_after_s > 0
  snap = svc_bo.metrics.snapshot()["brownout"]["sheds"]
  assert snap["prefetch"] == sheds_before["prefetch"] + 1
  assert svc_bo.slo.snapshot()[
      "objectives"]["availability"]["slow"]["bad"] == bad_before
  _arm(svc_bo, 2)
  good_before = svc_bo.slo.snapshot()["objectives"]["availability"]["slow"]
  svc_bo.render_request("scene_000", _pose())  # degraded, served
  good = svc_bo.slo.snapshot()["objectives"]["availability"]["slow"]
  assert good["bad"] == good_before["bad"]
  assert good["requests"] == good_before["requests"] + 1


def test_stats_overlay_and_transition_events(svc_bo):
  _arm(svc_bo, 3)
  block = svc_bo.stats()["brownout"]
  assert block["enabled"] is True and block["level"] == 3
  assert "sheds" in block and "signals" in block
  clock = _Clock()
  sig = {"burn": 10.0}
  svc_bo.brownout = tbrownout.BrownoutController(
      tbrownout.BrownoutConfig(eval_interval_s=0.0, step_dwell_s=0.0),
      burn_fn=lambda: sig["burn"], queue_fn=lambda: 0.0,
      on_transition=svc_bo._on_brownout_transition, clock=clock)
  svc_bo.brownout.tick()
  event = svc_bo.events.snapshot(kind="brownout_level")["events"][-1]
  assert (event["old"], event["new"], event["reason"]) == (0, 1, "overload")


def test_request_class_and_level_ride_to_the_trace(svc_bo):
  from mpi_vision_tpu_torch.obs.trace import Tracer

  _arm(svc_bo, 1)
  tracer = Tracer()
  svc_bo.render_request("scene_000", _pose(0.03), request_class="prefetch",
                        trace=tracer.start_trace("render"))
  spans = tracer.snapshot()["recent"][-1]["spans"]
  admit = [s for s in spans if s["name"] == "admit"]
  assert admit and admit[0]["attrs"] == {"request_class": "prefetch",
                                         "level": 1}


def _post(base, request_class=None, tx=0.0):
  body = json.dumps({"scene_id": "scene_000",
                     "pose": _pose(tx).tolist()}).encode()
  headers = {"Content-Type": "application/json"}
  if request_class is not None:
    headers[tbrownout.REQUEST_CLASS_HEADER] = request_class
  req = urllib.request.Request(base + "/render", data=body, headers=headers)
  try:
    with urllib.request.urlopen(req, timeout=60) as resp:
      return resp.status, dict(resp.headers.items())
  except urllib.error.HTTPError as e:
    with e:
      return e.code, dict(e.headers.items())


def test_http_headers_degraded_shed_and_l0(svc_bo):
  httpd = make_http_server(svc_bo, port=0)
  threading.Thread(target=httpd.serve_forever, daemon=True).start()
  base = f"http://127.0.0.1:{httpd.server_address[1]}"
  try:
    _arm(svc_bo, 2)
    status, headers = _post(base, request_class="interactive")
    assert status == 200
    assert headers[tbrownout.LEVEL_HEADER] == "2"
    assert headers[tbrownout.DEGRADED_HEADER] == "1"
    assert headers["Cache-Control"] == "no-store"
    assert "ETag" not in headers
    status, headers = _post(base, request_class="background")
    assert status == 503
    assert float(headers["Retry-After"]) > 0
    assert headers[tbrownout.LEVEL_HEADER] == "2"
    _arm(svc_bo, 4)
    status, headers = _post(base, request_class="interactive")
    assert status == 503 and headers["Retry-After"] == "1"
    _arm(svc_bo, 0)
    status, headers = _post(base, request_class="interactive")
    assert status == 200
    assert headers[tbrownout.LEVEL_HEADER] == "0"
    assert tbrownout.DEGRADED_HEADER not in headers
  finally:
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture
def svc_edge():
  svc = RenderService(
      device="cpu", max_batch=2, max_wait_ms=1.0,
      edge=EdgeConfig(trans_cell=0.01, rot_bucket_deg=90.0,
                      warp_max_trans=0.02, warp_max_rot_deg=45.0),
      brownout=tbrownout.BrownoutConfig())
  svc.add_synthetic_scenes(1, height=H, width=W, planes=P)
  yield svc
  svc.close()


def test_degraded_frames_never_enter_the_edge_cache(svc_edge):
  _arm(svc_edge, 2)
  img, info = svc_edge.render_request("scene_000", _pose())
  assert info["edge"] == "miss" and info["degraded"] is True
  assert info["etag"] is None
  assert svc_edge.edge.stats()["frames"] == 0
  _arm(svc_edge, 0)
  img0, info0 = svc_edge.render_request("scene_000", _pose())
  assert info0["edge"] == "miss" and info0["etag"]
  assert svc_edge.edge.stats()["frames"] == 1
  img1, info1 = svc_edge.render_request("scene_000", _pose())
  assert info1["edge"] == "hit" and info1["degraded"] is False
  assert info1["etag"] == info0["etag"]
  np.testing.assert_array_equal(img1, img0)


def test_l3_widens_warp_tolerance_and_labels_the_serve(svc_edge):
  _arm(svc_edge, 0)
  _, info0 = svc_edge.render_request("scene_000", _pose())
  assert info0["edge"] == "miss" and info0["etag"]
  _arm(svc_edge, 3)
  _, info = svc_edge.render_request("scene_000", _pose(0.04),
                                    request_class="interactive")
  assert info["edge"] == "warp" and info["degraded"] is True
  assert info["etag"] is None
  assert svc_edge.metrics.snapshot()["brownout"]["degraded"]["3"] >= 1
  _arm(svc_edge, 0)
  _, info_l0 = svc_edge.render_request("scene_000", _pose(0.04))
  assert info_l0["edge"] == "miss" and info_l0["degraded"] is False


def test_cli_serve_flags_parse_and_guard():
  ap = cli.build_parser()
  args = ap.parse_args([
      "serve", "--cpu-fallback", "on", "--prebake-fallback", "2",
      "--event-log", "e.jsonl", "--event-log-max-bytes", "4096",
      "--event-log-keep", "2", "--edge-cache", "--edge-cache-mb", "8",
      "--edge-trans-cell", "0.1", "--edge-negative-ttl-s", "1.5",
      "--slo-availability", "0.999", "--slo-fast-window-s", "5",
      "--brownout", "--brownout-plane-keep", "0.25",
      "--brownout-max-level", "3", "--profile-dir", "p",
      "--profile-hook", "echo"])
  assert (args.cpu_fallback, args.prebake_fallback) == ("on", 2)
  # The CPU route is opt-in: by default work never leaves the card.
  assert ap.parse_args(["serve"]).cpu_fallback == "off"
  assert args.edge_cache and args.edge_trans_cell == 0.1
  assert args.brownout and args.brownout_max_level == 3
  assert args.slo and not args.method_given
  kw = cli._degraded_mode_kwargs(args)
  assert kw["edge"].byte_budget == 8 << 20
  assert kw["edge"].negative_ttl_s == 1.5
  assert kw["brownout"].plane_keep == 0.25
  assert kw["slo"].availability_target == 0.999
  assert kw["profile_dir"] == "p" and callable(kw["profile_hook"])
  kw["events"].sink.close()
  os.remove("e.jsonl")
  for argv, msg in (
      (["--edge-trans-cell", "0.1"], "require.*--edge-cache"),
      (["--brownout-plane-keep", "0.3"], "require.*--brownout"),
      (["--profile-hook", "x"], "require.*--profile-dir"),
      (["--event-log-max-bytes", "9"], "require.*--event-log"),
      (["--brownout", "--no-slo"], "requires SLO"),
      (["--brownout", "--brownout-recover-burn", "5"], "bad brownout"),
      (["--brownout", "--method", "fused_pallas"], "fused_pallas"),
      (["--cpu-fallback", "sometimes"], None)):
    with pytest.raises(SystemExit, match=msg):
      cli.main(["serve", "--device", "cpu", "--port", "0", "--scenes", "0",
                *argv])


def test_cli_serve_brownout_picks_pallas_on_cpu(tmp_path, capsys):
  port_file = str(tmp_path / "port")
  events = str(tmp_path / "events.jsonl")
  out = {}

  def run():
    out["rc"] = cli.main(["serve", "--brownout", "--edge-cache", "--device",
                          "cpu", "--port", "0", "--port-file", port_file,
                          "--duration", "3", "--scenes", "1", "--img-size",
                          "16", "--num-planes", "4", "--event-log", events])

  thread = threading.Thread(target=run)
  thread.start()
  deadline = time.monotonic() + 60
  while not os.path.exists(port_file) and time.monotonic() < deadline:
    time.sleep(0.02)
  port = int(open(port_file).read())
  base = f"http://127.0.0.1:{port}"
  status, headers = _post(base)
  assert status == 200 and headers[tbrownout.LEVEL_HEADER] == "0"
  assert headers["X-Edge-Cache"] == "miss" and headers["ETag"]
  thread.join(60)
  assert out["rc"] == 0
  summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert summary["method"] == "pallas"
  assert summary["brownout"]["enabled"] is True
  assert summary["edge"]["misses"] == 1 and summary["fallback_renders"] == 0
  lines = [json.loads(l) for l in open(events)]
  assert [l["kind"] for l in lines] == ["edge_cache_enabled"]
