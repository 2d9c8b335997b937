"""The port's ``serve --mpi-dir`` / ``serve --ckpt`` command line, on the
CPU: the JAX CLI's guards, the ``--mpi-dir`` scene (id, intrinsics,
depths) equal to what the JAX CLI builds, and a live-reloading
``serve --ckpt --reload-ckpt-s`` process stopped by SIGTERM with its
watcher stopped first."""

import json
import os
import signal
import threading
import time
import urllib.request

import numpy as np
import pytest

from mpi_vision_tpu.core.camera import intrinsics_matrix as jintrinsics
from mpi_vision_tpu.core.camera import inv_depths as jinv_depths
from mpi_vision_tpu.viewer import export as jexport
from mpi_vision_tpu_torch import cli
from mpi_vision_tpu_torch.ckpt import CheckpointStore

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "scene_009")
P, HW = 4, 32


def _serve_args(*extra):
  return cli.build_parser().parse_args(
      ["serve", "--device", "cpu", "--port", "0", "--no-warmup", *extra])


@pytest.mark.parametrize("flags, message", [
    (["--ckpt-scenes", "2"], "--ckpt-scenes require(s) --ckpt"),
    (["--ckpt-dataset", "d"], "--ckpt-dataset require(s) --ckpt"),
    (["--reload-ckpt-s", "1"], "--reload-ckpt-s require(s) --ckpt"),
    (["--ckpt", "d", "--ckpt-scenes", "0"], "--ckpt-scenes must be >= 1"),
])
def test_serve_ckpt_flag_guards(flags, message):
  with pytest.raises(SystemExit, match=message.replace("(", r"\(")
                     .replace(")", r"\)")):
    cli.cmd_serve(_serve_args(*flags))


def test_serve_missing_ckpt_fails_fast_without_creating_it(tmp_path):
  missing = tmp_path / "typo"
  with pytest.raises(SystemExit, match="checkpoint directory does not exist"):
    cli.cmd_serve(_serve_args("--ckpt", str(missing), "--duration", "0.1"))
  assert not missing.exists()


@pytest.mark.parametrize("near, far, fov", [(1.0, 100.0, 60.0),
                                            (2.0, 40.0, 35.0)])
def test_mpi_dir_scene_equals_the_jax_cli(near, far, fov):
  """What ``mpi_vision_tpu/cli.py`` ``cmd_serve`` registers for
  ``--mpi-dir`` (its lines after the service is built)."""
  sid, rgba, depths, k = cli.mpi_dir_scene(FIXTURE + os.sep, "rgba_", near,
                                           far, fov)
  mpi = jexport.load_fixture_mpi(FIXTURE, prefix="rgba_")
  h, w, p = mpi.shape[:3]
  fx = 0.5 * w / np.tan(np.radians(fov) / 2.0)
  want_k = np.asarray(jintrinsics(fx, fx, w / 2.0, h / 2.0), np.float32)
  assert sid == "scene_009"
  np.testing.assert_array_equal(rgba, mpi)
  np.testing.assert_allclose(k, want_k, rtol=1e-7, atol=0)
  np.testing.assert_allclose(depths, np.asarray(jinv_depths(near, far, p)),
                             rtol=1e-6, atol=0)
  assert depths.dtype == np.float32 and k.dtype == np.float32


def _post(port, scene_id, pose):
  body = json.dumps({"scene_id": scene_id, "pose": pose.tolist()}).encode()
  req = urllib.request.Request(
      f"http://127.0.0.1:{port}/render", data=body,
      headers={"Accept": "application/octet-stream"})
  with urllib.request.urlopen(req, timeout=60) as resp:
    shape = tuple(int(x) for x in resp.headers["X-Image-Shape"].split(","))
    return np.frombuffer(resp.read(), "<f4").reshape(shape)


def test_serve_mpi_dir_and_live_reloading_ckpt_until_sigterm(tmp_path):
  if threading.current_thread() is not threading.main_thread():
    raise RuntimeError("signal handlers need the main thread")
  root = tmp_path / "run"
  cli.cmd_train(cli.build_parser().parse_args([
      "train", "--synthetic", "--synthetic-scenes", "2", "--img-size",
      str(HW), "--num-planes", str(P), "--epochs", "1", "--no-valid",
      "--no-vgg-loss", "--device", "cpu", "--dataset", str(root / "data"),
      "--ckpt", str(root / "ckpt")]))
  port_file = tmp_path / "port"
  pose = np.eye(4, dtype=np.float32)
  pose[0, 3] = 0.03
  seen: dict = {}

  def client():
    try:
      deadline = time.monotonic() + 60
      while not port_file.exists() and time.monotonic() < deadline:
        time.sleep(0.02)
      port = int(port_file.read_text())
      seen["before"] = _post(port, "ckpt_000", pose)
      seen["mpi"] = _post(port, "scene_009", pose)
      # Publish step 3: the step-2 weights, one of them changed.
      store = CheckpointStore(str(root / "ckpt"))
      old = store.restore()
      arrays = dict(old.arrays)
      key = "['model']['cnv8_1.conv.bias']"
      arrays[key] = arrays[key] + np.float32(0.5)
      store.save_arrays(3, arrays, meta=old.meta)
      while time.monotonic() < deadline:
        frame = _post(port, "ckpt_000", pose)
        if not np.array_equal(frame, seen["before"]):
          seen["after"] = frame
          break
        time.sleep(0.05)
      seen["watchers"] = [t.name for t in threading.enumerate()
                          if t.name == "mpi-ckpt-watch"]
    finally:
      # Only ever at the serve CLI's own handler (never the default,
      # which would end the test process).
      if getattr(signal.getsignal(signal.SIGTERM), "__name__",
                 "") == "_on_signal":
        os.kill(os.getpid(), signal.SIGTERM)

  handler = signal.getsignal(signal.SIGTERM)
  helper = threading.Thread(target=client, daemon=True)
  helper.start()
  summary = cli.cmd_serve(_serve_args(
      "--mpi-dir", FIXTURE, "--ckpt", str(root / "ckpt"),
      "--ckpt-dataset", str(root / "data"), "--reload-ckpt-s", "0.05",
      "--port-file", str(port_file), "--duration", "90"))
  helper.join(30)
  assert not helper.is_alive()
  assert summary["scenes"] == 3          # scene_009 + 2 from the ckpt
  assert summary["ckpt_reload"]["reloads"] == 1
  assert summary["ckpt_reload"]["seen_step"] == 3
  assert summary["errors"] == {"transient": 0, "permanent": 0,
                               "deadline": 0}
  assert seen["mpi"].shape == (400, 640, 3)
  assert np.isfinite(seen["after"]).all()
  assert seen["watchers"] == ["mpi-ckpt-watch"]
  assert not any(t.name == "mpi-ckpt-watch" for t in threading.enumerate())
  assert signal.getsignal(signal.SIGTERM) is handler   # restored


def test_train_export_html_is_the_viewer_of_the_trained_model(tmp_path):
  """``train --export-html`` writes the viewer of valid[0]'s MPI as the
  trained network predicts it: the same bytes as ``export_viewer_html``
  of the forward pass of the params the run's last checkpoint holds."""
  import torch

  from mpi_vision_tpu_torch import config as tconfig
  from mpi_vision_tpu_torch.ckpt.export import restore_params
  from mpi_vision_tpu_torch.models.stereo_mag import mpi_from_net_output
  from mpi_vision_tpu_torch.viewer import export as texport

  data, ckpt = tmp_path / "data", tmp_path / "ckpt"
  html = tmp_path / "viewer.html"
  summary = cli.cmd_train(cli.build_parser().parse_args([
      "train", "--synthetic", "--synthetic-scenes", "2", "--img-size",
      str(HW), "--num-planes", str(P), "--epochs", "1", "--no-valid",
      "--no-vgg-loss", "--device", "cpu", "--dataset", str(data),
      "--ckpt", str(ckpt), "--export-html", str(html)]))
  model, meta, step = restore_params(str(ckpt), device="cpu")
  assert step == summary["steps"] >= 1
  dcfg = tconfig.DataConfig(dataset_path=str(data), img_size=HW,
                            num_planes=P)
  example = dcfg.make_dataset(is_valid=True, device="cpu")[0]
  with torch.no_grad():
    rgba = mpi_from_net_output(model(example["net_input"][None]),
                               example["ref_img"][None])[0].numpy()
  want = texport.export_viewer_html(rgba, str(tmp_path / "want.html"),
                                    near=dcfg.depth_near, far=dcfg.depth_far)
  got = html.read_bytes()
  assert got.count(b"data:image/png;base64,") == P
  assert got == open(want, "rb").read()


def test_train_export_html_refuses_an_empty_test_split_before_training(
    tmp_path):
  root = tmp_path / "data"
  (root / "RealEstate10K" / "test").mkdir(parents=True)
  with pytest.raises(SystemExit, match="needs a non-empty test split"):
    cli.cmd_train(cli.build_parser().parse_args([
        "train", "--dataset", str(root), "--device", "cpu",
        "--export-html", str(tmp_path / "v.html")]))
  assert not (tmp_path / "v.html").exists()
