"""The port's viewer export (``viewer/export.py``) against the JAX
package's: the same layers give byte-identical PNGs and HTML, the same PNG
stack loads to the same array, and ``export-viewer`` reports the same
summary. Nothing here is approximate: the module is host code copied
across."""

import os

import numpy as np
import pytest

from mpi_vision_tpu import cli as jcli
from mpi_vision_tpu.viewer import export as jexport
from mpi_vision_tpu_torch import cli as tcli
from mpi_vision_tpu_torch.viewer import export as texport

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "scene_009")


def _random_mpi():
  rng = np.random.default_rng(9)
  rgba = rng.uniform(-1, 1, (24, 40, 5, 4)).astype(np.float32)
  rgba[..., 3] = rng.uniform(0, 1, (24, 40, 5))
  return rgba


def test_load_fixture_mpi_equals_jax():
  got = texport.load_fixture_mpi(FIXTURE)
  want = jexport.load_fixture_mpi(FIXTURE)
  assert got.shape == (400, 640, 10, 4) and got.dtype == np.float32
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(texport.load_fixture_mpi(FIXTURE, count=3),
                                want[:, :, :3])


@pytest.mark.parametrize("source", ["scene_009", "random"])
def test_export_viewer_html_byte_identical_to_jax(source, tmp_path):
  mpi = (jexport.load_fixture_mpi(FIXTURE) if source == "scene_009"
         else _random_mpi())
  kw = {"near": 1.5, "far": 80.0, "fov_deg": 50.0}
  got = texport.export_viewer_html(mpi, str(tmp_path / "port.html"), **kw)
  want = jexport.export_viewer_html(mpi, str(tmp_path / "jax.html"), **kw)
  assert got == str(tmp_path / "port.html")
  got_bytes = open(got, "rb").read()
  assert got_bytes == open(want, "rb").read()
  assert got_bytes.count(b"data:image/png;base64,") == mpi.shape[2]


def test_layer_png_round_trip(tmp_path):
  mpi = _random_mpi()
  paths = texport.save_layer_pngs(mpi, str(tmp_path), prefix="rgba_")
  assert [os.path.basename(p) for p in paths] == [
      f"rgba_{i:02d}.png" for i in range(mpi.shape[2])]
  for i, path in enumerate(paths):
    assert open(path, "rb").read() == jexport.layer_to_png_bytes(mpi[:, :, i])
  back = texport.load_fixture_mpi(str(tmp_path))
  # 8-bit quantization: rgb in [-1, 1] steps 2/255, alpha 1/255.
  np.testing.assert_allclose(back[..., :3], mpi[..., :3], atol=1 / 255 + 1e-6)
  np.testing.assert_allclose(back[..., 3], mpi[..., 3], atol=0.5 / 255 + 1e-6)
  assert texport.to_data_uri(b"\x89PNG") == jexport.to_data_uri(b"\x89PNG")


def test_export_viewer_cli_summary_equals_jax(tmp_path):
  argv = ["export-viewer", "--mpi-dir", FIXTURE, "--near", "2",
          "--far", "50", "--fov", "45"]
  got = tcli.main(argv + ["--out", str(tmp_path / "port.html")])
  assert got == 0
  port = tcli.cmd_export_viewer(tcli.build_parser().parse_args(
      argv + ["--out", str(tmp_path / "port.html")]))
  jax_ = jcli.cmd_export_viewer(jcli.build_parser().parse_args(
      argv + ["--out", str(tmp_path / "jax.html")]))
  assert {k: v for k, v in port.items() if k != "out"} == \
      {k: v for k, v in jax_.items() if k != "out"}
  assert port == {"command": "export-viewer", "layers": 10,
                  "size": [400, 640], "out": str(tmp_path / "port.html")}
  assert (tmp_path / "port.html").read_bytes() == \
      (tmp_path / "jax.html").read_bytes()
