"""Row bands on the CPU: the band planner, the plain version's row range,
the forward-only banded render and readback, and the ``readback_hidden``
counter from the engine's timings to ``/metrics``.

On a card the serving engine renders a large ``fused_pallas`` flight in
row bands and reads each band back while the next renders
(``serve/engine.py``, ``kernels/render_fused.render_bands``);
``tests/test_torch_bands_cuda.py`` holds those frames to the whole-frame
ones there. Here the same rows come from the
kernel's plain version, which must equal the whole frame's rows to the bit.
"""

import numpy as np
import pytest
import torch

from mpi_vision_tpu_torch.core import render
from mpi_vision_tpu_torch.core.sampling import Convention
from mpi_vision_tpu_torch.kernels import render_fused as rf
from mpi_vision_tpu_torch.obs import attrib, prom
from mpi_vision_tpu_torch.serve import RenderService
from mpi_vision_tpu_torch.serve.engine import (BAND_BYTES, MAX_BANDS,
                                               RenderEngine, row_bands,
                                               split_rows)
from mpi_vision_tpu_torch.serve.metrics import ServeMetrics
from mpi_vision_tpu_torch.serve.scheduler import MicroBatcher
from mpi_vision_tpu_torch.serve.server import synthetic_scene


def _pose(tx=0.0, ry=0.0):
  pose = np.eye(4, dtype=np.float32)
  c, s = np.cos(ry), np.sin(ry)
  pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
  pose[0, 3] = tx
  return pose


def _scene(h, w, p, views, seed=0):
  layers, depths, k = synthetic_scene("bands", h, w, p, seed=seed)
  planes = torch.from_numpy(layers).permute(2, 0, 1, 3).contiguous()
  poses = torch.from_numpy(np.stack(
      [_pose(0.02 * i - 0.01, 0.05 * (i % 3 - 1)) for i in range(views)]))
  homs = render.views_homographies(poses, torch.from_numpy(depths),
                                   torch.from_numpy(k), h, w,
                                   Convention.EXACT)
  return layers, depths, k, planes, poses, homs


@pytest.mark.parametrize("height, bands", [
    (7, [(0, 3), (3, 5), (5, 7)]),       # 7 rows in 3 odd bands
    (7, [(0, 6), (6, 7)]),               # a 1-row band
    (7, [(3, 4)]),                       # one row alone
    (1080, split_rows(1080, 4)),         # 1080 in 4, as the engine bands
])
def test_plain_render_rows_equal_the_whole_frame_to_the_bit(height, bands):
  width = 5 if height < 1080 else 6
  *_, planes, _, homs = _scene(height, width, 3, 2)
  whole = rf.plain_render(planes, homs)
  for r0, r1 in bands:
    got = rf.plain_render(planes, homs, rows=(r0, r1))
    assert got.shape == (2, r1 - r0, width, 3)
    assert torch.equal(got, whole[:, r0:r1])


def test_render_bands_on_the_cpu_assembles_render_views():
  """Band by band from ``views_homographies``: the frames ``render_views``
  gives, to the bit, in the frames buffer and in the host buffer."""
  layers, depths, k, planes, poses, homs = _scene(37, 11, 4, 3, seed=2)
  frames = torch.full((3, 37, 11, 3), float("nan"))
  host = torch.full_like(frames, float("nan"))
  launches = rf.render_mpi_fused.launches
  rf.render_bands(planes, homs, frames, host, split_rows(37, 3))
  assert rf.render_mpi_fused.launches == launches  # the CPU launches none
  want = render.render_views(
      torch.from_numpy(layers), poses, torch.from_numpy(depths),
      torch.from_numpy(k), convention=Convention.EXACT,
      method="fused_pallas")
  assert torch.equal(host, want) and torch.equal(frames, want)


@pytest.mark.parametrize("bands", [
    [], [(0, 4)], [(0, 4), (5, 8)], [(0, 5), (4, 8)], [(4, 8), (0, 4)],
    [(0, 0), (0, 8)], [(0, 9)]])
def test_render_bands_refuses_bands_that_do_not_tile_the_rows(bands):
  *_, planes, _, homs = _scene(8, 4, 2, 1)
  out = torch.empty((1, 8, 4, 3))
  with pytest.raises(ValueError, match="tile the rows"):
    rf.render_bands(planes, homs, out, out.clone(), bands)


def test_render_bands_refuses_buffers_it_cannot_take():
  *_, planes, _, homs = _scene(8, 4, 2, 1)
  out = torch.empty((1, 8, 4, 3))
  with pytest.raises(ValueError, match="frames must be"):
    rf.render_bands(planes, homs, torch.empty((2, 8, 4, 3)), out, [(0, 8)])
  with pytest.raises(ValueError, match="host must be"):
    rf.render_bands(planes, homs, out, torch.empty((1, 4, 8, 3)), [(0, 8)])
  with pytest.raises(TypeError, match="float32"):
    rf.render_bands(planes, homs, out, out.double(), [(0, 8)])


@pytest.mark.parametrize("height, width", [
    (1080, 1920), (7, 5), (1, 1), (720, 1280), (540, 960), (2160, 3840),
    (1081, 1920), (16, 200000)])
def test_bands_tile_the_rows_once_in_order_on_8_row_edges(height, width):
  bands = row_bands(height, width, "fused_pallas")
  assert bands[0][0] == 0 and bands[-1][1] == height
  for (a0, a1), (b0, b1) in zip(bands, bands[1:]):
    assert a1 == b0
  assert all(r0 < r1 for r0, r1 in bands)
  assert all(r1 % 8 == 0 for _, r1 in bands[:-1])
  frame = height * width * 12
  assert len(bands) == max(1, min(MAX_BANDS, frame // BAND_BYTES,
                                  -(-height // 8)))


def test_band_count_follows_the_frame_and_the_method():
  assert row_bands(1080, 1920, "fused_pallas") == [
      (0, 264), (264, 536), (536, 808), (808, 1080)]
  assert row_bands(540, 960, "fused_pallas") == [(0, 272), (272, 540)]
  # Small frames, and every method but the fused kernel, take one band.
  assert row_bands(360, 640, "fused_pallas") == [(0, 360)]
  assert row_bands(48, 64, "fused_pallas") == [(0, 48)]
  for method in ("pallas", "fused", "scan", "assoc"):
    assert row_bands(1080, 1920, method) == [(0, 1080)]
  assert split_rows(7, 10) == [(0, 7)]  # never more bands than tiles


class _HidingEngine(RenderEngine):
  """A CPU engine whose flights report a readback partly under the
  render, as a banded flight on a card does."""

  def wait(self, handle):
    out = super().wait(handle)
    handle.timings["readback_hidden_s"] = 0.25e-3
    return out


def test_readback_hidden_reaches_metrics_and_attrib_still_reconciles():
  svc = RenderService(engine=_HidingEngine(device="cpu", use_mesh=False),
                      max_batch=4, max_wait_ms=50.0,
                      attrib=attrib.AttribConfig())
  try:
    svc.add_synthetic_scenes(1, height=16, width=24, planes=3)
    futs = [svc.render_async("scene_000", _pose(0.01 * i)) for i in range(6)]
    for f in futs:
      f.result(60)
    m = svc.metrics
    assert m.batches >= 2
    assert m.phase_seconds["readback_hidden"] == pytest.approx(
        0.25e-3 * m.batches)
    stats = svc.stats()
    assert stats["device_phase_seconds"]["readback_hidden"] == round(
        0.25e-3 * m.batches, 3)
    text = prom.render_serve_metrics(
        {**stats, "device_phase_seconds": dict(m.phase_seconds)})
    samples = prom.parse_metrics_text(text)[
        "mpi_serve_device_phase_seconds_total"]["samples"]
    assert samples[("mpi_serve_device_phase_seconds_total",
                    (("phase", "readback_hidden"),))] == pytest.approx(
                        0.25e-3 * m.batches)
    # The ledger splits the three phases only, and they still reconcile.
    assert set(attrib.PHASES) == {"h2d", "compute", "readback"}
    snap = m.attrib.snapshot(reference=m.attrib_reference())
    assert snap["conservation"]["ok"], snap["conservation"]
  finally:
    svc.close()


def test_metrics_accumulate_readback_hidden_per_flight():
  m = ServeMetrics()
  m.record_batch(4, 0.01, phases={"h2d_s": 1e-4, "compute_s": 2e-3,
                                  "readback_s": 3e-3,
                                  "readback_hidden_s": 1.5e-3})
  m.record_batch(2, 0.01, phases={"h2d_s": 1e-4, "compute_s": 1e-3,
                                  "readback_s": 2e-3})
  assert m.phase_seconds["readback_hidden"] == pytest.approx(1.5e-3)
  assert m.phase_seconds["readback"] == pytest.approx(5e-3)
  assert set(m.attrib_reference()["device_phase_seconds"]) == {
      "h2d", "compute", "readback"}


class _Recorder:
  def __init__(self):
    self.spans = {}

  def record(self, name, t0, t1, parent=None):
    self.spans[name] = (t0, t1)


@pytest.mark.parametrize("hidden", [0.0, 1.5])
def test_flight_recorder_anchors_readback_where_it_began(hidden):
  rec = _Recorder()
  MicroBatcher._record_phases(None, rec, None, 10.0, {
      "h2d_s": 0.5, "compute_s": 2.0, "readback_s": 3.0,
      "readback_hidden_s": hidden})
  assert rec.spans["h2d"] == (10.0, 10.5)
  assert rec.spans["compute"] == (10.5, 12.5)
  assert rec.spans["readback"] == (12.5 - hidden, 15.5 - hidden)
