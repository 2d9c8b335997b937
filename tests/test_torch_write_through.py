"""Write-through rendering on the CPU: ``render_to_host``'s plain path and
its refusals, the launch shape it stages, which flights the serving engine
writes through, the three phase timings ``wait`` stamps, and their way to
``/stats``, ``/metrics``, the attribution ledger and the flight recorder,
as in the JAX package.

On a card the serving engine renders a whole-scene ``fused_pallas`` flight
straight into the flight's pinned host buffer (``serve/engine.py``,
``kernels/render_fused.render_to_host``);
``tests/test_torch_write_through_cuda.py`` holds those frames to the
device-output launch and to ``plain_render`` there. Here the host buffer
gets ``plain_render``'s frames.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpi_vision_tpu.serve.scheduler import MicroBatcher as JMicroBatcher
from mpi_vision_tpu_torch.core import render
from mpi_vision_tpu_torch.core.sampling import Convention
from mpi_vision_tpu_torch.kernels import render_fused as rf
from mpi_vision_tpu_torch.obs import attrib, prom
from mpi_vision_tpu_torch.serve import RenderService
from mpi_vision_tpu_torch.serve.cache import bake_scene
from mpi_vision_tpu_torch.serve.engine import (InFlightBatch, RenderEngine,
                                               writes_through)
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
  layers, depths, k = synthetic_scene("wt", h, w, p, seed=seed)
  planes = torch.from_numpy(layers).permute(2, 0, 1, 3).contiguous()
  poses = torch.from_numpy(np.stack(
      [_pose(0.02 * i - 0.01, 0.05 * (i % 3 - 1)) for i in range(views)]))
  homs = render.views_homographies(poses, torch.from_numpy(depths),
                                   torch.from_numpy(k), h, w,
                                   Convention.EXACT)
  return layers, depths, k, planes, poses, homs


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("views", [1, 2, 3, 4, 5, 8])
def test_render_to_host_on_the_cpu_writes_plain_render(views, shared):
  """Every view count the kernel's chunks of 4 split unevenly, one scene
  shared by every view or one scene a view: the host buffer holds
  ``plain_render``'s frames to the bit, and nothing launched."""
  *_, planes, _, homs = _scene(37, 50, 3, views, seed=views)
  if not shared:
    planes = torch.stack([planes * (1.0 - 0.1 * i) for i in range(views)])
  host = torch.full((views, 37, 50, 3), float("nan"))
  launches = (rf.render_to_host.launches, rf.render_mpi_fused.launches)
  rf.render_to_host(planes, homs, host)
  assert (rf.render_to_host.launches,
          rf.render_mpi_fused.launches) == launches
  assert torch.equal(host, rf.plain_render(planes, homs))


def test_render_to_host_on_the_cpu_equals_render_views():
  """From ``views_homographies``, as the engine calls it: the frames
  ``render_views`` gives, to the bit."""
  layers, depths, k, planes, poses, homs = _scene(37, 11, 4, 3, seed=2)
  host = torch.full((3, 37, 11, 3), float("nan"))
  rf.render_to_host(planes, homs, host)
  want = render.render_views(
      torch.from_numpy(layers), poses, torch.from_numpy(depths),
      torch.from_numpy(k), convention=Convention.EXACT,
      method="fused_pallas")
  assert torch.equal(host, want)


def _bad_hosts():
  return {
      "too_few_views": (torch.empty((1, 8, 4, 3)), ValueError, "must be"),
      "transposed_frame": (torch.empty((2, 4, 8, 3)), ValueError, "must be"),
      "float64": (torch.empty((2, 8, 4, 3), dtype=torch.float64), TypeError,
                  "float32"),
      "bfloat16": (torch.empty((2, 8, 4, 3), dtype=torch.bfloat16),
                   TypeError, "float32"),
      "non_contiguous": (torch.empty((2, 4, 8, 3)).transpose(1, 2),
                         ValueError, "contiguous"),
      "strided_views": (torch.empty((4, 8, 4, 3))[::2], ValueError,
                        "contiguous"),
  }


@pytest.mark.parametrize("case", sorted(_bad_hosts()))
def test_render_to_host_refuses_buffers_it_cannot_take(case):
  host, error, match = _bad_hosts()[case]
  *_, planes, _, homs = _scene(8, 4, 2, 2)
  with pytest.raises(error, match=match):
    rf.render_to_host(planes, homs, host)


def test_render_to_host_refuses_unpinned_memory_off_the_cpu():
  """Planes off the CPU need a pinned host buffer: the refusal comes
  before anything reads the planes' device."""
  *_, planes, _, homs = _scene(8, 4, 2, 2)
  host = torch.empty((2, 8, 4, 3))
  assert not host.is_pinned()
  with pytest.raises(ValueError, match="pinned"):
    rf.render_to_host(planes.to("meta"), homs.to("meta"), host)
  with pytest.raises(ValueError, match="CPU tensor"):
    rf.render_to_host(planes, homs, host.to("meta"))


@pytest.mark.parametrize("views, to_host, smem", [
    (1, False, 32 * 36), (8, False, 4 * 32 * 36),
    (1, True, 32 * 36 + 3072), (8, True, 4 * (32 * 36 + 3072))])
def test_launch_shape_stages_the_write_through_tile(views, to_host, smem):
  """The write-through instance stages a 32 x 8 tile of RGB floats a view
  beside the chunk's maps; the grid does not change."""
  shape = rf.launch_shape(views, 32, 1080, 1920, True, to_host=to_host)
  assert shape["smem_bytes"] == smem
  assert shape["grid"] == (60, 135, -(-views // 4))


def test_check_launch_counts_the_staged_tile_against_shared_memory():
  # 341 planes fit a chunk of 4 views' maps; with the staged tiles, 256.
  rf.check_launch("k", 8, rf.MAX_PLANES, 64, 64, True)
  rf.check_launch("k", 8, 256, 64, 64, True, to_host=True)
  with pytest.raises(ValueError, match="shared-memory"):
    rf.check_launch("k", 8, 257, 64, 64, True, to_host=True)


@pytest.fixture(scope="module")
def baked():
  return bake_scene("s", *synthetic_scene("s", 8, 12, 3, seed=0),
                    device="cpu")


@pytest.mark.parametrize("method, crop, half, through", [
    ("fused_pallas", False, False, True),   # a whole-scene bake
    ("fused_pallas", True, False, False),   # a tile crop
    ("fused_pallas", False, True, False),   # a brownout L2 view
    ("pallas", False, False, False),
    ("fused", False, False, False),
    ("scan", False, False, False),
    ("assoc", False, False, False)])
def test_which_flights_write_through(baked, method, crop, half, through):
  scene = baked
  if crop:
    scene = dataclasses.replace(scene, src_window=(0, 0, 8, 12))
  if half:
    scene = dataclasses.replace(scene, out_hw=(4, 6),
                                tgt_intrinsics=scene.intrinsics)
  assert writes_through(scene, method) is through


class _Event:
  """A timing event at ``t`` ms on the card's clock."""

  def __init__(self, t):
    self.t = t

  def elapsed_time(self, other):
    return other.t - self.t


@pytest.mark.parametrize("through", [True, False])
def test_wait_stamps_the_three_phases_of_a_card_flight(through):
  """A write-through flight has no copy, so ``readback_s`` is 0 and its
  frames' time over the link is in ``compute_s``; a copying flight's
  readback is the sum of its copies' own time. ``wait`` stamps these three
  and nothing else, as the JAX engine does."""
  eng = RenderEngine(device="cpu", use_mesh=False)
  marks = [_Event(0.0), _Event(0.25), _Event(4.25)]
  if not through:
    marks += [_Event(4.5), _Event(6.0), _Event(6.5), _Event(7.0)]
  eng._acquire_slot()
  handle = InFlightBatch(eng, torch.zeros((8, 2, 3, 3)), None, 5, 0.0, 0.0,
                         tuple(marks))
  assert eng.wait(handle).shape == (5, 2, 3, 3) and eng.inflight == 0
  t = handle.timings
  assert set(t) == {"h2d_s", "compute_s", "readback_s"}
  assert t["h2d_s"] == pytest.approx(0.25e-3)
  assert t["compute_s"] == pytest.approx(4e-3)
  assert t["readback_s"] == (0.0 if through else pytest.approx(2e-3))


PHASES = {"h2d", "compute", "readback"}


def test_three_phases_reach_stats_metrics_and_attrib_reconciles():
  svc = RenderService(engine=RenderEngine(device="cpu", use_mesh=False),
                      max_batch=4, max_wait_ms=50.0,
                      attrib=attrib.AttribConfig())
  try:
    svc.add_synthetic_scenes(1, height=16, width=24, planes=3)
    futs = [svc.render_async("scene_000", _pose(0.01 * i)) for i in range(6)]
    for f in futs:
      f.result(60)
    m = svc.metrics
    assert m.batches >= 2
    assert set(m.phase_seconds) == PHASES
    stats = svc.stats()
    assert stats["device_phase_seconds"] == {
        k: round(v, 3) for k, v in m.phase_seconds.items()}
    text = prom.render_serve_metrics(
        {**stats, "device_phase_seconds": dict(m.phase_seconds)})
    samples = prom.parse_metrics_text(text)[
        "mpi_serve_device_phase_seconds_total"]["samples"]
    assert samples == {
        ("mpi_serve_device_phase_seconds_total", (("phase", k),)):
            pytest.approx(v) for k, v in m.phase_seconds.items()}
    # The ledger splits the same three phases, and they reconcile.
    assert set(attrib.PHASES) == PHASES
    assert m.attrib_reference()["device_phase_seconds"] == m.phase_seconds
    snap = m.attrib.snapshot(reference=m.attrib_reference())
    assert snap["conservation"]["ok"], snap["conservation"]
  finally:
    svc.close()


def test_metrics_accumulate_the_three_phases_per_flight():
  m = ServeMetrics()
  m.record_batch(4, 0.01, phases={"h2d_s": 1e-4, "compute_s": 2e-3,
                                  "readback_s": 3e-3})
  m.record_batch(2, 0.01, phases={"h2d_s": 1e-4, "compute_s": 1e-3,
                                  "readback_s": 0.0})
  m.record_batch(1, 0.01)  # a flight with no phase split adds nothing
  assert m.phase_seconds == pytest.approx(
      {"h2d": 2e-4, "compute": 3e-3, "readback": 3e-3})
  assert set(m.attrib_reference()["device_phase_seconds"]) == PHASES


class _Recorder:
  def __init__(self):
    self.spans = {}

  def record(self, name, t0, t1, parent=None):
    self.spans[name] = (t0, t1)


@pytest.mark.parametrize("readback", [0.0, 1.5])
def test_flight_recorder_anchors_readback_where_it_began(readback):
  """A write-through flight (no readback) and a copying one: the port
  records the phases where the JAX scheduler does, front to back."""
  timings = {"h2d_s": 0.5, "compute_s": 2.0, "readback_s": readback}
  port, jax = _Recorder(), _Recorder()
  MicroBatcher._record_phases(None, port, None, 10.0, timings)
  JMicroBatcher._record_phases(None, jax, None, 10.0, timings)
  assert port.spans == jax.spans
  assert port.spans["readback"] == (12.5, 12.5 + readback)
