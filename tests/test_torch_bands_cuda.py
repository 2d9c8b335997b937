"""Row-banded flights on the card: the serving engine renders a 1080p flight
in row bands on its compute stream and reads each band back on its copy
stream (``serve/engine.py``). Frames must equal a one-band flight's and
``plain_render``'s to the bit, on one card and on a sharded engine, and a
scene or frames buffer freed while a flight's copies run must not show.

Needs an NVIDIA card and ``nvcc``; skips without them. Runs on the card
without the suite's CPU-mesh ``conftest.py`` (which imports JAX)::

  python -m pytest --noconftest -m card tests/test_torch_bands_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mpi_vision_tpu_torch.core import render
from mpi_vision_tpu_torch.kernels import render_fused
from mpi_vision_tpu_torch.serve import engine as engine_mod
from mpi_vision_tpu_torch.serve.cache import bake_scene
from mpi_vision_tpu_torch.serve.engine import RenderEngine
from mpi_vision_tpu_torch.serve.server import synthetic_scene

pytestmark = pytest.mark.card

# A 1080p frame takes four bands; eight planes keep the plain version's
# run on the card short.
H, W, P = 1080, 1920, 8


@pytest.fixture(scope="module")
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card (and nvcc to build the kernel)")
  return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def host_scene():
  return synthetic_scene("bands_000", H, W, P, seed=16)


def _poses(n, seed=0):
  rng = np.random.default_rng(seed)
  out = []
  for i in range(n):
    yaw = float(rng.uniform(-0.17, 0.17)) if i % 2 else 0.0
    c, s = np.cos(yaw), np.sin(yaw)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = rng.uniform(-0.05, 0.05, 3)
    out.append(pose)
  return np.stack(out).astype(np.float32)


def _one_band(monkeypatch):
  monkeypatch.setattr(engine_mod, "row_bands",
                      lambda height, width, method: [(0, height)])


@pytest.mark.parametrize("views", [1, 2, 4, 8])
def test_banded_flight_equals_one_band_and_plain_render(card, host_scene,
                                                        views, monkeypatch):
  scene = bake_scene("s", *host_scene, device=card)
  eng = RenderEngine(device=card, use_mesh=False)
  poses = _poses(views, seed=views)
  assert len(engine_mod.row_bands(H, W, eng.method)) == 4
  launches = render_fused.render_mpi_fused.launches
  handle = eng.submit(scene, poses)
  banded = eng.wait(handle).copy()
  assert handle.bands == 4
  assert render_fused.render_mpi_fused.launches - launches == 4
  t = handle.timings
  assert 0.0 <= t["readback_hidden_s"] <= min(t["compute_s"],
                                              t["readback_s"]) + 1e-6
  assert t["readback_hidden_s"] > 0.0
  with monkeypatch.context() as m:
    _one_band(m)
    handle = eng.submit(scene, poses)
    whole = eng.wait(handle)
    assert handle.bands == 1 and handle.timings["readback_hidden_s"] == 0.0
  np.testing.assert_array_equal(banded, whole)
  homs = render.views_homographies(
      torch.from_numpy(poses).to(card), scene.depths, scene.intrinsics, H, W,
      eng.convention)
  want = render_fused.plain_render(scene.planes, homs).cpu().numpy()
  np.testing.assert_array_equal(banded, want)


def test_sharded_engine_on_one_card_twice_equals_one_band(card, host_scene,
                                                          monkeypatch):
  scene = bake_scene("s", *host_scene, device=card)
  poses = _poses(5, seed=3)
  sharded = RenderEngine(devices=[card, card], use_mesh=True)
  handle = sharded.submit(scene, poses)
  got = sharded.wait(handle)
  assert handle.bands == 4 and got.shape == (5, H, W, 3)
  _one_band(monkeypatch)
  want = RenderEngine(device=card, use_mesh=False).render_batch(scene, poses)
  np.testing.assert_array_equal(got, want)


def test_freed_scene_and_back_to_back_flights_keep_their_frames(card,
                                                                host_scene):
  eng = RenderEngine(device=card, use_mesh=False)
  poses = [_poses(8, seed=s) for s in (5, 6, 7)]
  keep = bake_scene("keep", *host_scene, device=card)
  want = [eng.render_batch(keep, p) for p in poses]
  # Flights submitted back to back, each from a bake that is dropped at
  # once (as the cache drops an evicted scene) and whose memory is then
  # handed out again and overwritten while the flights' kernels and
  # copies may still run.
  handles = []
  for p in poses:
    scene = bake_scene("gone", *host_scene, device=card)
    handles.append(eng.submit(scene, p))
    count = scene.planes.numel()
    del scene
    torch.full((count,), float("nan"), device=card)
  for handle, w in zip(handles, want):
    np.testing.assert_array_equal(eng.wait(handle), w)


def test_concurrent_submitters_keep_frames_and_timings(card, host_scene):
  """Four completers submit at once, as the scheduler's do: their bands
  interleave on the card's two streams. Every frame equals its flight
  rendered alone, and every flight's timings stay inside their bounds."""
  import threading

  scene = bake_scene("s", *host_scene, device=card)
  eng = RenderEngine(device=card, use_mesh=False, max_inflight=4)
  jobs = [_poses(v, seed=10 + i) for i, v in enumerate([8, 5, 3, 8, 1, 6,
                                                        8, 2] * 2)]
  want = [eng.render_batch(scene, p) for p in jobs]
  got, errors = [None] * len(jobs), []

  def completer(w):
    try:
      for j in range(w, len(jobs), 4):
        handle = eng.submit(scene, jobs[j])
        got[j] = (eng.wait(handle), handle.timings)
    except Exception as e:  # noqa: BLE001 - reported below
      errors.append(e)

  threads = [threading.Thread(target=completer, args=(w,)) for w in range(4)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(300)
  assert not errors, errors
  for (frames, t), w in zip(got, want):
    np.testing.assert_array_equal(frames, w)
    assert 0.0 <= t["readback_hidden_s"] <= min(t["compute_s"],
                                                t["readback_s"]) + 1e-6
  assert any(t["readback_hidden_s"] > 0.0 for _, t in got)


def test_a_failed_shard_lets_the_enqueued_copies_end(card, host_scene,
                                                     monkeypatch):
  """The second shard's render fails after the first shard's band copies
  are enqueued: submit raises only once those copies have ended (they write
  pinned memory PyTorch's allocator does not track), frees its slot, and
  the engine serves the next flight intact."""
  scene = bake_scene("s", *host_scene, device=card)
  poses = _poses(8, seed=4)
  eng = RenderEngine(devices=[card, card], use_mesh=True, max_inflight=1)
  real, calls = render_fused.render_bands, []

  def second_fails(*args, **kwargs):
    calls.append(1)
    if len(calls) == 2:
      raise RuntimeError("render_bands failed: CUDA error 700")
    return real(*args, **kwargs)

  monkeypatch.setattr(render_fused, "render_bands", second_fails)
  with pytest.raises(RuntimeError, match="CUDA error 700"):
    eng.submit(scene, poses)
  assert all(s.query() for s in eng._copy_streams.values())
  assert eng._inflight == 0
  monkeypatch.setattr(render_fused, "render_bands", real)
  got = eng.render_batch(scene, poses)
  _one_band(monkeypatch)
  want = RenderEngine(device=card, use_mesh=False).render_batch(scene, poses)
  np.testing.assert_array_equal(got, want)
