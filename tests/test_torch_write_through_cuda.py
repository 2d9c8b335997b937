"""Write-through flights on the card: the serving engine renders a
whole-scene ``fused_pallas`` flight straight into the flight's pinned host
buffer, one launch a shard (``serve/engine.py``,
``kernels/render_fused.render_to_host``). Frames must equal the
device-output launch's and ``plain_render``'s to the bit, on one card and
on a sharded engine; a scene freed while a flight renders must not show;
a shard that fails after another shard's launch must leave the buffer to
that launch until its stream has passed it.

Needs an NVIDIA card and ``nvcc``; skips without them. Runs on the card
without the suite's CPU-mesh ``conftest.py`` (which imports JAX)::

  python -m pytest --noconftest -m card tests/test_torch_write_through_cuda.py -q
"""

import threading

import numpy as np
import pytest
import torch

from mpi_vision_tpu_torch.core import render
from mpi_vision_tpu_torch.kernels import render_fused
from mpi_vision_tpu_torch.serve.cache import bake_scene
from mpi_vision_tpu_torch.serve.engine import RenderEngine
from mpi_vision_tpu_torch.serve.server import synthetic_scene

pytestmark = pytest.mark.card

# Eight planes keep the plain version's run on the card short.
H, W, P = 1080, 1920, 8


@pytest.fixture(scope="module")
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card (and nvcc to build the kernel)")
  return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def host_scene():
  return synthetic_scene("wt_000", H, W, P, seed=20)


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


def _device_frames(eng, scene, poses):
  """The device-output launch of the same flight, read back."""
  return render.render_views(
      scene.rgba_layers, torch.from_numpy(poses).to(scene.device),
      scene.depths, scene.intrinsics, convention=eng.convention,
      method="fused_pallas").cpu().numpy()


@pytest.mark.parametrize("h, w", [(1080, 1920), (540, 960), (37, 50)])
@pytest.mark.parametrize("views", [1, 2, 3, 4, 5, 8])
def test_write_through_flight_equals_device_output_and_plain_render(
    card, views, h, w):
  """Chunk remainders (1, 2, 3, 5 views), whole tiles with 16-byte rows
  (1080p, 540p) and a ragged frame whose rows take scalar stores (37 x
  50): one launch, no copy, the padded views written too."""
  scene = bake_scene("s", *synthetic_scene("s", h, w, P, seed=h + views),
                     device=card)
  eng = RenderEngine(device=card, use_mesh=False)
  poses = _poses(views, seed=views)
  launches = (render_fused.render_to_host.launches,
              render_fused.render_mpi_fused.launches)
  handle = eng.submit(scene, poses)
  got = eng.wait(handle).copy()
  assert (render_fused.render_to_host.launches - launches[0],
          render_fused.render_mpi_fused.launches - launches[1]) == (1, 1)
  assert handle.out.shape[0] == eng.batch_bucket(views)
  t = handle.timings
  assert set(t) == {"h2d_s", "compute_s", "readback_s"}
  assert t["readback_s"] == 0.0 and t["compute_s"] > 0.0
  np.testing.assert_array_equal(got, _device_frames(eng, scene, poses))
  homs = render.views_homographies(
      torch.from_numpy(poses).to(card), scene.depths, scene.intrinsics, h, w,
      eng.convention)
  want = render_fused.plain_render(scene.planes, homs).cpu().numpy()
  np.testing.assert_array_equal(got, want)


def test_sharded_engine_on_one_card_twice(card, host_scene):
  """Two shards on one card write their halves of one pinned buffer, one
  launch a shard; the buffer holds the padded views."""
  scene = bake_scene("s", *host_scene, device=card)
  poses = _poses(5, seed=3)
  sharded = RenderEngine(devices=[card, card], use_mesh=True)
  launches = render_fused.render_to_host.launches
  handle = sharded.submit(scene, poses)
  got = sharded.wait(handle)
  assert render_fused.render_to_host.launches - launches == 2
  assert got.shape == (5, H, W, 3) and handle.out.shape[0] == 8
  np.testing.assert_array_equal(got, _device_frames(sharded, scene, poses))


def test_flights_that_keep_their_copy(card, host_scene):
  """A method other than ``fused_pallas`` (here ``pallas``, the warp and
  the compose kernel, as tile crops render) renders into a device buffer
  that the copy stream reads back: no write-through, a readback of its
  own, the frames ``render_views`` gives."""
  scene = bake_scene("s", *host_scene, device=card)
  eng = RenderEngine(method="pallas", device=card, use_mesh=False)
  poses = _poses(3, seed=9)
  launches = render_fused.render_to_host.launches
  handle = eng.submit(scene, poses)
  got = eng.wait(handle)
  assert render_fused.render_to_host.launches == launches
  t = handle.timings
  assert t["readback_s"] > 0.0 and handle.out.shape[0] == 4
  want = render.render_views(
      scene.rgba_layers, torch.from_numpy(poses).to(card), scene.depths,
      scene.intrinsics, convention=eng.convention, method="pallas")
  np.testing.assert_array_equal(got, want.cpu().numpy())


def test_freed_scene_and_back_to_back_flights_keep_their_frames(card,
                                                                host_scene):
  eng = RenderEngine(device=card, use_mesh=False)
  poses = [_poses(8, seed=s) for s in (5, 6, 7)]
  keep = bake_scene("keep", *host_scene, device=card)
  want = [eng.render_batch(keep, p) for p in poses]
  # Flights submitted back to back, each from a bake that is dropped at
  # once (as the cache drops an evicted scene) and whose memory is then
  # handed out again and overwritten while the flights' kernels may still
  # run.
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
  """Four completers submit at once, as the scheduler's do: their launches
  interleave on the card's compute stream. Every frame equals its flight
  rendered alone, no flight reads back, and every flight is one launch."""
  scene = bake_scene("s", *host_scene, device=card)
  eng = RenderEngine(device=card, use_mesh=False, max_inflight=4)
  jobs = [_poses(v, seed=10 + i) for i, v in enumerate([8, 5, 3, 8, 1, 6,
                                                        8, 2] * 2)]
  launches = render_fused.render_to_host.launches
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
    assert t["readback_s"] == 0.0 and t["compute_s"] > 0.0
  assert render_fused.render_to_host.launches - launches == 2 * len(jobs)


def test_a_failed_shard_leaves_the_buffer_to_the_written_shard(card,
                                                               host_scene,
                                                               monkeypatch):
  """The second shard's launch fails after the first shard's write-through
  is enqueued: submit raises only once the compute stream has passed that
  launch (it writes pinned memory PyTorch's allocator does not track),
  frees its slot, and the engine serves the next flight intact."""
  scene = bake_scene("s", *host_scene, device=card)
  poses = _poses(8, seed=4)
  eng = RenderEngine(devices=[card, card], use_mesh=True, max_inflight=1)
  real, calls = render_fused.render_to_host, []

  def second_fails(*args, **kwargs):
    calls.append(1)
    if len(calls) == 2:
      raise RuntimeError("render_to_host failed: CUDA error 700")
    return real(*args, **kwargs)

  # The real launch counts on the module's attribute, which this replaces.
  second_fails.launches = real.launches
  monkeypatch.setattr(render_fused, "render_to_host", second_fails)
  with pytest.raises(RuntimeError, match="CUDA error 700"):
    eng.submit(scene, poses)
  assert all(s.query() for s in eng._streams.values())
  assert eng._inflight == 0
  monkeypatch.setattr(render_fused, "render_to_host", real)
  got = eng.render_batch(scene, poses)
  want = RenderEngine(device=card, use_mesh=False).render_batch(scene, poses)
  np.testing.assert_array_equal(got, want)
