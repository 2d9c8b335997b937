"""The port's compose kernel module against the JAX package's Pallas kernel.

``mpi_vision_tpu_torch.kernels.compose_over`` on CPU tensors runs the
kernel's plain version; the JAX side runs ``compose_pallas`` in interpret
mode, as ``tests/test_compose_pallas.py`` does, at that file's shapes. The
CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.

Tolerances: atol 1e-6 for the f32 composite (``test_compose_pallas.py``'s
own; both sides evaluate the same f32 expressions, XLA may contract a
multiply-add); one bf16 ulp between the two bf16 composites (f32
accumulation, one rounding each, of results an f32 ulp apart) and 5e-3 of
the f32 scan (the JAX test's bound); atol 1e-5 for gradients and for
``render_mpi(method="pallas")``, whose warp differs from JAX's by a few
ulps of a pixel coordinate (see ``tests/test_torch_core.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_vision_tpu.core import camera as jcamera
from mpi_vision_tpu.core import compose as jcompose
from mpi_vision_tpu.core import render as jrender
from mpi_vision_tpu.core.sampling import Convention as JConvention
from mpi_vision_tpu.kernels import compose_pallas
from mpi_vision_tpu_torch.core import compose as tcompose
from mpi_vision_tpu_torch.core import render as trender
from mpi_vision_tpu_torch.core import sampling as tsampling
from mpi_vision_tpu_torch.core.sampling import Convention as TConvention
from mpi_vision_tpu_torch.kernels import compose_over

ATOL = 1e-6
# tests/test_compose_pallas.py's shapes (P, B, H, W).
SHAPES = [
    (1, 1, 8, 128),     # single plane: alpha ignored, out == rgb
    (10, 2, 16, 128),   # fixture-like
    (4, 1, 30, 100),    # non-tile-aligned H and W
    (32, 1, 40, 256),   # bench-like plane count
]


def _mpi(rng, *shape):
  return rng.uniform(0.0, 1.0, size=shape + (4,)).astype(np.float32)


def _close(got, want, atol=ATOL):
  np.testing.assert_allclose(np.asarray(got, np.float32),
                             np.asarray(want, np.float32), atol=atol, rtol=0)


@pytest.mark.parametrize("p,b,h,w", SHAPES)
def test_matches_the_jax_kernel(rng, p, b, h, w):
  rgba = _mpi(rng, p, b, h, w)
  got = compose_over.over_composite_pallas(torch.from_numpy(rgba))
  want = compose_pallas.over_composite_pallas(jnp.asarray(rgba))
  assert got.shape == (b, h, w, 3)
  _close(got, want)
  # The plain version is the port's scan, to the bit.
  assert torch.equal(got, tcompose.over_composite_scan(torch.from_numpy(rgba)))


def test_unbatched_layout_and_alphas_zero_and_one(rng):
  rgba = _mpi(rng, 6, 24, 136)                   # [P, H, W, 4]
  rgba[2, :, :40, 3] = 0.0                       # exact pass-through
  rgba[4, 10:, :, 3] = 1.0                       # exact replace
  got = compose_over.over_composite_pallas(torch.from_numpy(rgba))
  want = compose_pallas.over_composite_pallas(jnp.asarray(rgba))
  assert got.shape == (24, 136, 3)
  _close(got, want)
  # Alpha 1 on plane 4 makes the rows it covers the front planes' alone.
  front = tcompose.over_composite_scan(torch.from_numpy(rgba[4:, 10:]))
  assert torch.equal(got[10:], front)


def test_planar_entry_and_dispatcher(rng):
  rgba = _mpi(rng, 5, 2, 16, 128)                # [P, B, H, W, 4]
  planar = np.ascontiguousarray(rgba.transpose(1, 0, 4, 2, 3))
  got = compose_over.over_composite_pallas_planar(torch.from_numpy(planar))
  want = compose_pallas.over_composite_pallas_planar(jnp.asarray(planar))
  assert got.shape == (2, 3, 16, 128)
  _close(got, want)
  _close(tcompose.over_composite(torch.from_numpy(rgba), method="pallas"),
         jcompose.over_composite(jnp.asarray(rgba), method="pallas"))


def test_bfloat16_accumulates_in_f32_and_rounds_once(rng):
  rgba = _mpi(rng, 16, 1, 16, 128)
  got = compose_over.over_composite_pallas(
      torch.from_numpy(rgba).to(torch.bfloat16))
  want = compose_pallas.over_composite_pallas(
      jnp.asarray(rgba).astype(jnp.bfloat16))
  assert got.dtype == torch.bfloat16
  # Non-negative bf16 values order like their bit patterns: one ulp apart
  # is one step of the 16-bit integer.
  got_bits = got.view(torch.int16).numpy().astype(np.int32)
  want_bits = np.asarray(want).view(np.uint16).astype(np.int32)
  assert np.abs(got_bits - want_bits).max() <= 1
  _close(got.to(torch.float32),
         tcompose.over_composite_scan(torch.from_numpy(rgba)), atol=5e-3)
  # The plain version's contract: the f32 scan of the upcast input,
  # rounded once.
  bf = torch.from_numpy(rgba).to(torch.bfloat16)
  assert torch.equal(got, tcompose.over_composite_scan(
      bf.to(torch.float32)).to(torch.bfloat16))


def test_gradients_match_jax(rng):
  rgba = _mpi(rng, 4, 1, 8, 128)
  x = torch.from_numpy(rgba).requires_grad_(True)
  (compose_over.over_composite_pallas(x) ** 2).sum().backward()
  want = jax.grad(lambda v: jnp.sum(
      compose_pallas.over_composite_pallas(v) ** 2))(jnp.asarray(rgba))
  _close(x.grad, want, atol=1e-5)
  y = torch.from_numpy(rgba).requires_grad_(True)
  (tcompose.over_composite_scan(y) ** 2).sum().backward()
  assert torch.equal(x.grad, y.grad)


def _smooth(rng, b, h, w, p):
  yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                       indexing="ij")
  out = np.empty((b, h, w, p, 4), np.float32)
  for bi, pi, c in np.ndindex(b, p, 4):
    fx, fy = rng.uniform(0.5, 2.0, 2)
    out[bi, :, :, pi, c] = 0.5 + 0.5 * np.sin(
        np.pi * (fx * xx + fy * yy) + rng.uniform(0, 2 * np.pi))
  return out


def _pose(tx, ty, tz, ry):
  pose = np.eye(4, dtype=np.float32)
  c, s = np.cos(ry), np.sin(ry)
  pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
  pose[:3, 3] = [tx, ty, tz]
  return pose


def _k(h, w):
  return np.array([[0.6 * w, 0, w / 2], [0, 0.6 * w, h / 2], [0, 0, 1]],
                  np.float32)


# Jitted: eager JAX compiles every primitive per shape.
_jax_render = jax.jit(jrender.render_mpi,
                      static_argnames=("convention", "method", "out_hw"))


@pytest.mark.parametrize("convention,target", [
    ("EXACT", None), ("REF_HOMOGRAPHY", None), ("EXACT", (30, 40))])
def test_render_mpi_pallas_matches_jax(rng, convention, target):
  h, w, p = 24, 32, 4
  mpi = _smooth(rng, 2, h, w, p)
  poses = np.stack([_pose(0.04, 0.02, 0.03, -0.01),
                    _pose(-0.03, 0.01, -0.02, 0.02)])
  depths = np.array(jcamera.inv_depths(1.0, 100.0, p))
  k = np.stack([_k(h, w)] * 2)
  kw_j, kw_t = {}, {}
  if target is not None:
    k_t = np.stack([_k(*target)] * 2)
    kw_j = {"tgt_intrinsics": jnp.asarray(k_t), "out_hw": target}
    kw_t = {"tgt_intrinsics": torch.from_numpy(k_t), "out_hw": target}
  want = _jax_render(
      jnp.asarray(mpi), jnp.asarray(poses), jnp.asarray(depths),
      jnp.asarray(k), convention=JConvention[convention], method="pallas",
      **kw_j)
  got = trender.render_mpi(
      torch.from_numpy(mpi), torch.from_numpy(poses),
      torch.from_numpy(depths), torch.from_numpy(k),
      convention=TConvention[convention], method="pallas", **kw_t)
  assert got.shape == (2,) + (target or (h, w)) + (3,)
  _close(got, want, atol=1e-5)
  # The port's own batched route ('scan') to the bit: same warp, same
  # composite expressions.
  assert torch.equal(got, trender.render_mpi(
      torch.from_numpy(mpi), torch.from_numpy(poses),
      torch.from_numpy(depths), torch.from_numpy(k),
      convention=TConvention[convention], method="scan", **kw_t))


@pytest.mark.parametrize("convention", [c.name for c in TConvention])
def test_warp_stack_is_the_batched_warp_bit_for_bit(rng, convention):
  h, w, p, b = 20, 28, 5, 3
  planes = torch.from_numpy(_smooth(rng, 1, h, w, p)[0]).movedim(2, 0)
  planes = planes[:, None].expand(p, b, h, w, 4)  # one scene, 3 views
  poses = torch.from_numpy(np.stack([_pose(0.03 * i, -0.01 * i, 0.02 * i,
                                           0.01 * i) for i in range(b)]))
  depths = torch.linspace(50.0, 1.0, p)
  k = torch.from_numpy(np.stack([_k(h, w)] * b))
  k_t = torch.from_numpy(np.stack([_k(16, 36)] * b))
  conv = TConvention[convention]
  homs = trender.plane_homographies(poses, depths, k, tgt_intrinsics=k_t)
  got = trender.warp_stack(planes, homs, 16, 36, conv)
  want = tsampling.bilinear_sample(planes, trender.warp_coordinates(
      homs, 16, 36, conv, src_height=h, src_width=w))
  assert got.shape == (p, b, 16, 36, 4)
  assert torch.equal(got, want)


def test_no_kernel_launch_on_the_cpu_and_no_quiet_fallback(rng):
  launches = compose_over.over_composite_pallas.launches
  calls = compose_over.plain_composite.calls
  rgba = torch.from_numpy(_mpi(rng, 3, 8, 8))
  compose_over.over_composite_pallas(rgba)
  trender.render_mpi(rgba.reshape(1, 8, 8, 3, 4)[..., :4], torch.eye(4)[None],
                     torch.linspace(10.0, 1.0, 3),
                     torch.from_numpy(_k(8, 8))[None], method="pallas")
  assert compose_over.over_composite_pallas.launches == launches
  assert compose_over.plain_composite.calls == calls + 2
  # Neither a CPU nor a CUDA tensor: the wrapper raises, nothing runs.
  with pytest.raises(ValueError, match="CUDA device or the CPU"):
    compose_over.over_composite_pallas(torch.empty(3, 8, 8, 4,
                                                   device="meta"))
  with pytest.raises(TypeError, match="float32 or bfloat16"):
    compose_over.over_composite_pallas(torch.zeros(3, 8, 8, 4,
                                                   dtype=torch.float64))
  with pytest.raises(ValueError, match="trailing RGBA axis"):
    compose_over.over_composite_pallas(torch.zeros(3, 8, 8, 3))
  assert compose_over.plain_composite.calls == calls + 2
