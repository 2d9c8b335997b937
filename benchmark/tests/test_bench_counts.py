"""The frozen counts against cases worked by hand."""

import math

import pytest

from benchmark import counts


def test_render_at_1080p_32_planes_eight_views_is_bound_by_operations():
  # 8 x 1080 x 1920 x 32 samples x 67 operations / 67 TFLOP/s.
  least, bound = counts.render(8, 32, 1080, 1920)
  assert bound == "operations"
  assert least == pytest.approx(8 * 1080 * 1920 * 32 / 1e12)
  assert round(least * 1e3, 3) == 0.531


def test_render_at_1080p_32_planes_one_view_is_bound_by_bytes():
  # The scene (1080 x 1920 x 32 x 16 B) read once, 32 homographies, one
  # RGB f32 frame written, at 3.35 TB/s.
  nbytes = 1080 * 1920 * 32 * 16 + 32 * 36 + 1080 * 1920 * 12
  least, bound = counts.render(1, 32, 1080, 1920)
  assert bound == "bytes"
  assert least == pytest.approx(nbytes / 3.35e12)
  assert round(least * 1e3, 3) == 0.324


def test_one_vgg_and_one_unet_layer():
  vgg = dict(counts.vgg_layer_flops(224))
  assert vgg[2] == 2 * 64 * 64 * 9 * 224 * 224 == 3699376128  # conv1_2
  assert vgg[0] == 2 * 3 * 64 * 9 * 224 * 224
  unet = dict(counts.unet_layer_flops(224, 10))
  assert unet["cnv1_1"] == 2 * 33 * 33 * 9 * 224 * 224 == 983549952
  assert unet["cnv1_2"] == 2 * 33 * 66 * 9 * 112 * 112
  # The transpose conv takes 16 ngf (528) channels at 28 px to 4 ngf (132)
  # at 56 px: every input pixel scatters 132 x 4 x 4 multiply-adds.
  assert unet["cnv5_1"] == 2 * 528 * 28 * 28 * 132 * 16 == 1748533248
  assert unet["cnv8_1"] == 2 * 23 * 23 * 224 * 224


def test_train_step_total_and_the_backward_kernels():
  step = counts.train_step_flops(224, 10, 1, 224)
  unet_fwd = sum(f for _, f in counts.unet_layer_flops(224, 10))
  vgg_fwd = sum(f for _, f in counts.vgg_layer_flops(224))
  assert step["unet"] == 3 * unet_fwd - 983549952
  assert step["vgg"] == 3 * vgg_fwd
  assert math.isclose(step["total"] / 1e9, 132.548, rel_tol=1e-5)
  a, bound_a = counts.rewarp_composite_vjp(1, 10, 224, 224)
  b, bound_b = counts.adjoint_warp(1, 10, 224, 224)
  scene = 10 * 224 * 224 * 16
  assert (bound_a, bound_b) == ("bytes", "bytes")
  assert a == pytest.approx((2 * scene + 360 + 224 * 224 * 12) / 3.35e12)
  assert b == pytest.approx((2 * scene + 360) / 3.35e12)


def test_operation_counts_are_frozen():
  assert (counts.FLOPS_RENDER, counts.FLOPS_A, counts.FLOPS_B) == (67, 82, 57)
  assert (counts.PEAK_F32_S, counts.PEAK_BYTES_S) == (67e12, 3.35e12)
