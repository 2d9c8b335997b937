"""The port's reference-name surface against the JAX package's.

``mpi_vision_tpu_torch.compat`` is the torch backend of the reference's
``utils`` star-import surface; every name is held to the JAX surface's
``backend="jax"`` function on the same seeded numpy inputs, at the
tolerances ``tests/test_compat.py`` uses: 0 for the pixel-shuffle ops,
1e-3 for the render, the sweeps and the warps, 1e-4 for the planar
transforms, 1e-5 for the small helpers and the crops. Here every call
passes ``device="cpu"``; on the card the render and the composite launch
the CUDA kernels (``chip_smoke.py`` phase 13).
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mpi_vision_tpu import compat as jc
from mpi_vision_tpu.core import camera as jcamera
from mpi_vision_tpu.core import sweep as jsweep
from mpi_vision_tpu.core.camera import inv_depths
from mpi_vision_tpu.data import realestate as jreal
from mpi_vision_tpu_torch import compat as tc
from mpi_vision_tpu_torch.core import camera as tcamera
from mpi_vision_tpu_torch.core import sweep as tsweep
from mpi_vision_tpu_torch.data import realestate as treal
from mpi_vision_tpu_torch.kernels import compose_over, render_fused

CPU = {"device": "cpu"}


def _k(h, w, b=1):
  return np.array([[0.5 * w, 0, w / 2], [0, 0.5 * w, h / 2], [0, 0, 1]],
                  np.float32)[None].repeat(b, 0)


def _mpi_args(rng, b=1, hw=24, p=3):
  mpi = rng.uniform(0, 1, (b, hw, hw, p, 4)).astype(np.float32)
  pose = np.eye(4, dtype=np.float32)
  pose[0, 3] = 0.05
  planes = np.asarray(inv_depths(1.0, 100.0, p), np.float32)
  k = np.array([[hw / 2, 0, hw / 2], [0, hw / 2, hw / 2], [0, 0, 1]],
               np.float32)
  return mpi, pose[None].repeat(b, 0), planes, k[None].repeat(b, 0)


def test_surface_is_complete_and_matches_the_jax_signatures():
  import inspect

  names = [n for n in dir(jc) if not n.startswith("_")
           and (inspect.isfunction(getattr(jc, n))
                or inspect.isclass(getattr(jc, n)))
           and getattr(getattr(jc, n), "__module__", "").startswith(
               "mpi_vision_tpu.")]
  names = [n for n in names if n not in ("shard_map", "Convention")]
  assert len(names) >= 39
  missing = [n for n in names if not hasattr(tc, n)]
  assert not missing, missing
  for n in names:
    jfn, tfn = getattr(jc, n), getattr(tc, n)
    if inspect.isclass(jfn):
      continue
    jparams = list(inspect.signature(jfn).parameters)
    tparams = list(inspect.signature(tfn).parameters)
    # Same positional names in order; the port adds ``device`` last.
    assert tparams[:len(jparams)] == jparams, n
    if "backend" in jparams:
      assert tparams == jparams + ["device"], n
      assert inspect.signature(tfn).parameters["backend"].default == "torch"


@pytest.mark.parametrize("backend", ["jax", "tf"])
def test_only_the_torch_backend_is_accepted(backend):
  with pytest.raises(ValueError, match="mpi_vision_tpu.compat"):
    tc.inv_depths(1.0, 100.0, 4, backend=backend, device="cpu")
  with pytest.raises(ValueError, match="backend"):
    tc.mpi_render_view_torch(*_mpi_args(np.random.default_rng(0)),
                             backend=backend, device="cpu")


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    tc.inv_depths(1.0, 100.0, 4)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    tc.over_composite([np.zeros((1, 4, 4, 4), np.float32)] * 2)
  assert tc.inv_depths(1.0, 100.0, 4, device="cpu").device.type == "cpu"


class TestPixelShuffle:

  def test_camera_ops_bit_exact_against_torch_references(self, rng):
    b = 2
    x = rng.uniform(size=(1, 4, 6, 3)).astype(np.float32)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = F.unfold(nchw, b, stride=b).reshape(1, 3 * b * b, 2, 3)
    got = tcamera.space_to_depth(torch.from_numpy(x), b)
    np.testing.assert_allclose(got.permute(0, 3, 1, 2).numpy(),
                               want.numpy(), atol=0)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcamera.space_to_depth(x, b)))
    y = rng.uniform(size=(1, 3, 4, 5 * b * b)).astype(np.float32)
    want = torch.nn.PixelShuffle(b)(torch.from_numpy(y).permute(0, 3, 1, 2))
    got = tcamera.depth_to_space(torch.from_numpy(y), b)
    np.testing.assert_allclose(got.permute(0, 3, 1, 2).numpy(),
                               want.numpy(), atol=0)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcamera.depth_to_space(y, b)))
    z = rng.uniform(size=(2, 8, 12, 3)).astype(np.float32)
    np.testing.assert_array_equal(tcamera.depth_to_space(
        tcamera.space_to_depth(torch.from_numpy(z), 2), 2).numpy(), z)
    with pytest.raises(ValueError, match="divisible"):
      tcamera.space_to_depth(torch.zeros(1, 5, 4, 3), 2)

  def test_modules_nchw_against_jax_and_autograd(self, rng):
    x = rng.uniform(size=(1, 3, 4, 8)).astype(np.float32)  # NCHW
    s2d, d2s = tc.SpaceToDepth(2), tc.DepthToSpace(2)
    assert isinstance(s2d, torch.nn.Module)
    y = s2d(x)
    assert y.shape == (1, 12, 2, 4)
    np.testing.assert_array_equal(y.numpy(),
                                  np.asarray(jc.SpaceToDepth(2)(x)))
    np.testing.assert_array_equal(d2s(y).numpy(), x)
    np.testing.assert_array_equal(
        y.numpy(), F.pixel_unshuffle(torch.from_numpy(x), 2).numpy())
    xt = torch.from_numpy(x).requires_grad_(True)
    d2s(s2d(xt)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


class TestRenderAndSweep:

  def test_mpi_render_view_runs_the_fused_kernels_plain_version(self, rng):
    mpi, pose, planes, k = _mpi_args(rng, b=2)
    calls = render_fused.plain_render.calls
    got = tc.mpi_render_view_torch(mpi, pose, planes, k, **CPU)
    assert render_fused.plain_render.calls == calls + 1
    want = jc.mpi_render_view_torch(mpi, pose, planes, k, backend="jax")
    assert got.shape == (2, 24, 24, 3) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)

  def test_over_composite_list_and_stack(self, rng):
    planes = [rng.uniform(0, 1, (1, 8, 8, 4)).astype(np.float32)
              for _ in range(3)]
    want = np.asarray(jc.over_composite(planes, backend="jax"))
    calls = compose_over.plain_composite.calls
    got_list = tc.over_composite(planes, **CPU)
    got_stack = tc.over_composite(torch.from_numpy(np.stack(planes)), **CPU)
    assert compose_over.plain_composite.calls == calls + 2
    np.testing.assert_allclose(got_list.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_list.numpy(), got_stack.numpy())

  def test_projective_forward_homography(self, rng):
    mpi, pose, planes, k = _mpi_args(rng)
    stack = np.moveaxis(mpi, 3, 0)
    got = tc.projective_forward_homography_torch(stack, k, pose, planes,
                                                 **CPU)
    want = jc.projective_forward_homography_torch(stack, k, pose, planes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)

  def test_plane_sweeps(self, rng):
    img = rng.uniform(-1, 1, (1, 24, 24, 3)).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3] = 0.07
    planes = np.asarray(inv_depths(1.0, 100.0, 4), np.float32)
    k = np.array([[12., 0, 12], [0, 12., 12], [0, 0, 1]], np.float32)
    for name, args in (
        ("plane_sweep_torch", (img, planes, pose[None], k[None])),
        ("plane_sweep_torch_one", (img[0], planes, pose, k)),
        ("projective_inverse_warp_torch",
         (img, np.full((1, 24, 24), 3.0, np.float32), pose[None], k[None]))):
      got = getattr(tc, name)(*args, **CPU)
      want = getattr(jc, name)(*args)
      assert got.shape == np.asarray(want).shape, name
      np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                                 rtol=0, err_msg=name)

  def test_format_network_input_multi_source(self, rng):
    n, b, hw, p = 2, 1, 24, 3
    ref = rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)
    srcs = rng.uniform(-1, 1, (n, b, hw, hw, 3)).astype(np.float32)
    ref_pose = np.eye(4, dtype=np.float32)[None]
    src_poses = np.stack([np.eye(4, dtype=np.float32)[None]] * n)
    src_poses[0, :, 0, 3] = 0.06
    src_poses[1, :, 1, 3] = -0.04
    planes = np.asarray(inv_depths(1.0, 100.0, p), np.float32)
    k = _k(hw, hw)
    want = np.asarray(jc.format_network_input_torch(
        ref, srcs, ref_pose, src_poses, planes, k))
    got = tc.format_network_input_torch(ref, srcs, ref_pose, src_poses,
                                        planes, k, **CPU)
    got_list = tc.format_network_input_torch(
        ref, list(srcs), ref_pose, list(src_poses), planes, k, **CPU)
    assert got.shape == (b, hw, hw, 3 + 3 * p * n)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got_list.numpy(), got.numpy())

  def test_pixel2cam_cam2pixel_and_pixel_transform(self, rng):
    b, h, w = 1, 10, 12
    depth = np.full((b, h, w), 2.5, np.float32)
    grid = np.asarray(jc.meshgrid_abs_torch(b, h, w))
    np.testing.assert_array_equal(
        tc.meshgrid_abs_torch(b, h, w, **CPU).numpy(), grid)
    k = _k(h, w)
    cam_t = tc.pixel2cam_torch(depth, grid, k, **CPU)
    cam_j = jc.pixel2cam_torch(depth, grid, k)
    np.testing.assert_allclose(cam_t.numpy(), np.asarray(cam_j), atol=1e-5)
    proj = np.eye(4, dtype=np.float32)[None]
    proj[0, :3, :3] = k[0]
    np.testing.assert_allclose(
        tc.cam2pixel_torch(cam_t, proj, **CPU).numpy(),
        np.asarray(jc.cam2pixel_torch(cam_j, proj)), atol=1e-4)
    src_pose = np.eye(4, dtype=np.float32)[None]
    tgt_pose = np.eye(4, dtype=np.float32)[None]
    tgt_pose[:, 0, 3] = 0.1
    args = (depth, grid, src_pose, tgt_pose, k, k)
    got = tc.projective_pixel_transform(*args, **CPU)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jc.projective_pixel_transform(*args)),
        atol=1e-4)
    # The core function itself, against the JAX core function.
    np.testing.assert_allclose(
        tsweep.projective_pixel_transform(
            *(torch.from_numpy(np.array(a)) for a in args)).numpy(),
        np.asarray(jsweep.projective_pixel_transform(*args)), atol=1e-4)

  def test_warp2_and_sweep_one2(self, rng):
    hs, ws, ht, wt = 12, 16, 10, 14
    img = rng.uniform(size=(1, hs, ws, 3)).astype(np.float32)
    depth = np.full((1, ht, wt), 3.0, np.float32)
    pose = np.eye(4, dtype=np.float32)[None]
    pose[:, 0, 3] = 0.05
    ks, kt = _k(hs, ws), _k(ht, wt)
    got = tc.projective_inverse_warp_torch2(img, depth, pose, ks, kt, ht,
                                            wt, **CPU)
    want = jc.projective_inverse_warp_torch2(img, depth, pose, ks, kt, ht,
                                             wt)
    assert got.shape == (1, ht, wt, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    wt_, ft = tc.projective_inverse_warp_torch2(
        img, depth, pose, ks, kt, ht, wt, ret_flows=True, **CPU)
    wj, fj = jc.projective_inverse_warp_torch2(
        img, depth, pose, ks, kt, ht, wt, ret_flows=True)
    np.testing.assert_allclose(wt_.numpy(), np.asarray(wj), atol=1e-3)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-3)
    assert float(ft.abs().max()) > 1.5  # raw pixels, not (0, 1)
    planes = np.asarray(inv_depths(1.0, 20.0, 4))
    st = tc.plane_sweep_torch_one2(img[0], planes, pose[0], ks[0], kt[0],
                                   ht, wt, **CPU)
    sj = jc.plane_sweep_torch_one2(img[0], planes, pose[0], ks[0], kt[0],
                                   ht, wt)
    assert st.shape == (1, ht, wt, 12)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-3)


class TestPlanarTransforms:

  def _plane_args(self, rng, h=16, w=16, b=1):
    imgs = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    grid = np.asarray(jc.meshgrid_abs_torch(b, h, w))
    pix = np.moveaxis(grid, 1, -1).astype(np.float32)
    rot = np.eye(3, dtype=np.float32)[None].repeat(b, 0)
    t = np.array([[0.05], [0.0], [-0.02]], np.float32)[None].repeat(b, 0)
    n_hat = np.array([[[0.0, 0.0, 1.0]]], np.float32).repeat(b, 0)
    a = np.full((b, 1, 1), -2.0, np.float32)
    return imgs, pix, _k(h, w, b), rot, t, n_hat, a

  def test_inverse_homography_and_points(self, rng):
    imgs, pix, k, rot, t, n_hat, a = self._plane_args(rng)
    np.testing.assert_allclose(
        tc.inv_homography_torch(k, k, rot, t, n_hat, a, **CPU).numpy(),
        np.asarray(jc.inv_homography_torch(k, k, rot, t, n_hat, a)),
        atol=1e-4)
    hom = np.eye(3, dtype=np.float32) + 0.01 * rng.normal(
        size=(1, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(tc.transpose_torch(hom, **CPU).numpy(),
                                  np.asarray(jc.transpose_torch(hom)))
    pt = tc.transform_points_torch(pix, hom, **CPU)
    pj = jc.transform_points_torch(pix, hom)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
    np.testing.assert_allclose(
        tc.normalize_homogeneous_torch(pt, **CPU).numpy(),
        np.asarray(jc.normalize_homogeneous_torch(pj)), atol=1e-4)

  def test_transform_plane_imgs(self, rng):
    args = self._plane_args(rng)
    imgs, pix, k, rot, t, n_hat, a = args
    got = tc.transform_plane_imgs_torch(imgs, pix, k, k, rot, t, n_hat, a,
                                        **CPU)
    want = jc.transform_plane_imgs_torch(imgs, pix, k, k, rot, t, n_hat, a)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

  def test_planar_transform(self, rng):
    imgs, pix, k, rot, t, n_hat, a = self._plane_args(rng)
    n = 3
    imgs_l = np.stack([imgs] * n)
    n_l = np.stack([n_hat] * n)
    a_l = np.stack([a * (i + 1) for i in range(n)])
    got = tc.planar_transform_torch(imgs_l, pix, k, k, rot, t, n_l, a_l,
                                    **CPU)
    want = jc.planar_transform_torch(imgs_l, pix, k, k, rot, t, n_l, a_l)
    assert got.shape == (n, 1, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)

  def test_sampler_wrappers(self, rng):
    imgs = rng.uniform(size=(2, 9, 11, 3)).astype(np.float32)
    coords = rng.uniform(-0.1, 1.1, (2, 5, 7, 2)).astype(np.float32)
    want = np.asarray(jc.resampler_wrapper_torch(imgs, coords))
    for name in ("resampler_wrapper_torch", "bilinear_wrapper_torch"):
      got = getattr(tc, name)(imgs, coords, **CPU)
      assert got.shape == (2, 5, 7, 3)  # NHWC: quirk Q1 not reproduced
      np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


class TestSmallHelpersAndCrops:

  def test_small_helpers(self, rng):
    np.testing.assert_allclose(
        tc.inv_depths(1.0, 100.0, 6, **CPU).numpy(),
        np.asarray(jc.inv_depths(1.0, 100.0, 6)), atol=1e-5)
    np.testing.assert_allclose(
        tc.make_intrinsics_matrix(2.0, 3.0, 4.0, 5.0, **CPU).numpy(),
        np.asarray(jc.make_intrinsics_matrix(2.0, 3.0, 4.0, 5.0)),
        atol=1e-5)
    k = _k(8, 10)[0]
    np.testing.assert_allclose(
        tc.scale_intrinsics(k, 0.5, 0.25, **CPU).numpy(),
        np.asarray(jc.scale_intrinsics(k, 0.5, 0.25)), atol=1e-5)
    x = rng.uniform(size=(2, 3)).astype(np.float32)
    pre = tc.preprocess_image_torch(x, **CPU)
    np.testing.assert_allclose(pre.numpy(),
                               np.asarray(jc.preprocess_image_torch(x)),
                               atol=1e-5)
    de = tc.deprocess_image_torch(pre, **CPU)
    assert de.dtype == torch.uint8
    np.testing.assert_array_equal(de.numpy(), np.asarray(
        jc.deprocess_image_torch(np.asarray(pre))))
    num = rng.normal(size=(4,)).astype(np.float32)
    den = np.array([0.0, 1.0, -2.0, 0.0], np.float32)
    np.testing.assert_allclose(
        tc.divide_safe_torch(num, den, **CPU).numpy(),
        np.asarray(jc.divide_safe_torch(num, den)), atol=1e-5)

  def test_crops(self, rng):
    img = rng.uniform(size=(1, 12, 14, 3)).astype(np.float32)
    got = tc.crop_to_bounding_box_torch(img, 2, 3, 6, 8, **CPU)
    want = jc.crop_to_bounding_box_torch(img, 2, 3, 6, 8)
    assert got.shape == (1, 6, 8, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # A fractional offset through the core function.
    np.testing.assert_allclose(
        tcamera.crop_to_bounding_box(torch.from_numpy(img), 1.5, 2.25, 5,
                                     7).numpy(),
        np.asarray(jcamera.crop_to_bounding_box(img, 1.5, 2.25, 5, 7)),
        atol=1e-5)
    k = np.array([[0.9, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1]],
                 np.float32)[None]
    ct, kt = tc.crop_image_and_adjust_intrinsics_torch(img, k, 2, 3, 6, 8,
                                                       **CPU)
    cj, kj = jc.crop_image_and_adjust_intrinsics_torch(img, k, 2, 3, 6, 8)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-5)


class TestHostHelpers:

  def test_open_image_and_resize_with_intrinsics(self, rng, tmp_path):
    from PIL import Image

    arr = (rng.uniform(size=(20, 30, 3)) * 255).astype(np.uint8)
    path = os.path.join(tmp_path, "img.png")
    Image.fromarray(arr).save(path)
    for kw in ({}, {"size": (15, 10), "scale": False}):
      np.testing.assert_array_equal(treal.open_image(path, **kw),
                                    jreal.open_image(path, **kw))
    assert tc.open_image is treal.open_image
    k = np.array([[30., 0, 15], [0, 20., 10], [0, 0, 1]], np.float32)
    image, k2 = treal.resize_with_intrinsics(path, k, 10, 15)
    jimage, jk2 = jreal.resize_with_intrinsics(path, k, 10, 15)
    np.testing.assert_allclose(image, jimage, atol=1e-5)
    np.testing.assert_allclose(k2, jk2, atol=1e-5)
    np.testing.assert_allclose(k2[0, 0], 15.0)
    ti, tk = tc.resize_with_intrinsics_torch(path, torch.from_numpy(k), 10,
                                             15, **CPU)
    ji, jk = jc.resize_with_intrinsics_torch(path, k, 10, 15)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)

  def test_fs_and_camera_file_helpers(self, tmp_path):
    (tmp_path / "b").mkdir()
    (tmp_path / "a").mkdir()
    (tmp_path / "f.txt").write_text(
        "https://www.youtube.com/watch?v=abc\n# comment\n"
        "1000 0.5 0.6 0.5 0.5 0 0 1 0 0 0.1 0 1 0 0 0 0 1 0\n")
    for name in ("list_folders", "list_files"):
      assert getattr(tc, name)(tmp_path) == getattr(jc, name)(tmp_path)
    assert tc.flatten([[1, 2], [3]]) == jc.flatten([[1, 2], [3]])
    lines = tc.read_file_lines(str(tmp_path / "f.txt"))
    assert lines == jc.read_file_lines(str(tmp_path / "f.txt"))
    got, want = tc.parse_camera_lines(lines), jc.parse_camera_lines(lines)
    assert got.youtube_id == want.youtube_id == "abc"
    np.testing.assert_array_equal(got.poses, want.poses)

  def test_show_torch_image(self, rng):
    plt = pytest.importorskip("matplotlib.pyplot")
    img = torch.from_numpy(rng.uniform(0, 255, (3, 4, 5)).astype(np.float32))
    tc.show_torch_image(img)
    plt.close("all")
