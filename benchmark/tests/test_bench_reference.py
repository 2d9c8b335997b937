"""The plain reference held against the port's outputs at small sizes on
the CPU (the port's kernels run their plain versions there)."""

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import render as ref_render
from benchmark.reference import stereo_mag as ref

from mpi_vision_tpu_torch.core import render as port_render
from mpi_vision_tpu_torch.core.sampling import Convention
from mpi_vision_tpu_torch.models import stereo_mag as port_model
from mpi_vision_tpu_torch.train import loss as port_loss
from mpi_vision_tpu_torch.train.vgg import VGG16Features

F64 = torch.float64


@pytest.mark.parametrize("convention,hw", [("exact", (24, 40)),
                                           ("ref_homography", (32, 32))])
def test_render_matches_the_port(convention, hw):
  h, w = hw
  planes = inputs.scene(5, 0, h, w, 6, 4, "cpu")            # [P, 4, H, W]
  depths = inputs.inv_depths(1.0, 100.0, 6)
  k = inputs.intrinsics(h, w, 0.5)
  poses = inputs.poses(5, 4, 10.0, 0.05, 0.5)
  got = port_render.render_views(
      planes.permute(2, 3, 0, 1).contiguous(), torch.from_numpy(poses),
      torch.from_numpy(depths), torch.from_numpy(k),
      convention=Convention(convention), method="fused_pallas")
  for v in range(len(poses)):
    want = ref_render.render(planes.permute(0, 2, 3, 1), poses[v], depths, k,
                             convention)
    assert (got[v].to(F64) - want).abs().max() < 1e-5


def test_render_reads_zero_outside_the_image():
  planes = torch.ones(1, 8, 8, 4, dtype=F64)
  pose = np.eye(4, dtype=np.float32)
  pose[0, 3] = 0.5          # fx 4 at depth 1: the plane moves by 2 pixels
  out = ref_render.render(planes, pose, [1.0], inputs.intrinsics(8, 8, 0.5),
                          "exact")
  # Target column x samples source column x - 2.
  assert (out[:, :2] == 0.0).all() and (out[:, 2:] == 1.0).all()


def test_unet_and_mpi_assembly_match_the_port():
  weights = inputs.unet_weights(3, 4, "cpu")
  model = port_model.StereoMagnificationModel(num_planes=4)
  model.load_state_dict(weights)
  x = inputs.train_batches(3, 1, 32, 4, 1.0, 100.0, 0.5, 10.0, 0.05, 4,
                           "cpu")[0]
  got = model(x["net_input"])
  want = ref.unet_forward({k: v.to(F64) for k, v in weights.items()},
                          x["net_input"].to(F64), 4)
  assert (got.to(F64) - want).abs().max() < 1e-4
  mpi_got = port_model.mpi_from_net_output(got, x["ref_img"])
  mpi_want = ref.mpi_from_net_output(got.to(F64), x["ref_img"].to(F64))
  assert (mpi_got.to(F64) - mpi_want).abs().max() < 1e-6


@pytest.mark.parametrize("resize", [None, 24])
def test_vgg_features_and_perceptual_loss_match_the_port(resize):
  vgg_w = inputs.vgg_weights(4, "cpu")
  vgg = VGG16Features(state_dict=vgg_w)
  gen = torch.Generator().manual_seed(0)
  out = torch.rand(1, 32, 32, 3, generator=gen) * 2 - 1
  tgt = torch.rand(1, 32, 32, 3, generator=gen) * 2 - 1
  w64 = {k: v.to(F64) for k, v in vgg_w.items()}
  for a, b in zip(vgg(out.permute(0, 3, 1, 2)),
                  ref.vgg_features(w64, out.permute(0, 3, 1, 2).to(F64))):
    assert (a.to(F64) - b).abs().max() <= 1e-4 * b.abs().max()
  got = port_loss.perceptual_loss(out, tgt, vgg, resize)
  want = ref.perceptual_loss(out.to(F64), tgt.to(F64), w64, resize)
  assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_adam_steps_match_the_port():
  from mpi_vision_tpu_torch.config import DataConfig, TrainConfig

  cfg = TrainConfig(data=DataConfig(img_size=32, num_planes=4),
                    vgg_resize=32)
  weights = inputs.unet_weights(9, 4, "cpu")
  vgg_w = inputs.vgg_weights(9, "cpu")
  batches = inputs.train_batches(9, 2, 32, 4, 1.0, 100.0, 0.5, 10.0, 0.05, 4,
                                 "cpu")
  state = cfg.make_train_state(0, "cpu")
  state.model.load_state_dict(weights)
  step = cfg.make_train_step(VGG16Features(state_dict=vgg_w), "fused_pallas")
  losses = [float(step(state, b)[1]["loss"]) for b in batches]
  out = ref.train({k: v.to(F64) for k, v in weights.items()},
                  {k: v.to(F64) for k, v in vgg_w.items()},
                  [{k: v.to(F64) for k, v in b.items()} for b in batches],
                  4, cfg.learning_rate, 32, "ref_homography")
  assert np.allclose(losses, out["losses"], rtol=1e-5)
  # Leaf by leaf, the norm of the change: a bias ahead of InstanceNorm has a
  # gradient of rounding noise whose sign Adam's first step turns into
  # +-lr, so its elements are not compared one by one, and leaves that
  # the reference does not move are left out.
  grads = {k: float(v.norm()) for k, v in out["first_grad"].items()}
  median = sorted(grads.values())[len(grads) // 2]
  for name, p in state.model.named_parameters():
    if grads[name] < 1e-3 * median:
      continue
    got = float((p.detach().to(F64) - weights[name].to(F64)).norm())
    want = float((out["params"][name] - weights[name].to(F64)).norm())
    assert abs(got - want) <= 1e-3 * want, name
