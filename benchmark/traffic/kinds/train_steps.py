"""Traffic kind ``train_steps``: the training step back to back.

Set-up builds one train state (the port's ``TrainConfig`` model and Adam,
with weights the benchmark made from the seed), the VGG loss network and
a pool of distinct batches on the card, and drives that state through
its first ``check_steps`` steps with the step the window uses, reading
the losses, the first gradient (from Adam's first moment) and the
parameters' change for the check; further warm-up steps follow. The
window then runs steps over the pool until ``--seconds`` have passed and
ends in a synchronise. Data decoding is not part of the cell.

After the window the program's state is freed and the reference
(``reference/stereo_mag.py``, float64) follows the same first steps from
the same weights and batches.
"""

from __future__ import annotations

import gc
import math
import time

from benchmark import common, inputs
from benchmark.reference import stereo_mag as ref

ADAM_B1 = 0.9


def _config(cfg):
  from mpi_vision_tpu_torch.config import DataConfig, TrainConfig

  return TrainConfig(
      data=DataConfig(img_size=cfg["img_size"], num_planes=cfg["num_planes"],
                      depth_near=cfg["depth_near"],
                      depth_far=cfg["depth_far"],
                      batch_size=cfg["batch_size"]),
      learning_rate=cfg["learning_rate"], vgg_resize=cfg["vgg_resize"],
      norm=cfg["norm"], compute_dtype=cfg["compute_dtype"])


def _batches(ctx, count: int) -> list:
  cfg, tr = ctx.config, ctx.traffic
  return inputs.train_batches(
      ctx.seed, count, cfg["img_size"], cfg["num_planes"],
      cfg["depth_near"], cfg["depth_far"], cfg["focal_over_width"],
      tr["pose"]["yaw_deg"], tr["pose"]["trans"], cfg["content_scale_px"],
      ctx.devices[0])


def leaf_norms(tensors: dict) -> dict:
  return {k: float(v.double().norm()) for k, v in tensors.items()}


def run(ctx) -> dict:
  torch, cfg, tr = ctx.torch, ctx.config, ctx.traffic
  dev = ctx.devices[0]
  if not ctx.on_cpu:
    from mpi_vision_tpu_torch.kernels import _build

    with ctx.setup.part("kernel_build"):
      built = _build.build(["render_fused", "render_fused_bwd"])
    if built:
      ctx.log(f"kernels built: {built}")
  from mpi_vision_tpu_torch.train.vgg import VGG16Features

  tcfg = _config(cfg)
  if ctx.options.get("control"):
    # The control: the nearest precision below f32 with TF32 off.
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
  else:
    tcfg.set_precision()
  with ctx.setup.part("weights_make"):
    weights = inputs.unet_weights(ctx.seed, cfg["num_planes"], dev)
    vgg_w = inputs.vgg_weights(ctx.seed, dev)
    batches = _batches(ctx, tr["pool"])
    ctx.sync()
  with ctx.setup.part("model_build"), torch.device(dev):
    state = tcfg.make_train_state(0, dev)
    state.model.load_state_dict(weights)
    vgg = VGG16Features(state_dict=vgg_w, dtype=tcfg.torch_dtype)
    del vgg_w
    step = tcfg.make_train_step(vgg, cfg["render_method"])
  n_check = tr["check_steps"]
  with ctx.setup.part("check_steps"):
    losses, first_grad = [], None
    for i in range(n_check):
      state, out = step(state, batches[i])
      losses.append(out["loss"])
      if i == 0:  # a leaf Adam holds no moment of got no gradient
        moments = state.optimizer.state
        first_grad = leaf_norms({
            n: (moments[p]["exp_avg"] / (1 - ADAM_B1) if p in moments
                else torch.zeros(1)) for n, p in
            state.model.named_parameters()})
    change = leaf_norms({n: p.detach() - weights[n]
                         for n, p in state.model.named_parameters()})
    losses = [float(l) for l in losses]
  del weights
  with ctx.setup.part("warmup_steps"):
    for i in range(tr["warmup_steps"]):
      state, out = step(state, batches[(n_check + i) % tr["pool"]])
    ctx.sync()
  setup_s = ctx.setup.close()
  from mpi_vision_tpu_torch.kernels import render_fused, render_fused_bwd

  launches0 = _launches(render_fused, render_fused_bwd)
  steps, last = 0, None
  with common.DeviceTrace(torch, ctx.devices, ctx.profiled) as dt:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
      state, out = step(state, batches[(n_check + steps) % tr["pool"]])
      last = out["loss"]
      steps += 1
  window_s = dt.window_s
  launches = {k: v - launches0[k]
              for k, v in _launches(render_fused, render_fused_bwd).items()}
  last = float(last) if last is not None else float("nan")
  peak = 0 if ctx.on_cpu else torch.cuda.max_memory_allocated(dev)
  del state, vgg, step, out, batches
  gc.collect()
  if not ctx.on_cpu:
    torch.cuda.empty_cache()
  checks = check(ctx, losses, first_grad, change)
  checks.append({"name": "window_loss_finite", "value": last,
                 "limit": "finite", "ok": math.isfinite(last)})
  data = {"window_s": window_s, "chips": 1, "config": cfg,
          "steps": steps, "launches": launches, "trace": dt.summary()}
  return {"attempted": steps, "failed": 0 if math.isfinite(last) else steps,
          "e2e": {"setup_s": setup_s, "train_steps_per_s": steps / window_s},
          "checks": checks, "memory_peak_bytes": peak, "data": data}


def _launches(render_fused, render_fused_bwd) -> dict:
  return {"render_fused": render_fused.render_mpi_fused.launches,
          "rewarp_composite_vjp":
              render_fused_bwd.rewarp_composite_vjp.launches,
          "adjoint_warp": render_fused_bwd.adjoint_warp.launches}


def gap(prog: dict, want: dict, keep=None) -> float:
  """The worst leaf's gap between the program's norm and the reference's,
  over the larger of that leaf's reference norm and the median leaf's."""
  names = [n for n in want if keep is None or n in keep]
  median = sorted(want[n] for n in names)[len(names) // 2]
  return max(abs(prog[n] - want[n]) / max(want[n], median, 1e-30)
             for n in names)


def check(ctx, losses, first_grad, change) -> list:
  """The reference follows the first steps in float64 from the same
  weights and batches; returns the three check readings."""
  torch, cfg, tr = ctx.torch, ctx.config, ctx.traffic
  dev = ctx.devices[0]
  f64 = torch.float64
  weights = {k: v.to(f64) for k, v in
             inputs.unet_weights(ctx.seed, cfg["num_planes"], dev).items()}
  vgg_w = {k: v.to(f64) for k, v in inputs.vgg_weights(ctx.seed, dev).items()}
  batches = [{k: v.to(f64) for k, v in b.items()}
             for b in _batches(ctx, tr["pool"])[:tr["check_steps"]]]
  out = ref.train(weights, vgg_w, batches, cfg["num_planes"],
                  cfg["learning_rate"], cfg["vgg_resize"], cfg["convention"])
  ref_grad = leaf_norms(out["first_grad"])
  ref_change = leaf_norms({k: out["params"][k] - weights[k]
                           for k in weights})
  median_grad = sorted(ref_grad.values())[len(ref_grad) // 2]
  moved = {n for n, g in ref_grad.items()
           if g >= tr["still_leaf_share"] * median_grad}
  loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, out["losses"]))
  lim = tr["limits"]
  readings = {"loss_gap": loss_gap, "grad_gap": gap(first_grad, ref_grad),
              "change_gap": gap(change, ref_change, moved)}
  ctx.log(f"train check: losses {losses} vs reference {out['losses']}; "
          f"{len(ref_grad) - len(moved)} still leaves left out of the "
          f"change: {sorted(set(ref_grad) - moved)}")
  return [{"name": k, "value": v, "limit": lim[k], "ok": v <= lim[k]}
          for k, v in readings.items()]
