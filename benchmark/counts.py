"""Operations and bytes of the measured work, computed from shapes.

The yardstick of every roofline share and every ``mfu`` metric. It imports
nothing of the measured program, so a later change to the program cannot
change what its work is counted as. The per-sample operation counts are
frozen here from the kernels' own notes as they stood when the benchmark
was defined:

  * the fused render, 67 f32 operations per output pixel, plane and view:
    homography 6 mul + 6 add + 2 div + the zero test (15), floor, fraction
    and 1 - fraction for x and y (6), the bilinear blend of 4 channels
    (36), the composite (10);
  * kernel A (re-warp and composite VJP), 82;
  * kernel B (warp transpose), 57.

Bytes count each input read once and each output written once. Peaks are
the published H100 SXM figures (NVIDIA data sheet, dense, 700 W): 3.35 TB/s
of HBM and 67 TFLOP/s of f32 outside the tensor cores, the rate of an f32
step with TF32 off.
"""

from __future__ import annotations

from benchmark.reference import stereo_mag

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
FLOPS_RENDER = 67
FLOPS_A = 82
FLOPS_B = 57
F32 = 4


def least_s(nbytes: float, ops: float) -> tuple[float, str]:
  """The least time the card could take: the larger of bytes over the HBM
  rate and f32 operations over the f32 peak, and which of the two it is."""
  t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
  return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _scene_bytes(planes: int, height: int, width: int) -> int:
  return planes * height * width * 4 * F32


def render(views: int, planes: int, height: int, width: int,
           shared: bool = True) -> tuple[float, str]:
  """One launch of the fused render: ``views`` views of one resident scene
  (``shared``) or of one scene each. Reads the scene(s) and the
  homographies, writes the RGB frames."""
  scenes = 1 if shared else views
  nbytes = (scenes * _scene_bytes(planes, height, width)
            + views * planes * 9 * F32 + views * height * width * 3 * F32)
  return least_s(nbytes, views * planes * height * width * FLOPS_RENDER)


def rewarp_composite_vjp(views: int, planes: int, height: int, width: int,
                         shared: bool = False) -> tuple[float, str]:
  """Kernel A: reads the scene(s), the homographies and the frames'
  gradient, writes the warped planes' gradient, one stack a view."""
  scenes = 1 if shared else views
  nbytes = (scenes * _scene_bytes(planes, height, width)
            + views * planes * 9 * F32 + views * height * width * 3 * F32
            + views * _scene_bytes(planes, height, width))
  return least_s(nbytes, views * planes * height * width * FLOPS_A)


def adjoint_warp(views: int, planes: int, height: int, width: int,
                 shared: bool = False) -> tuple[float, str]:
  """Kernel B: reads the warped planes' gradient and the homographies,
  writes the planes' gradient (one scene, or one a view)."""
  scenes = 1 if shared else views
  nbytes = (views * _scene_bytes(planes, height, width)
            + views * planes * 9 * F32
            + scenes * _scene_bytes(planes, height, width))
  return least_s(nbytes, views * planes * height * width * FLOPS_B)


def conv2d_flops(batch: int, cin: int, cout: int, h_out: int, w_out: int,
                 kernel: int) -> int:
  """Multiply-adds of a convolution, two operations each."""
  return 2 * batch * cout * h_out * w_out * cin * kernel * kernel


def conv_transpose2d_flops(batch: int, cin: int, cout: int, h_in: int,
                           w_in: int, kernel: int) -> int:
  """Every input pixel scatters ``cout * k * k`` multiply-adds."""
  return 2 * batch * cin * h_in * w_in * cout * kernel * kernel


def unet_layer_flops(img: int, planes: int, batch: int = 1) -> list[tuple]:
  """``(name, forward FLOPs)`` of each U-Net convolution at ``img`` px."""
  out, s = [], img  # the layers run in this order; concats keep the size
  for layer in stereo_mag.unet_shapes(planes):
    if layer["transpose"]:
      flops = conv_transpose2d_flops(batch, layer["cin"], layer["cout"],
                                     s, s, layer["kernel"])
      s *= 2
    else:
      s //= layer["stride"]
      flops = conv2d_flops(batch, layer["cin"], layer["cout"], s, s,
                           layer["kernel"])
    out.append((layer["name"], flops))
  return out


def vgg_layer_flops(size: int, batch: int = 1) -> list[tuple]:
  """``(torchvision index, forward FLOPs)`` of the VGG convolutions to
  relu4_3 at ``size`` px."""
  out, s = [], size
  for layer in stereo_mag.vgg_shapes():
    out.append((layer["index"],
                conv2d_flops(batch, layer["cin"], layer["cout"], s, s, 3)))
    if layer["pool"]:
      s //= 2
  return out


def train_step_flops(img: int, planes: int, batch: int = 1,
                     vgg_resize: int | None = None) -> dict:
  """Convolution and kernel operations of one training step.

  U-Net: forward, weight gradients of every layer, input gradients of
  every layer but the first (the net input needs none). VGG (frozen): the
  forward of the rendered view and of the target, and the input-gradient
  pass of the rendered view's branch. Render forward, kernel A and kernel
  B at one view a batch element. Normalisation, activations, pooling, the
  loss and Adam are left out: they are elementwise and small beside these.
  """
  unet = unet_layer_flops(img, planes, batch)
  unet_fwd = sum(f for _, f in unet)
  unet_bwd = unet_fwd + (unet_fwd - unet[0][1])
  vgg_fwd = sum(f for _, f in vgg_layer_flops(vgg_resize or img, batch))
  samples = batch * planes * img * img
  out = {"unet": unet_fwd + unet_bwd, "vgg": 3 * vgg_fwd,
         "render": samples * FLOPS_RENDER, "rewarp_composite_vjp":
         samples * FLOPS_A, "adjoint_warp": samples * FLOPS_B}
  out["total"] = sum(out.values())
  return out
