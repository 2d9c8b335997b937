"""The whole training step's share of the card's f32 peak (TF32 off):
the step's convolution and kernel operations from shapes
(``benchmark/counts.py``) times the steps, over the window, over
67 TFLOP/s."""

from benchmark import counts


def read(data):
  if not data.get("steps") or not data.get("window_s"):
    return None
  cfg = data["config"]
  flops = counts.train_step_flops(cfg["img_size"], cfg["num_planes"],
                                  cfg["batch_size"], cfg["vgg_resize"])
  return (100.0 * flops["total"] * data["steps"]
          / (data["window_s"] * counts.PEAK_F32_S))
