"""Device milliseconds a step of convolution kernels (U-Net and VGG,
forward and backward), matched by name in the profiler's trace."""

from benchmark import readers

# Name fragments of cuDNN's and PyTorch's convolution kernels on Hopper.
MATCH = ("conv", "xmma", "implicit_gemm", "implicit_convolve", "wgrad",
         "dgrad", "fprop", "winograd", "cudnn")


def read(data):
  secs, n = readers.kernel_seconds(data, *MATCH)
  if secs <= 0 or not data.get("steps"):
    return None
  return 1e3 * secs / data["steps"]
