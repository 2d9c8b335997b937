"""The two backward render kernels' share of their roofline: the least
time of kernels A and B at the step's shapes (``benchmark/counts.py``),
times the launches the port counted, over their summed device time."""

from benchmark import counts, readers


def read(data):
  secs, n = readers.kernel_seconds(data, "rewarp_composite_vjp_kernel",
                                   "adjoint_warp_kernel")
  launches = data.get("launches") or {}
  if secs <= 0 or not n:
    return None
  cfg = data["config"]
  shape = (cfg["batch_size"], cfg["num_planes"], cfg["img_size"],
           cfg["img_size"])
  least = (launches.get("rewarp_composite_vjp", 0)
           * counts.rewarp_composite_vjp(*shape)[0]
           + launches.get("adjoint_warp", 0) * counts.adjoint_warp(*shape)[0])
  if least <= 0:
    return None
  return 100.0 * least / secs
