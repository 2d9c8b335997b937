"""Near-miss frame warping: one homography from a cached frame's pose.

PyTorch counterpart of ``mpi_vision_tpu/serve/edge/warp.py``. A finished
frame rendered at pose A is one plane-induced homography warp away from a
good approximation of nearby pose B: instead of re-running the full
P-plane composite, the cached RGB frame is treated as a single textured
plane at a representative scene depth and resampled through the
machinery the renderer itself uses (``core.render.plane_homographies`` ->
``warp_coordinates`` -> ``core.sampling.bilinear_sample``).

The relative pose is computed in float64 on the host, as in the JAX
package; the resample runs on the device the caller names (the serving
engine's), in plain PyTorch — it is XLA code in the JAX package, not a
Pallas kernel — and the frame comes back to the host.

The approximation error is parallax the single plane cannot express plus
zero-filled disocclusions at the frame border; both grow with pose
distance, which is why the serving layer only warps under its pose-error
thresholds and renders for real past them.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_vision_tpu_torch.core import render, sampling
from mpi_vision_tpu_torch.debug import named_scope


def relative_pose(src_pose: np.ndarray, tgt_pose: np.ndarray) -> np.ndarray:
  """The transform taking points in the cached camera's frame to the
  target camera's frame — the "tgt_pose" the renderer's homography solver
  expects when the cached frame plays the role of the reference MPI —
  computed in float64 on the host, as the JAX package does."""
  src = np.asarray(src_pose, np.float32)
  tgt = np.asarray(tgt_pose, np.float32)
  return (tgt.astype(np.float64) @ np.linalg.inv(
      src.astype(np.float64))).astype(np.float32)


def warp_tensor(img: torch.Tensor, rel: torch.Tensor,
                intrinsics: torch.Tensor, plane_depth: float) -> torch.Tensor:
  """The resample on ``img``'s device: ``[H, W, 3]`` frame, ``[4, 4]``
  relative pose, ``[3, 3]`` intrinsics -> ``[H, W, 3]``."""
  with named_scope("edge/warp"):
    h, w, _ = img.shape
    homs = render.plane_homographies(
        rel[None],
        torch.tensor([plane_depth], dtype=torch.float32, device=img.device),
        intrinsics[None])                                   # [1, 1, 3, 3]
    # EXACT, not the reference-parity REF_HOMOGRAPHY: the cached frame is
    # a finished image, and resampling it must be the identity at zero
    # pose error.
    coords = render.warp_coordinates(
        homs, h, w, convention=sampling.Convention.EXACT)   # [1,1,H,W,2]
    return sampling.bilinear_sample(img[None, None], coords)[0, 0]


def warp_frame(frame: np.ndarray, src_pose: np.ndarray, tgt_pose: np.ndarray,
               intrinsics: np.ndarray, plane_depth: float,
               device="cuda") -> np.ndarray:
  """Resample a cached ``[H, W, 3]`` frame from ``src_pose`` to ``tgt_pose``.

  ``src_pose``/``tgt_pose`` are the serving pose convention (reference-
  camera -> camera transforms); ``plane_depth`` is the representative
  depth the frame is treated as living at. Regions the source frame never
  saw come back zero (``bilinear_sample``'s padding). Returns a host
  ``[H, W, 3]`` float32 frame; ``device`` is where the resample runs
  (the card unless the caller passes "cpu").
  """
  dev = torch.device(device)
  out = warp_tensor(
      torch.tensor(np.asarray(frame, np.float32), device=dev),
      torch.from_numpy(relative_pose(src_pose, tgt_pose)).to(dev),
      torch.tensor(np.asarray(intrinsics, np.float32), device=dev),
      plane_depth)
  return out.cpu().numpy()
