"""View-cell lattice: pose quantization + pose-error metrics.

A copy of ``mpi_vision_tpu/serve/edge/lattice.py``.

The edge cache's keying primitive. MPI rendering is a pure function of
(scene, params, pose), and real traffic clusters in pose space — a
thousand users orbiting one viewpoint land within millimeters and
fractions of a degree of each other. Quantizing poses onto a per-scene
lattice (translation cells of ``trans_cell`` scene units, rotation
buckets of ``rot_bucket_deg`` degrees on the axis-angle vector) turns
"close enough to share a frame" into an exact, hashable cache key.

Everything here is small host-side numpy (a cell is computed per request
on the HTTP path — no device work), and pure: the same pose
always lands in the same cell, so two router replicas and a CDN all
agree on the cache identity of a request.
"""

from __future__ import annotations

import math

import numpy as np

# Below this rotation angle (radians) the axis is numerically meaningless
# and the rotation vector is defined as exactly zero — keeping near-
# identity rotations in one stable bucket instead of jittering between
# sign-flipped axes.
_MIN_ANGLE = 1e-6


def rotation_vector(rot: np.ndarray) -> np.ndarray:
  """Axis-angle vector (radians) of a ``[3, 3]`` rotation matrix.

  The standard log map: direction is the rotation axis, norm is the
  angle in ``[0, pi]``. Near the identity the vector is zero; near pi
  the axis sign is inherently unstable (both signs describe the same
  rotation) — acceptable for bucketing, since MPI viewing poses live
  nowhere near a half-turn from the reference camera.
  """
  rot = np.asarray(rot, np.float64)
  cos = min(max((np.trace(rot) - 1.0) / 2.0, -1.0), 1.0)
  angle = math.acos(cos)
  if angle < _MIN_ANGLE:
    return np.zeros(3, np.float64)
  axis = np.array([rot[2, 1] - rot[1, 2],
                   rot[0, 2] - rot[2, 0],
                   rot[1, 0] - rot[0, 1]], np.float64)
  norm = np.linalg.norm(axis)
  if norm < _MIN_ANGLE:
    # angle ~ pi: the skew part vanishes; recover the axis from the
    # diagonal (sign ambiguity is fine for bucketing, see docstring).
    diag = np.clip((np.diag(rot) + 1.0) / 2.0, 0.0, 1.0)
    axis = np.sqrt(diag)
    norm = np.linalg.norm(axis)
    if norm < _MIN_ANGLE:
      return np.zeros(3, np.float64)
  return axis / norm * angle


def quantize_pose(pose: np.ndarray, trans_cell: float,
                  rot_bucket_deg: float) -> tuple[int, ...]:
  """The pose's view cell: 6 lattice indices ``(tx, ty, tz, rx, ry, rz)``.

  Translation components quantize at ``trans_cell`` scene units; the
  axis-angle rotation vector quantizes at ``rot_bucket_deg`` degrees per
  component. Floor quantization, so a cell is the half-open box
  ``[i * pitch, (i + 1) * pitch)`` along each axis.
  """
  pose = np.asarray(pose, np.float64)
  rot_bucket = math.radians(rot_bucket_deg)
  t = pose[:3, 3]
  r = rotation_vector(pose[:3, :3])
  return (math.floor(t[0] / trans_cell),
          math.floor(t[1] / trans_cell),
          math.floor(t[2] / trans_cell),
          math.floor(r[0] / rot_bucket),
          math.floor(r[1] / rot_bucket),
          math.floor(r[2] / rot_bucket))


def pose_error(pose_a: np.ndarray, pose_b: np.ndarray) -> tuple[float, float]:
  """``(translation_error, rotation_error_deg)`` between two ``[4, 4]`` poses.

  Translation error is the Euclidean camera-center distance; rotation
  error is the geodesic angle of ``R_a R_b^T``. Both are symmetric —
  the near-miss threshold check reads the same from either side.
  """
  pose_a = np.asarray(pose_a, np.float64)
  pose_b = np.asarray(pose_b, np.float64)
  trans = float(np.linalg.norm(pose_a[:3, 3] - pose_b[:3, 3]))
  rel = pose_a[:3, :3] @ pose_b[:3, :3].T
  cos = min(max((np.trace(rel) - 1.0) / 2.0, -1.0), 1.0)
  return trans, math.degrees(math.acos(cos))
