"""Constant-velocity / EMA pose predictor for session prefetch.

PyTorch-package copy of ``mpi_vision_tpu/serve/session/predictor.py``
(host numpy; the two differ in this docstring alone).

The predictor watches the session's observed camera poses and
extrapolates the path a few steps ahead so the prefetcher can map it
onto edge-cache view cells (`serve/edge/lattice.py`) and warm the ones
the client is about to enter.

Model: the relative step between consecutive poses is split into a
translation delta and a rotation delta; the translation delta is
EMA-smoothed (jittery hand-held paths should not fling prefetch off into
space) while the rotation delta is kept as the latest relative rotation.
Prediction applies the smoothed step repeatedly from the newest pose —
constant velocity in translation, constant angular velocity in rotation.
Pure function of the observed poses: no clocks, no randomness.
"""

from __future__ import annotations

import numpy as np


class TrajectoryPredictor:
    """EMA-smoothed constant-velocity extrapolation over 4x4 poses.

    ``alpha`` is the EMA weight on the newest translation delta
    (1.0 = pure constant-velocity on the last step).
    """

    def __init__(self, alpha: float = 0.5):
        alpha = float(alpha)
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._last: np.ndarray | None = None
        self._vel: np.ndarray | None = None  # EMA translation delta (3,)
        self._rot_step: np.ndarray | None = None  # latest relative rotation (3, 3)

    def observe(self, pose) -> None:
        pose = np.asarray(pose, dtype=np.float32)
        if pose.shape != (4, 4):
            raise ValueError(f"pose must be 4x4, got {pose.shape}")
        if self._last is not None:
            delta_t = pose[:3, 3] - self._last[:3, 3]
            if self._vel is None:
                self._vel = delta_t.astype(np.float64)
            else:
                self._vel = self.alpha * delta_t + (1.0 - self.alpha) * self._vel
            # Relative rotation R_step = R_new @ R_old^T (orthonormal, so
            # the transpose is the inverse).
            self._rot_step = pose[:3, :3].astype(np.float64) @ self._last[:3, :3].T
        self._last = pose.copy()

    def predict(self, steps: int) -> list[np.ndarray]:
        """Extrapolated poses 1..steps ahead; [] until two observations."""
        if steps <= 0 or self._last is None or self._vel is None:
            return []
        out: list[np.ndarray] = []
        pos = self._last[:3, 3].astype(np.float64)
        rot = self._last[:3, :3].astype(np.float64)
        rot_step = self._rot_step if self._rot_step is not None else np.eye(3)
        for _ in range(int(steps)):
            pos = pos + self._vel
            rot = rot_step @ rot
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = rot.astype(np.float32)
            pose[:3, 3] = pos.astype(np.float32)
            out.append(pose)
        return out

    def reset(self) -> None:
        self._last = None
        self._vel = None
        self._rot_step = None
