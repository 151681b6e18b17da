"""Orbit camera for interactive viewing (reference nerf/gui.py:10-52 OrbitCamera).

The port's own copy of ``palettenerf_tpu/gui/camera.py`` (host-only NumPy / SciPy).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


class OrbitCamera:
    def __init__(self, W: int, H: int, r: float = 2.0, fovy: float = 60.0):
        self.W = W
        self.H = H
        self.radius = r
        self.fovy = fovy
        self.center = np.zeros(3, np.float32)
        self.rot = Rotation.from_quat([0, 0, 0, 1])
        self.up = np.array([0, 1, 0], np.float32)

    @property
    def pose(self) -> np.ndarray:
        """c2w [4,4]: translate back radius along the rotated z."""
        res = np.eye(4, dtype=np.float32)
        res[2, 3] -= self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self.rot.as_matrix()
        res = rot @ res
        res[:3, 3] -= self.center
        return res

    @property
    def intrinsics(self):
        focal = self.H / (2 * np.tan(np.radians(self.fovy) / 2))
        return np.array([focal, focal, self.W // 2, self.H // 2])

    def orbit(self, dx: float, dy: float):
        side = self.rot.as_matrix()[:3, 0]
        self.rot = Rotation.from_rotvec(self.up * -dx * 0.1) * self.rot
        self.rot = Rotation.from_rotvec(side * -dy * 0.1) * self.rot

    def scale(self, delta: float):
        self.radius *= 1.1 ** -delta

    def pan(self, dx: float, dy: float, dz: float = 0):
        self.center += 5e-4 * self.rot.as_matrix()[:3, :3] @ np.array([dx, dy, dz])

    def set_pose(self, pose: np.ndarray):
        """Teleport to a dataset c2w pose (the reference's test-pose jump,
        palette/gui.py:401-427): decompose into rotation + look-at center so the
        orbit controls keep working from the new viewpoint."""
        pose = np.asarray(pose, np.float64)
        self.rot = Rotation.from_matrix(pose[:3, :3])
        eye = pose[:3, 3]
        fwd = pose[:3, :3] @ np.array([0.0, 0.0, 1.0])
        self.center = -(eye + fwd * self.radius).astype(np.float32)
        self.radius = float(self.radius)
