"""A Blender-layout scene as the reference reads it: ``transforms_<split>.json`` poses in
the Instant-NGP convention (torch-ngp ``nerf/provider.py``: axes cycled to (y, z, x), the
y and z columns negated, the translation scaled), the pinhole intrinsics from
``camera_angle_x``, the images (RGBA in [0, 1]) and the rays through pixel centres.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from .png import read_png


class Scene:
    def __init__(self, root: str, split: str, scale: float):
        self.root = root
        with open(os.path.join(root, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        self.files = [os.path.join(root, fr["file_path"] + ".png") for fr in meta["frames"]]
        poses = []
        for fr in meta["frames"]:
            m = np.asarray(fr["transform_matrix"], np.float32)
            p = np.eye(4, dtype=np.float32)
            p[:3, 0], p[:3, 1], p[:3, 2] = m[[1, 2, 0], 0], -m[[1, 2, 0], 1], -m[[1, 2, 0], 2]
            p[:3, 3] = m[[1, 2, 0], 3] * np.float32(scale)
            poses.append(p)
        self.poses = np.stack(poses)
        first = read_png(self.files[0])
        self.H, self.W = first.shape[:2]
        focal = self.W / (2.0 * math.tan(meta["camera_angle_x"] / 2.0))
        self.intrinsics = (focal, focal, self.W / 2.0, self.H / 2.0)
        self._images = {0: first}

    def image(self, i: int) -> np.ndarray:
        """[H, W, C] float32 in [0, 1]."""
        if i not in self._images:
            self._images[i] = read_png(self.files[i])
        return self._images[i].astype(np.float32) / 255.0

    def rays(self, i: int, pixels: torch.Tensor):
        """Origins and unit directions [N, 3] through the centres of flat ``pixels``."""
        fx, fy, cx, cy = self.intrinsics
        pose = torch.as_tensor(self.poses[i], device=pixels.device)
        u = (pixels % self.W).to(torch.float32) + 0.5
        v = (pixels // self.W).to(torch.float32) + 0.5
        d = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        d = d @ pose[:3, :3].T
        return pose[:3, 3].expand_as(d), d
