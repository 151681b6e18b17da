"""NeRF dataset provider: instant-ngp-style ``transforms*.json`` scenes.

Capability port of the reference ``nerf/provider.py`` (NeRFDataset):
- auto-detect colmap (``transforms.json``) vs blender (``transforms_train.json``) layout
  (provider.py:115-120), with ``all`` / ``trainval`` / ``traintest`` split merges
  (:123-152)
- ``nerf_matrix_to_ngp`` axis permutation + scale/offset (:19-27)
- colmap test split = slerp interpolation between two random poses (:169-185)
- uint16->uint8, BGR(A)->RGB(A), resize, alpha kept as mask (:213-231)
- intrinsics from fl_x/fl_y or camera_angle_x/y (:266-281)
- error-map state for importance sampling (:241-245)
- orbit-camera ``rand_poses`` for the CLIP mode (:57-91)

Host side is NumPy; ``collate`` returns numpy arrays (ray generation itself is in
``data/rays.py``). The PyTorch port's own copy of ``palettenerf_tpu/data/provider.py``:
images load through ``data/image.py:read_image`` (the native JPEG decoder and the
``zlib``/NumPy PNG reader) instead of ``cv2.imread``, and ``area_resize`` computes what
``cv2.resize(..., INTER_AREA)`` computes for any shrink. The per-split RNG seed uses a
stable ``crc32`` of the split name instead of Python's per-process ``hash``.
"""

from __future__ import annotations

import glob
import json
import math
import os
import zlib

import numpy as np

from ..utils import profiling
from .image import read_image
from .rays import gen_rays, sample_ray_indices


def nerf_matrix_to_ngp(pose: np.ndarray, scale: float = 0.33, offset=(0, 0, 0)) -> np.ndarray:
    """NeRF c2w -> instant-ngp convention: cycle axes (y,z,x), flip y/z columns,
    scale+offset translation (provider.py:19-27)."""
    perm = [1, 2, 0]
    new = np.eye(4, dtype=np.float32)
    new[:3, 0] = pose[perm, 0]
    new[:3, 1] = -pose[perm, 1]
    new[:3, 2] = -pose[perm, 2]
    new[:3, 3] = pose[perm, 3] * scale + np.asarray(offset, np.float32)
    return new


def rand_poses(rng: np.random.Generator, size: int, radius: float = 1.0,
               theta_range=(np.pi / 3, 2 * np.pi / 3), phi_range=(0, 2 * np.pi)) -> np.ndarray:
    """Random orbit-camera poses [size,4,4] (provider.py:57-91; y-up, look-at origin)."""
    thetas = rng.uniform(*theta_range, size)
    phis = rng.uniform(*phi_range, size)
    centers = np.stack(
        [radius * np.sin(thetas) * np.sin(phis),
         radius * np.cos(thetas),
         radius * np.sin(thetas) * np.cos(phis)], -1)

    def norm(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-10)

    forward = -norm(centers)
    up = np.tile(np.array([0.0, -1.0, 0.0], np.float32), (size, 1))
    right = norm(np.cross(forward, up))
    up = norm(np.cross(right, forward))
    poses = np.tile(np.eye(4, dtype=np.float32), (size, 1, 1))
    poses[:, :3, :3] = np.stack([right, up, forward], -1)
    poses[:, :3, 3] = centers
    return poses


_DBL_EPSILON = float(np.finfo(np.float64).eps)


def _area_taps(ssize: int, dsize: int):
    """cv2's ``computeResizeAreaTab`` for one axis: for each destination index, its
    (source index, float32 weight) pairs in cv2's summation order."""
    scale = 1.0 / (dsize / ssize)  # cv2: inv_scale = dsize / ssize, scale = 1 / inv_scale
    taps = []
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s2 = min(math.floor(f2), ssize - 1)
        s1 = min(math.ceil(f1), s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        taps.append(row)
    return taps


def _area_rows(x: np.ndarray, taps) -> np.ndarray:
    """float32 weighted sums over axis 0: each output row adds its taps in order, one
    float32 multiply and one float32 add per tap, as cv2's ``ResizeArea_Invoker``."""
    out = np.zeros((len(taps),) + x.shape[1:], np.float32)
    for k in range(max(len(t) for t in taps)):
        dst = [d for d, t in enumerate(taps) if len(t) > k]
        src = [t[k][0] for t in taps if len(t) > k]
        w = np.array([t[k][1] for t in taps if len(t) > k], np.float32)
        out[dst] += x[src] * w.reshape((-1,) + (1,) * (x.ndim - 1))
    return out


def area_resize(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """uint8/uint16 [h, w, C] -> [H, W, C]: ``cv2.resize(img, (W, H), INTER_AREA)`` for
    any shrink (H <= h, W <= w), fractional and unequal factors included.

    Integer factors on both axes take cv2's fast path: the block sum, rounded as
    ``(sum + 2) >> 2`` for 2x2 with 1, 3 or 4 channels, else as ``sum * float32(1 /
    area)`` rounded half to even. Other factors take cv2's area-overlap weights in
    float32, rows first, then columns. Enlarging raises (cv2 then interpolates
    bilinearly; no recipe enlarges)."""
    h, w, c = img.shape
    if H > h or W > w or H < 1 or W < 1:
        raise ValueError(f"area_resize shrinks only: cannot resize {h}x{w} to {H}x{W}")
    top = np.iinfo(img.dtype).max
    sy, sx = 1.0 / (H / h), 1.0 / (W / w)  # cv2's scales, and its test for the fast path
    fy, fx = round(sy), round(sx)
    if abs(sy - fy) < _DBL_EPSILON and abs(sx - fx) < _DBL_EPSILON:
        s = img.reshape(H, fy, W, fx, c).astype(np.int64).sum(axis=(1, 3))
        if fy == fx == 2 and c in (1, 3, 4):
            out = (s + 2) >> 2
        else:
            out = np.rint(s.astype(np.float32) * np.float32(1.0 / (fx * fy)))
    else:
        cols = _area_rows(np.ascontiguousarray(img.swapaxes(0, 1), np.float32), _area_taps(w, W))
        out = np.rint(_area_rows(np.ascontiguousarray(cols.swapaxes(0, 1)), _area_taps(h, H)))
    return np.clip(out, 0, top).astype(img.dtype)


def _slerp(r0: np.ndarray, r1: np.ndarray, t: float) -> np.ndarray:
    from scipy.spatial.transform import Rotation, Slerp

    rots = Rotation.from_matrix(np.stack([r0, r1]))
    return Slerp([0, 1], rots)(t).as_matrix()


class NeRFDataset:
    """Scene dataset. ``type`` in train/val/test/all/trainval/traintest/video."""

    def __init__(self, opt, type: str = "train", downscale: int = 1, n_test: int = 10):
        self.opt = opt
        self.type = type
        self.downscale = downscale
        self.root_path = opt.path
        self.training = type in ("train", "all", "trainval")
        self.num_rays = opt.num_rays if self.training else -1
        self.rand_pose = opt.rand_pose
        self.rng = np.random.default_rng(opt.seed + zlib.crc32(type.encode()) % 2 ** 16)

        if os.path.exists(os.path.join(self.root_path, "transforms.json")):
            self.mode = "colmap"
        elif os.path.exists(os.path.join(self.root_path, "transforms_train.json")):
            self.mode = "blender"
        else:
            raise FileNotFoundError(f"Cannot find transforms*.json under {self.root_path}")

        transform = self._load_transform(type)

        if "h" in transform and "w" in transform:
            self.H = int(transform["h"]) // downscale
            self.W = int(transform["w"]) // downscale
        else:
            self.H = self.W = None

        frames = transform["frames"]
        self.poses, self.images = self._load_frames(frames, type, n_test)

        if self.H is None or self.W is None:
            # pose-only splits (e.g. video trajectories without h/w metadata) fall back
            # to the GUI/render dims, like the reference's opt.H/opt.W plumbing
            self.H, self.W = opt.H, opt.W

        self.radius = float(np.linalg.norm(self.poses[:, :3, 3], axis=-1).mean())

        self.error_map = (
            np.ones((len(self.poses), 128 * 128), np.float32)
            if self.training and opt.error_map
            else None
        )

        self.intrinsics = self._load_intrinsics(transform)

    # ---------- loading ----------

    def _load_transform(self, type: str) -> dict:
        root = self.root_path
        if self.mode == "colmap":
            with open(os.path.join(root, "transforms.json")) as f:
                return json.load(f)
        if type == "all":
            transform = None
            for p in sorted(glob.glob(os.path.join(root, "*.json"))):
                with open(p) as f:
                    t = json.load(f)
                if transform is None:
                    transform = t
                else:
                    transform["frames"].extend(t["frames"])
            return transform
        if type == "trainval":
            with open(os.path.join(root, "transforms_train.json")) as f:
                transform = json.load(f)
            with open(os.path.join(root, "transforms_val.json")) as f:
                transform["frames"].extend(json.load(f)["frames"])
            return transform
        if type == "traintest":
            with open(os.path.join(root, "transforms_train.json")) as f:
                return json.load(f)
        with open(os.path.join(root, f"transforms_{type}.json")) as f:
            return json.load(f)

    def _load_frames(self, frames, type: str, n_test: int):
        opt = self.opt
        if self.mode == "colmap" and type == "test":
            # interpolate a smooth test path between two random poses (provider.py:169-185)
            f0, f1 = self.rng.choice(frames, 2, replace=False)
            p0 = nerf_matrix_to_ngp(np.asarray(f0["transform_matrix"], np.float32), opt.scale, opt.offset)
            p1 = nerf_matrix_to_ngp(np.asarray(f1["transform_matrix"], np.float32), opt.scale, opt.offset)
            poses = []
            for i in range(n_test + 1):
                ratio = np.sin(((i / n_test) - 0.5) * np.pi) * 0.5 + 0.5
                pose = np.eye(4, dtype=np.float32)
                pose[:3, :3] = _slerp(p0[:3, :3], p1[:3, :3], ratio)
                pose[:3, 3] = (1 - ratio) * p0[:3, 3] + ratio * p1[:3, 3]
                poses.append(pose)
            return np.stack(poses), None

        if self.mode == "colmap":
            if type == "train":
                frames = frames[1:]
            elif type == "val":
                frames = frames[:1]

        poses, images = [], []
        for f in frames:
            f_path = os.path.join(self.root_path, f["file_path"])
            if self.mode == "blender" and "." not in os.path.basename(f_path):
                f_path += ".png"
            if not os.path.exists(f_path) and type != "video":
                continue
            poses.append(
                nerf_matrix_to_ngp(np.asarray(f["transform_matrix"], np.float32), opt.scale, opt.offset)
            )
            if os.path.exists(f_path):
                images.append(self._read_image(f_path))
        poses = np.stack(poses)
        images = np.stack(images) if images else None
        return poses, images

    def _read_image(self, path: str) -> np.ndarray:
        """The JAX loader's rules in its order: 16-bit ``// 256`` when its maximum is over
        500, gray to three channels, then the area resize to the split's size."""
        img = read_image(path)
        if img.dtype == np.uint16 and img.max() > 500:
            img = (img // 256).astype(np.uint8)
        if self.H is None or self.W is None:
            self.H = img.shape[0] // self.downscale
            self.W = img.shape[1] // self.downscale
        if img.shape[-1] == 1:
            img = img.repeat(3, -1)
        if img.shape[0] != self.H or img.shape[1] != self.W:
            img = area_resize(img, self.H, self.W)
        return img.astype(np.float32) / 255.0

    def _load_intrinsics(self, transform) -> np.ndarray:
        d = self.downscale
        if "fl_x" in transform or "fl_y" in transform:
            fl_x = transform.get("fl_x", transform.get("fl_y")) / d
            fl_y = transform.get("fl_y", transform.get("fl_x")) / d
        elif "camera_angle_x" in transform or "camera_angle_y" in transform:
            fl_x = (
                self.W / (2 * np.tan(transform["camera_angle_x"] / 2))
                if "camera_angle_x" in transform else None
            )
            fl_y = (
                self.H / (2 * np.tan(transform["camera_angle_y"] / 2))
                if "camera_angle_y" in transform else None
            )
            fl_x = fl_x if fl_x is not None else fl_y
            fl_y = fl_y if fl_y is not None else fl_x
        else:
            raise RuntimeError("Failed to load focal length from transforms.json")
        cx = transform.get("cx", (self.W or 0) / 2) / (d if "cx" in transform else 1)
        cy = transform.get("cy", (self.H or 0) / 2) / (d if "cy" in transform else 1)
        if "cx" not in transform:
            cx, cy = self.W / 2, self.H / 2
        return np.array([fl_x, fl_y, cx, cy], np.float64)

    # ---------- batching ----------

    def __len__(self):
        size = len(self.poses)
        if self.training and self.rand_pose > 0:
            size += size // self.rand_pose
        return size

    @property
    def has_gt(self) -> bool:
        return self.images is not None

    def collate(self, index: int) -> dict:
        """One training/eval batch for image ``index`` (provider.py:284-330)."""
        with profiling.span("data.collate", unit=index):
            return self._collate(index)

    def _collate(self, index: int) -> dict:
        if self.rand_pose == 0 or index >= len(self.poses):
            # random orbit pose, low-res full frame for CLIP mode
            pose = rand_poses(self.rng, 1, radius=self.radius)[0]
            s = np.sqrt(self.H * self.W / self.num_rays)
            rH, rW = int(self.H / s), int(self.W / s)
            ro, rd = gen_rays(pose, self.intrinsics / s, rH, rW, None)
            return {"H": rH, "W": rW, "rays_o": ro, "rays_d": rd}

        pose = self.poses[index]
        out = {"H": self.H, "W": self.W, "index": index}
        if self.training:
            emap = self.error_map[index] if self.error_map is not None else None
            inds, inds_coarse = sample_ray_indices(
                self.rng, self.H, self.W, self.num_rays, emap,
                self.opt.patch_size, getattr(self.opt, "random_size", 0),
            )
            ro, rd = gen_rays(pose, self.intrinsics, self.H, self.W, inds)
            out.update(rays_o=ro, rays_d=rd, inds=inds)
            if inds_coarse is not None:
                out["inds_coarse"] = inds_coarse
            if self.images is not None:
                out["images"] = self.images[index].reshape(-1, self.images.shape[-1])[inds]
        else:
            ro, rd = gen_rays(pose, self.intrinsics, self.H, self.W, None)
            out.update(rays_o=ro, rays_d=rd)
            if self.images is not None:
                out["images"] = self.images[index]
        return out

    def iter_epoch(self):
        """Yield one collated batch per image (shuffled when training)."""
        order = np.arange(len(self))
        if self.training:
            self.rng.shuffle(order)
        for idx in order:
            yield self.collate(int(idx))

    def update_error_map(self, index: int, inds_coarse: np.ndarray, error: np.ndarray):
        """EMA update of the per-image error map (nerf/utils.py:556-578)."""
        if self.error_map is None:
            return
        em = self.error_map[index]
        em[inds_coarse] = 0.1 * em[inds_coarse] + 0.9 * error
        self.error_map[index] = em
