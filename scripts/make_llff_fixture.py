"""A small LLFF-layout, Mip-NeRF-360-style JPEG scene: ``data_proc/proc_toys_llff/``.

The real LLFF and Mip-NeRF 360 scenes ship camera JPEGs with ``poses_bounds.npy``; none
is in the repository. This script renders ``make_proc_scene.py``'s analytic scene from an
inward-facing orbit and writes it in that layout, so the real-scene recipe
(``scripts/run_mip360.sh``: ``--bound 2``, ``--datatype mip360``) and the JPEG input path
run on data of the same kind:

- ``images/view_NN.jpg``: 32 views at 1000x750, composited on white, encoded by cv2 (the
  JAX loader's own codec) at quality 95 with 4:2:0 chroma; baseline for most views,
  progressive for views 5, 13, 21 and 29, 4:4:4 for view 2, restart interval 4 for
  view 7, so every decoding route of the loader is taken;
- ``poses_bounds.npy``: LLFF's [down right back] camera columns, translation, [H W focal]
  and near/far bounds (the inverse of ``llff2nerf.py``'s column swap);
- ``transforms_{train,val,test,video}.json``: ``llff2nerf.py --datatype mip360 --images
  images --downscale 3`` (training size 333x250, so x shrinks by a fractional factor);
- ``decoded.json``: the SHA-256 of cv2's decode of every image, in RGB order, which the
  port's decoder must reproduce.

Needs cv2 (encoding and the reference decode). Deterministic.

Usage: python scripts/make_llff_fixture.py [out_root] [--views 32]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "..", "tests"))
from llff2nerf import convert  # noqa: E402
from make_proc_scene import render_image  # noqa: E402
from synthetic import look_at_pose  # noqa: E402

H, W, FOV_DEG = 750, 1000, 50.0
CAM_RADIUS = 2.35
TARGET = (0.0, -0.1, 0.0)
PROGRESSIVE = (5, 13, 21, 29)
FULL_CHROMA = (2,)
RESTART = (7,)


def encode_params(k: int):
    import cv2

    sampling = (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444 if k in FULL_CHROMA
                else cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)
    return [cv2.IMWRITE_JPEG_QUALITY, 95,
            cv2.IMWRITE_JPEG_PROGRESSIVE, int(k in PROGRESSIVE),
            cv2.IMWRITE_JPEG_RST_INTERVAL, 4 if k in RESTART else 0,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]


def decoded_digest(path: str) -> str:
    """SHA-256 of cv2.imread(path, IMREAD_UNCHANGED) in RGB order."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return hashlib.sha256(np.ascontiguousarray(img[..., ::-1]).tobytes()).hexdigest()


def make_fixture(root: str, n_views: int = 32, seed: int = 0) -> str:
    import cv2

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rng = np.random.default_rng(seed)
    focal = 0.5 * W / np.tan(np.radians(FOV_DEG) / 2)
    rows, digests = [], {}
    for k in range(n_views):
        phi = 2 * np.pi * k / n_views + rng.uniform(-0.05, 0.05)
        theta = np.radians(rng.uniform(45, 70))  # polar angle from +y (up)
        eye = CAM_RADIUS * np.array([np.sin(theta) * np.cos(phi), np.cos(theta),
                                     np.sin(theta) * np.sin(phi)])
        pose = look_at_pose(eye, target=TARGET)
        rgba, _ = render_image(pose, H, W, FOV_DEG)
        rgb = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
        bgr = np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8)[..., ::-1]
        rel = os.path.join("images", f"view_{k:02d}.jpg")
        ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(bgr), encode_params(k))
        if not ok:
            raise RuntimeError(f"cv2 could not encode view {k}")
        with open(os.path.join(root, rel), "wb") as f:
            f.write(enc.tobytes())
        digests[rel] = decoded_digest(os.path.join(root, rel))
        # LLFF columns: [down, right, back] = [-up, right, back] of the OpenGL c2w
        cols = np.stack([-pose[:3, 1], pose[:3, 0], pose[:3, 2], pose[:3, 3],
                         np.array([H, W, focal])], 1)
        dist = np.linalg.norm(eye - np.asarray(TARGET))
        rows.append(np.concatenate([cols.reshape(-1), [dist - 1.2, dist + 1.2]]))
        print(f"[llff-fixture] view {k + 1}/{n_views}", flush=True)
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))
    convert(root, images="images", downscale=3, hold=8, datatype="mip360")
    with open(os.path.join(root, "decoded.json"), "w") as f:
        json.dump({"decoder": f"cv2 {cv2.__version__} imread IMREAD_UNCHANGED, RGB order",
                   "sha256": digests}, f, indent=1)
    return root


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=os.path.join(HERE, "..", "data_proc",
                                                            "proc_toys_llff"))
    ap.add_argument("--views", type=int, default=32)
    args = ap.parse_args()
    make_fixture(args.root, args.views)
