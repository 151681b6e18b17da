"""A small forward-facing LLFF JPEG scene: ``data_proc/proc_toys_ff/``.

The LLFF recipe (``scripts/run_llff.sh`` with ``configs_llff/*.sh``) expects a handheld
forward-facing capture: ``poses_bounds.npy`` at the camera's full resolution, the images
downscaled 8x in ``images_8/``, and ``llff2nerf.py --datatype llff`` to turn them into
transforms. No real LLFF scene is in the repository. This script renders
``make_proc_scene.py``'s analytic toys from one side, in front of a textured backdrop, and
writes them in that layout:

- cameras: ``N_VIEWS`` (20, as fern) on a jittered 5 x 4 grid in a plane ``CAM_DIST`` (2.3)
  from the toys, each looking at ``TARGET``, so that their optical axes meet there
  (``llff2nerf.py``'s closest-point recentring needs pairs that are not parallel);
- ``poses_bounds.npy``: LLFF's [down right back] camera columns, translation, [H W focal] at
  fern's full resolution (4032x3024, focal 3260.526) and each view's nearest and farthest
  depth;
- ``images_8/view_NN.jpg``: each view at 504x378 (2x2 rays per pixel, box-averaged): the
  toys over a backdrop plane ``BACKDROP_DIST`` behind the target, square to the cameras' mean
  axis (a colour gradient under a checker, lit by the scene's lights, with the toys'
  shadows), so that every frame is filled edge to edge as an LLFF frame is; encoded by cv2
  (the JAX loader's codec) at quality 90 with 4:2:0 chroma;
- ``transforms_{train,val,test,video}.json``: ``llff2nerf.convert(root, images="images_8",
  downscale=8, hold=8, datatype="llff")``, the real recipe's route: test views 0, 8, 16, the
  val view 0, 17 train views and 120 ``spiral_path`` video poses;
- ``decoded.json``: the SHA-256 of cv2's decode of every image, in RGB order.

Where it lands (``placement``, printed and checked at the end of ``main``). ``llff2nerf``
recentres on ``TARGET`` and scales the cameras to a mean distance of 4 from it; fern's
``--scale 0.25 --offset 0 0 1.5`` then put the cameras 0.95-1.05 from the target, at z
0.45-0.55 of the provider's frame, the target at (0, 0, 1.5), the toys within z 1.1-1.9 and
the backdrop at z 1.96: all inside ``--bound 2``'s box. Without the offset (the recipe's
extract block) the whole scene sits 1.5 lower in z (the cameras at z -1.05 to -0.95).

``llff2nerf`` fixes only the up direction, so the heading of the cameras in its frame comes
from the world frame of the poses. A capture whose world frame looks along its cameras'
forward axis (COLMAP's first camera: x right, y down, z forward) lands with its cameras at z
2.4-2.5 under the offset, outside the box (measured with this fixture's cameras turned
round); this world frame looks the other way, so that the cameras sit inside the box.

Needs cv2 (encoding and the reference decode). Deterministic; ~1 min.

Usage: python scripts/make_ff_fixture.py [out_root]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "..", "tests"))
from llff2nerf import convert  # noqa: E402
from make_llff_fixture import decoded_digest  # noqa: E402
from make_proc_scene import AMBIENT, LIGHTS, _norm, _trace_t, render_image  # noqa: E402
from synthetic import look_at_pose  # noqa: E402

FULL_H, FULL_W, FULL_FOCAL = 3024, 4032, 3260.526  # fern's poses_bounds.npy
DOWNSCALE = 8                                      # images_8: 504x378
N_VIEWS, GRID = 20, (5, 4)
TARGET = np.array([0.0, -0.1, 0.0])
CAM_DIST = 2.3            # the camera plane, on the -z side of the toys
CAM_SPREAD = (0.7, 0.45)  # half-extents of the camera grid in x and y
CAM_HEIGHT = 0.35         # the grid's centre above the target
BACKDROP_DIST = 1.1       # the backdrop plane's distance behind the target
SUPERSAMPLE = 2
JPEG_QUALITY = 90
RECIPE = dict(scale=0.25, offset=(0.0, 0.0, 1.5), bound=2.0)  # configs_llff/fern.sh


def camera_poses(seed: int = 0) -> list:
    """N_VIEWS c2w poses (OpenGL: x right, y up, z back) on the jittered camera grid, each
    looking at TARGET."""
    rng = np.random.default_rng(seed)
    nx, ny = GRID
    poses = []
    for k in range(N_VIEWS):
        gx, gy = k % nx, k // nx
        eye = TARGET + np.array([
            CAM_SPREAD[0] * (2 * gx / (nx - 1) - 1) + rng.uniform(-0.06, 0.06),
            CAM_HEIGHT + CAM_SPREAD[1] * (2 * gy / (ny - 1) - 1) + rng.uniform(-0.05, 0.05),
            -CAM_DIST + rng.uniform(-0.05, 0.05)])
        poses.append(look_at_pose(eye, target=TARGET))
    return poses


def mean_axis(poses) -> np.ndarray:
    """The cameras' mean forward axis (unit)."""
    return _norm(np.mean([-p[:3, 2] for p in poses], 0))


def backdrop(ro, rd, axis):
    """Colour and ray distance of the backdrop where the rays [N, 3] meet it: the plane
    BACKDROP_DIST behind TARGET along ``axis``, facing the cameras. A gradient from teal to
    sand across it, toward rose upward, under a 0.3-unit checker that darkens every other
    square; Lambertian under the scene's lights and ambient term, in the toys' shadows."""
    n = -axis
    t = ((TARGET + BACKDROP_DIST * axis - ro) @ n) / np.minimum(rd @ n, -1e-9)
    p = ro + t[:, None] * rd
    side = _norm(np.cross(axis, [0.0, 1.0, 0.0]))
    up = np.cross(side, axis)
    a, b = (p - TARGET) @ side, (p - TARGET) @ up
    u = np.clip(0.5 + a / 5.0, 0, 1)[:, None]
    v = np.clip(0.5 + b / 4.0, 0, 1)[:, None]
    teal, sand, rose = (np.array(c) for c in ((0.20, 0.55, 0.55), (0.85, 0.75, 0.55),
                                              (0.75, 0.40, 0.45)))
    albedo = (1 - u) * teal + u * sand
    albedo = (1 - v) * albedo + v * (0.6 * albedo + 0.4 * rose)
    checker = (np.floor(a / 0.3) + np.floor(b / 0.3)) % 2 == 0
    albedo = np.where(checker[:, None], albedo, 0.7 * albedo)
    col = AMBIENT * albedo
    for ldir, inten in LIGHTS:
        lv = _norm(np.asarray(ldir, np.float64))
        diff = float(lv @ n)
        if diff <= 0.0:
            continue
        t_sh, _ = _trace_t(p + n * 1e-3, np.broadcast_to(lv, p.shape))
        col = col + inten * diff * (~np.isfinite(t_sh))[:, None] * albedo
    return np.clip(col, 0.0, 1.0), t


def render_view(pose, axis, H, W, focal):
    """The view [H, W, 3] in [0, 1] (the toys of ``make_proc_scene.render_image`` over the
    backdrop, SUPERSAMPLE^2 rays per pixel, box-averaged) and the nearest and farthest depth
    along the camera's axis of what it sees."""
    s = SUPERSAMPLE
    rgba, _ = render_image(pose, H * s, W * s, np.degrees(2 * np.arctan(0.5 * W / focal)))
    f = focal * s
    i, j = np.meshgrid(np.arange(W * s) + 0.5, np.arange(H * s) + 0.5)
    dirs = _norm(np.stack([(i - W * s / 2) / f, -(j - H * s / 2) / f, -np.ones_like(i)], -1))
    dirs = dirs.reshape(-1, 3)
    rd = dirs @ pose[:3, :3].T
    ro = np.broadcast_to(pose[:3, 3], rd.shape)
    bg, t_bg = backdrop(ro, rd, axis)
    t_obj, _ = _trace_t(ro, rd)
    alpha = rgba[..., 3:].reshape(-1, 1)
    rgb = (rgba[..., :3].reshape(-1, 3) * alpha + bg * (1.0 - alpha)).reshape(H, s, W, s, 3)
    depth = np.minimum(t_obj, t_bg) * -dirs[:, 2]
    return rgb.mean((1, 3)), float(depth.min()), float(depth.max())


def make_fixture(root: str) -> str:
    import cv2

    os.makedirs(os.path.join(root, "images_8"), exist_ok=True)
    H, W = FULL_H // DOWNSCALE, FULL_W // DOWNSCALE
    focal = FULL_FOCAL / DOWNSCALE
    poses = camera_poses()
    axis = mean_axis(poses)
    rows, digests = [], {}
    for k, pose in enumerate(poses):
        rgb, near, far = render_view(pose, axis, H, W, focal)
        bgr = np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8)[..., ::-1]
        rel = os.path.join("images_8", f"view_{k:02d}.jpg")
        ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(bgr), [
            cv2.IMWRITE_JPEG_QUALITY, JPEG_QUALITY,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
        if not ok:
            raise RuntimeError(f"cv2 could not encode view {k}")
        with open(os.path.join(root, rel), "wb") as f:
            f.write(enc.tobytes())
        digests[rel] = decoded_digest(os.path.join(root, rel))
        # LLFF columns: [down, right, back] = [-up, right, back] of the OpenGL c2w, and the
        # full-resolution [H, W, focal]
        cols = np.stack([-pose[:3, 1], pose[:3, 0], pose[:3, 2], pose[:3, 3],
                         np.array([FULL_H, FULL_W, FULL_FOCAL])], 1)
        rows.append(np.concatenate([cols.reshape(-1), [near, far]]))
        print(f"[ff-fixture] view {k + 1}/{N_VIEWS}: depth {near:.3f}-{far:.3f}", flush=True)
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows))
    convert(root, images="images_8", downscale=DOWNSCALE, hold=8, datatype="llff")
    with open(os.path.join(root, "decoded.json"), "w") as f:
        json.dump({"decoder": f"cv2 {cv2.__version__} imread IMREAD_UNCHANGED, RGB order",
                   "sha256": digests}, f, indent=1)
    return root


def placement(root: str, scale: float = RECIPE["scale"], offset=RECIPE["offset"]) -> dict:
    """Where the cameras, the target, the toys' box and the backdrop land in the provider's
    frame (``nerf_matrix_to_ngp``: the transforms' (x, y, z) -> (y, z, x) * scale + offset).

    ``llff2nerf`` moves the cameras by a similarity (a rotation, one scale, a shift); it is
    solved here from the world and transformed camera centres (Umeyama), and applied to
    the scene's points: the corners of the toys' box (``make_proc_scene``'s ground slab and
    objects: x, z in [-0.85, 0.85], y in [-0.46, 0.56]) and, for every view, the backdrop's
    points at the corners of the frame."""
    poses = camera_poses()
    n = len(poses)
    test = list(range(0, n, 8))
    order = [i for i in range(n) if i not in test] + test  # train, then test frames
    moved = []
    for split in ("train", "test"):
        with open(os.path.join(root, f"transforms_{split}.json")) as f:
            moved += [np.asarray(fr["transform_matrix"])[:3, 3] for fr in json.load(f)["frames"]]
    src = np.stack([poses[i][:3, 3] for i in order])
    dst = np.stack(moved)
    ms, md = src.mean(0), dst.mean(0)
    u, sv, vt = np.linalg.svd((dst - md).T @ (src - ms))
    rot = u @ vt
    s = sv.sum() / ((src - ms) ** 2).sum()
    shift = md - s * rot @ ms
    residual = float(np.abs(src @ rot.T * s + shift - dst).max())

    def ngp(points):
        p = np.asarray(points, np.float64) @ rot.T * s + shift
        return p[..., [1, 2, 0]] * scale + np.asarray(offset)

    axis = mean_axis(poses)
    H, W = FULL_H // DOWNSCALE, FULL_W // DOWNSCALE
    focal = FULL_FOCAL / DOWNSCALE
    corners = np.array([[(i - W / 2) / focal, -(j - H / 2) / focal, -1.0]
                        for i in (0, W) for j in (0, H)])
    back = []
    for pose in poses:
        rd = _norm(corners) @ pose[:3, :3].T
        _, t = backdrop(np.broadcast_to(pose[:3, 3], rd.shape), rd, axis)
        back.append(pose[:3, 3] + t[:, None] * rd)
    box = np.array([[x, y, z] for x in (-0.85, 0.85) for y in (-0.46, 0.56)
                    for z in (-0.85, 0.85)])
    out = {"residual": residual, "cameras": ngp(src), "target": ngp(TARGET),
           "toys": ngp(box), "backdrop": ngp(np.concatenate(back))}
    out["inside"] = bool(all(np.abs(v).max() < RECIPE["bound"]
                             for k, v in out.items() if k not in ("residual", "inside")))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=os.path.join(HERE, "..", "data_proc",
                                                            "proc_toys_ff"))
    args = ap.parse_args(argv)
    make_fixture(args.root)
    for offset in (RECIPE["offset"], (0.0, 0.0, 0.0)):
        p = placement(args.root, offset=offset)
        print(f"[ff-fixture] --scale {RECIPE['scale']} --offset {offset}: similarity "
              f"residual {p['residual']:.1e}; target {np.round(p['target'], 3).tolist()}")
        for k in ("cameras", "toys", "backdrop"):
            print(f"  {k}: x {p[k][:, 0].min():.3f}..{p[k][:, 0].max():.3f}, y "
                  f"{p[k][:, 1].min():.3f}..{p[k][:, 1].max():.3f}, z "
                  f"{p[k][:, 2].min():.3f}..{p[k][:, 2].max():.3f}")
        if not p["inside"]:
            raise SystemExit(f"the scene leaves --bound {RECIPE['bound']}'s box")


if __name__ == "__main__":
    main()
