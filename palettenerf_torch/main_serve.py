"""Serving CLI of the PyTorch port: trained palette checkpoint -> baked volume ->
shear-warp sweep frames with live palette edits, on an NVIDIA GPU.

    python -m palettenerf_torch.main_serve deploy/proc_toys --data data_proc/proc_toys --bench
    python -m palettenerf_torch.main_serve deploy/proc_toys --edit_basis 0 --out frame.png

Same flags and defaults as the JAX package's ``main_serve.py``: the field is baked once
(``--resolution``^3, ``--vd_bands`` SH bands of view-dependent color, masked with the
checkpoint's occupancy bitfield), then every frame — including recolors, RegionEdit
masks and the offsets dials — is rendered from the bake by ``render/sweep.py``. The
checkpoint is the port's own (a workspace of ``main_palette``) or a JAX-package pickle
(``train/checkpoint.py:load_palette_checkpoint`` reads it without JAX or ``ml_dtypes``). ``--out *.png`` writes the first frame; video
output is not ported (it needs ``cv2``). Runs on CUDA; ``main(argv, device="cpu")`` runs
on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from dataclasses import dataclass

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("workspace", help="palette workspace (version dir) or .ckpt path")
    ap.add_argument("--bound", type=float, default=1.0)
    ap.add_argument("--data", default=None,
                    help="scene root: orbit through its test poses (slerp) instead of a "
                         "y-up orbit")
    ap.add_argument("--scale", type=float, default=0.8)
    ap.add_argument("--offset", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    ap.add_argument("--num_basis", type=int, default=0, help="0 = infer from ckpt")
    ap.add_argument("--resolution", type=int, default=256, help="bake grid resolution")
    ap.add_argument("--W", type=int, default=800)
    ap.add_argument("--H", type=int, default=800)
    ap.add_argument("--u_res", type=int, default=400, help="intermediate sweep grid")
    ap.add_argument("--radius", type=float, default=2.35)
    ap.add_argument("--fovy", type=float, default=50.0)
    ap.add_argument("--n_frames", type=int, default=60)
    ap.add_argument("--out", default=None, help="png output path (first frame)")
    ap.add_argument("--bench", action="store_true", help="print fps and exit")
    ap.add_argument("--edit_basis", type=int, default=-1,
                    help="recolor this basis (with --edit_rgb)")
    ap.add_argument("--edit_rgb", type=float, nargs=3, default=(0.2, 0.9, 0.2))
    ap.add_argument("--edit_xyz", type=float, nargs=3, default=None,
                    help="optional spatial edit center")
    ap.add_argument("--edit_std", type=float, default=0.3)
    ap.add_argument("--density_thresh", type=float, default=1.0,
                    help="bake-time sigma floor for slice occupancy")
    ap.add_argument("--vd_bands", type=int, default=2,
                    help="SH bands for baked view-dependent color (0 = diffuse only)")
    ap.add_argument("--view_dep_weight", type=float, default=1.0,
                    help="scale of the baked view-dependent channel (eval dial)")
    ap.add_argument("--pred_clip", action="store_true",
                    help="checkpoint predicts clip features (bakes the clip volume)")
    ap.add_argument("--clip_dim", type=int, default=16)
    ap.add_argument("--edit_clip_xyz", type=float, nargs=3, default=None,
                    help="pick a point; its baked clip feature becomes the semantic edit "
                         "center (requires --pred_clip)")
    ap.add_argument("--edit_clip_std", type=float, default=0.5)
    ap.add_argument("--grid_levels", type=int, default=16)
    ap.add_argument("--grid_level_dim", type=int, default=2)
    ap.add_argument("--log2_hashmap_size", type=int, default=19)
    ap.add_argument("--gridtype", default="hash", choices=["hash", "tiled", "hash_xadd"],
                    help="the checkpoint's hash-grid type (main_palette's --gridtype)")
    return ap


def find_checkpoint(path: str) -> str:
    """A .ckpt path, the newest ``checkpoints/*.ckpt`` of a workspace, or the committed
    deploy artifact ``palette_*.ckpt`` of a deploy directory."""
    if os.path.isfile(path):
        return path
    cands = sorted(glob.glob(os.path.join(path, "checkpoints", "*.ckpt")))
    if not cands:
        cands = sorted(glob.glob(os.path.join(path, "palette_*.ckpt")))
    if not cands:
        raise FileNotFoundError(f"no checkpoints under {path}")
    return cands[-1]


def orbit_camera(opt, dataset=None):
    """(pose_at(i) -> [4, 4] c2w, intrinsics): a slerp through the dataset's test poses,
    or a y-up orbit of radius ``--radius`` without a dataset."""
    if dataset is not None:
        from scipy.spatial.transform import Rotation, Slerp

        poses = np.asarray(dataset.poses)
        sc = opt.H / dataset.H
        intr = tuple(float(v) * sc for v in dataset.intrinsics)
        n_key = len(poses)
        rots = Rotation.from_matrix(poses[:, :3, :3])

        def pose_at(i):
            t = (i / opt.n_frames) * (n_key - 1)
            k0 = min(int(t), n_key - 2)
            slerp = Slerp([0, 1], Rotation.concatenate([rots[k0], rots[k0 + 1]]))
            f = t - k0
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = slerp(f).as_matrix()
            pose[:3, 3] = (1 - f) * poses[k0, :3, 3] + f * poses[k0 + 1, :3, 3]
            return pose

        return pose_at, intr

    def pose_at(i):
        ang = 2 * np.pi * i / opt.n_frames
        eye = opt.radius * np.array([np.sin(ang) * 0.92, 0.40, np.cos(ang) * 0.92])
        fwd = np.array([0.0, -0.1, 0.0]) - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, down, fwd, eye
        return pose

    f = 0.5 * opt.H / np.tan(np.radians(opt.fovy) / 2)
    return pose_at, (f, f, opt.W / 2, opt.H / 2)


@dataclass
class ServeResult:
    """What one run of ``main`` measured and built."""

    bake_s: float   # load-to-sweep-volume seconds (checkpoint read excluded)
    fps: float
    frames: list    # rendered images [H, W, 3] (CPU numpy) when --out is given
    sv: object      # SweepVolume


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, device="cuda") -> ServeResult:
    from . import resolve_device
    from .models.palette import PaletteSpec
    from .render.baking import bake_palette, mask_with_bitfield
    from .render.palette_renderer import make_region_edit, region_edit_delta_hsv
    from .render.sweep import build_clip_masks, build_sweep_volume, render_sweep
    from .train.checkpoint import load_palette_checkpoint

    opt = build_parser().parse_args(argv)
    if opt.out is not None and not opt.out.endswith(".png"):
        raise NotImplementedError(f"--out {opt.out}: only .png output is ported "
                                  "(video writing needs cv2)")
    dev = resolve_device(device)

    ckpt = find_checkpoint(opt.workspace)
    params, gs = load_palette_checkpoint(ckpt, device=dev)
    P = opt.num_basis or params["basis_color"].shape[0]
    spec = PaletteSpec.build(bound=opt.bound, num_basis=P, grid_levels=opt.grid_levels,
                             grid_level_dim=opt.grid_level_dim,
                             log2_hashmap_size=opt.log2_hashmap_size, gridtype=opt.gridtype,
                             pred_clip=opt.pred_clip, clip_dim=opt.clip_dim)
    print(f"[serve] ckpt {ckpt} (P={P}); baking {opt.resolution}^3 "
          f"(vd_bands={opt.vd_bands}) on {dev} ...", flush=True)
    _sync(dev)
    t0 = time.perf_counter()
    baked = bake_palette(params, spec, resolution=opt.resolution, vd_bands=opt.vd_bands)
    # mask with the training bitfield (the cell set the marcher sampled): the field is
    # unconstrained fog elsewhere, which speckles the background and defeats slice skips
    if gs is not None and gs.get("bitfield") is not None:
        baked = mask_with_bitfield(baked, gs)
        print("[serve] bitfield-masked bake", flush=True)
    sv = build_sweep_volume(baked, sigma_thresh=1e-3)
    _sync(dev)
    bake_s = time.perf_counter() - t0
    print(f"[serve] baked in {bake_s:.1f}s", flush=True)

    palette = np.clip(params["basis_color"].cpu().numpy(), 0, 1)
    bc = torch.as_tensor(palette, dtype=torch.float32).to(dev)
    edit = None
    clip_masks = None
    if opt.edit_basis >= 0:
        new_pal = palette.copy()
        new_pal[opt.edit_basis] = opt.edit_rgb
        dh = region_edit_delta_hsv(palette, new_pal).numpy()
        mean_clip = None
        if opt.edit_clip_xyz is not None:
            if baked.clip_feat is None:
                raise ValueError("--edit_clip_xyz needs --pred_clip")
            Rr = opt.resolution
            ijk = np.clip(((np.asarray(opt.edit_clip_xyz) + opt.bound)
                           / (2 * opt.bound) * (Rr - 1)).round().astype(int), 0, Rr - 1)
            mean_clip = baked.clip_feat[ijk[0], ijk[1], ijk[2]].cpu().numpy()
            clip_masks = build_clip_masks(baked.clip_feat, mean_clip, opt.edit_clip_std)
            print(f"[serve] semantic edit mask from clip@{opt.edit_clip_xyz}", flush=True)
        edit = make_region_edit(
            P, clip_dim=(opt.clip_dim if mean_clip is not None else 1),
            mean_xyz=opt.edit_xyz, std_xyz=opt.edit_std,
            mean_clip=mean_clip, std_clip=opt.edit_clip_std)._replace(delta_hsv=dh)
        print(f"[serve] recoloring basis {opt.edit_basis} "
              f"{palette[opt.edit_basis].round(3)} -> {opt.edit_rgb}", flush=True)
    del baked  # the f32 bake (~2.5 GB at 256^3); the sweep volume holds what frames need

    dataset = None
    if opt.data:
        from .config import Config
        from .data.provider import NeRFDataset

        dataset = NeRFDataset(Config(path=opt.data, bound=opt.bound, scale=opt.scale,
                                     offset=tuple(opt.offset)), type="test")
    pose_at, intr = orbit_camera(opt, dataset)

    def frame(i):
        return render_sweep(sv, pose_at(i), intr, opt.H, opt.W, u_res=opt.u_res,
                            basis_color=bc, edit=edit, view_dep_weight=opt.view_dep_weight,
                            clip_masks=clip_masks)

    frame(0)                      # first-use costs (allocator, library handles)
    frame(opt.n_frames // 3)      # the other sweep direction
    _sync(dev)
    t0 = time.perf_counter()
    frames = []
    for i in range(opt.n_frames):
        o = frame(i)
        if opt.out:
            frames.append(o["image"])
    _sync(dev)                    # one trailing sync times the whole orbit
    dt = time.perf_counter() - t0
    fps = opt.n_frames / dt
    print(f"[serve] {opt.n_frames} frames @ {opt.W}x{opt.H}: {dt:.2f}s = {fps:.1f} fps",
          flush=True)

    frames = [f.cpu().numpy() for f in frames]
    if opt.out:
        from .data.png import write_png

        write_png(opt.out, (np.clip(frames[0], 0, 1) * 255).astype(np.uint8))
        print(f"[serve] wrote {opt.out}", flush=True)
    return ServeResult(bake_s, fps, frames, sv)


if __name__ == "__main__":
    main()
