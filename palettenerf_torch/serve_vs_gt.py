"""Serve-path quality against ground truth: the baked sweep and the exact palette render
of a trained palette checkpoint, each against the test images, and against each other.

    python -m palettenerf_torch.serve_vs_gt results_palette/proc_toys/version_1 \
        --data data_proc/proc_toys

Counterpart of the JAX package's ``scripts/serve_vs_gt.py``, with its settings:

1. bake the checkpoint at ``resolution=256`` with ``vd_bands=3`` SH bands of
   view-dependent colour, masked with the checkpoint's occupancy bitfield, into a sweep
   volume (``sigma_thresh=1e-3``);
2. ``render_sweep`` (``u_res=448``, ``min_near=0.05``) at every test pose, against the
   test image composited on white;
3. the exact path (``render_palette_eval`` with ``gui_mode=True``, in 16,384-ray chunks,
   the last one counted as padded with copies of its last ray as the script pads it, so
   that its compact budget is the script's; ``max_steps 512``, ``num_samples 192``,
   ``t_thresh 1e-2``, ``march_groups 48``, ``compact_frac 0.375``, one cascade) on the
   first two views: against the image and against the sweep frame; ``exact_dropped``
   counts the samples the budget dropped over the padded chunks.

The checkpoint is the port's own (a ``main_palette`` workspace) or a JAX-package pickle
(``train/checkpoint.py:load_palette_checkpoint``). Prints the per-view and mean PSNRs and
returns them. Runs on CUDA; ``serve_vs_gt(..., device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch


@dataclass
class ServeVsGT:
    """Per-view PSNRs (dB) and frames [H, W, 3] (host arrays) of one run."""

    sweep_vs_gt: List[float] = field(default_factory=list)
    exact_vs_gt: List[float] = field(default_factory=list)
    sweep_vs_exact: List[float] = field(default_factory=list)
    sweep_frames: List[np.ndarray] = field(default_factory=list)
    exact_frames: List[np.ndarray] = field(default_factory=list)
    exact_s: List[float] = field(default_factory=list)
    # samples the exact path's compaction budget dropped, per exact frame
    exact_dropped: List[int] = field(default_factory=list)
    bake_s: float = 0.0

    def means(self) -> dict:
        def mean(v):
            return float(np.mean(v)) if v else float("nan")

        return {"sweep_vs_gt": mean(self.sweep_vs_gt), "exact_vs_gt": mean(self.exact_vs_gt),
                "sweep_vs_exact": mean(self.sweep_vs_exact)}


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float32) - np.asarray(b, np.float32)) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def exact_settings(grid_size: int, bound: float = 1.0, min_near: float = 0.05):
    """The exact path's ``RenderSettings`` of ``scripts/serve_vs_gt.py:48-50``."""
    from .render.nerf_renderer import RenderSettings

    return RenderSettings(bound=bound, cascade=1, grid_size=grid_size, dt_gamma=0.0,
                          max_steps=512, num_samples=192, t_thresh=1e-2, min_near=min_near,
                          march_groups=48, compact_frac=0.375)


def serve_vs_gt(palette_ws: str, data: str, device="cuda", resolution: int = 256,
                vd_bands: int = 3, u_res: int = 448, n_exact: int = 2, bound: float = 1.0,
                scale: float = 0.8, offset=(0.0, 0.0, 0.0), min_near: float = 0.05,
                chunk: int = 16384, grid_levels: int = 16, log2_hashmap_size: int = 19,
                verbose: bool = True) -> ServeVsGT:
    """Bake the newest checkpoint of ``palette_ws`` (or that checkpoint file), then hold
    the sweep and the exact render against the test split of the scene at ``data``."""
    from . import resolve_device
    from .config import Config
    from .data.provider import NeRFDataset
    from .main_serve import find_checkpoint
    from .models.palette import PaletteSpec
    from .render.baking import bake_palette, mask_with_bitfield
    from .render.palette_renderer import render_palette_eval
    from .render.sweep import build_sweep_volume, render_sweep
    from .train.checkpoint import load_palette_checkpoint

    dev = resolve_device(device)
    ckpt = find_checkpoint(palette_ws)
    params, gs = load_palette_checkpoint(ckpt, device=dev)
    P = params["basis_color"].shape[0]
    spec = PaletteSpec.build(bound=bound, num_basis=P, grid_levels=grid_levels,
                             log2_hashmap_size=log2_hashmap_size)
    res = ServeVsGT()
    t0 = time.perf_counter()
    baked = bake_palette(params, spec, resolution=resolution, vd_bands=vd_bands)
    if gs is not None and gs.get("bitfield") is not None:
        baked = mask_with_bitfield(baked, gs)
    sv = build_sweep_volume(baked, sigma_thresh=1e-3)
    del baked
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    res.bake_s = time.perf_counter() - t0
    bc = params["basis_color"].detach().clamp(0.0, 1.0).to(torch.float32)
    if verbose:
        print(f"[serve_vs_gt] {ckpt}: P = {P}, baked {resolution}^3 (vd_bands {vd_bands}) "
              f"in {res.bake_s:.1f} s", flush=True)

    ds = NeRFDataset(Config(path=data, bound=bound, scale=scale, offset=tuple(offset),
                            min_near=min_near, bg_radius=0), type="test")
    G = round(np.asarray(gs["density_grid"]).shape[-1] ** (1 / 3) + 1e-6)
    settings = exact_settings(G, bound, min_near)
    bitfield = torch.as_tensor(np.asarray(gs["bitfield"])[: G ** 3 // 8]).to(dev)
    white = torch.ones(3, device=dev)

    def exact_render(ro, rd, H, W):
        outs, dropped = [], 0
        for s in range(0, ro.shape[0], chunk):
            out = render_palette_eval(params, spec, bitfield,
                                      torch.as_tensor(ro[s:s + chunk]).to(dev),
                                      torch.as_tensor(rd[s:s + chunk]).to(dev), settings,
                                      bg_color=white, gui_mode=True, pad_to=chunk)
            outs.append(out["image"])
            dropped = dropped + out["compact_overflow"].sum()
        res.exact_dropped.append(int(dropped))
        return torch.cat(outs).cpu().numpy().reshape(H, W, 3)

    for i, data_i in enumerate(ds.iter_epoch()):
        H, W = data_i["H"], data_i["W"]
        gt = np.asarray(ds.images[data_i["index"]], np.float32).reshape(H, W, -1)
        if gt.shape[-1] == 4:
            gt = gt[..., :3] * gt[..., 3:] + 1.0 * (1 - gt[..., 3:])
        img = render_sweep(sv, ds.poses[data_i["index"]], ds.intrinsics, H, W, u_res=u_res,
                           basis_color=bc, min_near=min_near)["image"].cpu().numpy()
        res.sweep_frames.append(img)
        res.sweep_vs_gt.append(psnr(img, gt))
        line = f"view {i}: sweep-vs-GT {res.sweep_vs_gt[-1]:.2f} dB"
        if i < n_exact:
            t0 = time.perf_counter()
            ex = exact_render(data_i["rays_o"].reshape(-1, 3), data_i["rays_d"].reshape(-1, 3),
                              H, W)
            res.exact_s.append(time.perf_counter() - t0)
            res.exact_frames.append(ex)
            res.exact_vs_gt.append(psnr(ex, gt))
            res.sweep_vs_exact.append(psnr(img, ex))
            line += (f" | exact-vs-GT {res.exact_vs_gt[-1]:.2f} dB | sweep-vs-exact "
                     f"{res.sweep_vs_exact[-1]:.2f} dB ({res.exact_s[-1]:.1f}s/frame, "
                     f"{res.exact_dropped[-1]} samples past the compaction budget)")
        if verbose:
            print(line, flush=True)
    if verbose:
        m = res.means()
        print(f"sweep-vs-GT mean {m['sweep_vs_gt']:.2f} dB over {len(res.sweep_vs_gt)} views; "
              f"exact-vs-GT {m['exact_vs_gt']:.2f}; sweep-vs-exact {m['sweep_vs_exact']:.2f}",
              flush=True)
    return res


def main(argv=None, device="cuda") -> ServeVsGT:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workspace", help="palette workspace (version dir) or .ckpt path")
    ap.add_argument("--data", default="data_proc/proc_toys", help="scene root")
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--vd_bands", type=int, default=3)
    ap.add_argument("--u_res", type=int, default=448)
    ap.add_argument("--n_exact", type=int, default=2, help="views also rendered exactly")
    ap.add_argument("--bound", type=float, default=1.0)
    ap.add_argument("--scale", type=float, default=0.8)
    ap.add_argument("--offset", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    ap.add_argument("--grid_levels", type=int, default=16)
    ap.add_argument("--log2_hashmap_size", type=int, default=19)
    opt = ap.parse_args(argv)
    return serve_vs_gt(opt.workspace, opt.data, device=device, resolution=opt.resolution,
                       vd_bands=opt.vd_bands, u_res=opt.u_res, n_exact=opt.n_exact,
                       bound=opt.bound, scale=opt.scale, offset=opt.offset,
                       grid_levels=opt.grid_levels, log2_hashmap_size=opt.log2_hashmap_size)


if __name__ == "__main__":
    main()
