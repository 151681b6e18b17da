"""Stage-1 CLI of the PyTorch port: train/test an Instant-NGP NeRF on an NVIDIA GPU.

    python -m palettenerf_torch.main_nerf data_proc/proc_toys -O --bound 1 --scale 0.8 \
        --bg_radius 0 --density_thresh 10 --iters 8000 --workspace proc_toys
    python -m palettenerf_torch.main_nerf data_proc/proc_toys -O2 --bound 1 --scale 0.8 \
        --bg_radius 0 --density_thresh 10 --iters 8000 --workspace proc_toys_o2

    # the background net and the random-feature LPIPS loss on 16x16 pixel patches
    python -m palettenerf_torch.main_nerf data_proc/proc_toys -O --bound 1 --scale 0.8 \
        --density_thresh 10 --bg_radius 32 --patch_size 16 --lambda_lpips 0.1 \
        --iters 8000 --workspace proc_toys_bg

``-O2`` is ``-O`` plus ``--fast_grad --stochastic_trilerp --grad_levels 8``;
``--gridtype hash_xadd``, ``--error_map``, ``--color_space linear`` combine with either.

    # ray data-parallel over two ranks (spawned here; nccl with a card per rank, else gloo)
    python -m palettenerf_torch.main_nerf data_proc/proc_toys -O --bound 1 --scale 0.8 \
        --bg_radius 0 --density_thresh 10 --iters 8000 --workspace proc_toys_dp --n_devices 2

Same flags as the JAX package's ``main_nerf.py`` (``--rand_pose`` is accepted and
raises) and the same meters: PSNR, LPIPS (NaN without
the ``lpips`` package) and rLPIPS in training, SSIM too with ``--test``. Both branches
end with the mesh export, ``save_mesh(256, 10)`` ->
``<workspace>/meshes/ngp_<epoch>.ply``; ``--gui`` opens the DearPyGui viewer
instead (``palettenerf_torch.gui.NeRFGUI``; without the ``dearpygui`` package it raises,
and ``palettenerf_torch.gui.EditingSession`` is the headless way in). Runs on CUDA;
``main(argv, device="cpu")`` runs on the CPU. With ``--n_devices N > 1`` ``main`` spawns N
ranks (``palettenerf_torch.parallel``), each of which runs ``main`` on its shard of the
rays, waits for them and returns None; rank 0 writes the workspace.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("path", type=str)
    p.add_argument("-O", action="store_true", help="equals --fp16 --cuda_ray --preload")
    p.add_argument("-O2", action="store_true",
                   help="-O plus the TPU fast-training profile "
                        "(--fast_grad --stochastic_trilerp --grad_levels 8)")
    p.add_argument("--test", action="store_true")
    p.add_argument("--workspace", type=str, default="workspace")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--version_id", type=int, default=-1)

    p.add_argument("--iters", type=int, default=30000)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--ckpt", type=str, default="latest")
    p.add_argument("--num_rays", type=int, default=4096)
    p.add_argument("--cuda_ray", action="store_true",
                   help="kept for CLI parity; grid marching is always used")
    p.add_argument("--max_steps", type=int, default=1024)
    p.add_argument("--num_steps", type=int, default=512)
    p.add_argument("--upsample_steps", type=int, default=0)
    p.add_argument("--update_extra_interval", type=int, default=16)
    p.add_argument("--max_ray_batch", type=int, default=4096)
    p.add_argument("--patch_size", type=int, default=1)

    p.add_argument("--fp16", action="store_true", help="bf16 hash-grid backward scatter")

    p.add_argument("--color_space", type=str, default="srgb")
    p.add_argument("--preload", action="store_true")
    p.add_argument("--bound", type=float, default=2.0)
    p.add_argument("--scale", type=float, default=0.33)
    p.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    p.add_argument("--dt_gamma", type=float, default=1 / 128)
    p.add_argument("--min_near", type=float, default=0.2)
    p.add_argument("--density_thresh", type=float, default=10)
    p.add_argument("--bg_radius", type=float, default=-1)
    p.add_argument("--no_bg", action="store_true")

    p.add_argument("--gui", action="store_true")
    p.add_argument("--W", type=int, default=960)
    p.add_argument("--H", type=int, default=540)
    p.add_argument("--radius", type=float, default=5)
    p.add_argument("--fovy", type=float, default=50)
    p.add_argument("--max_spp", type=int, default=64)

    p.add_argument("--error_map", action="store_true")
    p.add_argument("--clip_text", type=str, default="")
    p.add_argument("--rand_pose", type=int, default=-1)

    p.add_argument("--lambda_sparse", type=float, default=0.05)
    p.add_argument("--filter_close_point", action="store_true")

    # knobs of the rebuild (no reference analog)
    p.add_argument("--n_devices", type=int, default=1,
                   help="data-parallel: shard the ray batch over this many chips")
    p.add_argument("--train_samples_per_ray", type=int, default=64)
    p.add_argument("--infer_samples_per_ray", type=int, default=256)
    p.add_argument("--eval_interval", type=int, default=50)
    p.add_argument("--log2_hashmap_size", type=int, default=19)
    p.add_argument("--grid_levels", type=int, default=16)
    p.add_argument("--grid_level_dim", type=int, default=2)
    p.add_argument("--grid_update_warmup", type=int, default=256)
    p.add_argument("--lambda_lpips", type=float, default=0.0,
                   help="perceptual patch loss weight (requires --patch_size > 1)")
    p.add_argument("--stochastic_trilerp", action="store_true",
                   help="train-only single-corner Monte-Carlo hash interpolation "
                        "(8x fewer gathers; unbiased estimator, eval stays exact)")
    p.add_argument("--march_groups", type=int, default=-1,
                   help="hierarchical-march group slots (-1 auto: train-only, eval stays flat/exact; 0 forces flat parity everywhere; >0 enables hierarchical on both paths)")
    p.add_argument("--grad_levels", type=int, default=0,
                   help="hash backward: scatter a random subset of K levels per step (0=all)")
    p.add_argument("--gridtype", type=str, default="hash",
                   choices=["hash", "tiled", "hash_xadd"],
                   help="hash_xadd: TPU pair-local hash (x-adjacent rows, 2x fewer gathers)")
    p.add_argument("--fast_grad", action="store_true",
                   help="nearest-corner hash backward: ~3x faster steps, slightly biased grads")
    p.add_argument("--eval_compaction", type=int, default=1, choices=[0, 1],
                   help="alive-ray compaction rounds in eval renders (1=on; "
                        "0=exact single-pass — use for metric runs)")
    p.add_argument("--eval_fine_grid", type=int, default=0,
                   help="eval-only: bake a finer occupancy bitfield from the "
                        "trained field at this resolution (multiple of "
                        "grid_size, e.g. 256; 0 = off). Collapses march-valid "
                        "samples to thin surface shells — large exact-eval "
                        "speedup at identical culling semantics")
    p.add_argument("--eval_compact_frac", type=float, default=0.0,
                   help="eval-only cross-ray valid-sample compaction budget "
                        "(fraction of N*S slots; 0 = off)")
    p.add_argument("--train_compact_frac", type=float, default=0.0,
                   help="train-step sample compaction budget (opt-in; overflow "
                        "drops samples from the gradient)")
    return p


def resolve_workspace(root: str, workspace: str, version_id: int, test: bool) -> str:
    """results/<name>/version_N auto-versioning (main_nerf.py:105-112)."""
    workspace_dir = os.path.join(root, workspace)
    if version_id >= 0:
        return os.path.join(workspace_dir, f"version_{version_id}")
    existing = glob.glob(os.path.join(workspace_dir, "version*"))
    vid = max([0] + [int(x.split("_")[-1]) for x in existing])
    return os.path.join(workspace_dir, f"version_{(1 - int(test)) + vid}")


def _rank_main(argv, device, mesh_resolution: int) -> None:
    """One rank of a ``--n_devices`` run, spawned by ``main``."""
    main(argv, device, mesh_resolution)


def main(argv=None, device="cuda", mesh_resolution: int = 256):
    from . import parallel
    from .config import Config
    from .data.provider import NeRFDataset
    from .models.nerf import NeRFSpec
    from .train.metrics import LPIPSMeter, PSNRMeter, RLPIPSMeter, SSIMMeter
    from .train.trainer import Trainer, check_ported

    opt = build_parser().parse_args(argv)
    cfg = Config.from_args(opt)
    check_ported(cfg)
    if cfg.n_devices > 1:
        if parallel.group() is None:  # the parent: start the ranks
            workspace = resolve_workspace("results", cfg.workspace, cfg.version_id, cfg.test)
            return parallel.run_cli(_rank_main, cfg, argv, workspace, device, mesh_resolution)
        device = parallel.group().device
    if parallel.group() is None or parallel.group().is_main:
        print(cfg)

    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)

    spec = NeRFSpec.build(
        bound=cfg.bound, bg_radius=cfg.bg_radius, fp16=cfg.fp16_enabled,
        fast_grad=cfg.fast_grad, stochastic_trilerp=cfg.stochastic_trilerp,
        grad_levels=cfg.grad_levels, log2_hashmap_size=cfg.log2_hashmap_size,
        grid_levels=cfg.grid_levels, grid_level_dim=cfg.grid_level_dim, gridtype=cfg.gridtype,
    )
    workspace = resolve_workspace("results", cfg.workspace, cfg.version_id, cfg.test)

    if cfg.test:
        metrics = [PSNRMeter(), SSIMMeter(), LPIPSMeter(), RLPIPSMeter(device=device)]
        trainer = Trainer("ngp", cfg, spec, workspace=workspace, metrics=metrics,
                          use_checkpoint=cfg.ckpt, device=device)
        if cfg.gui:
            from .gui.dpg_gui import NeRFGUI

            NeRFGUI(cfg, trainer, NeRFDataset(cfg, type="traintest")).render()
            return trainer
    else:
        train_ds = NeRFDataset(cfg, type="train")
        valid_ds = NeRFDataset(cfg, type="val", downscale=1)
        metrics = [PSNRMeter(), LPIPSMeter(), RLPIPSMeter(device=device)]
        trainer = Trainer("ngp", cfg, spec, workspace=workspace, metrics=metrics,
                          use_checkpoint=cfg.ckpt, ema_decay=0.95,
                          eval_interval=cfg.eval_interval, device=device)
        if cfg.gui:
            from .gui.dpg_gui import NeRFGUI

            NeRFGUI(cfg, trainer, train_ds).render()
            return trainer
        max_epoch = int(np.ceil(cfg.iters / len(train_ds)))
        trainer.train(train_ds, valid_ds, max_epoch)

    test_ds = NeRFDataset(cfg, type="test")
    if test_ds.has_gt:
        trainer.evaluate_one_epoch(test_ds)
    trainer.test(test_ds)
    trainer.save_mesh(resolution=mesh_resolution, threshold=10)
    return trainer


if __name__ == "__main__":
    main()
