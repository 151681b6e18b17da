"""Palette CLI of the PyTorch port: extract a palette, or train / test a PaletteNeRF, on
an NVIDIA GPU.

    python -m palettenerf_torch.main_palette data_proc/proc_toys results/proc_toys -O \
        --bound 1 --scale 0.8 --bg_radius 0 --density_thresh 10 \
        --extract_palette --use_normalized_palette --extract_via_sweep
    python -m palettenerf_torch.main_palette data_proc/proc_toys results/proc_toys -O \
        --bound 1 --scale 0.8 --bg_radius 0 --density_thresh 10 \
        --use_initialization_from_rgbxy --use_normalized_palette --dt_gamma 0 \
        --datatype blender --iters 8000
    # the shipped fast profile with the paired-pixel sampler (scripts/run_blender.sh)
    python -m palettenerf_torch.main_palette data_proc/proc_toys results/proc_toys -O2 \
        --bound 1 --scale 0.8 --bg_radius 0 --density_thresh 10 \
        --use_initialization_from_rgbxy --use_normalized_palette --dt_gamma 0 \
        --datatype blender --iters 8000 --random_size 8 --lambda_patchsmooth 1e-3
    # on a stage-1 workspace trained with the background net, in linear colour space
    python -m palettenerf_torch.main_palette data_proc/proc_toys results/proc_toys_bg -O \
        --bound 1 --scale 0.8 --density_thresh 10 --bg_radius 32 --color_space linear \
        --use_initialization_from_rgbxy --use_normalized_palette --dt_gamma 0 \
        --datatype blender --iters 8000

Same flags as the JAX package's ``main_palette.py`` (``--rand_pose`` is accepted and
raises; ``--n_devices N > 1`` spawns N ranks, as ``main_nerf`` does) and the same meters
(PSNR, LPIPS, rLPIPS in training; PSNR, SSIM, LPIPS, rLPIPS, TV, Sparsity with
``--test``), including the nerf-version discovery and the ``results_palette/...``
workspace mirroring (reference ``main_palette.py:114-132``), the palette size taken from
the extracted palette (:137-141), and the three branches extract / test / train
(:147-243). The stage-1 workspace is one that ``main_nerf`` of this package wrote (a
JAX-package stage-1 pickle is read too). Runs on CUDA; ``main(argv, device="cpu")`` runs
on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from . import parallel


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("path", type=str)
    p.add_argument("nerf_path", type=str)
    p.add_argument("--config", type=str, required=False, default="")
    p.add_argument("-O", action="store_true")
    p.add_argument("-O2", action="store_true",
                   help="-O plus the fast-training profile "
                        "(--fast_grad --stochastic_trilerp --grad_levels 8)")
    p.add_argument("--test", action="store_true")
    p.add_argument("--video", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--version_id", type=int, default=-1)

    p.add_argument("--iters", type=int, default=30000)
    p.add_argument("--ckpt", type=str, default="latest")
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--num_rays", type=int, default=4096)
    p.add_argument("--cuda_ray", action="store_true")
    p.add_argument("--max_steps", type=int, default=1024)
    p.add_argument("--num_steps", type=int, default=512)
    p.add_argument("--upsample_steps", type=int, default=0)
    p.add_argument("--update_extra_interval", type=int, default=16)
    p.add_argument("--max_ray_batch", type=int, default=4096)
    p.add_argument("--patch_size", type=int, default=1)
    p.add_argument("--random_size", type=int, default=0)

    p.add_argument("--fp16", action="store_true")

    p.add_argument("--color_space", type=str, default="srgb", choices=["srgb", "linear"])
    p.add_argument("--preload", action="store_true")
    p.add_argument("--bound", type=float, default=2)
    p.add_argument("--scale", type=float, default=0.33)
    p.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    p.add_argument("--dt_gamma", type=float, default=1 / 128)
    p.add_argument("--min_near", type=float, default=0.2)
    p.add_argument("--density_thresh", type=float, default=10)
    p.add_argument("--bg_radius", type=float, default=-1)
    p.add_argument("--datatype", type=str, default="", choices=["", "llff", "blender", "mip360"])

    p.add_argument("--gui", action="store_true")
    p.add_argument("--W", type=int, default=960)
    p.add_argument("--H", type=int, default=540)
    p.add_argument("--radius", type=float, default=5)
    p.add_argument("--fovy", type=float, default=50)
    p.add_argument("--max_spp", type=int, default=64)

    p.add_argument("--error_map", action="store_true")
    p.add_argument("--clip_text", type=str, default="")
    p.add_argument("--rand_pose", type=int, default=-1)
    p.add_argument("--continue_training", action="store_true")

    p.add_argument("--extract_palette", action="store_true")
    p.add_argument("--extract_downscale", type=int, default=1,
                   help="render training views at 1/N resolution during palette "
                        "extraction (the RGBXY statistics are resolution-insensitive)")
    p.add_argument("--extract_via_sweep", action="store_true",
                   help="render extraction views with the baked shear-warp sweep "
                        "instead of the exact per-ray path")
    p.add_argument("--use_normalized_palette", action="store_true")
    p.add_argument("--error_thres", type=float, default=5.0 / 255)
    p.add_argument("--update_grid", action="store_true")
    p.add_argument("--num_basis", type=int, default=4)

    p.add_argument("--use_initialization_from_rgbxy", action="store_true")
    p.add_argument("--max_freeze_palette_epoch", type=int, default=100)
    p.add_argument("--smooth_loss_start_epoch", type=int, default=30)

    p.add_argument("--lambda_sparsity", type=float, default=2e-4)
    p.add_argument("--lambda_smooth", type=float, default=4e-3)
    p.add_argument("--lambda_patchsmooth", type=float, default=0)
    p.add_argument("--lambda_view_dep", type=float, default=0.1)
    p.add_argument("--lambda_offsets", type=float, default=0.03)
    p.add_argument("--lambda_weight", type=float, default=0.05)
    p.add_argument("--lambda_palette", type=float, default=0.001)

    p.add_argument("--smooth_sigma_xyz", type=float, default=0.005)
    p.add_argument("--smooth_sigma_color", type=float, default=0.2)
    p.add_argument("--smooth_sigma_clip", type=float, default=0)

    p.add_argument("--lweight_decay_epoch", type=int, default=100)

    p.add_argument("--pred_clip", action="store_true")
    p.add_argument("--clip_dim", type=int, default=16)

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
    p.add_argument("--stochastic_trilerp", action="store_true",
                   help="train-only MC corner draw in the hash encode (unbiased, 4-8x fewer gathers)")
    p.add_argument("--march_groups", type=int, default=-1,
                   help="hierarchical-march group slots (-1 auto: train-only, eval stays flat/exact; 0 forces flat parity everywhere; >0 enables hierarchical on both paths)")
    p.add_argument("--grad_levels", type=int, default=0,
                   help="hash backward: scatter a random subset of K levels per step (0=all)")
    p.add_argument("--gridtype", type=str, default="hash",
                   choices=["hash", "tiled", "hash_xadd"],
                   help="hash_xadd: pair-local hash (x-adjacent rows, 2x fewer gathers)")
    p.add_argument("--eval_compaction", type=int, default=1, choices=[0, 1],
                   help="alive-ray compaction rounds in eval renders (0=exact)")
    p.add_argument("--train_compact_frac", type=float, default=0.0,
                   help="train-step sample compaction budget (opt-in)")
    p.add_argument("--eval_compact_frac", type=float, default=0.0,
                   help="eval-only cross-ray valid-sample compaction budget "
                        "(fraction of N*S slots; 0 = off)")
    p.add_argument("--eval_fine_grid", type=int, default=0,
                   help="eval-only: bake a finer occupancy bitfield from the "
                        "trained field at this resolution (multiple of "
                        "grid_size, e.g. 256; 0 = off)")
    p.add_argument("--fast_grad", action="store_true",
                   help="nearest-corner hash backward: ~3x faster steps, slightly biased grads")
    return p


def resolve_workspaces(opt):
    """nerf-version discovery + results_palette mirroring (main_palette.py:114-132)."""
    nerf_path = opt.nerf_path
    if "version" not in os.path.basename(nerf_path):
        versions = glob.glob(os.path.join(nerf_path, "version*"))
        vid = max([0] + [int(x.split("_")[-1]) for x in versions])
        nerf_path = os.path.join(nerf_path, f"version_{vid}")

    palette_workspace = nerf_path.replace("results", "results_palette")
    if opt.use_normalized_palette:
        palette_workspace = palette_workspace.replace("version", "normalized_version")
    os.makedirs(palette_workspace, exist_ok=True)

    workspace_dir = os.path.dirname(palette_workspace)
    if opt.version_id >= 0:
        workspace = os.path.join(workspace_dir, f"version_{opt.version_id}")
    else:
        versions = glob.glob(os.path.join(workspace_dir, "version*"))
        vid = max([0] + [int(x.split("_")[-1]) for x in versions])
        workspace = os.path.join(
            workspace_dir, f"version_{(1 - max(opt.test, opt.continue_training)) + vid}"
        )
    return nerf_path, palette_workspace, workspace


def _setup(argv):
    """Parse ``argv``, resolve the workspaces and read the extracted palette
    (main_palette.py:114-141): (cfg, (nerf_path, palette_workspace, workspace),
    (palette, hist_weights))."""
    from .config import Config
    from .train.trainer import check_ported

    opt = build_parser().parse_args(argv)
    cfg = Config.from_args(opt)
    check_ported(cfg)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)

    paths = resolve_workspaces(opt)
    extracted = (None, None)
    if cfg.use_initialization_from_rgbxy and not cfg.extract_palette:
        pal_file = os.path.join(paths[1], "palette.npz")
        if not os.path.exists(pal_file):
            raise FileNotFoundError(f"Extracted palette missing: {pal_file}")
        extracted = (np.load(pal_file)["palette"],
                     np.load(os.path.join(paths[1], "hist_weights.npz"))["hist_weights"])
        cfg = cfg.replace(num_basis=int(extracted[0].shape[0]))
    if parallel.group() is None or parallel.group().is_main:
        print(cfg)
    return cfg, paths, extracted


def _grid_kw(cfg) -> dict:
    return dict(log2_hashmap_size=cfg.log2_hashmap_size, grid_levels=cfg.grid_levels,
                grid_level_dim=cfg.grid_level_dim, gridtype=cfg.gridtype)


def _palette_spec(cfg):
    from .models.palette import PaletteSpec

    return PaletteSpec.build(
        bound=cfg.bound, bg_radius=cfg.bg_radius, num_basis=cfg.num_basis,
        pred_clip=cfg.pred_clip, clip_dim=cfg.clip_dim, color_space=cfg.color_space,
        smooth_sigma_xyz=cfg.smooth_sigma_xyz, smooth_sigma_color=cfg.smooth_sigma_color,
        smooth_sigma_clip=cfg.smooth_sigma_clip, fp16=cfg.fp16_enabled,
        fast_grad=cfg.fast_grad, stochastic_trilerp=cfg.stochastic_trilerp,
        grad_levels=cfg.grad_levels, **_grid_kw(cfg),
    )


def _test_trainer(cfg, workspace: str, extracted, device):
    from .train.metrics import (LPIPSMeter, PSNRMeter, RLPIPSMeter, SparsityMeter, SSIMMeter,
                                TVMeter)
    from .train.palette_trainer import PaletteTrainer

    metrics = [PSNRMeter(), SSIMMeter(), LPIPSMeter(), RLPIPSMeter(device=device), TVMeter(),
               SparsityMeter()]
    trainer = PaletteTrainer("palette", cfg, _palette_spec(cfg), workspace=workspace,
                             metrics=metrics, use_checkpoint=cfg.ckpt, nerf_path=None,
                             device=device)
    if trainer.params.get("hist_weights") is None and extracted[1] is not None:
        trainer.initialize_palette(*extracted)
    return trainer


def _train_trainer(cfg, paths, extracted, device):
    """The PaletteTrainer of a training run: warm-started from the stage-1 workspace on a
    fresh run, with the extracted palette then set (main_palette.py:249-257)."""
    from .train.metrics import LPIPSMeter, PSNRMeter, RLPIPSMeter
    from .train.palette_trainer import PaletteTrainer

    nerf_path, _, workspace = paths
    trainer = PaletteTrainer("palette", cfg, _palette_spec(cfg), workspace=workspace,
                             metrics=[PSNRMeter(), LPIPSMeter(), RLPIPSMeter(device=device)],
                             use_checkpoint=cfg.ckpt, nerf_path=nerf_path, ema_decay=0.95,
                             eval_interval=cfg.eval_interval, device=device)
    if trainer.global_step == 0:
        # fresh run only: a resumed checkpoint already carries the initialized palette and
        # the Adam / EMA state that initialize_palette would reset
        trainer.initialize_palette(*extracted)
    return trainer


def load_train_trainer(argv=None, device="cuda"):
    """The PaletteTrainer that a training run of ``main`` trains, built as ``main`` builds
    it, before its first step: (cfg, trainer)."""
    cfg, paths, extracted = _setup(argv)
    if cfg.test or cfg.extract_palette:
        raise ValueError("load_train_trainer loads a training run's trainer: no --test, "
                         "no --extract_palette")
    return cfg, _train_trainer(cfg, paths, extracted, device)


def load_test_trainer(argv=None, device="cuda"):
    """The PaletteTrainer that ``--test`` (and ``--test --gui``) runs on, loaded as
    ``main`` loads it: (cfg, trainer). ``argv`` is ``main``'s, ``--test`` included."""
    cfg, paths, extracted = _setup(argv)
    if not cfg.test:
        raise ValueError("load_test_trainer loads the --test trainer: pass --test")
    return cfg, _test_trainer(cfg, paths[2], extracted, device)


def _rank_main(argv, device) -> None:
    """One rank of a ``--n_devices`` run, spawned by ``main``."""
    main(argv, device)


def main(argv=None, device="cuda"):
    """The palette CLI. With ``--n_devices N > 1`` it spawns N ranks, each of which runs
    ``main`` on its shard of the rays, waits for them and returns None; rank 0 writes the
    workspace."""
    from .config import Config
    from .data.palette_provider import PaletteDataset
    from .models.nerf import NeRFSpec
    from .models.palette import PaletteSpec
    from .train.palette_trainer import PaletteTrainer
    from .train.trainer import Trainer, check_ported

    if parallel.group() is None:
        opt = build_parser().parse_args(argv)
        cfg = Config.from_args(opt)
        if cfg.n_devices > 1:  # the parent: start the ranks
            check_ported(cfg)
            return parallel.run_cli(_rank_main, cfg, argv, resolve_workspaces(opt)[2], device)
    else:
        device = parallel.group().device
    cfg, (nerf_path, palette_workspace, workspace), extracted = _setup(argv)
    if cfg.extract_palette:
        # stage 2: render the training views with the plain NeRF and extract
        nerf_spec = NeRFSpec.build(bound=cfg.bound, bg_radius=cfg.bg_radius,
                                   fp16=cfg.fp16_enabled, **_grid_kw(cfg))
        nerf_trainer = Trainer("ngp", cfg, nerf_spec, workspace=nerf_path,
                               use_checkpoint="latest", ema_decay=None, device=device)
        pal_trainer = PaletteTrainer(
            "palette", cfg,
            PaletteSpec.build(bound=cfg.bound, bg_radius=cfg.bg_radius,
                              num_basis=cfg.num_basis, pred_clip=cfg.pred_clip,
                              clip_dim=cfg.clip_dim, color_space=cfg.color_space,
                              **_grid_kw(cfg)),
            workspace=palette_workspace, use_checkpoint="scratch", nerf_path=None,
            device=device,
        )
        loader = PaletteDataset(cfg, type="traintest", downscale=cfg.extract_downscale)
        pal_trainer.extract_palette(nerf_trainer, loader,
                                    normalize_input=cfg.use_normalized_palette,
                                    save_path=palette_workspace,
                                    via_sweep=cfg.extract_via_sweep)
        return pal_trainer

    if cfg.test:
        trainer = _test_trainer(cfg, workspace, extracted, device)
        if cfg.gui:
            from .gui.dpg_gui import PaletteGUI

            PaletteGUI(cfg, trainer, train_loader=PaletteDataset(cfg, type="traintest")).render()
            return trainer
        if cfg.video:
            raise NotImplementedError("--video output is not ported (it needs cv2)")
    else:
        trainer = _train_trainer(cfg, (nerf_path, palette_workspace, workspace), extracted,
                                 device)
        train_ds = PaletteDataset(cfg, type="train")
        valid_ds = PaletteDataset(cfg, type="val", downscale=1)
        max_epoch = int(np.ceil(cfg.iters / len(train_ds)))
        trainer.train(train_ds, valid_ds, max_epoch)

    test_ds = PaletteDataset(cfg, type="test", n_test=30)
    if test_ds.has_gt:
        trainer.evaluate_one_epoch(test_ds)
    trainer.test(test_ds)
    return trainer


if __name__ == "__main__":
    main()
