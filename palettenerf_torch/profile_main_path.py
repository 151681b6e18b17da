"""Where the time of the port's main paths goes on the card: ``torch.profiler`` over

- train: one ``-O`` training epoch (100 steps with their grid refreshes) and one exact
  eval frame of ``data_proc/proc_toys`` at full width, after a warm-up epoch;
- eval: one exact 800x800 eval frame (``val/r_0``) of the trained stage-1 workspace
  ``--nerf_ws``, after a warm-up frame (which bakes the ``--eval_fine_grid`` bitfield);
- palette: one PaletteNeRF training epoch (100 steps, smooth loss on, basis colors
  unfrozen: the graph of most of a training run) and one eval frame, resumed from the
  palette workspace ``--palette_ws`` on the stage-1 workspace ``--nerf_ws``;
- serve: one 800x800 sweep frame (u_res 400) of a palette checkpoint's 256^3 bake,
  plain and with basis 0 recolored, after the serve CLI's own warm-up frames;
  ``--serve_ckpt deploy/proc_toys`` serves the committed trained checkpoint;
- edit: the palette workspace loaded as ``main_palette --test`` loads it, in an
  ``EditingSession`` at the ``--gui`` defaults (960x540) from test view 0: a plain exact
  frame, a region recolor frame, a 150-step stylizer fit on one correspondence, a
  stylized frame and a 16-step training burst.

The eval, palette, serve and edit parts default to the workspaces ``chip_smoke.py`` trains
(full width), so run it first. ``--O2`` trains (train, palette) with ``-O2`` in place of
``-O``: the stochastic trilerp, the nearest-corner / drawn-row backward and 8 of 16
levels scattered per step. The opt-in render flags ``--march_groups``,
``--eval_fine_grid``, ``--eval_compact_frac`` and ``--train_compact_frac`` and the model
flags ``--bg_radius``, ``--patch_size``, ``--lambda_lpips`` and ``--color_space`` are
passed on to the trainers of the train, eval, palette and edit parts (``--only train
--bg_radius 32 --patch_size 16 --lambda_lpips 0.1``: the background net and the patch
loss's share of a host-sampled step).

    python -m palettenerf_torch.profile_main_path [--steps_warmup 100] [--O2]
        [--only train|eval|palette|serve|edit] [--serve_ckpt PATH] [--palette_ws DIR]
        [--nerf_ws DIR] [--march_groups G] [--eval_fine_grid F] [--eval_compact_frac f]
        [--train_compact_frac f] [--bg_radius R] [--patch_size N] [--lambda_lpips L]
        [--color_space linear]

Prints, for each window, the wall time, the summed device time of all kernels and its
share of the wall time (busy share; one stream, so kernels do not overlap), the number
of kernel launches, the operators with the most device time, and the device time per
launch of the hand-written scatter kernel on that path, and the program's spans by host
self time with its counters (``utils.profiling``); and writes each window's Chrome trace
and its spans under ``results/profile_trace/`` (``utils.profiling.trace``).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import torch

from .config import Config
from .data.provider import NeRFDataset
from .main_nerf import build_parser
from .models.nerf import NeRFSpec
from .train.trainer import Trainer
from .utils.profiling import snapshot, trace

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = [os.path.join(_ROOT, "data_proc", "proc_toys"), "-O", "--bound", "1", "--scale",
        "0.8", "--bg_radius", "0", "--density_thresh", "10", "--iters", "8000"]


def _profile(what: str, fn, top: int = 15):
    torch.cuda.synchronize()
    with trace(os.path.join(_ROOT, "results", "profile_trace")) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e6
    print(f"== {what}: wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}%), {len(kernels)} kernel launches")
    ops = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True)
    for e in ops[:top]:
        print(f"   {e.self_device_time_total / 1e3:10.2f} ms  {e.count:7d} calls  {e.key[:90]}")
    # the hand-written scatter kernel (csrc/scatter_add.cu), whatever its rank above
    own = [e for e in kernels if "scatter_add_" in e.name]
    if own:
        total = sum(e.device_time_total for e in own)
        print(f"   scatter_add kernel: {len(own)} launches, {total / len(own) / 1e3:.3f} ms of "
              f"device time per launch ({own[0].name[:60]})")
    # the program's own spans (utils.profiling), by host self time
    rec = snapshot()
    for name, v in sorted(rec["spans"].items(), key=lambda kv: -kv[1]["self_ns"]):
        print(f"   span {name:18s} x{v['count']:<6d} self {v['self_ns'] / 1e6:10.2f} ms, "
              f"total {v['total_ns'] / 1e6:10.2f} ms")
    if rec["counters"]:
        print("   counters " + ", ".join(f"{k} {v}" for k, v in sorted(rec["counters"].items())))


# the flags passed on to the trainers, with their types
TRAINER_FLAGS = {"march_groups": int, "eval_fine_grid": int, "eval_compact_frac": float,
                "train_compact_frac": float, "bg_radius": float, "patch_size": int,
                "lambda_lpips": float, "color_space": str}


def _trainer_args(a) -> list:
    """The trainer flags that were given, as CLI arguments (after ARGS: a given
    ``--bg_radius`` wins over its 0 there)."""
    return [x for f in TRAINER_FLAGS if getattr(a, f) is not None
            for x in (f"--{f}", str(getattr(a, f)))]


def _args(a):
    """The proc_toys flags, with -O2 in place of -O under ``--O2``, and the render flags."""
    return [("-O2" if a.O2 and v == "-O" else v) for v in ARGS] + _trainer_args(a)


def _profile_flags(cfg) -> dict:
    return dict(fp16=cfg.fp16_enabled, fast_grad=cfg.fast_grad,
                stochastic_trilerp=cfg.stochastic_trilerp, grad_levels=cfg.grad_levels)


def profile_train(a):
    cfg = Config.from_args(build_parser().parse_args(_args(a)))
    spec = NeRFSpec.build(bound=cfg.bound, bg_radius=cfg.bg_radius,
                          log2_hashmap_size=cfg.log2_hashmap_size,
                          grid_levels=cfg.grid_levels, **_profile_flags(cfg))
    train_ds = NeRFDataset(cfg, type="train")
    valid_ds = NeRFDataset(cfg, type="val")
    tr = Trainer("ngp", cfg, spec, workspace=os.path.join(_ROOT, "results", "profile"),
                 use_checkpoint="scratch", mute=True, device="cuda")
    tr.train(train_ds, None, max(1, a.steps_warmup // len(train_ds)))
    tr.epoch += 1
    _profile(f"train epoch {_args(a)[1]} ({len(train_ds)} steps, step {tr.global_step}+)",
             lambda: tr.train_one_epoch(train_ds))
    data = valid_ds.collate(0)
    tr.eval_step_full(data)
    _profile(f"eval frame {data['W']}x{data['H']}", lambda: tr.eval_step_full(data))


def profile_eval(a):
    cfg = Config.from_args(build_parser().parse_args(_args(a)))
    spec = NeRFSpec.build(bound=cfg.bound, bg_radius=cfg.bg_radius,
                          log2_hashmap_size=cfg.log2_hashmap_size,
                          grid_levels=cfg.grid_levels, **_profile_flags(cfg))
    tr = Trainer("ngp", cfg, spec, workspace=a.nerf_ws, use_checkpoint="latest", mute=True,
                 device="cuda")
    if tr.global_step == 0:
        raise FileNotFoundError(f"no stage-1 checkpoint under {a.nerf_ws}")
    data = NeRFDataset(cfg, type="val").collate(0)
    t0 = time.perf_counter()
    tr.eval_step_full(data)
    torch.cuda.synchronize()
    print(f"warm-up eval frame {time.perf_counter() - t0:.3f} s"
          + (f", fine bake {tr.fine_bake_stats}" if cfg.eval_fine_grid else ""))
    flags = " ".join(_trainer_args(a)) or "flat"
    _profile(f"eval frame {data['W']}x{data['H']} ({flags})", lambda: tr.eval_step_full(data))
    if tr.last_compact_overflow is not None:
        print(f"   compact overflow {tr.last_compact_overflow} samples")


def profile_palette(a):
    import numpy as np

    from . import main_palette
    from .data.palette_provider import PaletteDataset
    from .models.palette import PaletteSpec
    from .train.palette_trainer import PaletteTrainer

    pal_dir = os.path.join(os.path.dirname(a.palette_ws),
                           "normalized_" + os.path.basename(a.nerf_ws))
    P = int(np.load(os.path.join(pal_dir, "palette.npz"))["palette"].shape[0])
    argv = [ARGS[0], a.nerf_ws] + _args(a)[1:] + ["--use_initialization_from_rgbxy",
                                                   "--dt_gamma", "0", "--num_basis", str(P)]
    cfg = Config.from_args(main_palette.build_parser().parse_args(argv))
    spec = PaletteSpec.build(bound=cfg.bound, num_basis=P, bg_radius=cfg.bg_radius,
                             color_space=cfg.color_space, **_profile_flags(cfg))
    tr = PaletteTrainer("palette", cfg, spec, workspace=a.palette_ws, use_checkpoint="latest",
                        nerf_path=None, mute=True, device="cuda")
    if tr.global_step == 0:
        raise FileNotFoundError(f"no palette checkpoint under {a.palette_ws}")
    tr.freeze_basis_color, tr.require_smooth_loss = False, True
    tr.lambda_palette = cfg.lambda_palette
    train_ds = PaletteDataset(cfg, type="train")
    tr.train_one_epoch(train_ds)
    _profile(f"palette train epoch {_args(a)[1]} ({len(train_ds)} steps, smooth loss, "
             f"colors unfrozen, "
             f"step {tr.global_step}+)", lambda: tr.train_one_epoch(train_ds))
    data = PaletteDataset(cfg, type="val").collate(0)
    tr.eval_step_full(data)
    _profile(f"palette eval frame {data['W']}x{data['H']}", lambda: tr.eval_step_full(data))


def profile_serve(a):
    from . import main_serve
    from .render.palette_renderer import make_region_edit, region_edit_delta_hsv
    from .render.sweep import render_sweep
    from .train.checkpoint import load_palette_checkpoint

    argv = [a.serve_ckpt, "--data", ARGS[0], "--bench", "--n_frames", "4"]
    sv = main_serve.main(argv, device="cuda").sv
    params, _ = load_palette_checkpoint(main_serve.find_checkpoint(a.serve_ckpt))
    palette = params["basis_color"].clamp(0, 1)
    del params
    new = palette.clone()
    new[0] = torch.tensor([0.2, 0.9, 0.2])
    edit = make_region_edit(palette.shape[0], clip_dim=1)._replace(
        delta_hsv=region_edit_delta_hsv(palette.numpy(), new.numpy()).numpy())
    opt = main_serve.build_parser().parse_args(argv)
    pose_at, intr = main_serve.orbit_camera(opt, NeRFDataset(
        Config(path=ARGS[0], bound=opt.bound, scale=opt.scale), type="test"))
    palette = palette.cuda()
    for what, e in (("plain", None), ("edited (basis 0)", edit)):
        def frame(e=e):
            render_sweep(sv, pose_at(0), intr, 800, 800, u_res=400, basis_color=palette,
                         edit=e)
        frame()
        _profile(f"sweep frame 800x800 u_res 400, {what}", frame)


def profile_edit(a):
    from . import main_palette
    from .data.palette_provider import PaletteDataset
    from .gui import EditingSession

    version = os.path.basename(a.palette_ws).split("_")[-1]
    argv = [ARGS[0], a.nerf_ws] + ARGS[1:] + _trainer_args(a) + [
        "--use_normalized_palette", "--use_initialization_from_rgbxy", "--dt_gamma", "0",
        "--test", "--version_id", version]
    cfg, tr = main_palette.load_test_trainer(argv, device="cuda")
    if tr.global_step == 0:
        raise FileNotFoundError(f"no palette checkpoint under {a.palette_ws}")
    sess = EditingSession(tr, W=cfg.W, H=cfg.H, radius=cfg.radius, fovy=cfg.fovy)
    sess.jump_to_pose(PaletteDataset(cfg, type="test").poses, 0)
    sess.render()
    what = f"edit frame {cfg.W}x{cfg.H}"
    _profile(f"{what}, plain", sess.render)
    sess.set_region(mean_xyz=sess.pick(cfg.W // 2, cfg.H // 2)["xyz"], std_xyz=0.35)
    sess.recolor(0, [0.15, 0.85, 0.25])
    _profile(f"{what}, region recolor of basis 0", sess.render)
    sess.reset_colors()
    sess.set_region()
    sess.add_correspondence(cfg.W // 2, cfg.H // 2, [0.9, 0.6, 0.1])
    _profile("stylizer fit, 150 steps, 1 correspondence", lambda: sess.optimize_style(iters=150))
    _profile(f"{what}, stylized", sess.render)
    train_ds = PaletteDataset(cfg, type="train")
    sess.train_burst(train_ds, steps=2)
    _profile("train burst, 16 steps", lambda: sess.train_burst(train_ds, steps=16))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps_warmup", type=int, default=100)
    p.add_argument("--only", choices=["train", "eval", "palette", "serve", "edit"],
                   default=None)
    p.add_argument("--O2", action="store_true", help="train and palette with -O2")
    for f, kind in TRAINER_FLAGS.items():
        p.add_argument(f"--{f}", type=kind, default=None, help="passed on to the trainers")
    pal_ws = os.path.join(_ROOT, "results_palette", "chip_smoke", "version_1")
    p.add_argument("--serve_ckpt", default=pal_ws,
                   help="palette checkpoint or directory to serve")
    p.add_argument("--palette_ws", default=pal_ws,
                   help="palette training workspace to resume (palette) or load (edit)")
    p.add_argument("--nerf_ws", default=os.path.join(_ROOT, "results", "chip_smoke", "version_1"),
                   help="the stage-1 workspace it was trained on")
    a = p.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    if a.only in (None, "train"):
        profile_train(a)
    if a.only in (None, "eval"):
        profile_eval(a)
    if a.only in (None, "palette"):
        profile_palette(a)
    if a.only in (None, "serve"):
        profile_serve(a)
    if a.only in (None, "edit"):
        profile_edit(a)


if __name__ == "__main__":
    main()
