"""Where the time of the port's main paths goes on the card: ``torch.profiler`` over

- train: one ``-O`` training epoch (100 steps with their grid refreshes) and one exact
  eval frame of ``data_proc/proc_toys`` at full width, after a warm-up epoch;
- serve: one 800x800 sweep frame (u_res 400) of a palette checkpoint's 256^3 bake,
  plain and with basis 0 recolored, after the serve CLI's own warm-up frames. The
  default checkpoint is the one ``chip_smoke.py`` writes (full width, P = 5);
  ``--serve_ckpt deploy/proc_toys`` serves the committed trained one.

    python -m palettenerf_torch.profile_main_path [--steps_warmup 100] [--only train|serve]
        [--serve_ckpt PATH]

Prints, for each window, the wall time, the summed device time of all kernels and its
share of the wall time (busy share; one stream, so kernels do not overlap), the number
of kernel launches, the operators with the most device time, and the device time per
launch of the hand-written scatter kernel on that path.
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

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = [os.path.join(_ROOT, "data_proc", "proc_toys"), "-O", "--bound", "1", "--scale",
        "0.8", "--bg_radius", "0", "--density_thresh", "10", "--iters", "8000"]


def _profile(what: str, fn, top: int = 15):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
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


def profile_train(a):
    cfg = Config.from_args(build_parser().parse_args(ARGS))
    spec = NeRFSpec.build(bound=cfg.bound, bg_radius=cfg.bg_radius, fp16=cfg.fp16_enabled,
                          log2_hashmap_size=cfg.log2_hashmap_size,
                          grid_levels=cfg.grid_levels)
    train_ds = NeRFDataset(cfg, type="train")
    valid_ds = NeRFDataset(cfg, type="val")
    tr = Trainer("ngp", cfg, spec, workspace=os.path.join(_ROOT, "results", "profile"),
                 use_checkpoint="scratch", mute=True, device="cuda")
    tr.train(train_ds, None, max(1, a.steps_warmup // len(train_ds)))
    tr.epoch += 1
    _profile(f"train epoch ({len(train_ds)} steps, step {tr.global_step}+)",
             lambda: tr.train_one_epoch(train_ds))
    data = valid_ds.collate(0)
    tr.eval_step_full(data)
    _profile(f"eval frame {data['W']}x{data['H']}", lambda: tr.eval_step_full(data))


def profile_serve(a):
    from . import main_serve
    from .render.palette_renderer import make_region_edit, region_edit_delta_hsv
    from .render.sweep import render_sweep
    from .train.checkpoint import load_reference_checkpoint, palette_params_from_jax

    argv = [a.serve_ckpt, "--data", ARGS[0], "--bench", "--n_frames", "4"]
    sv = main_serve.main(argv, device="cuda").sv
    tree = load_reference_checkpoint(main_serve.find_checkpoint(a.serve_ckpt))["params"]
    palette = palette_params_from_jax(tree)["basis_color"].clamp(0, 1)
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


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps_warmup", type=int, default=100)
    p.add_argument("--only", choices=["train", "serve"], default=None)
    p.add_argument("--serve_ckpt", default=os.path.join(_ROOT, "results", "chip_smoke", "serve"),
                   help="palette checkpoint or directory to serve")
    a = p.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    if a.only != "serve":
        profile_train(a)
    if a.only != "train":
        profile_serve(a)


if __name__ == "__main__":
    main()
