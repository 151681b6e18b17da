#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``palettenerf_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. device: prints the card's name and power limit (nvidia-smi); TF32 off.
2. build: compiles every CUDA kernel from ``palettenerf_torch/csrc``, one ``nvcc``
   per source, all started together.
3. kernels: holds each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it and at edge cases, and times kernel, plain version and the
   one PyTorch call that computes the same function. ``window_gather`` is on no path
   (standalone): it must be bit-exact, and its launches are those of its timed run.
4. train reference: one small ``-O`` train step on the card against the same step on
   the CPU (where the port runs the plain versions): loss and every gradient.
5. train main path: the ``-O`` trainer of ``palettenerf_torch.main_nerf`` at full width
   on ``data_proc/proc_toys`` for 300 steps, then one validation view.
   It ends by writing the serve path's checkpoint (see ``write_serve_checkpoint``).
6. serve reference: a small palette field baked and swept on the card and on the CPU
   from the same weights: bake channels within tolerance, frames by PSNR (plain and
   with a RegionEdit recolor).
7. serve main path: ``python -m palettenerf_torch.main_serve <ckpt> --data
   data_proc/proc_toys --bench`` at full width: 256^3 bake with vd_bands=2, bitfield
   mask, sweep volume, 60 frames of 800x800 at u_res 400, once with ``--edit_basis 0``
   and once plain; then, on the same bake, test view 0's opacity against its ground
   truth alpha, the sweep against ``render_baked``, and the edit checks.

Launch counts are zeroed just before each main path and read just after; every kernel
of the train path must have launched there (the serve path runs no kernel of its own).
The line before the last carries the card's name and power limit; before it, one JSON
line lists every kernel with its numbers. The last line is the result object.
Exits non-zero, printing no result, without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(ROOT, "data_proc", "proc_toys")
WORKSPACE = os.path.join(ROOT, "results", "chip_smoke")

# proc_toys configuration (scripts/configs_proc/proc_toys.sh) with -O, default widths
MAIN_ARGS = [SCENE, "-O", "--bound", "1", "--scale", "0.8", "--bg_radius", "0",
             "--density_thresh", "10", "--iters", "8000", "--seed", "0"]
EPOCHS = 3                 # 100 training views -> 300 steps
PSNR_FLOOR = 20.0          # validation view 0 after 300 steps
SERVE_P = 5                # palette size of the committed proc_toys palette checkpoint
ALPHA_PSNR_FLOOR = 24.0    # sweep opacity of test view 0 vs its ground truth alpha: set
#                            from the first card run (25.308 dB) with ~1.3 dB margin
SWEEP_VS_BAKED_FLOOR = 26.0  # sweep vs render_baked, the threshold of tests/test_sweep.py
BAKE_RTOL, BAKE_ATOL = 1e-4, 1e-5  # card vs CPU bake: f32 sums in another order
SWEEP_CARD_PSNR = 40.0     # card vs CPU sweep frame, bf16 shade (rounding flips)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
PALETTE = [[0.9, 0.2, 0.1], [0.1, 0.8, 0.3], [0.2, 0.3, 0.9], [0.8, 0.8, 0.2],
           [0.6, 0.4, 0.7]]
SCATTER_RTOL = 1e-5        # of the row's summed |update|: f32 atomics reorder the sums
TABLE_ROWS = 6_119_864     # full width: 16 levels, 2^19 rows per hashed level


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _counted():
    """Every kernel wrapper with its launch counter, by kernel name."""
    from palettenerf_torch.ops import scatter, window_gather

    return {"scatter_add": scatter.scatter_add, "window_gather": window_gather.window_gather}


def zero_counts() -> None:
    for fn in _counted().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counted().items()}


def check_scatter(torch, scatter, idx, vals, total, what):
    """Kernel vs plain version; returns the max abs error. Raises on disagreement."""
    got = scatter.scatter_add(idx, vals, total)
    ref = scatter.scatter_add_reference(idx, vals, total)
    scale = scatter.scatter_add_reference(idx, vals.abs(), total)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    bad = int((err > SCATTER_RTOL * scale).sum())
    max_err = float(err.max())
    log(f"scatter_add {what}: U={idx.numel()} C={vals.shape[1]} rows={total} "
        f"max_abs_err={max_err:.3e} rows_out_of_tol={bad}")
    if bad or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"scatter_add {what}: {bad} rows differ from the plain "
                             f"version beyond {SCATTER_RTOL} of their summed |update|")
    return max_err, got


def phase_kernels(torch, dev):
    from palettenerf_torch.ops import hashgrid_fast, scatter
    from palettenerf_torch.ops.hashgrid import HashGridSpec

    spec = HashGridSpec.build(desired_resolution=2048, num_levels=16, level_dim=2,
                              log2_hashmap_size=19)
    total, C = spec.total_params, spec.level_dim
    gen = torch.Generator(device=dev).manual_seed(0)
    # the main path's shape: one encode of 4096 rays x 64 samples -> 33,554,432 corner rows
    x = torch.rand((4096 * 64, 3), generator=gen, device=dev)
    idx = hashgrid_fast.corner_indices(spec, x)[0].reshape(-1).contiguous()
    U = idx.numel()
    vals = (torch.randn((U, C), generator=gen, device=dev) * 1e-3).to(torch.bfloat16)
    max_err, _ = check_scatter(torch, scatter, idx, vals, total, "main-path shape")

    dup = (torch.arange(1 << 20, device=dev, dtype=torch.int32) % 7).contiguous()
    _, got = check_scatter(torch, scatter, dup, torch.ones((1 << 20, 2), device=dev,
                                                           dtype=torch.bfloat16),
                           4096 * 2, "heavy duplicates")
    if float(got[:7].min()) != float((1 << 20) // 7):
        raise AssertionError("heavy duplicates: counts are not exact")
    few = torch.arange(256, device=dev, dtype=torch.int32)
    _, got = check_scatter(torch, scatter, few, torch.ones((256, 2), device=dev,
                                                           dtype=torch.bfloat16),
                           total, "empty tiles")
    if float(got[256:].abs().max()) != 0.0:
        raise AssertionError("empty tiles: rows without updates are not zero")
    check_scatter(torch, scatter, idx[: 1 << 22].contiguous(),
                  vals[: 1 << 22, :1].contiguous(), total, "C=1")

    vals_f32 = vals.float()
    out_f32 = torch.zeros((total, C), device=dev)
    ms = time_ms(torch, lambda: scatter.scatter_add(idx, vals, total))
    plain_ms = time_ms(torch, lambda: scatter.scatter_add_reference(idx, vals, total))
    library_ms = time_ms(torch, lambda: out_f32.index_add_(0, idx, vals_f32))
    n_bytes = U * (4 + 2 * C) + total * C * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = U * C / FP32_FLOPS * 1e3
    entry = {
        "name": "scatter_add", "route": "cuda",
        "source": "palettenerf_torch/csrc/scatter_add.cu",
        "replaces": "palettenerf_tpu/ops/pallas_scatter.py:102",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }
    log(f"scatter_add timing at U={U}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"index_add_ {library_ms:.3f} ms, bound {entry['bound_ms']:.4f} ms "
        f"({n_bytes / 1e6:.1f} MB)")
    return [entry]


def phase_window_gather(torch, dev):
    """window_gather against its plain version, bit for bit: the shapes of
    tests/test_window_gather.py, Rw 1 and 32, bf16 windows and M8 = 65,536; then the
    timed standalone run at the largest shape (its launches are the entry's count)."""
    from palettenerf_torch.ops import window_gather as wg

    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [(8, 100, torch.float32), (16, 64, torch.float32), (1, 4096, torch.float32),
             (32, 4096, torch.float32), (16, 4096, torch.bfloat16),
             (32, 65536, torch.bfloat16), (32, 65536, torch.float32)]
    max_err = 0.0
    for rows, m8, dt in cases:
        W = torch.randn((rows, 128), generator=gen, device=dev).to(dt)
        r = torch.randint(0, rows, (m8, 128), generator=gen, device=dev, dtype=torch.int32)
        c = torch.randint(0, 128, (m8, 128), generator=gen, device=dev, dtype=torch.int32)
        got = wg.window_gather(W, r, c)
        ref = wg.window_gather_reference(W, r, c)
        torch.cuda.synchronize()
        if got.dtype != dt or got.shape != (m8, 128) or not torch.equal(got, ref):
            raise AssertionError(f"window_gather Rw={rows} M8={m8} {dt}: not bit-exact "
                                 f"against W[r, c]")
        max_err = max(max_err, float((got.float() - ref.float()).abs().max()))
    log(f"window_gather: bit-exact at {len(cases)} shapes (Rw 1..32, M8 up to 65536, "
        f"f32 and bf16), max_abs_err {max_err}")

    # timed at the largest shape (the last case): kernel alone, plain version, torch.take
    rows, m8, _ = cases[-1]
    flat_idx = (r.long() * 128 + c.long())
    wg.window_gather.launches = 0
    ms = time_ms(torch, lambda: wg.launch(W, r, c), iters=50, warmup=5)
    launches = wg.window_gather.launches
    wrapper_ms = time_ms(torch, lambda: wg.window_gather(W, r, c), iters=20)
    plain_ms = time_ms(torch, lambda: wg.window_gather_reference(W, r, c), iters=50, warmup=5)
    library_ms = time_ms(torch, lambda: torch.take(W.reshape(-1), flat_idx), iters=50, warmup=5)
    n_bytes = m8 * 128 * (4 + 4 + 4) + rows * 128 * 4
    entry = {
        "name": "window_gather", "route": "cuda",
        "source": "palettenerf_torch/csrc/window_gather.cu",
        "replaces": "palettenerf_tpu/ops/pallas_window_gather.py:45",
        "path": "standalone", "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": library_ms,
    }
    log(f"window_gather timing at Rw={rows} M8={m8} f32: kernel {ms:.4f} ms "
        f"(wrapper with range check {wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"torch.take {library_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms "
        f"({n_bytes / 1e6:.1f} MB), {launches} launches")
    return entry


def phase_reference(torch, dev):
    """One small -O train step on the card and on the CPU, from the same weights and
    draws: the loss and every gradient must agree."""
    from palettenerf_torch.config import Config
    from palettenerf_torch.models.nerf import NeRFSpec, init_nerf, param_list
    from palettenerf_torch.train.trainer import Trainer

    cfg = Config(O=True, fp16=True, bound=1.0, grid_size=32, num_rays=512, max_steps=256,
                 train_samples_per_ray=32, log2_hashmap_size=14, grid_levels=8, iters=100)
    spec = NeRFSpec.build(bound=1.0, fp16=True, log2_hashmap_size=14, grid_levels=8)
    gen = torch.Generator().manual_seed(1)
    params = init_nerf(spec, gen)
    params["encoder"].uniform_(-1, 1, generator=gen)
    n = cfg.num_rays
    o = torch.randn((n, 3), generator=gen)
    o = o / o.norm(dim=-1, keepdim=True) * 2.0
    d = -o + 0.5 * torch.randn((n, 3), generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    img, bg, noise = (torch.rand((n, 4), generator=gen), torch.rand((n, 3), generator=gen),
                      torch.rand((n,), generator=gen))
    results = []
    for device in ("cpu", dev):
        tr = Trainer("ref", cfg, spec, params={k: (v.clone() if torch.is_tensor(v) else
                                                     [w.clone() for w in v])
                                               for k, v in params.items()},
                     workspace=os.path.join(WORKSPACE, "reference"),
                     use_checkpoint="scratch", mute=True, device=device)
        tr.grid_state = tr.grid_state._replace(
            bitfield=torch.full_like(tr.grid_state.bitfield, 255))
        loss, _ = tr.train_step(*(t.to(tr.device) for t in (o, d, img)),
                                bg=bg.to(tr.device), noise=noise.to(tr.device))
        results.append((float(loss), [p.grad.cpu() for p in param_list(tr.params)]))
    (loss_c, grads_c), (loss_g, grads_g) = results
    # tolerance per tensor, relative to its largest gradient: the MLP gradients are f32
    # sums in another order (1e-4); a table update that differs in its last f32 bit
    # between the devices can round to a neighbouring bf16 value (2^-8 of it: 1e-2)
    rel = [float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
           for a, b in zip(grads_c, grads_g)]
    log(f"reference: loss cpu {loss_c:.7f} gpu {loss_g:.7f}; max relative gradient "
        f"difference: table {rel[0]:.3e}, MLPs {max(rel[1:]):.3e}")
    if abs(loss_c - loss_g) > 1e-5 * abs(loss_c) or rel[0] > 1e-2 or max(rel[1:]) > 1e-4:
        raise AssertionError("the -O train step on the card disagrees with the CPU reference")


def phase_main_path(torch, dev):
    import numpy as np

    from palettenerf_torch.config import Config
    from palettenerf_torch.data.provider import NeRFDataset
    from palettenerf_torch.main_nerf import build_parser
    from palettenerf_torch.models.nerf import NeRFSpec, param_list
    from palettenerf_torch.train.metrics import psnr
    from palettenerf_torch.train.trainer import Trainer

    cfg = Config.from_args(build_parser().parse_args(MAIN_ARGS))
    spec = NeRFSpec.build(bound=cfg.bound, bg_radius=cfg.bg_radius, fp16=cfg.fp16_enabled,
                          log2_hashmap_size=cfg.log2_hashmap_size,
                          grid_levels=cfg.grid_levels, grid_level_dim=cfg.grid_level_dim)
    t0 = time.perf_counter()
    train_ds = NeRFDataset(cfg, type="train")
    valid_ds = NeRFDataset(cfg, type="val")
    log(f"loaded {len(train_ds)} train + {len(valid_ds)} val views "
        f"({train_ds.H}x{train_ds.W}) in {time.perf_counter() - t0:.1f} s")
    trainer = Trainer("ngp", cfg, spec, workspace=WORKSPACE, use_checkpoint="scratch",
                      eval_interval=10_000, device=dev)
    if spec.grid.total_params != TABLE_ROWS:
        raise AssertionError(f"hash table has {spec.grid.total_params} rows")

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    # -------------------------------------------------------------- main path
    trainer.train(train_ds, None, 1)          # epoch 1: first-use costs included
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps0 = trainer.global_step
    trainer.train(train_ds, None, EPOCHS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    timed_steps = trainer.global_step - steps0
    data = valid_ds.collate(0)
    trainer.eval_step_full(data)              # first render: warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = trainer.eval_step_full(data)
    eval_s = time.perf_counter() - t0
    launches = read_counts()
    # -------------------------------------------------------------- checks
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = trainer.global_step
    losses = trainer.stats["loss"]
    img = data["images"]
    gt = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
    val_psnr = psnr(out["image"], gt)
    log(f"main path: {steps} steps, epoch losses {['%.5f' % v for v in losses]}")
    log(f"main path: {timed_steps / train_s:.2f} steps/s over {timed_steps} steps "
        f"(epochs 2-{EPOCHS}, grid refreshes and checkpoints included), eval "
        f"{eval_s:.3f} s/frame ({train_ds.W}x{train_ds.H}), val PSNR {val_psnr:.3f} dB, "
        f"peak memory {peak_gb:.2f} GiB, launches {launches}")
    if steps != EPOCHS * len(train_ds):
        raise AssertionError(f"{steps} steps instead of {EPOCHS * len(train_ds)}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if launches["scatter_add"] != steps:
        raise AssertionError(f"scatter_add launched {launches['scatter_add']} times in "
                             f"{steps} train steps")
    finite = all(bool(torch.isfinite(p).all()) for p in param_list(trainer.params))
    finite &= all(np.isfinite(v).all() for v in out.values())
    if not finite:
        raise AssertionError("non-finite parameters or render")
    if out["image"].shape != (train_ds.H, train_ds.W, 3):
        raise AssertionError(f"render shape {out['image'].shape}")
    if not val_psnr > PSNR_FLOOR:
        raise AssertionError(f"validation PSNR {val_psnr:.3f} dB <= floor {PSNR_FLOOR}")
    return launches, write_serve_checkpoint(torch, trainer)


def write_serve_checkpoint(torch, trainer) -> str:
    """The checkpoint the serve main path runs on, in the JAX package's pickle layout.
    The palette trainer is not ported, so it is built at the widths of the committed
    proc_toys palette checkpoint (P = 5, three 16-level 2^19-row tables) from the train
    phase's EMA NeRF (encoder, sigma_net, color_net) and occupancy grid, under seeded
    random palette heads. The script thus needs no file beyond the code and the scene."""
    from palettenerf_torch.models.palette import PaletteSpec
    from palettenerf_torch.train.checkpoint import save_reference_checkpoint

    spec = PaletteSpec.build(bound=1.0, num_basis=SERVE_P)
    params = _random_palette_params(torch, spec, torch.Generator().manual_seed(4),
                                    lively=False)
    params.update({k: v for k, v in trainer.eval_params().items()
                   if k in ("encoder", "sigma_net", "color_net")})
    path = os.path.join(WORKSPACE, "serve", f"palette_ep{trainer.epoch:04d}.ckpt")
    return save_reference_checkpoint(path, params, trainer.epoch, trainer.global_step,
                                     grid_state=trainer.grid_state._asdict())


def _random_palette_params(torch, spec, gen, lively: bool = True):
    """A random palette field (CPU): MLPs at torch.nn.Linear's init, the density and
    omega heads scaled by 8 and the first P colors of PALETTE. ``lively`` tables are
    U(-4, 4), so that density and palette weights vary across the volume (sigma from
    ~0.03 to ~15); else they keep the U(-1e-4, 1e-4) init and omega varies with the
    geometry feature alone."""
    from palettenerf_torch.models.mlp import init_mlp
    from palettenerf_torch.ops.hashgrid import init_hashgrid

    P, g, h, n = spec.num_basis, spec.geo_feat_dim, spec.hidden_dim, spec.grid.output_dim
    params = {name: init_hashgrid(spec.grid, gen) for name in ("encoder", "encoder_palette")}
    if lively:
        for t in params.values():
            t.uniform_(-4, 4, generator=gen)
    params.update(
        sigma_net=init_mlp([n, h, 1 + g], gen),
        color_net=init_mlp([spec.sh_dim + g, h, h, 3], gen),
        diff_net=init_mlp([g, h, h, 3], gen),
        basis_net=init_mlp([n + 3, h, g], gen),
        offsets_radiance_net=init_mlp([g, 3 * P + 1], gen, bias=True),
        omega_net=init_mlp([g, P], gen),
        basis_color=torch.tensor(PALETTE[:P]),
    )
    params["basis_color_origin"] = params["basis_color"].clone()
    params["sigma_net"][-1][:, 0] *= 8.0
    params["omega_net"][0] *= 8.0
    return params


def _to(torch, params, dev):
    return {k: (v.to(dev) if torch.is_tensor(v) else
                [{a: b.to(dev) for a, b in w.items()} if isinstance(w, dict) else w.to(dev)
                 for w in v]) for k, v in params.items()}


def _psnr(torch, a, b) -> float:
    mse = float(((a.float().cpu() - b.float().cpu()) ** 2).mean())
    return -10.0 * math.log10(mse + 1e-12)


def phase_serve_reference(torch, dev):
    """Bake + sweep of a 4-level, 2^13-row palette field on the card and on the CPU,
    from the same weights: bake channels to BAKE_RTOL/BAKE_ATOL, frames by PSNR."""
    import numpy as np

    from palettenerf_torch.models.palette import PaletteSpec
    from palettenerf_torch.render.baking import bake_palette
    from palettenerf_torch.render.palette_renderer import make_region_edit
    from palettenerf_torch.render.sweep import build_sweep_volume, render_sweep

    spec = PaletteSpec.build(bound=1.0, num_basis=4, grid_levels=4, log2_hashmap_size=13)
    params = _random_palette_params(torch, spec, torch.Generator().manual_seed(3))
    eye = np.array([0.4, 0.5, -2.6])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, np.cross(fwd, right), fwd, eye
    intr = (70.0, 70.0, 32.0, 32.0)
    edit = make_region_edit(4, clip_dim=1, mean_xyz=(0.2, 0.0, -0.1), std_xyz=0.3)._replace(
        delta_hsv=np.array([[120.0, 1.0, 1.0], [0.0, 0.5, 1.5], [180.0, 1.0, 0.5],
                            [0.0, 1.0, 1.0]], np.float32))
    res = {}
    for device in ("cpu", dev):
        p = _to(torch, params, device)
        baked = bake_palette(p, spec, resolution=48, vd_bands=2)
        sv = build_sweep_volume(baked)
        frames = [render_sweep(sv, pose, intr, 64, 64, u_res=160, basis_color=p["basis_color"],
                               edit=e)["image"] for e in (None, edit)]
        res[str(device)] = (baked, frames)
    (bc, fc), (bg, fg) = res["cpu"], res[str(dev)]
    worst = {}
    for name in ("density", "diffuse", "omega", "offsets", "radiance", "view_sh"):
        c, g = getattr(bc, name), getattr(bg, name).cpu()
        excess = ((g - c).abs() - (BAKE_ATOL + BAKE_RTOL * c.abs())).max()
        worst[name] = float((g - c).abs().max())
        if float(excess) > 0:
            raise AssertionError(f"serve reference: baked {name} on the card differs from "
                                 f"the CPU beyond {BAKE_ATOL} + {BAKE_RTOL}|ref|")
    ps = [_psnr(torch, a, b) for a, b in zip(fc, fg)]
    moved = float((fg[1] - fg[0]).abs().max())
    log(f"serve reference: bake max |card - cpu| "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f"; sweep card vs cpu PSNR plain {ps[0]:.2f} dB, edited {ps[1]:.2f} dB; "
          f"edit moves {moved:.3f}")
    if min(ps) < SWEEP_CARD_PSNR or moved <= 0.05:
        raise AssertionError(f"serve reference: sweep on the card vs the CPU {ps} dB "
                             f"(floor {SWEEP_CARD_PSNR}), edit moved {moved}")


def phase_serve(torch, dev, ckpt):
    """The serving main path at full width, on the checkpoint of the train phase."""
    from palettenerf_torch import main_serve
    from palettenerf_torch.config import Config
    from palettenerf_torch.data.provider import NeRFDataset
    from palettenerf_torch.data.rays import gen_rays
    from palettenerf_torch.models.palette import PaletteSpec
    from palettenerf_torch.render.baking import (bake_palette, fuse_volume,
                                                 mask_with_bitfield, render_baked)
    from palettenerf_torch.render.palette_renderer import make_region_edit, region_edit_delta_hsv
    from palettenerf_torch.render.sweep import build_sweep_volume, render_sweep
    from palettenerf_torch.train.checkpoint import (load_reference_checkpoint,
                                                    palette_params_from_jax)

    argv = [ckpt, "--data", SCENE, "--bench"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    # -------------------------------------------------------------- main path
    r = main_serve.main(argv + ["--edit_basis", "0"], device=dev)
    peak_edit = torch.cuda.max_memory_allocated() / 2 ** 30
    fps_edit, bake_edit = r.fps, r.bake_s
    del r
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r = main_serve.main(argv, device=dev)
    peak_plain = torch.cuda.max_memory_allocated() / 2 ** 30
    fps, bake_s = r.fps, r.bake_s
    del r
    launches = read_counts()
    # -------------------------------------------------------------- checks
    if "ml_dtypes" in sys.modules:
        raise AssertionError("the checkpoint load imported ml_dtypes")
    torch.cuda.empty_cache()
    # the CLI's bake again, kept in f32 for the golden per-ray renderer
    payload = load_reference_checkpoint(ckpt)
    params = palette_params_from_jax(payload["params"], device=dev)
    spec = PaletteSpec.build(bound=1.0, num_basis=params["basis_color"].shape[0])
    baked = mask_with_bitfield(bake_palette(params, spec, resolution=256, vd_bands=2),
                               payload["grid_state"])
    sv = build_sweep_volume(baked, sigma_thresh=1e-3)
    C = sv.vols[0].shape[2]
    if sv.vols[0].shape != (256, 256, C, 256) or C != 2 + 4 * SERVE_P + 3 * 4:
        raise AssertionError(f"sweep volume {tuple(sv.vols[0].shape)}")
    palette = params["basis_color"].clamp(0, 1)
    new = palette.cpu().clone()
    new[0] = torch.tensor([0.2, 0.9, 0.2])  # --edit_basis 0 with the default --edit_rgb
    edit = make_region_edit(SERVE_P, clip_dim=1, std_xyz=0.3)._replace(
        delta_hsv=region_edit_delta_hsv(palette.cpu().numpy(), new.numpy()).numpy())

    ds = NeRFDataset(Config(path=SCENE, bound=1.0, scale=0.8), type="test")
    H, W = ds.H, ds.W
    pose = ds.poses[0]
    out = render_sweep(sv, pose, ds.intrinsics, H, W, u_res=400, basis_color=palette)
    img = out["image"]
    finite = all(bool(torch.isfinite(v).all()) for v in out.values())
    alpha_psnr = _psnr(torch, out["weights_sum"].reshape(H, W),
                       torch.from_numpy(ds.images[0][..., 3]))
    # pixels that saw only background keep T = 1: the JAX package's per-block test
    # max(T) > t_thresh (dropped by the port) could not skip any block of such a frame
    ws_min = float(out["weights_sum"].min())

    fused = fuse_volume(baked)
    ro, rd = (torch.from_numpy(a).to(dev) for a in gen_rays(pose, ds.intrinsics, H, W))
    gold = torch.cat([render_baked(baked, ro[s:s + 8192], rd[s:s + 8192], num_samples=512,
                                   basis_color=palette, fused=fused)["image"]
                      for s in range(0, H * W, 8192)]).reshape(H, W, 3)
    del fused, baked
    psnr_baked = _psnr(torch, img, gold)
    edited = render_sweep(sv, pose, ds.intrinsics, H, W, u_res=400, basis_color=palette,
                          edit=edit)["image"]
    neutral = render_sweep(sv, pose, ds.intrinsics, H, W, u_res=400, basis_color=palette,
                           edit=make_region_edit(SERVE_P, clip_dim=1))["image"]
    moved = float((edited - img).abs().max())
    neutral_moved = float((neutral - img).abs().max())
    log(f"serve main path: bake {bake_s:.2f} s (edited run {bake_edit:.2f} s), "
        f"{fps:.2f} fps plain, {fps_edit:.2f} fps edited ({W}x{H}, u_res 400, 60 "
        f"frames), peak memory {peak_plain:.2f} GiB plain / {peak_edit:.2f} GiB edited; "
        f"test view 0: opacity vs ground-truth alpha PSNR {alpha_psnr:.3f} dB, sweep vs "
        f"render_baked (512 samples) {psnr_baked:.3f} dB; edit moves {moved:.3f}, neutral "
        f"edit {neutral_moved:.3g}; min weights_sum {ws_min:.3g}; launches {launches}")
    if img.shape != (H, W, 3) or (H, W) != (800, 800) or not finite:
        raise AssertionError(f"sweep frame {tuple(img.shape)}, finite {finite}")
    if not alpha_psnr > ALPHA_PSNR_FLOOR:
        raise AssertionError(f"test view 0 opacity PSNR {alpha_psnr:.3f} dB <= floor "
                             f"{ALPHA_PSNR_FLOOR}")
    if not psnr_baked > SWEEP_VS_BAKED_FLOOR:
        raise AssertionError(f"sweep vs render_baked {psnr_baked:.3f} dB <= "
                             f"{SWEEP_VS_BAKED_FLOOR}")
    if not moved > 0.05 or neutral_moved != 0.0:
        raise AssertionError(f"edit moved {moved} (> 0.05 needed), neutral edit moved "
                             f"{neutral_moved} (0 needed)")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "palettenerf_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(palettenerf_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()

    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    from concurrent.futures import ThreadPoolExecutor

    from palettenerf_torch.ops import scatter, window_gather

    t0 = time.perf_counter()
    libs = [scatter.LIBRARY, window_gather.LIBRARY]
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source, all at once
        for f in [pool.submit(lib.build) for lib in libs]:
            f.result()
    log(f"build: {', '.join(os.path.basename(lib.source) for lib in libs)} in "
        f"{time.perf_counter() - t0:.1f} s (in parallel)")
    for lib in libs:
        if lib.build_log:
            log(f"nvcc -Xptxas -v ({lib.name}):\n" + lib.build_log.strip())

    kernels = phase_kernels(torch, dev)
    wg_entry = phase_window_gather(torch, dev)
    phase_reference(torch, dev)
    train_launches, serve_ckpt = phase_main_path(torch, dev)
    for k in kernels:
        k["path"] = "train"
        k["launches"] = train_launches[k["name"]]
    kernels.append(wg_entry)
    phase_serve_reference(torch, dev)
    phase_serve(torch, dev, serve_ckpt)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
