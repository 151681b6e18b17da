#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``palettenerf_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. device: prints the card's name and power limit (nvidia-smi); TF32 off.
2. build: compiles every CUDA kernel from ``palettenerf_torch/csrc``, one ``nvcc``
   per source, and the host C++ libraries (``palettenerf_torch/native``: the extraction's
   kernels and the JPEG decoder) with ``g++``, all started together.
3. kernels: holds each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it and at edge cases, and times kernel, plain version and the
   one PyTorch call that computes the same function. ``scatter_add`` is held and timed
   in each of its kernels (column walk, one vector atomic per row in stream order,
   scalar atomics) on the corner rows of uniform random points.
   ``window_gather`` is on no path (standalone): it must be bit-exact, and its launches
   are those of its timed run.
4. train reference: one small ``-O`` train step on the card against the same step on
   the CPU (where the port runs the plain versions): loss and every gradient.
5. train main path: the ``-O`` trainer of ``palettenerf_torch.main_nerf`` at full width
   on ``data_proc/proc_toys`` for 300 steps, then one validation view. Then the path
   stream: the update stream one train batch gives ``scatter_add`` on the trained
   field (rays marched through the trained occupancy grid), on which the kernel is
   held against its plain version and timed again, with the stream's statistics.
   Data parallel: the same configuration on the first 20 training views, 100 steps in two
   gloo ranks sharing the card (``palettenerf_torch.parallel.spawn``) beside 100 steps in
   this process with the same seed: the first step's loss (1e-5 relative), the first 20
   steps' losses (2e-3), parameters, EMA and bitfield equal bit for bit across the ranks,
   ``scatter_add`` launched once per step on each rank, and held against its plain
   version and timed on the update stream rank 0's last step gave it; steps/s and peak
   memory of both. On a machine with two cards or more, the same also in two nccl ranks,
   one card each, and in one nccl rank per card. ``python3 chip_smoke.py --dp-only``
   builds the kernels and runs this phase alone (on four cards: one process, two gloo
   ranks on one card, two and four nccl ranks) and ends with its numbers as one JSON line.
   -O2 reference: the ``-O2`` encoder (4 levels, 2^13 rows, hash and hash_xadd) on the
   card against the CPU on the same points and draws: exact forward, corner draws and
   the forward where they agree, the table gradient of each backward mode (drawn row,
   nearest corner, grad_levels) with B1 against the plain version.
   -O2 train main path: the same configuration with ``-O2`` for 300 steps, one
   validation view, then B1 on the ``-O2`` and ``--fast_grad`` backward streams of one
   batch on that field, held and timed in both of its modes; one ``--error_map`` epoch
   (host-sampled, resumed from it) and two epochs of ``--gridtype hash_xadd -O2``.
   Compaction reference: on a small field, the supercell mip and the fine bake card vs
   CPU bit for bit, the hierarchical and fine-grid marches' masks and ``ts``, and a
   compacted train render's outputs and gradients.
   Compacted train path: one 100-step ``-O`` epoch resumed from the train main path with
   ``--train_compact_frac 0.25`` and the same epoch without it (copies of the
   workspace): steps/s, the overflow summed over the epoch, B1's launches; then B1 held
   and timed on the compacted stream of one train batch.
   Exact eval settings: ``val/r_0`` at 800x800 flat, with ``--eval_compact_frac 1.0``
   (compaction alone: equal to the flat frame), ``--eval_fine_grid 256``, + ``--eval_compact_frac
   0.125``, + ``--march_groups 32``, and one pass of 256 slots (``--eval_compaction 0``)
   plain and with all three: s/frame, bake s and occupied cells, overflow, PSNR against
   the image and the flat frame.
6. palette reference: one small ``-O`` palette train step (smooth loss on, basis colors
   unfrozen, hist weights present) on the card against the same step on the CPU: loss
   and every gradient; ``encoder`` and ``sigma_net`` get none on either.
7. palette main path, through ``palettenerf_torch.main_palette.main`` on the stage-1
   workspace of phase 5, at full width: RGBXY palette extraction from sweep renders of
the training views (``--extract_palette --extract_via_sweep``), then 300 palette training steps (three epochs, one per
   schedule phase: colors frozen, + smooth loss, + colors unfrozen) with the test-split
   evaluation and renders the CLI ends with; then the checks of what moved and what
   did not, and one validation view. The extraction's time by phase (bake, sweep
   renders, device-to-host moves, the host's rays and gathers, the host extraction in the
   native kernels), and the host extraction again on the same inputs in NumPy: its
   seconds, and the same palette and weights.
8. serve reference: a small palette field baked and swept on the card and on the CPU
   from the same weights: bake channels within tolerance, frames by PSNR (plain and
   with a RegionEdit recolor).
9. serve main path: ``python -m palettenerf_torch.main_serve <palette workspace> --data
   data_proc/proc_toys --bench`` on the checkpoint phase 7 trained, at full width: 256^3
   bake with vd_bands=2, bitfield mask, sweep volume, 60 frames of 800x800 at u_res 400,
   once with ``--edit_basis 0`` and once plain; then, on the same bake, test view 0
   against its image (color and opacity), the sweep against ``render_baked``, and the
   edit checks.

10. edit reference: a small palette field on the card and on the CPU from the same
    weights: ``EditingSession`` frames (plain, region recolor, weight mode, dials,
    stylizer on) by PSNR, a ``fit_stylizer`` solve (each leaf, relative) and one palette
    GUI step (loss, relative).
11. edit main path: the palette workspace of phase 7, loaded as ``main_palette --test``
    loads it, in an ``EditingSession`` at the ``--gui`` defaults (960x540, radius 5,
    fovy 50): the interaction sequence of ``scripts/record_edit_session.py`` from test
    view 0 (orbit, pick -> spatial region, weight mode, two recolors, reset, the two
    dials, one correspondence -> a 150-step stylizer fit, style off), 4 paced frames
    (``render_dynamic``, 100 ms budget) and a 16-step ``train_burst`` on the training
    split; then ``save_mesh(256, 10)`` of the stage-1 trainer of phase 5 (``main_nerf``'s
    tail), with the PLY's checks.

11b. palette eval settings: the palette eval frame of ``val/r_0`` under the first five
    settings of the stage-1 eval and those of ``scripts/serve_vs_gt.py`` (budget 3/8, 48
    group slots, fine grid) (trainers loaded as ``main_palette --test`` loads them), then one
    ``EditingSession`` frame at the ``--gui`` defaults with ``--eval_fine_grid 256
    --eval_compact_frac 0.125`` at test view 0 (``jump_to_pose`` to test pose 0).

11c. model options reference: on small sizes, card against CPU with the same parameters
    and draws: ``sph_from_ray``, the background grid's encoding (full width) and its f32
    table gradient, ``rlpips_distance`` and its input gradient, one ``-O`` stage-1 step
    with the background net and ``--patch_size 4 --lambda_lpips 0.1`` (loss and every
    gradient), one palette eval render with the background net in linear colour space.
11d. bg + patch main path: ``main_nerf.main`` with ``-O --bg_radius 32 --patch_size 16
    --lambda_lpips 0.1`` on proc_toys at full width, 300 steps from scratch (workspace
    ``results/chip_smoke_bg/version_1``) with the CLI's test tail (the JAX meter list) and
    its mesh at 128^3; validation view 0 against the training target; B1 held and timed
    on the stream of one patch batch.
11e. bg + linear palette main path: ``main_palette`` with ``--bg_radius 32 --color_space
    linear`` on that workspace: extraction via the sweep (``main_palette.main``), then the
    CLI's training run over the three schedule phases (``load_train_trainer`` + ``train``,
    300 steps; its test tail is cut for time); the bg net's warm start (step 0 and the
    log's tensor count), the linear palette, validation view 0 in linear space.

12. -O2 palette main path: ``main_palette.main`` with ``-O2 --random_size 8
    --lambda_patchsmooth 0.004`` on the extraction of phase 7 (host-sampled epochs, one
    per schedule phase, workspace ``results_palette/chip_smoke/version_2``) with the
    CLI's test tail and one validation view; then a 16-step ``train_burst`` of an
    ``EditingSession`` on its ``--test`` trainer.

13. real scene: the Mip-NeRF 360 recipe (``scripts/run_mip360.sh``, ``configs_mip360/
    bonsai.sh``) on the LLFF-layout JPEG fixture ``data_proc/proc_toys_llff`` at full width:
    every image through the native JPEG decoder against ``decoded.json`` (ms per
    megapixel) and the provider's load; ``main_nerf.main`` with ``-O --bound 2`` (two
    occupancy cascades) ``--no_bg --filter_close_point``, iters cut from 90,000 to 300
    (308 steps), with the test tail and a 128^3 mesh: steps/s beside the one-cascade
    ``-O`` path's, occupied cells per cascade, eval s/frame at 333x250, val PSNR; B1 held
    and timed on the stream one step's real cotangents give it; the per-ray extraction
    (``--extract_palette`` without ``--extract_via_sweep``) with its time by phase; 308
    palette steps with ``--datatype mip360`` and the test tail (val PSNR, peak memory).
    ``python3 chip_smoke.py --real-scene-only`` builds and runs this phase alone;
    ``--real-scene-only --trace-memory`` also records the allocator's history around the
    palette run and prints the peak of its second train epoch, its test tail and one eval
    frame, each with the blocks live at it and the code that allocated them.

Depth modes (``python3 chip_smoke.py --depth-only <mode>``, one at a time, none in the default
run): the recipes at their own depth through the CLIs, with the shell recipe's flags (only
``--iters``, ``EXTRA_FLAGS`` and the workspace set). Each prints every ``evaluate_one_epoch``
with its step, holds and times B1 on the last step's update stream, prints a JSON summary and
ends with the result line. ``chain``: ``scripts/run_blender.sh`` with
``configs_proc/proc_toys.sh`` and ``EXTRA_FLAGS="--fast_grad"`` at 8000 steps, the
extraction at ``--extract_downscale 2``, 8000 palette steps and
``palettenerf_torch.serve_vs_gt``, every figure held to the README's JAX figure less 1.0 dB,
with the stage-1 grid's occupied cells, mean density and refreshes beside the JAX package's
and the serve figures again from a 384^3 bake. ``deploy-ab``: the chain's palette stage and
``serve_vs_gt`` on the JAX package's stage-1 field (the committed deploy export's density half,
grid and extracted palette, copied to ``results/deploy_copy`` for the call).
``chain-bf16-matmul``: the chain with its training stages' f32 matmuls at a TPU's default
precision (bf16 operands); ``chain-bf16-matmul-grads``: the matrix products' gradients too.
``stage1``: its stage 1 at ``-O`` (held to the chain's stage-1 floor) and at ``-O2``.
``bg``: the bg + patch stage 1 of phase 11d at 8000 steps. ``mip360``: the recipe of phase 13
at 8400 + 8400 steps, with both cascades' cells and the march reach at every eval;
``mip360-explore``: its stage 1 alone at 20,020 steps. ``llff``: ``scripts/run_llff.sh`` with
``configs_llff/fern.sh`` on the forward-facing JPEG fixture ``data_proc/proc_toys_ff``
(``scripts/make_ff_fixture.py``) at fern's 10,000 + 10,000 steps: stage 1 with its test tail
and 256^3 mesh (each cascade's occupied cells and mean density at every eval), the per-ray
extraction without ``--offset`` as the recipe runs it, the palette stage with its test tail;
val and test PSNR of both stages beside the fixture's mean-colour frame and the black frame,
eval seconds per 504x378 frame, peak memory.

Launch counts are zeroed just before each main path and read just after (the data-parallel
ranks count in their own processes and report them); every kernel of the train, palette
and edit paths must have launched there (the serve path runs no
kernel of its own; on the edit path ``scatter_add`` launches in the training burst only).
A kernel wrapper's ``launches`` counts the host's calls. Where palette steps replay a CUDA
graph (the palette, bg + linear palette, edit, -O2 palette and real-scene palette paths,
and the depth modes' palette stages), the kernels run without a call: those paths count
each kernel's launches on the card from the kernel events of a ``torch.profiler`` window
(``LaunchWindow``) over the training run or burst, whose times are then traced times, and
log the window's palette steps, graph captures and replays beside them.
The line before the last carries the card's name and power limit; before it, one JSON
line lists every kernel with its numbers. The last line is the result object.
Exits non-zero, printing no result, without a CUDA device or outside a checkout.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(ROOT, "data_proc", "proc_toys")
WORKSPACE = os.path.join(ROOT, "results", "chip_smoke")
# the stage-1 workspace, relative to ROOT (the script changes into it): main_palette
# mirrors it under results_palette/ by replacing "results" in the path as given
NERF_WS = os.path.join("results", "chip_smoke", "version_1")

# proc_toys configuration (scripts/configs_proc/proc_toys.sh) with -O, default widths
MAIN_ARGS = [SCENE, "-O", "--bound", "1", "--scale", "0.8", "--bg_radius", "0",
             "--density_thresh", "10", "--iters", "8000", "--seed", "0"]
EPOCHS = 3                 # 100 training views -> 300 steps
PSNR_FLOOR = 20.0          # validation view 0 after 300 steps
# the palette stages: scripts/run_blender.sh with scripts/configs_proc/proc_toys.sh
PALETTE_ARGS = [SCENE, NERF_WS, "-O", "--bound", "1", "--scale", "0.8", "--bg_radius", "0",
                "--density_thresh", "10", "--use_normalized_palette", "--seed", "0"]
EXTRACT_ARGS = PALETTE_ARGS + ["--extract_palette", "--extract_via_sweep"]
# 300 of 8000 iterations: three epochs, one per phase of the schedule
PALETTE_TRAIN_ARGS = PALETTE_ARGS + ["--use_initialization_from_rgbxy", "--dt_gamma", "0",
                                     "--datatype", "blender", "--iters", "300",
                                     "--smooth_loss_start_epoch", "1",
                                     "--max_freeze_palette_epoch", "2"]
PALETTE_PSNR_FLOOR = 21.0  # validation view 0 after 300 + 300 steps: set from the first
#                            card run (23.153 dB) with ~2 dB margin
ALPHA_PSNR_FLOOR = 24.0    # sweep opacity of test view 0 vs its ground truth alpha: set
#                            from the first card run (25.308 dB) with ~1.3 dB margin
SERVE_COLOR_PSNR_FLOOR = 23.0  # sweep frame of test view 0 vs its image, on the checkpoint
#                                the palette phase trains: first card run 25.275 dB
SWEEP_VS_BAKED_FLOOR = 26.0  # sweep vs render_baked, the threshold of tests/test_sweep.py
BAKE_RTOL, BAKE_ATOL = 1e-4, 1e-5  # card vs CPU bake: f32 sums in another order
SWEEP_CARD_PSNR = 40.0     # card vs CPU sweep frame, bf16 shade (rounding flips)
EDIT_CARD_PSNR = 100.0     # card vs CPU EditingSession frames (f32 throughout): set from the
#                            first card run (119.80 dB for every frame) with ~20 dB margin
STYLIZER_RTOL = 1e-4       # card vs CPU stylizer leaves after 20 Adam steps, of each leaf's
#                            max (first card run: 1.2e-07), as tests/test_torch_gui.py holds JAX
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
SM_CLOCK_HZ = 1.7e9        # roughly; only sizes the head start of time_ms
PALETTE = [[0.9, 0.2, 0.1], [0.1, 0.8, 0.3], [0.2, 0.3, 0.9], [0.8, 0.8, 0.2],
           [0.6, 0.4, 0.7]]
# the -O2 stage-1 path: the same configuration with -O2 (= -O + --fast_grad
# --stochastic_trilerp --grad_levels 8) in place of -O
O2_ARGS = [("-O2" if a == "-O" else a) for a in MAIN_ARGS]
O2_WS = os.path.join("results", "chip_smoke_o2", "version_1")
XADD_WS = os.path.join("results", "chip_smoke_xadd", "version_1")
O2_PSNR_FLOOR = 18.0       # validation view 0 after 300 -O2 steps: set from the first
#                            card run (19.737 dB; -O 21.759 dB) with ~1.7 dB margin
# the -O2 palette path: scripts/run_blender.sh:58-84 with configs_blender/hotdog.sh's
# --random_size 8, -O2 in place of -O, and the patch-smooth term on at the default
# weight of the other smooth term (--lambda_smooth 0.004); workspace version_2 beside
# the -O palette path's version_1
PATCHSMOOTH = 0.004
O2_PALETTE_ARGS = [("-O2" if a == "-O" else a) for a in PALETTE_TRAIN_ARGS] + [
    "--random_size", "8", "--lambda_patchsmooth", str(PATCHSMOOTH), "--version_id", "2"]
O2_PALETTE_PSNR_FLOOR = 21.0  # validation view 0 after 300 + 300 steps: set from the
#                               first card run (22.684 dB; -O 23.127 dB) with ~1.7 dB margin
PICK_FLIP_SHARE = 1e-5     # card vs CPU corner draws that may differ (u within an ulp of a
#                            cumulative weight)
SCATTER_RTOL = 1e-5        # of the row's summed |update|: f32 atomics reorder the sums
SCATTER_PERIOD = 128       # corner columns per point: 16 levels x 8 corners
TABLE_ROWS = 6_119_864     # full width: 16 levels, 2^19 rows per hashed level
# sample compaction, the fine eval grid and the hierarchical march (opt-in flags)
COMPACT_FRAC = 0.25        # --train_compact_frac of the compacted train epoch
EVAL_SETTINGS = {          # exact-eval settings, each against the flat frame
    "flat": [],
    "compact": ["--eval_compact_frac", "1.0"],    # compaction alone: a budget of every slot
    "fine": ["--eval_fine_grid", "256"],
    "fine+compact": ["--eval_fine_grid", "256", "--eval_compact_frac", "0.125"],
    "fine+compact+groups": ["--eval_fine_grid", "256", "--eval_compact_frac", "0.125",
                            "--march_groups", "32"],
}
# the stage-1 eval only: one pass of 256 slots instead of the compaction rounds (the
# JAX package's metric setting), plain and with all three options
STAGE1_SETTINGS = dict(EVAL_SETTINGS, **{
    "single pass": ["--eval_compaction", "0"],
    "single pass+fine+compact+groups": ["--eval_compaction", "0", "--eval_fine_grid", "256",
                                        "--eval_compact_frac", "0.125", "--march_groups", "32"],
})
# the palette eval only: the settings of scripts/serve_vs_gt.py:50 (a budget of 3/8, 48
# group slots) on the fine grid
PALETTE_SETTINGS = dict(EVAL_SETTINGS, **{
    "fine+compact 3/8+groups 48": ["--eval_fine_grid", "256", "--eval_compact_frac", "0.375",
                                   "--march_groups", "48"],
})
COMPACT_EXACT_ATOL = 1e-4  # compacted frame vs uncompacted with zero overflow: f32 sums
# PSNR against the flat frame, set from the first card runs (NVIDIA H100 80GB HBM3, 700 W) with
# margin. Stage 1 (dt_gamma 1/128): fine inf (the fine test never applies: dt > 2/256
# past t = 1), + compact and + groups 11.74-11.81 dB (the rounds' budgets drop 3.65 M
# samples), one pass with all three 150.1 dB. Palette (dt_gamma 0): fine 51.08 dB,
# + compact 11.91 dB, + groups 12.55 dB (11-14 M samples dropped: 21% of the slots hold one)
STAGE1_PSNR_FLOORS = {"fine": 60.0, "fine+compact": 10.5, "fine+compact+groups": 10.5,
                      "single pass+fine+compact+groups": 60.0}
PALETTE_PSNR_FLOORS = {"fine": 45.0, "fine+compact": 10.5, "fine+compact+groups": 11.0}
EDIT_COMPACT_PSNR_FLOOR = 21.0  # edit frame, fine grid + budget 1/8 vs plain: first run
#                                 23.13 dB (633 k samples dropped)
COMPACT_TS_RTOL = 1e-6     # card vs CPU march t with exp in the step rule (a few ulp)
COMPACT_CARD_ATOL = 2e-5   # card vs CPU compacted train render: f32 sums in another order
COMPACT_GRAD_RTOL = 1e-4   # of each gradient tensor's largest entry (f32 atomics, sums)
# the model options of the background net, the patch loss and the linear colour space:
# stage 1 with torch-ngp's unbounded-scene background radius (any radius beyond the
# cameras' 1.88 units after --scale 0.8) and the rLPIPS loss on 16 patches of 16x16
BG_RADIUS = 32.0
BG_PATCH_WS = os.path.join("results", "chip_smoke_bg", "version_1")
BG_PATCH_ARGS = [SCENE, "-O", "--bound", "1", "--scale", "0.8", "--density_thresh", "10",
                 "--bg_radius", str(BG_RADIUS), "--patch_size", "16", "--lambda_lpips", "0.1",
                 "--iters", "300", "--seed", "0", "--workspace", "chip_smoke_bg",
                 "--version_id", "1"]
BG_MESH_RESOLUTION = 128   # the CLI's mesh tail, at 128^3 instead of 256^3 (host time)
# then the palette stages on that workspace in linear colour space (workspaces mirrored
# under results_palette/chip_smoke_bg/)
BG_LINEAR_ARGS = [SCENE, BG_PATCH_WS, "-O", "--bound", "1", "--scale", "0.8",
                  "--density_thresh", "10", "--bg_radius", str(BG_RADIUS), "--color_space",
                  "linear", "--use_normalized_palette", "--seed", "0"]
BG_LINEAR_TRAIN_ARGS = BG_LINEAR_ARGS + PALETTE_TRAIN_ARGS[len(PALETTE_ARGS):]
OPTIONS_GRAD_RTOL = 1e-4   # card vs CPU gradients of the f32 tensors, of each tensor's largest
#                            entry: f32 sums and atomics in another order
# card vs CPU gradients of the background net (encoder_bg, bg_net), |a - b| / |a| over the
# tensor: sph_from_ray differs by ulps between the devices (atan2, sqrt: 2.4e-7), which at
# the finest background level (2048 cells across [0, 1]) moves a sample by 2.5e-4 of a cell;
# on the lively table of the reference that moves the bg gradients by 8.4e-3 (L2) and
# 3.4e-2 (largest entry) (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6)
BG_GRAD_L2_RTOL = 3e-2
OPTIONS_RENDER_ATOL = 1e-4  # card vs CPU palette eval render with the bg net: f32 sums
# val view 0 against the training target (the straight RGB; linear for the palette), set
# from the card runs with ~2 dB margin: 12.609 dB after 300 bg + patch steps, 14.390 dB after
# 300 + 300 steps in linear space (NVIDIA H100 80GB HBM3, 700 W). Low: with the bg net the
# field fogs up early on this scene (PERF.md §6)
BG_PATCH_PSNR_FLOOR = 10.5
BG_LINEAR_PSNR_FLOOR = 12.0

# ray data-parallel phase: two gloo ranks sharing cuda:0 beside one process, the -O
# configuration at full width on the first DP_VIEWS training views (an epoch of DP_VIEWS
# steps), DP_EPOCHS epochs
DP_WORLD = 2
DP_VIEWS = 20
DP_EPOCHS = 5               # 100 steps: parameters, EMA and bitfield equal across ranks
DP_FIRST_RTOL = 1e-5        # the first step's loss: the same rays, the means in another order
DP_TRAJ_RTOL = 2e-3         # the first DP_VIEWS steps' losses (tests/test_trainer_dp_resume.py)
DP_TIMEOUT_S = 300.0        # the two ranks' deadline
# the Mip-NeRF 360 recipe (scripts/run_mip360.sh with configs_mip360/bonsai.sh) on the
# LLFF-layout JPEG fixture, iters cut from 90,000 to 300
LLFF_SCENE = os.path.join(ROOT, "data_proc", "proc_toys_llff")


def mip360_nerf_args(data_dir, name, iters, extra=()):
    """``scripts/run_mip360.sh -m nerf`` with ``configs_mip360/bonsai.sh`` on ``data_dir``."""
    return [data_dir, "--workspace", name, "--iters", str(iters), "--bound", "2", "--offset",
            "0", "0", "0", "--scale", "0.16", "--bg_radius", "0", "--density_thresh", "10",
            "--lambda_sparse", "0.00", "--min_near", "0.2", "-O", "--no_bg",
            "--filter_close_point", *extra]


def mip360_extract_args(data_dir, nerf_model):
    """``scripts/run_mip360.sh -m extract`` with ``configs_mip360/bonsai.sh``."""
    return [data_dir, nerf_model, "-O", "--bound", "2", "--scale", "0.16", "--bg_radius", "0",
            "--density_thresh", "10", "--min_near", "0.2", "--extract_palette",
            "--use_normalized_palette"]


def mip360_palette_args(data_dir, nerf_model, iters, extra=()):
    """``scripts/run_mip360.sh -m palette`` with ``configs_mip360/bonsai.sh``."""
    return [data_dir, nerf_model, "-O", "--iters", str(iters), "--bound", "2", "--scale",
            "0.16", "--offset", "0", "0", "0", "--bg_radius", "0", "--density_thresh", "10",
            "--min_near", "0.2", "--random_size", "0", "--use_initialization_from_rgbxy",
            "--use_normalized_palette", "--datatype", "mip360", *extra]


REAL_NERF_ARGS = mip360_nerf_args(LLFF_SCENE, "chip_smoke_real", 300)
REAL_EXTRACT_ARGS = mip360_extract_args(LLFF_SCENE, os.path.join("results", "chip_smoke_real"))
REAL_PALETTE_ARGS = mip360_palette_args(LLFF_SCENE, os.path.join("results", "chip_smoke_real"),
                                        300)
REAL_MESH_RESOLUTION = 128  # the CLI's mesh tail at 128^3 (host time)
# validation view 0 (333x250) after 308 steps, stage 1 and then the palette: set from the
# first card run (8.535 and 7.390 dB) with ~1 dB margin. At this depth the field is poor
# (the all-white frame scores 7.59 dB on that view): the train step's 64 slots reach only
# t ~0.42 from min_near 0.2 through every cell the cameras see, the cameras 0.64 from the
# centre (ROADMAP C16)
REAL_PSNR_FLOOR = 7.5
REAL_PALETTE_PSNR_FLOOR = 6.4


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 10, warmup: int = 2, head_start_ms: float = 0.0) -> float:
    """Device ms per call of ``fn`` between two CUDA events. ``head_start_ms``: the
    device first spins that long, so that the host has queued every call before the
    first one runs; a call shorter than its own launch overhead is then timed by what
    the device takes, not by how fast the host can launch it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if head_start_ms:
        torch.cuda._sleep(int(head_start_ms * 1e-3 * SM_CLOCK_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _counted():
    """Every kernel wrapper with its launch counter, by kernel name."""
    from palettenerf_torch.ops import hashgrid_fast, scatter, window_gather

    return {"scatter_add": scatter.scatter_add, "window_gather": window_gather.window_gather,
            "hashgrid_encode": hashgrid_fast.encode_kernel}


def zero_counts() -> None:
    for fn in _counted().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counted().items()}


class LaunchWindow:
    """Each kernel's launches on the card, by the names of ``_counted``, from the kernel
    events of a ``torch.profiler`` window (``profiling.kernel_launches``): the count where
    palette steps replay a CUDA graph, whose kernels run without a call of their wrapper.
    Open from its making to ``close()``, to the end of a palette training run
    (``PaletteTrainer.train``) that ends inside it, or to the end of its ``epochs``-th
    palette training epoch (a long run's
    trace would hold millions of kernels). The recorder is on inside (the steps then replay a
    graph of their own): ``steps``, ``captures`` and ``replays`` are the window's training
    steps, graph captures and replays."""

    def __init__(self, epochs: int = None):
        from palettenerf_torch.train.palette_trainer import PaletteTrainer
        from palettenerf_torch.utils import profiling

        self.launches = None
        train_run, epoch = PaletteTrainer.train, PaletteTrainer.train_one_epoch
        window, left = self, [epochs]

        def train(tr, *a, **kw):
            try:
                return train_run(tr, *a, **kw)
            finally:
                window.close()

        def train_one_epoch(tr, *a, **kw):
            out = epoch(tr, *a, **kw)
            if left[0] is not None:
                left[0] -= 1
                if left[0] == 0:
                    window.close()
            return out

        self._saved = {k: PaletteTrainer.__dict__.get(k) for k in ("train", "train_one_epoch")}
        PaletteTrainer.train, PaletteTrainer.train_one_epoch = train, train_one_epoch
        profiling.reset()
        profiling.enable()
        self._window = profiling.kernel_launches(list(_counted()))
        self._counts = self._window.__enter__()

    def close(self) -> dict:
        """Close the window (once); returns the launches by kernel name."""
        from palettenerf_torch.train.palette_trainer import PaletteTrainer
        from palettenerf_torch.utils import profiling

        if self.launches is None:
            for name, fn in self._saved.items():  # None: inherited
                if fn is None:
                    delattr(PaletteTrainer, name)
                else:
                    setattr(PaletteTrainer, name, fn)
            self._window.__exit__(None, None, None)
            snap = profiling.snapshot()
            profiling.enable(False)
            profiling.reset()
            self.launches = dict(self._counts)
            self.steps = snap["spans"].get("train.step", {}).get("count", 0)
            self.captures = snap["counters"].get("train.graph.captures", 0)
            self.replays = snap["counters"].get("train.graph.replays", 0)
            log(f"launch window: {self.launches} on the card; {self.steps} steps of "
                f"training epochs, {self.captures} graph captures, {self.replays} replays")
        return self.launches


def scatter_kernels(scatter, period):
    """The kernels of ``scatter_add`` by name: the path's call (a period: the column
    walk), the call without a period (one vector atomic per row in the stream's order),
    and the yardstick both are timed against (scalar atomics, the first design)."""
    kernels = {"columns": lambda *a: scatter.scatter_add(*a, period),
               "rows": lambda *a: scatter.scatter_add(*a),
               "scalar": lambda *a: scatter._scatter_add(*a, period, scalar=True)}
    if period is None:  # a stream the path hands over without its layout: no column walk
        del kernels["columns"]
    return kernels


def check_scatter(torch, scatter, idx, vals, total, what, period):
    """Every kernel of ``scatter_add`` vs the plain version; returns (max abs error, the
    result of the path's call). Raises on disagreement or on a row the kernel refused."""
    ref = scatter.scatter_add_reference(idx, vals, total)
    scale = scatter.scatter_add_reference(idx, vals.abs(), total)
    kernels = scatter_kernels(scatter, period)
    max_err, first = 0.0, None
    for name, call in kernels.items():
        got = call(idx, vals, total)
        torch.cuda.synchronize()
        scatter.check_refused()
        err = (got - ref).abs()
        bad = int((err > SCATTER_RTOL * scale).sum())
        if bad or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"scatter_add {what} ({name}): {bad} rows differ from the "
                                 f"plain version beyond {SCATTER_RTOL} of their summed |update|")
        max_err = max(max_err, float(err.max()))
        first = got if first is None else first
    log(f"scatter_add {what}: U={idx.numel()} C={vals.shape[1]} rows={total} kernels "
        f"{list(kernels)} max_abs_err={max_err:.3e}")
    return max_err, first


def time_scatter(torch, scatter, idx, vals, total, what, period=SCATTER_PERIOD):
    """Times of one stream: the path's call (the column walk with a period, else stream
    order), the other kernels, the plain version and ``index_add_``. ms per call, wrapper
    included (zero-fill of the output)."""
    vals_f32 = vals.float()
    out_f32 = torch.zeros((total, vals.shape[1]), device=idx.device)
    t = {}
    for i, (name, call) in enumerate(scatter_kernels(scatter, period).items()):
        t["ms" if i == 0 else f"{name}_ms"] = time_ms(torch, lambda: call(idx, vals, total))
    t["plain_ms"] = time_ms(torch, lambda: scatter.scatter_add_reference(idx, vals, total))
    t["library_ms"] = time_ms(torch, lambda: out_f32.index_add_(0, idx, vals_f32))
    walk = (f"column walk {t['ms']:.3f} ms, vector atomic per row in stream order "
            f"{t['rows_ms']:.3f} ms" if period else
            f"vector atomic per row in stream order {t['ms']:.3f} ms")
    log(f"scatter_add timing, {what} stream, U={idx.numel()}: {walk}, scalar atomics "
        f"{t['scalar_ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, index_add_ "
        f"{t['library_ms']:.3f} ms")
    return t


def stream_stats(torch, spec, idx, vals, what, period=SCATTER_PERIOD):
    """What the stream asks of the atomic units: how many updates land on the dense
    coarse levels, the longest same-row chain, how many updates are zero, and (with the
    stream's ``period``) how many repeat the row of the point before them in their column."""
    coarse = float((idx < spec.offsets[5]).float().mean())
    per_row = torch.bincount(idx.long(), minlength=spec.total_params)
    zero = float((vals == 0).all(-1).float().mean())
    repeat = ""
    if period:
        cols = idx.view(-1, period)
        repeat = (f", {100 * float((cols[1:] == cols[:-1]).float().mean()):.2f}% repeat the "
                  f"row of the point before")
    log(f"{what} stream: {100 * coarse:.2f}% of updates on levels 0-4 "
        f"({spec.offsets[5]} rows), largest per-row update count {int(per_row.max())}, "
        f"{int((per_row > 0).sum())} rows touched, {100 * zero:.2f}% of updates all-zero"
        + repeat)


@contextlib.contextmanager
def last_scatter():
    """The arguments of the last ``scatter_add`` call of the hash-grid backward while open
    (the launch is still counted by the kernel's own wrapper), and the number of calls."""
    from palettenerf_torch.ops import hashgrid_fast

    kernel, stream = hashgrid_fast.scatter_add, {"calls": 0}

    def keep(idx, vals, total_rows, period=None):
        stream.update(idx=idx, vals=vals, total=total_rows, period=period,
                      calls=stream["calls"] + 1)
        return kernel(idx, vals, total_rows, period)

    hashgrid_fast.scatter_add = keep
    try:
        yield stream
    finally:
        hashgrid_fast.scatter_add = kernel


def stream_numbers(torch, spec, stream, what):
    """B1 on a kept update stream: every kernel against the plain version, the stream's
    statistics, the times (the path's kernel, the others, plain, ``index_add_``) and the
    byte bound."""
    from palettenerf_torch.ops import scatter

    idx, vals, total, period = (stream[k] for k in ("idx", "vals", "total", "period"))
    if total != spec.total_params:
        raise AssertionError(f"{what} stream: {total} rows, the table has {spec.total_params}")
    max_err, _ = check_scatter(torch, scatter, idx, vals, total, f"{what} stream", period)
    stream_stats(torch, spec, idx, vals, what, period)
    t = time_scatter(torch, scatter, idx, vals, total, what, period)
    U, C = idx.numel(), vals.shape[1]
    n_bytes = U * (4 + 2 * C) + total * C * 4
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, U * C / FP32_FLOPS * 1e3
    t.update(U=U, period=period, max_abs_err=max_err,
             nonzero_share=float((vals != 0).any(-1).float().mean()),
             bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
    log(f"scatter_add on the {what} stream: U={U}, period {period}, "
        f"{100 * t['nonzero_share']:.2f}% of the updates non-zero, bound "
        f"{t['bound_ms']:.4f} ms ({n_bytes / 1e6:.1f} MB)")
    return t


def phase_kernels(torch, dev):
    from palettenerf_torch.ops import hashgrid_fast, scatter
    from palettenerf_torch.ops.hashgrid import HashGridSpec

    spec = HashGridSpec.build(desired_resolution=2048, num_levels=16, level_dim=2,
                              log2_hashmap_size=19)
    total, C, P = spec.total_params, spec.level_dim, SCATTER_PERIOD
    gen = torch.Generator(device=dev).manual_seed(0)
    # the main path's shape: one encode of 4096 rays x 64 samples -> 33,554,432 corner rows
    x = torch.rand((4096 * 64, 3), generator=gen, device=dev)
    idx = hashgrid_fast.corner_indices(spec, x)[0].reshape(-1).contiguous()
    U = idx.numel()
    vals = (torch.randn((U, C), generator=gen, device=dev) * 1e-3).to(torch.bfloat16)
    max_err, _ = check_scatter(torch, scatter, idx, vals, total, "main-path shape", P)

    def ones(n, c):
        return torch.ones((n, c), device=dev, dtype=torch.bfloat16)

    dup = (torch.arange(1 << 20, device=dev, dtype=torch.int32) % 7).contiguous()
    _, got = check_scatter(torch, scatter, dup, ones(1 << 20, 2), 4096 * 2,
                           "heavy duplicates", P)
    if float(got[:7].min()) != float((1 << 20) // 7):
        raise AssertionError("heavy duplicates: counts are not exact")
    # equal rows one period apart, 16 points in a row, a ragged last chunk of points
    n_pts = 8192 + 5
    periodic = ((torch.arange(n_pts, device=dev, dtype=torch.int32) // 16)[:, None] * P
                + torch.arange(P, device=dev, dtype=torch.int32)[None, :]).reshape(-1)
    n_rows = int(periodic.max()) + 1
    for c in (1, 2, 4, 8):
        _, got = check_scatter(torch, scatter, periodic, ones(n_pts * P, c), n_rows,
                               f"periodic duplicates C={c}", P)
        counts = torch.bincount(periodic.long(), minlength=n_rows).float()
        if not torch.equal(got, counts[:, None].expand(-1, c)):
            raise AssertionError(f"periodic duplicates C={c}: counts are not exact")
    few = torch.arange(256, device=dev, dtype=torch.int32)
    _, got = check_scatter(torch, scatter, few, ones(256, 2), total, "empty tiles", P)
    if float(got[256:].abs().max()) != 0.0:
        raise AssertionError("empty tiles: rows without updates are not zero")
    check_scatter(torch, scatter, idx[: 1 << 22].contiguous(),
                  vals[: 1 << 22, :1].contiguous(), total, "C=1", P)
    vals4 = (torch.randn((1 << 22, 4), generator=gen, device=dev) * 1e-3).to(torch.bfloat16)
    check_scatter(torch, scatter, idx[: 1 << 22].contiguous(), vals4, total, "C=4", P)
    check_scatter(torch, scatter, idx[: 1 << 20].contiguous(), vals4[: 1 << 20, :3].contiguous(),
                  total, "C=3 (general case)", P)
    # a row out of range is refused: neither written nor silent
    bad = few.clone()
    bad[7] = total
    got = scatter.scatter_add(bad, ones(256, 2), total, P)
    torch.cuda.synchronize()
    try:
        scatter.check_refused()
    except ValueError:
        if float(got.sum()) != 2.0 * 255:
            raise AssertionError("scatter_add wrote a row it refused") from None
    else:
        raise AssertionError("scatter_add passed a row out of range silently")

    stream_stats(torch, spec, idx, vals, "uniform")
    t = time_scatter(torch, scatter, idx, vals, total, "uniform")
    n_bytes = U * (4 + 2 * C) + total * C * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = U * C / FP32_FLOPS * 1e3
    entry = {
        "name": "scatter_add", "route": "cuda",
        "source": "palettenerf_torch/csrc/scatter_add.cu",
        "replaces": "palettenerf_tpu/ops/pallas_scatter.py:102",
        "launches": None, "max_abs_err": max_err, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": t["library_ms"], "rows_ms": t["rows_ms"], "scalar_ms": t["scalar_ms"],
    }
    log(f"scatter_add bound {entry['bound_ms']:.4f} ms ({n_bytes / 1e6:.1f} MB)")
    return [entry]


def encode_bytes(M: int, L: int, C: int, residuals: bool) -> int:
    """The bytes the exact forward must move: 12 in and 4 L C out per point, plus the
    residuals' 8 L K (int32 row and f32 weight of each of K = 8 corners) with a backward."""
    return M * (12 + 4 * L * C + (8 * L * 8 if residuals else 0))


def phase_encode(torch, dev):
    """The hash-grid encoder's exact forward kernel (csrc/hashgrid_encode.cu) at the cells'
    encoder (16 levels x 2, 6,119,864 rows): bit for bit against the plain version on the
    card, then timed beside the plain version and the compulsory-byte bound at the train
    shape (262,144 points, with and without residuals) and at round 0 of an exact chunk
    (1,048,576 points, without), on uniform points and on points along rays (64 a segment
    across the box). The table stays in L2 between calls, as it largely does on the path."""
    from palettenerf_torch.ops import hashgrid_fast as hf
    from palettenerf_torch.ops.hashgrid import HashGridSpec

    spec = HashGridSpec.build(desired_resolution=2048, num_levels=16, level_dim=2,
                              log2_hashmap_size=19)
    L, C = spec.num_levels, spec.level_dim
    gen = torch.Generator(device=dev).manual_seed(5)
    table = (torch.rand((spec.total_params, C), generator=gen, device=dev) * 2 - 1) * 1e-2

    def points(kind, M):
        if kind == "uniform":
            return torch.rand((M, 3), generator=gen, device=dev)
        a, b = (torch.rand((M // 64, 1, 3), generator=gen, device=dev) for _ in range(2))
        t = torch.linspace(0, 1, 64, device=dev)[None, :, None]
        return (a + (b - a) * t).reshape(M, 3)

    def plain(x, residuals):
        if residuals:
            return hf._encode_plain(table, spec, x, None, False)
        return torch.cat([hf._encode_plain(table, spec, x[s:s + hf.NO_GRAD_CHUNK], None,
                                           False)[0]
                          for s in range(0, x.shape[0], hf.NO_GRAD_CHUNK)]), None

    rows = []
    for shape, M, residuals in (("train", 1 << 18, True), ("train", 1 << 18, False),
                                ("exact round 0", 1 << 20, False)):
        for kind in ("uniform", "rays"):
            x = points(kind, M)
            x[:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [-0.01, 0.5, 0.5],
                                  [0.5, 0.5, 1.01]], device=dev)
            want, want_res = plain(x, residuals)
            got, res = hf.encode_kernel(table, spec, x, residuals)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            if residuals:
                same &= all(torch.equal(res[i], want_res[i]) for i in (0, 1, 4))
            if not same:
                raise AssertionError(f"hashgrid_encode {shape} {kind}: not the plain "
                                     f"version's bit for bit")
            del want, want_res, got, res
            iters = 20 if M <= 1 << 18 else 10
            row = {"shape": shape, "points": kind, "M": M, "residuals": residuals,
                   "ms": time_ms(torch, lambda: hf.encode_kernel(table, spec, x, residuals),
                                 iters=iters),
                   "plain_ms": time_ms(torch, lambda: plain(x, residuals), iters=3, warmup=1),
                   "bound_ms": encode_bytes(M, L, C, residuals) / HBM_BYTES_PER_S * 1e3}
            log(f"hashgrid_encode {shape}, {kind} points, M={M}, residuals {residuals}: "
                f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({encode_bytes(M, L, C, residuals) / 1e6:.1f} MB); "
                f"bit for bit")
            rows.append(row)
    first = rows[0]
    return {"name": "hashgrid_encode", "route": "cuda",
            "source": "palettenerf_torch/csrc/hashgrid_encode.cu", "replaces": None,
            "launches": None, "max_abs_err": 0.0, "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"], "bound_by": "bytes",
            "shapes": rows}


def phase_window_gather(torch, dev):
    """window_gather against its plain version, bit for bit: the shapes of
    tests/test_window_gather.py, Rw 1 and 32, bf16 windows, M8 from 1 to 65,536; an
    index out of range; then the timed standalone run at the largest shape (its launches
    are the entry's count)."""
    from palettenerf_torch.ops import window_gather as wg

    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [(8, 100, torch.float32), (16, 64, torch.float32), (1, 4096, torch.float32),
             (32, 4096, torch.float32), (16, 4096, torch.bfloat16), (32, 1, torch.float32),
             (32, 3, torch.bfloat16), (1, 65536, torch.bfloat16),
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
    wg.check_refused()
    log(f"window_gather: bit-exact at {len(cases)} shapes (Rw 1..32, M8 up to 65536, "
        f"f32 and bf16), max_abs_err {max_err}")

    # an index outside the window is refused: zero bits written, and not silently
    r_bad = r.clone()
    r_bad[5, 9] = 32
    got = wg.window_gather(W, r_bad, c)
    torch.cuda.synchronize()
    try:
        wg.check_refused()
    except ValueError:
        ref[5, 9] = 0
        if not torch.equal(got, ref):
            raise AssertionError("window_gather: a refused index changed other outputs") from None
    else:
        raise AssertionError("window_gather passed an index out of range silently")

    # timed at the largest shape (the last case): the wrapper, plain version, torch.take
    rows, m8, _ = cases[-1]
    flat_idx = (r.long() * 128 + c.long())
    wg.window_gather.launches = 0
    ahead = dict(iters=50, warmup=5, head_start_ms=20.0)  # the calls are ~40 us each
    ms = time_ms(torch, lambda: wg.window_gather(W, r, c), **ahead)
    launches = wg.window_gather.launches
    back_to_back_ms = time_ms(torch, lambda: wg.window_gather(W, r, c), iters=50, warmup=5)
    plain_ms = time_ms(torch, lambda: wg.window_gather_reference(W, r, c), **ahead)
    library_ms = time_ms(torch, lambda: torch.take(W.reshape(-1), flat_idx), **ahead)
    n_bytes = m8 * 128 * (4 + 4 + 4) + rows * 128 * 4
    entry = {
        "name": "window_gather", "route": "cuda",
        "source": "palettenerf_torch/csrc/window_gather.cu",
        "replaces": "palettenerf_tpu/ops/pallas_window_gather.py:45",
        "path": "standalone", "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": library_ms, "back_to_back_ms": back_to_back_ms,
    }
    log(f"window_gather timing at Rw={rows} M8={m8} f32: kernel {ms:.4f} ms (the "
        f"wrapper, calls queued ahead; {back_to_back_ms:.4f} ms per call launched back to back), "
        f"plain {plain_ms:.4f} ms, "
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
    trainer = Trainer("ngp", cfg, spec, workspace=os.path.join(ROOT, NERF_WS),
                      use_checkpoint="scratch", eval_interval=10_000, device=dev)
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
    if launches["hashgrid_encode"] < steps:
        raise AssertionError(f"hashgrid_encode launched {launches['hashgrid_encode']} times "
                             f"in {steps} train steps")
    finite = all(bool(torch.isfinite(p).all()) for p in param_list(trainer.params))
    finite &= all(np.isfinite(v).all() for v in out.values())
    if not finite:
        raise AssertionError("non-finite parameters or render")
    if out["image"].shape != (train_ds.H, train_ds.W, 3):
        raise AssertionError(f"render shape {out['image'].shape}")
    if not val_psnr > PSNR_FLOOR:
        raise AssertionError(f"validation PSNR {val_psnr:.3f} dB <= floor {PSNR_FLOOR}")
    return launches, phase_path_stream(torch, trainer, train_ds), train_ds, trainer, val_psnr


def march_train_batch(torch, trainer, train_ds, seed, inds=None, bitfield=None):
    """One train batch as the train step marches it: 4096 random pixels of training view
    0 (or its pixels ``inds``) through the trainer's occupancy grid (or ``bitfield``),
    jittered, 64 sample slots per ray. Returns (the march, the sample positions in [0, 1]^3
    [N*S, 3], the generator drawn from)."""
    from palettenerf_torch.data.rays import gen_rays_torch
    from palettenerf_torch.ops.rays import near_far_from_aabb
    from palettenerf_torch.render.nerf_renderer import _aabb, _march

    dev, st = trainer.device, trainer.train_settings
    gen = torch.Generator(device=dev).manual_seed(seed)
    if inds is None:
        inds = torch.randint(0, train_ds.H * train_ds.W, (trainer.opt.num_rays,),
                             generator=gen, device=dev)
    n = inds.numel()
    rays_o, rays_d = gen_rays_torch(torch.as_tensor(train_ds.poses[0]).to(dev),
                                    [float(v) for v in train_ds.intrinsics], train_ds.H,
                                    train_ds.W, inds)
    nears, fars = near_far_from_aabb(rays_o, rays_d, _aabb(st, dev), st.min_near)
    bitfield = trainer.grid_state.bitfield if bitfield is None else bitfield
    m = _march(rays_o, rays_d, nears, fars, bitfield, st, st.num_samples,
               torch.rand((n,), generator=gen, device=dev))
    return m, (m.xyzs.reshape(-1, 3) + st.bound) / (2.0 * st.bound), gen


def phase_path_stream(torch, trainer, train_ds):
    """``scatter_add`` on the stream one train batch gives it on the trained field: 4096
    random pixels of training view 0, marched through the trained occupancy grid as the
    train step marches them (jittered, 64 sample slots per ray), the sample positions
    through the encoder's corner indices, seeded bf16 values that are zero in the padded
    sample slots (their cotangents are zero in the train step). Held against the plain
    version, then timed; returns the times with ``path_`` before each name."""
    from palettenerf_torch.ops import hashgrid_fast, scatter

    dev, spec, st = trainer.device, trainer.spec.grid, trainer.train_settings
    n = trainer.opt.num_rays
    m, x01, gen = march_train_batch(torch, trainer, train_ds, 5)
    idx = hashgrid_fast.corner_indices(spec, x01)[0].reshape(-1).contiguous()
    U, C = idx.numel(), spec.level_dim
    if U != n * st.num_samples * SCATTER_PERIOD:
        raise AssertionError(f"path stream has {U} updates")
    vals = torch.randn((U, C), generator=gen, device=dev) * 1e-3
    vals = (vals.view(-1, SCATTER_PERIOD, C) * m.mask.reshape(-1, 1, 1)).view(U, C)
    vals = vals.to(torch.bfloat16)
    log(f"path stream: {n} rays x {st.num_samples} slots, "
        f"{100 * float(m.mask.float().mean()):.2f}% of the slots hold a sample")
    check_scatter(torch, scatter, idx, vals, spec.total_params, "path stream", SCATTER_PERIOD)
    stream_stats(torch, spec, idx, vals, "path")
    t = time_scatter(torch, scatter, idx, vals, spec.total_params, "path")
    return {f"path_{k}": v for k, v in t.items()}


def digest(tensors) -> str:
    """A hash of the tensors' bytes: two ranks give the same only if every bit agrees."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def dp_run(out_dir: str, n_devices: int, device: str = "cuda") -> None:
    """The ``-O`` trainer as ``main_nerf`` builds it, at full width on the first DP_VIEWS
    training views of proc_toys, for DP_EPOCHS epochs: in a rank of a ``--n_devices`` run
    (spawned by ``phase_dp``; the rank's device) or, with ``n_devices`` 1, in this process
    (on ``device``). Writes ``<out_dir>/rank<r>.json``: every step's loss, steps/s over
    epochs 2 on, peak device memory, every kernel's launches in the run and digests of
    the parameters, the EMA and the bitfield. Rank 0 of a run of ranks keeps the update
    stream its last step gave ``scatter_add`` and, once every rank is done with the card,
    holds the kernel against its plain version on it and times it (``dp_stream``)."""
    import torch

    from palettenerf_torch import parallel
    from palettenerf_torch.config import Config
    from palettenerf_torch.data.provider import NeRFDataset
    from palettenerf_torch.main_nerf import build_parser
    from palettenerf_torch.models.mlp import param_leaves
    from palettenerf_torch.models.nerf import NeRFSpec
    from palettenerf_torch.ops import hashgrid_fast
    from palettenerf_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = parallel.group()
    dev = torch.device(device) if g is None else g.device
    rank = 0 if g is None else g.rank
    cfg = Config.from_args(build_parser().parse_args(
        MAIN_ARGS + ["--n_devices", str(n_devices)]))
    spec = NeRFSpec.build(bound=cfg.bound, bg_radius=cfg.bg_radius, fp16=cfg.fp16_enabled,
                          log2_hashmap_size=cfg.log2_hashmap_size,
                          grid_levels=cfg.grid_levels, grid_level_dim=cfg.grid_level_dim)
    train_ds = NeRFDataset(cfg, type="train")
    train_ds.poses, train_ds.images = train_ds.poses[:DP_VIEWS], train_ds.images[:DP_VIEWS]
    trainer = Trainer("ngp", cfg, spec, workspace=os.path.join(out_dir, "workspace"),
                      use_checkpoint="scratch", eval_interval=10_000, device=dev, mute=True)
    steps = []
    update = trainer._update

    def record(*args, **kw):  # every step's loss, read after the run
        loss = update(*args, **kw)
        steps.append(loss)
        return loss

    trainer._update = record
    kernel, calls, stream = hashgrid_fast.scatter_add, [0], {}

    def keep_last(idx, vals, total_rows, period=None):  # the last step's stream
        if calls[0] == DP_EPOCHS * DP_VIEWS - 1:
            stream.update(idx=idx, vals=vals, total=total_rows, period=period)
        calls[0] += 1
        return kernel(idx, vals, total_rows, period)

    if g is not None and g.is_main:
        hashgrid_fast.scatter_add = keep_last
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    try:
        # ---------------------------------------------------------- main path
        trainer.train(train_ds, None, 1)          # epoch 1: first-use costs included
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        trainer.train(train_ds, None, DP_EPOCHS)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        launches = read_counts()
        # ----------------------------------------------------------
    finally:
        hashgrid_fast.scatter_add = kernel
    result = {
        "rank": rank, "world": n_devices, "device": str(dev),
        "backend": None if g is None else g.backend,
        "steps": [float(v) for v in steps], "global_step": trainer.global_step,
        "steps_per_s": (DP_EPOCHS - 1) * DP_VIEWS / seconds,
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        "launches": launches,
        "params": digest(param_leaves(trainer.params)),
        "ema": digest(param_leaves(trainer.ema_params)),
        "bitfield": digest([trainer.grid_state.bitfield]),
    }
    if g is not None:
        g.all_reduce_(torch.zeros(1, device=dev))   # a barrier: every rank is done
        if stream:
            result["stream"] = dp_stream(torch, trainer.spec.grid, stream)
        g.all_reduce_(torch.zeros(1, device=dev))   # the others wait until rank 0 has timed
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def dp_stream(torch, spec, stream: dict) -> dict:
    """B1 on the update stream a rank's backward gave it (one rank's share of a ``-O``
    batch, its real cotangents): ``stream_numbers``."""
    if stream["period"] != SCATTER_PERIOD:
        raise AssertionError(f"rank stream: period {stream['period']}")
    return stream_numbers(torch, spec, stream, "data-parallel rank 0")


def _dp_ranks(torch, out_dir, world, backend, one):
    """``dp_run`` in ``world`` spawned ranks with ``backend``: gloo ranks share the first
    card (they see only it), nccl ranks take one card each. Checks the run against the
    one-process run ``one`` and the ranks against rank 0; returns the ranks' results and
    the run's numbers."""
    import numpy as np

    from palettenerf_torch import parallel

    os.makedirs(out_dir)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if backend == "gloo":   # the spawned ranks inherit the environment
        os.environ["CUDA_VISIBLE_DEVICES"] = (visible or "0").split(",")[0]
    t0 = time.perf_counter()
    try:
        parallel.spawn(dp_run, world, args=(out_dir, world), device="cuda",
                       timeout_s=DP_TIMEOUT_S)
    finally:
        if visible is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = visible
    ranks_s = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    steps = DP_VIEWS * DP_EPOCHS
    ref = np.asarray(one["steps"][:DP_VIEWS])
    got = np.asarray(ranks[0]["steps"][:DP_VIEWS])
    first_rel = abs(got[0] - ref[0]) / abs(ref[0])
    traj_rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
    out = {"backend": ranks[0]["backend"], "world": world,
           "devices": [r["device"] for r in ranks],
           "steps_per_s": [r["steps_per_s"] for r in ranks],
           "peak_gib": [r["peak_gib"] for r in ranks],
           "first_step_loss": got[0], "first_step_rel": first_rel,
           "trajectory_max_rel": traj_rel, "phase_s": ranks_s,
           "launches_per_rank": {k: [r["launches"][k] for r in ranks]
                                 for k in ranks[0]["launches"]}}
    log(f"data-parallel, {world} {backend} ranks: " + json.dumps(out, default=float))
    if out["backend"] != backend:
        raise AssertionError(f"the ranks chose {out['backend']}, not {backend}")
    for r in ranks:
        if r["global_step"] != steps or r["launches"]["scatter_add"] != steps:
            raise AssertionError(f"rank {r['rank']}: {r['global_step']} steps, scatter_add "
                                 f"launched {r['launches']['scatter_add']} times ({steps} "
                                 f"expected)")
        for k in ("steps", "params", "ema", "bitfield"):
            if r[k] != ranks[0][k]:
                raise AssertionError(f"rank {r['rank']} holds another {k} than rank 0")
    if not first_rel <= DP_FIRST_RTOL:
        raise AssertionError(f"first step's loss {got[0]} on the ranks, {ref[0]} in one "
                             f"process: {first_rel:.2e} relative")
    np.testing.assert_allclose(got, ref, rtol=DP_TRAJ_RTOL, atol=2e-5,
                               err_msg=f"data-parallel loss trajectory ({backend})")
    if not np.isfinite(np.asarray(ranks[0]["steps"])).all():
        raise AssertionError("non-finite data-parallel losses")
    if "stream" not in ranks[0]:
        raise AssertionError("rank 0 kept no scatter_add stream")
    return ranks, out


def phase_dp(torch, dev):
    """Ray data-parallel training: ``dp_run`` in DP_WORLD gloo ranks sharing the card
    (``palettenerf_torch.parallel.spawn``), beside ``dp_run`` in this process with the
    same seed. The first step's loss within DP_FIRST_RTOL, the first DP_VIEWS steps
    within DP_TRAJ_RTOL, the ranks' parameters, EMA and bitfields equal bit for bit
    after DP_VIEWS * DP_EPOCHS steps, ``scatter_add`` launched once per step on each
    rank and held against its plain version on rank 0's stream. With DP_WORLD cards or
    more, the same in DP_WORLD nccl ranks, one card each, and in one rank per card.
    Returns (each kernel's launches per gloo rank, B1 on rank 0's stream, the phase's
    numbers)."""
    import shutil

    root = os.path.join(ROOT, "results", "chip_smoke_dp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "n1"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dp_run(os.path.join(root, "n1"), 1, str(dev))
    one_s = time.perf_counter() - t0
    with open(os.path.join(root, "n1", "rank0.json")) as f:
        one = json.load(f)
    if one["global_step"] != DP_VIEWS * DP_EPOCHS:
        raise AssertionError(f"one process: {one['global_step']} steps")
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    plan = [(DP_WORLD, "gloo")]
    if cards >= DP_WORLD:
        plan.append((DP_WORLD, "nccl"))
    if cards > DP_WORLD:
        plan.append((cards, "nccl"))
    out = {"one": {"steps_per_s": one["steps_per_s"], "peak_gib": one["peak_gib"],
                   "first_step_loss": one["steps"][0], "phase_s": one_s}}
    for world, backend in plan:
        ranks, info = _dp_ranks(torch, os.path.join(root, f"{backend}{world}"), world,
                                backend, one)
        out[f"{backend}{world}"] = dict(info, stream=ranks[0]["stream"])
        if (world, backend) == plan[0]:
            launches, stream = info["launches_per_rank"], ranks[0]["stream"]
    return launches, stream, out


def phase_compaction_reference(torch, dev):
    """The sample-compaction slice on a small field, card against CPU: the supercell mip
    (cascade 1 and 2) and the fine bake of an analytic field bit for bit; the
    hierarchical and fine-grid marches' masks (and ``ts``: equal at dt_gamma 0, within
    COMPACT_TS_RTOL with exp in the step rule); a compacted train render's outputs and
    gradients within COMPACT_CARD_ATOL / COMPACT_GRAD_RTOL. Returns the largest output
    difference."""
    import numpy as np

    from palettenerf_torch.models.nerf import NeRFSpec, init_nerf, param_list
    from palettenerf_torch.ops import march, occupancy
    from palettenerf_torch.ops.rays import near_far_from_aabb
    from palettenerf_torch.render.nerf_renderer import RenderSettings, render_nerf_train

    rng = np.random.default_rng(0)
    G = 32
    for cascade in (1, 2):
        occ = torch.from_numpy(rng.uniform(size=(cascade * G ** 3,)) < 0.02)
        bits = occupancy.packbits(occ)
        cpu = march.build_super_bitfield(bits, G, cascade)
        card = march.build_super_bitfield(bits.to(dev), G, cascade)
        if not torch.equal(card.cpu(), cpu):
            raise AssertionError(f"build_super_bitfield (cascade {cascade}): card != CPU")

    def density(p):
        return torch.where((p ** 2).sum(-1) < 0.25, 30.0, 0.0)

    c = (torch.arange(G) + 0.5) / G * 2 - 1
    box = (torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1).abs() < 0.75).all(-1)
    state = occupancy.GridState(torch.where(box, 30.0, 0.0).reshape(1, -1),
                                occupancy.packbits(box.reshape(-1)), torch.tensor(20.0),
                                torch.tensor(0))
    fine = occupancy.bake_fine_bitfield(state, density, 1.0, 10.0, fine_size=64, grid_size=G)
    fine_card = occupancy.bake_fine_bitfield(
        occupancy.GridState(*[t.to(dev) for t in state]), density, 1.0, 10.0, fine_size=64,
        grid_size=G)
    if not torch.equal(fine_card.cpu(), fine):
        raise AssertionError("bake_fine_bitfield: card != CPU")

    n = 2048
    o = torch.tensor([0.0, 0.0, -1.6]).expand(n, 3).contiguous()
    d = torch.from_numpy(rng.normal(size=(n, 3)) * 0.3 + [0.0, 0.0, 1.0]).float()
    d = d / d.norm(dim=-1, keepdim=True)
    nears, fars = near_far_from_aabb(o, d, torch.tensor([-1.0] * 3 + [1.0] * 3), 0.05)
    noise = torch.from_numpy(rng.uniform(size=(n,))).float()
    sup = march.build_super_bitfield(state.bitfield, G, 1)
    for what, kw in (("hierarchical", dict(sup_bitfield=sup, max_groups=12)),
                     ("fine grid", dict(fine_grid_size=64)),
                     ("hierarchical + fine grid", dict(sup_bitfield=sup, max_groups=12,
                                                       fine_grid_size=64))):
        for dt_gamma in (0.0, 1.0 / 128):
            bf = (state.bitfield, fine) if "fine_grid_size" in kw else state.bitfield
            args = (o, d, nears, fars, bf)
            cpu = march.march_rays(*args, 1.0, 1, G, dt_gamma, 512, 48, noise, **kw)
            to = [t.to(dev) if torch.is_tensor(t) else tuple(x.to(dev) for x in t)
                  for t in args]
            kd = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in kw.items()}
            card = march.march_rays(*to, 1.0, 1, G, dt_gamma, 512, 48, noise.to(dev), **kd)
            if not torch.equal(card.mask.cpu(), cpu.mask):
                raise AssertionError(f"{what} march mask (dt_gamma {dt_gamma}): card != CPU")
            ts_err = float(((card.ts.cpu() - cpu.ts).abs() / cpu.ts.abs().clamp_min(1e-30)).max())
            if ts_err > (0.0 if dt_gamma == 0 else COMPACT_TS_RTOL):
                raise AssertionError(f"{what} march ts (dt_gamma {dt_gamma}): card differs "
                                     f"from CPU by {ts_err:.3g} relative")
            if not 0 < int(cpu.mask.sum()) < cpu.mask.numel():
                raise AssertionError(f"{what} march: {int(cpu.mask.sum())} samples")

    spec = NeRFSpec.build(bound=1.0, log2_hashmap_size=14, grid_levels=8, hidden_dim=32,
                          hidden_dim_color=32)
    params = init_nerf(spec, torch.Generator().manual_seed(0))
    params["encoder"] = torch.from_numpy(rng.uniform(-1, 1, params["encoder"].shape)).float()
    st = RenderSettings(bound=1.0, grid_size=G, dt_gamma=0.0, max_steps=256, num_samples=32,
                        min_near=0.05, compact_frac=0.25)
    results = {}
    for where in ("cpu", dev):
        def leaf(t):
            return t.detach().to(where, copy=True).requires_grad_(True)

        p = {k: ([leaf(layer) for layer in v] if isinstance(v, list) else leaf(v))
             for k, v in params.items()}
        out = render_nerf_train(p, spec, state.bitfield.to(where), o.to(where), d.to(where),
                                st, noise=noise.to(where))
        out["image"].square().sum().backward()
        results[where] = ({k: v.detach().cpu() for k, v in out.items()},
                          [t.grad.cpu() for t in param_list(p)])
    (o_cpu, g_cpu), (o_card, g_card) = results["cpu"], results[dev]
    if int(o_cpu["compact_overflow"][0]) != int(o_card["compact_overflow"][0]):
        raise AssertionError("compact_overflow: card != CPU")
    out_err = max(float((o_card[k] - o_cpu[k]).abs().max()) for k in o_cpu
                  if k != "compact_overflow")
    grad_err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(g_card, g_cpu))
    log(f"compaction reference: supercell mips, fine bake, hierarchical / fine-grid march "
        f"masks card = CPU; compacted train render (budget {st.compact_frac} of "
        f"{n * 32} slots, overflow {int(o_cpu['compact_overflow'][0])}): outputs within "
        f"{out_err:.2e}, gradients within {grad_err:.2e} of each tensor's largest entry")
    if out_err > COMPACT_CARD_ATOL or grad_err > COMPACT_GRAD_RTOL:
        raise AssertionError(f"compacted train render card vs CPU: outputs {out_err}, "
                             f"gradients {grad_err}")
    return out_err


def _copy_workspace(src, dst):
    """A workspace whose checkpoints are those of ``src`` (so a resumed run leaves
    ``src`` as it was)."""
    import shutil

    shutil.rmtree(os.path.join(ROOT, dst), ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, src, "checkpoints"), os.path.join(ROOT, dst, "checkpoints"))
    return os.path.join(ROOT, dst)


def _stage1_trainer(torch, dev, flags, workspace):
    from palettenerf_torch.config import Config
    from palettenerf_torch.main_nerf import build_parser
    from palettenerf_torch.models.nerf import NeRFSpec
    from palettenerf_torch.train.trainer import Trainer

    cfg = Config.from_args(build_parser().parse_args(MAIN_ARGS + list(flags)))
    spec = NeRFSpec.build(bound=cfg.bound, bg_radius=cfg.bg_radius, fp16=cfg.fp16_enabled,
                          log2_hashmap_size=cfg.log2_hashmap_size,
                          grid_levels=cfg.grid_levels, grid_level_dim=cfg.grid_level_dim)
    return Trainer("ngp", cfg, spec, workspace=workspace, use_checkpoint="latest",
                   eval_interval=10_000, mute=True, device=dev)


def phase_compact_train(torch, dev, train_ds):
    """Sample compaction on the train path: one 100-step ``-O`` epoch resumed from the
    train main path's workspace with ``--train_compact_frac 0.25`` and the same epoch
    without it (copies of the workspace). Then B1 on the compacted stream of one train
    batch. Returns (the compacted epoch's launch counts, what was measured, the stream's
    times)."""
    from palettenerf_torch.ops import hashgrid_fast, scatter
    from palettenerf_torch.render.nerf_renderer import forward_compact, train_rows

    info = {}
    for name, flags in (("plain", []), ("compact", ["--train_compact_frac", str(COMPACT_FRAC)])):
        tr = _stage1_trainer(torch, dev, flags, _copy_workspace(
            NERF_WS, os.path.join("results", "chip_smoke_compact", name)))
        if tr.global_step != EPOCHS * len(train_ds):
            raise AssertionError(f"resumed at step {tr.global_step}")
        torch.cuda.synchronize()
        zero_counts()
        # -------------------------------------------------------------- main path
        tr.train(train_ds, None, EPOCHS + 1)
        torch.cuda.synchronize()
        launches = read_counts()
        # -------------------------------------------------------------- checks
        steps = len(train_ds)
        info[name] = {"steps_per_s": steps / tr.stats["epoch_seconds"][-1],
                      "loss": tr.stats["loss"][-1],
                      "overflow": (tr.stats["compact_overflow"][-1]
                                   if "compact_overflow" in tr.stats else None),
                      "scatter_add_launches": launches["scatter_add"]}
        if launches["scatter_add"] != steps or not math.isfinite(tr.stats["loss"][-1]):
            raise AssertionError(f"{name} epoch: scatter_add launched "
                                 f"{launches['scatter_add']} times in {steps} steps, loss "
                                 f"{tr.stats['loss'][-1]}")
        if name == "compact":
            compact_launches, trainer = launches, tr
        else:
            del tr
    c = info["compact"]
    log(f"train compaction: epoch {EPOCHS + 1} ({len(train_ds)} steps, resumed at step "
        f"{EPOCHS * len(train_ds)}) {c['steps_per_s']:.2f} steps/s with --train_compact_frac "
        f"{COMPACT_FRAC} (overflow {c['overflow']} samples "
        f"over the epoch, loss {c['loss']:.5f}), {info['plain']['steps_per_s']:.2f} without "
        f"(loss {info['plain']['loss']:.5f}); scatter_add launches {c['scatter_add_launches']}")
    if c["overflow"] is None or info["plain"]["overflow"] is not None:
        raise AssertionError("the compacted epoch did not count its overflow")

    # the compacted stream: one batch marched as the train step marches it, the valid
    # samples packed into the budget, their corner rows; zero cotangents past the valid count
    st, spec = trainer.train_settings, trainer.spec.grid
    m, x01, gen = march_train_batch(torch, trainer, train_ds, 5)
    n = trainer.opt.num_rays
    budget = train_rows(st, n)
    packed = []
    forward_compact(lambda x: packed.append(x) or (x[:, 0],), m.mask.reshape(-1), budget, x01)
    idx = hashgrid_fast.corner_indices(spec, packed[0])[0].reshape(-1).contiguous()
    U, C = idx.numel(), spec.level_dim
    held = min(int(m.mask.sum()), budget)
    vals = torch.randn((U, C), generator=gen, device=dev) * 1e-3
    vals[held * SCATTER_PERIOD:] = 0.0
    vals = vals.to(torch.bfloat16)
    log(f"compacted stream: {n} rays x {st.num_samples} slots, {int(m.mask.sum())} samples, "
        f"budget {budget} ({held} held, the rest at the tail with zero updates)")
    max_err, _ = check_scatter(torch, scatter, idx, vals, spec.total_params,
                               "compacted stream", SCATTER_PERIOD)
    stream_stats(torch, spec, idx, vals, "compacted")
    t = time_scatter(torch, scatter, idx, vals, spec.total_params, "compacted")
    n_bytes = U * (4 + 2 * C) + spec.total_params * C * 4
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, U * C / FP32_FLOPS * 1e3
    t.update(U=U, budget=budget, held=held, max_abs_err=max_err, bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations")
    log(f"scatter_add bound on the compacted stream {t['bound_ms']:.4f} ms "
        f"({n_bytes / 1e6:.1f} MB)")
    del trainer
    torch.cuda.empty_cache()
    return compact_launches, info, t


def _frame_psnr(torch, a, b) -> float:
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else -10.0 * math.log10(mse)


def _eval_settings_run(torch, make, data, gt, what, settings, floors):
    """One exact frame after a warm-up frame (which bakes the fine grid) under each of
    ``settings``: s/frame, bake s and occupied cells, overflow, PSNR against the image and
    against the flat frame; the checks of compaction alone and the ``floors``."""
    import numpy as np

    frames, rows = {}, {}
    for name, flags in settings.items():
        tr = make(flags)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.eval_step_full(data)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = tr.eval_step_full(data)
        frame_s = time.perf_counter() - t0
        bake = getattr(tr, "fine_bake_stats", None)
        frames[name] = out["image"]
        rows[name] = {"s_per_frame": frame_s, "warm_up_s": warm_s,
                      "bake_s": None if bake is None else bake["seconds"],
                      "occupied": None if bake is None else bake["occupied"],
                      "overflow": tr.last_compact_overflow,
                      "psnr": _frame_psnr(torch, out["image"], gt)}
        if not np.isfinite(out["image"]).all():
            raise AssertionError(f"{what} {name}: non-finite frame")
        del tr
        torch.cuda.empty_cache()
    for name, row in rows.items():
        row["psnr_vs_flat"] = _frame_psnr(torch, frames[name], frames["flat"])
        log(f"{what}, {name} ({' '.join(settings[name]) or 'no flags'}): "
            + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in row.items()))
    exact = {}
    for name, base in (("compact", "flat"), ("fine+compact", "fine")):
        if rows[name]["overflow"] == 0:
            exact[name] = float(np.abs(frames[name] - frames[base]).max())
    log(f"{what}: max |compacted frame - uncompacted| with zero overflow {exact}")
    if "compact" not in exact or max(exact.values()) > COMPACT_EXACT_ATOL:
        raise AssertionError(f"{what}: compaction alone is not the uncompacted frame "
                             f"({exact}, overflow {rows['compact']['overflow']})")
    for name, floor in floors.items():
        if not rows[name]["psnr_vs_flat"] > floor:
            raise AssertionError(f"{what} {name}: {rows[name]['psnr_vs_flat']:.3f} dB "
                                 f"against the flat frame <= floor {floor}")
    return rows


def phase_compact_eval(torch, dev):
    """The exact eval frame (val/r_0, 800x800) of the train main path's workspace under
    the settings of STAGE1_SETTINGS, each through a trainer built from main_nerf's flags."""
    from palettenerf_torch.config import Config
    from palettenerf_torch.data.provider import NeRFDataset

    data = NeRFDataset(Config(path=SCENE, bound=1.0, scale=0.8), type="val").collate(0)
    img = data["images"]
    gt = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
    rows = _eval_settings_run(
        torch, lambda flags: _stage1_trainer(torch, dev, flags, os.path.join(ROOT, NERF_WS)),
        data, gt, "stage-1 eval", STAGE1_SETTINGS, STAGE1_PSNR_FLOORS)
    for name, row in rows.items():
        if name not in STAGE1_PSNR_FLOORS and not row["psnr"] > PSNR_FLOOR:
            raise AssertionError(f"stage-1 eval {name}: {row['psnr']:.3f} dB <= {PSNR_FLOOR}")
    return rows


def phase_compact_palette(torch, dev):
    """The palette eval frame (val/r_0, 800x800) of the palette workspace under the
    settings of PALETTE_SETTINGS (trainers loaded as ``main_palette --test`` loads them);
    then one EditingSession frame at the --gui defaults with --eval_fine_grid 256
    --eval_compact_frac 0.125 at test view 0 (``jump_to_pose(test poses, 0)``)."""
    import numpy as np

    from palettenerf_torch import main_palette
    from palettenerf_torch.config import Config
    from palettenerf_torch.data.palette_provider import PaletteDataset
    from palettenerf_torch.data.provider import NeRFDataset
    from palettenerf_torch.gui import EditingSession

    data = NeRFDataset(Config(path=SCENE, bound=1.0, scale=0.8), type="val").collate(0)
    img = data["images"]
    gt = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
    argv = PALETTE_TRAIN_ARGS + ["--test", "--version_id", "1"]
    rows = _eval_settings_run(
        torch, lambda flags: main_palette.load_test_trainer(argv + list(flags), device=dev)[1],
        data, gt, "palette eval", PALETTE_SETTINGS, PALETTE_PSNR_FLOORS)
    flags = EVAL_SETTINGS["fine+compact"]
    edit = {}
    for name, f in (("plain", []), ("fine+compact", flags)):
        cfg, tr = main_palette.load_test_trainer(argv + list(f), device=dev)
        sess = EditingSession(tr, W=cfg.W, H=cfg.H, radius=cfg.radius, fovy=cfg.fovy)
        sess.jump_to_pose(PaletteDataset(cfg, type="test").poses, 0)
        sess.render()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = sess.render()
        edit[name] = (time.perf_counter() - t0, frame["image"], tr.last_compact_overflow)
        del sess, tr
        torch.cuda.empty_cache()
    psnr = _frame_psnr(torch, edit["fine+compact"][1], edit["plain"][1])
    log(f"edit frame {cfg.W}x{cfg.H} at test view 0 (jump_to_pose to test pose 0, radius "
        f"{cfg.radius}): {edit['plain'][0]:.3f} s plain, {edit['fine+compact'][0]:.3f} s with "
        f"{' '.join(flags)} (overflow {edit['fine+compact'][2]}), {psnr:.2f} dB against the "
        f"plain frame")
    if not np.isfinite(edit["fine+compact"][1]).all() or not psnr > EDIT_COMPACT_PSNR_FLOOR:
        raise AssertionError(f"edit frame with {flags}: {psnr:.3f} dB against the plain frame")
    return rows, {"plain_s": edit["plain"][0], "fine_compact_s": edit["fine+compact"][0],
                  "overflow": edit["fine+compact"][2], "psnr_vs_plain": psnr}


def phase_o2_reference(torch, dev):
    """The -O2 encoder on a small spec (4 levels, 2^13 rows) on the card and on the CPU,
    same points, uniforms and level subset, for hash and hash_xadd: the exact forward
    (1e-6); the stochastic draws (a share <= PICK_FLIP_SHARE may differ) and the forward
    where they agree (1e-6); the table gradient of each backward mode, B1 on the card
    against the plain version on the CPU on the card's own update stream, and against
    the CPU's whole backward where no draw differs (SCATTER_RTOL of each row's summed
    |update|). Returns the largest absolute gradient difference."""
    from palettenerf_torch.ops import hashgrid_fast as hf
    from palettenerf_torch.ops import scatter
    from palettenerf_torch.ops.hashgrid import HashGridSpec

    gen = torch.Generator().manual_seed(11)
    M, L = 1 << 16, 4
    x = torch.rand((M, 3), generator=gen)
    u = torch.rand((M, L), generator=gen)
    lvls = torch.tensor([3, 1])
    co = torch.randn((M, 2 * L), generator=gen)
    modes = {"stochastic": (False, True, 0), "nearest_corner_grad": (True, False, 0),
             "grad_levels": (True, True, 2)}
    worst, notes = 0.0, []
    for gridtype in ("hash", "hash_xadd"):
        spec = HashGridSpec.build(num_levels=L, desired_resolution=512, log2_hashmap_size=13,
                                  gridtype=gridtype)
        table = torch.rand((spec.total_params, 2), generator=gen) * 2 - 1
        exact = [hf.hashgrid_encode_fast(table.to(d), x.to(d), spec).cpu() for d in ("cpu", dev)]
        err_exact = float((exact[0] - exact[1]).abs().max())
        (out_c, res_c), (out_g, res_g) = (hf._encode(table.to(d), spec, x.to(d), u.to(d), True)
                                          for d in ("cpu", dev))
        flipped = res_c[0] != res_g[0].cpu()
        same = ~flipped[..., None].expand(-1, -1, 2).reshape(M, 2 * L)
        err_draw = float((out_c - out_g.cpu())[same].abs().max())
        share = float(flipped.float().mean())
        if err_exact > 1e-6 or err_draw > 1e-6 or share > PICK_FLIP_SHARE:
            raise AssertionError(f"-O2 reference {gridtype}: exact forward off by {err_exact}, "
                                 f"drawn forward by {err_draw}, {share} of the draws differ")
        for mode, (nearest, stochastic, levels) in modes.items():
            rand = hf.EncodeRand(u=u.to(dev), lvls=lvls.to(dev))
            t = table.to(dev, copy=True).requires_grad_(True)
            before = read_counts()["scatter_add"]
            out = hf.hashgrid_encode_fast(t, x.to(dev), spec, torch.bfloat16, nearest,
                                          stochastic, rand, levels)
            (out * co.to(dev)).sum().backward()
            torch.cuda.synchronize()
            scatter.check_refused()
            if read_counts()["scatter_add"] - before != 1:
                raise AssertionError(f"-O2 reference {gridtype} {mode}: B1 not launched once")
            _, res = hf._encode(table.to(dev), spec, x.to(dev), u.to(dev), stochastic)
            rows, upd, _ = hf._backward_stream(spec, res, lvls.to(dev), co.to(dev), nearest,
                                               stochastic, levels)
            rows, vals = rows.cpu(), upd.to(torch.bfloat16).cpu()
            ref = scatter.scatter_add_reference(rows, vals, spec.total_params)
            scale = scatter.scatter_add_reference(rows, vals.abs(), spec.total_params)
            got = t.grad.cpu()
            err = (got - ref).abs()
            bad = int((err > SCATTER_RTOL * scale).sum())
            if not flipped.any():
                tc = table.detach().clone().requires_grad_(True)
                hf.hashgrid_encode_fast(tc, x, spec, torch.bfloat16, nearest, stochastic,
                                        hf.EncodeRand(u=u, lvls=lvls),
                                        levels).mul(co).sum().backward()
                bad += int(((got - tc.grad).abs() > SCATTER_RTOL * scale).sum())
            if bad:
                raise AssertionError(f"-O2 reference {gridtype} {mode}: {bad} table rows off "
                                     f"beyond {SCATTER_RTOL} of their summed |update|")
            worst = max(worst, float(err.max()))
            notes.append(f"{gridtype}/{mode} U={rows.numel()} {float(err.max()):.2e}")
        notes.append(f"{gridtype}: exact forward {err_exact:.1e}, drawn forward "
                     f"{err_draw:.1e}, {int(flipped.sum())} of {flipped.numel()} draws differ")
    log("-O2 reference (card vs CPU, 4 levels, 2^13 rows, 65,536 points): "
        + "; ".join(notes))
    return worst


def o2_streams(torch, trainer, train_ds):
    """The backward streams B1 gets under -O2 and under --fast_grad alone, from one train
    batch on the field ``trainer`` trained (4096 rays of view 0 marched through its
    occupancy grid as the train step marches them, 64 slots per ray; cotangents zero in
    the padded slots): rows picked by the corner draw (stochastic, 8 of 16 levels) and by
    the nearest corner (16 levels). Each is held against the plain version in both of the
    kernel's modes, then timed in both, beside the plain version and ``index_add_``."""
    from palettenerf_torch.ops import hashgrid_fast as hf
    from palettenerf_torch.ops import scatter

    dev, spec = trainer.device, trainer.spec.grid
    m, x01, gen = march_train_batch(torch, trainer, train_ds, 7)
    M, C = x01.shape[0], spec.level_dim
    rand = hf.make_encode_rand(gen, M, spec, trainer.spec.grad_levels)
    g = torch.randn((M, spec.output_dim), generator=gen, device=dev) * 1e-3
    g = g * m.mask.reshape(-1, 1)
    table = trainer.params["encoder"].detach()
    out = {}
    for name, (nearest, stochastic, levels) in (("O2", (True, True, 8)),
                                                ("fast_grad", (True, False, 0))):
        _, res = hf._encode(table, spec, x01, rand.u if stochastic else None, stochastic)
        rows, upd, period = hf._backward_stream(spec, res, rand.lvls, g, nearest, stochastic,
                                                levels)
        vals = upd.to(torch.bfloat16).contiguous()
        U = rows.numel()
        if U != M * (levels or spec.num_levels):
            raise AssertionError(f"{name} stream has {U} updates")
        total = spec.total_params
        ref = scatter.scatter_add_reference(rows, vals, total)
        scale = scatter.scatter_add_reference(rows, vals.abs(), total)
        modes = {"columns": period, "rows": None}
        max_err = 0.0
        for mode, per in modes.items():
            got = scatter.scatter_add(rows, vals, total, per)
            torch.cuda.synchronize()
            scatter.check_refused()
            bad = int(((got - ref).abs() > SCATTER_RTOL * scale).sum())
            if bad:
                raise AssertionError(f"scatter_add on the {name} stream ({mode}): {bad} rows "
                                     f"differ from the plain version")
            max_err = max(max_err, float((got - ref).abs().max()))
        # the two modes in turns (columns, rows, rows, columns, ...): median of 4 each
        runs = {mode: [] for mode in modes}
        for rep in range(4):
            for mode in (list(modes) if rep % 2 == 0 else list(modes)[::-1]):
                runs[mode].append(time_ms(torch, lambda per=modes[mode]: scatter.scatter_add(
                    rows, vals, total, per)))
        t = {f"{mode}_ms": sorted(v)[len(v) // 2] for mode, v in runs.items()}
        vals_f32 = vals.float()
        out_f32 = torch.zeros((total, C), device=dev)
        t["plain_ms"] = time_ms(torch, lambda: scatter.scatter_add_reference(rows, vals, total))
        t["library_ms"] = time_ms(torch, lambda: out_f32.index_add_(0, rows, vals_f32))
        n_bytes = U * (4 + 2 * C) + total * C * 4
        takes = "columns" if period >= hf.MIN_COLUMN_PERIOD else "rows"
        faster = "columns" if t["columns_ms"] < t["rows_ms"] else "rows"
        t.update(U=U, period=period, max_abs_err=max_err, port_takes=takes, faster=faster,
                 bound_ms=max(n_bytes / HBM_BYTES_PER_S, U * C / FP32_FLOPS) * 1e3,
                 bound_by="bytes" if n_bytes / HBM_BYTES_PER_S >= U * C / FP32_FLOPS
                 else "operations")
        log(f"scatter_add on the {name} stream: U={U}, {period} columns per point, "
            f"{100 * float(m.mask.float().mean()):.2f}% of the slots hold a sample; column "
            f"walk {t['columns_ms']:.4f} ms, stream order {t['rows_ms']:.4f} ms (medians of "
            f"4 in turns; the port takes {takes}), plain {t['plain_ms']:.4f} ms, index_add_ "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({n_bytes / 1e6:.1f} "
            f"MB), max_abs_err {max_err:.3e}")
        out[name] = t
    return out


def phase_o2_main_path(torch, dev, train_ds, o_psnr):
    """-O2 stage 1 at full width: ``main_nerf``'s parser with MAIN_ARGS and -O2, 300 steps
    from scratch, one validation view, the B1 streams of -O2 and --fast_grad; then one
    --error_map epoch (the host-sampled epoch) resumed from it, and two epochs of
    --gridtype hash_xadd -O2 from scratch. Returns (launch counts of the -O2 run, a dict
    of what was measured)."""
    import numpy as np

    from palettenerf_torch.config import Config
    from palettenerf_torch.data.provider import NeRFDataset
    from palettenerf_torch.main_nerf import build_parser
    from palettenerf_torch.models.nerf import NeRFSpec, param_list
    from palettenerf_torch.train.metrics import psnr
    from palettenerf_torch.train.trainer import Trainer

    cfg = Config.from_args(build_parser().parse_args(O2_ARGS))
    if (cfg.fast_grad, cfg.stochastic_trilerp, cfg.grad_levels, cfg.fp16) != (True, True, 8, True):
        raise AssertionError(f"-O2 resolved to {cfg}")

    def spec_of(c):
        return NeRFSpec.build(bound=c.bound, bg_radius=c.bg_radius, fp16=c.fp16_enabled,
                              fast_grad=c.fast_grad, stochastic_trilerp=c.stochastic_trilerp,
                              grad_levels=c.grad_levels, log2_hashmap_size=c.log2_hashmap_size,
                              grid_levels=c.grid_levels, grid_level_dim=c.grid_level_dim,
                              gridtype=c.gridtype)

    spec = spec_of(cfg)
    valid_ds = NeRFDataset(cfg, type="val")
    trainer = Trainer("ngp", cfg, spec, workspace=os.path.join(ROOT, O2_WS),
                      use_checkpoint="scratch", eval_interval=10_000, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    # -------------------------------------------------------------- main path
    trainer.train(train_ds, None, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(train_ds, None, EPOCHS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    data = valid_ds.collate(0)
    trainer.eval_step_full(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = trainer.eval_step_full(data)
    eval_s = time.perf_counter() - t0
    launches = read_counts()
    # -------------------------------------------------------------- checks
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps, losses = trainer.global_step, trainer.stats["loss"]
    img = data["images"]
    val_psnr = psnr(out["image"], img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:]))
    res = {"steps_per_s": (steps - len(train_ds)) / train_s, "eval_s": eval_s,
           "val_psnr": val_psnr, "peak_gib": peak_gb}
    log(f"-O2 main path: {steps} steps, epoch losses {['%.5f' % v for v in losses]}; "
        f"{res['steps_per_s']:.2f} steps/s (epochs 2-{EPOCHS}), eval {eval_s:.3f} s/frame, "
        f"val PSNR {val_psnr:.3f} dB (-O: {o_psnr:.3f} dB), peak memory {peak_gb:.2f} GiB, "
        f"launches {launches}")
    if steps != EPOCHS * len(train_ds) or not losses[-1] < losses[0]:
        raise AssertionError(f"-O2: {steps} steps, epoch losses {losses}")
    if launches["scatter_add"] != steps:
        raise AssertionError(f"-O2: scatter_add launched {launches['scatter_add']} times in "
                             f"{steps} steps")
    if not all(bool(torch.isfinite(p).all()) for p in param_list(trainer.params)) or not all(
            np.isfinite(v).all() for v in out.values()):
        raise AssertionError("-O2: non-finite parameters or render")
    if not val_psnr > O2_PSNR_FLOOR:
        raise AssertionError(f"-O2 validation PSNR {val_psnr:.3f} dB <= floor {O2_PSNR_FLOOR}")
    res["streams"] = o2_streams(torch, trainer, train_ds)
    del trainer

    # -------------------------------------------------------------- --error_map epoch
    em_cfg = cfg.replace(error_map=True)
    em_ds = NeRFDataset(em_cfg, type="train")
    em_tr = Trainer("ngp", em_cfg, spec, workspace=os.path.join(ROOT, O2_WS),
                    use_checkpoint="latest", eval_interval=10_000, device=dev)
    before = em_ds.error_map.copy()
    zero_counts()
    t0 = time.perf_counter()
    em_tr.train(em_ds, None, EPOCHS + 1)
    torch.cuda.synchronize()
    em_s = time.perf_counter() - t0
    em_launches = read_counts()["scatter_add"]
    moved = int((em_ds.error_map != before).any(-1).sum())
    res["error_map_steps_per_s"] = len(em_ds) / em_s
    log(f"-O2 --error_map epoch (host-sampled): {len(em_ds) / em_s:.2f} steps/s, loss "
        f"{em_tr.stats['loss'][-1]:.5f}, error maps of {moved} of {len(em_ds)} views moved, "
        f"scatter_add launches {em_launches}")
    if em_tr.global_step != (EPOCHS + 1) * len(em_ds) or moved != len(em_ds) or \
            em_launches != len(em_ds) or not math.isfinite(em_tr.stats["loss"][-1]):
        raise AssertionError(f"--error_map epoch: step {em_tr.global_step}, {moved} maps moved, "
                             f"{em_launches} launches")
    del em_tr, em_ds

    # -------------------------------------------------------------- --gridtype hash_xadd
    x_cfg = cfg.replace(gridtype="hash_xadd")
    x_tr = Trainer("ngp", x_cfg, spec_of(x_cfg), workspace=os.path.join(ROOT, XADD_WS),
                   use_checkpoint="scratch", eval_interval=10_000, device=dev)
    zero_counts()
    t0 = time.perf_counter()
    x_tr.train(train_ds, None, 2)
    torch.cuda.synchronize()
    x_s = time.perf_counter() - t0
    x_launches = read_counts()["scatter_add"]
    x_losses = x_tr.stats["loss"]
    res["xadd_steps_per_s"] = x_tr.global_step / x_s
    log(f"-O2 --gridtype hash_xadd from scratch: {x_tr.global_step} steps, epoch losses "
        f"{['%.5f' % v for v in x_losses]}, {res['xadd_steps_per_s']:.2f} steps/s (first-use "
        f"costs included), scatter_add launches {x_launches}")
    if not all(math.isfinite(v) for v in x_losses) or not x_losses[-1] < x_losses[0] or \
            x_launches != x_tr.global_step:
        raise AssertionError(f"hash_xadd: losses {x_losses}, {x_launches} launches")
    del x_tr
    gc.collect()  # the trainers of this phase hold the card's memory until collected
    torch.cuda.empty_cache()
    return launches, res


def phase_o2_palette(torch, dev, o_palette_psnr, n_views):
    """The -O2 palette path through ``main_palette.main`` on the extraction the palette
    phase made: 300 steps of -O2 --random_size 8 with the patch-smooth term (host-sampled
    epochs, one per schedule phase), the CLI's test tail, one validation view; then a
    16-step training burst of an ``EditingSession`` on the --test trainer. Returns (the
    launch counts of the training run, those of the burst, a dict of what was measured)."""
    import numpy as np

    from palettenerf_torch import main_palette
    from palettenerf_torch.config import Config
    from palettenerf_torch.data.palette_provider import PaletteDataset
    from palettenerf_torch.data.provider import NeRFDataset
    from palettenerf_torch.gui import EditingSession
    from palettenerf_torch.models.mlp import param_leaves
    from palettenerf_torch.ops import scatter
    from palettenerf_torch.train.metrics import psnr

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    window = LaunchWindow()   # the steps replay a CUDA graph; closes with the training run
    # -------------------------------------------------------------- main path
    t0 = time.perf_counter()
    trainer = main_palette.main(O2_PALETTE_ARGS, device=dev)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = window.close()
    # -------------------------------------------------------------- checks
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    scatter.check_refused()
    spec = trainer.palette_spec
    losses, secs = trainer.stats["loss"], trainer.stats["epoch_seconds"]
    rates = [n_views / t for t in secs]
    log(f"-O2 palette main path (--random_size 8, --lambda_patchsmooth {PATCHSMOOTH}): "
        f"{trainer.global_step} steps in {total_s:.1f} s with the test tail; epoch losses "
        f"{['%.5f' % v for v in losses]}; steps/s per epoch (colors frozen / + smooth and "
        f"patch terms / + colors unfrozen) {['%.2f' % r for r in rates]}; peak memory "
        f"{peak_gb:.2f} GiB; launches {launches}")
    if not (trainer.host_sampled() and spec.stochastic_trilerp and spec.grad_levels == 8):
        raise AssertionError("-O2 palette: not the host-sampled -O2 trainer")
    if trainer.global_step != 3 * n_views or len(losses) != 3 or not all(
            math.isfinite(v) for v in losses) or not losses[2] < losses[0]:
        raise AssertionError(f"-O2 palette: {trainer.global_step} steps, losses {losses}")
    if launches["scatter_add"] != 5 * n_views:
        raise AssertionError(f"-O2 palette: scatter_add launched {launches['scatter_add']} "
                             f"times ({5 * n_views} expected: once per step, twice with the "
                             f"smooth loss's second pass)")
    valid_ds = NeRFDataset(Config(path=SCENE, bound=1.0, scale=0.8), type="val")
    data = valid_ds.collate(0)
    out = trainer.eval_step_full(data)
    img = data["images"]
    val_psnr = psnr(out["image"], img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:]))
    log(f"-O2 palette main path: val PSNR {val_psnr:.3f} dB (-O: {o_palette_psnr:.3f} dB)")
    if not all(np.isfinite(v).all() for v in out.values()) or not val_psnr > O2_PALETTE_PSNR_FLOOR:
        raise AssertionError(f"-O2 palette validation PSNR {val_psnr:.3f} dB <= floor "
                             f"{O2_PALETTE_PSNR_FLOOR}")
    del trainer

    # -------------------------------------------------------------- the editor's burst
    cfg, tr = main_palette.load_test_trainer(O2_PALETTE_ARGS + ["--test"], device=dev)
    sess = EditingSession(tr, W=cfg.W, H=cfg.H, radius=cfg.radius, fovy=cfg.fovy)
    train_ds = PaletteDataset(cfg, type="train")
    window = LaunchWindow()   # the burst's steps replay a CUDA graph
    t0 = time.perf_counter()
    burst = sess.train_burst(train_ds, steps=16)
    torch.cuda.synchronize()
    burst_s = time.perf_counter() - t0
    burst_launches = window.close()
    log(f"-O2 edit burst: 16 steps at {16 / burst_s:.2f} steps/s (loss {burst['loss']:.5f}), "
        f"launches {burst_launches}")
    if burst_launches["scatter_add"] != 16 or not math.isfinite(burst["loss"]) or not all(
            bool(torch.isfinite(p).all()) for p in param_leaves(tr.params)):
        raise AssertionError(f"-O2 burst: {burst_launches}, loss {burst['loss']}")
    del sess, tr
    gc.collect()
    torch.cuda.empty_cache()
    return launches, burst_launches, {"steps_per_s": rates, "val_psnr": val_psnr,
                                      "burst_steps_per_s": 16 / burst_s, "peak_gib": peak_gb}


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


def phase_palette_reference(torch, dev):
    """One small -O palette train step (smooth loss on, basis colors unfrozen, hist
    weights present) on the card and on the CPU, from the same weights and draws: the
    loss and every gradient must agree; ``encoder`` and ``sigma_net`` get none."""
    from palettenerf_torch.config import Config
    from palettenerf_torch.models.mlp import param_leaves
    from palettenerf_torch.models.palette import FROZEN, PaletteSpec
    from palettenerf_torch.train.palette_trainer import PaletteTrainer

    kw = dict(bound=1.0, log2_hashmap_size=14, grid_levels=8)
    cfg = Config(O=True, fp16=True, grid_size=32, num_rays=512, max_steps=256,
                 train_samples_per_ray=32, iters=100, use_initialization_from_rgbxy=True, **kw)
    spec = PaletteSpec.build(num_basis=4, fp16=True, **kw)
    gen = torch.Generator().manual_seed(6)
    params = _random_palette_params(torch, spec, gen)
    params["basis_color"][0, 0] = 1.0   # a color on the clamp's bound, as extraction gives
    params["basis_color_origin"] = params["basis_color"] - 0.01
    hist = torch.rand((32, 32, 32, 4), generator=gen)
    params["hist_weights"] = hist / hist.sum(-1, keepdim=True)
    n, S = cfg.num_rays, cfg.train_samples_per_ray
    o = torch.randn((n, 3), generator=gen)
    o = o / o.norm(dim=-1, keepdim=True) * 2.0
    d = -o + 0.5 * torch.randn((n, 3), generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    img, bg, noise, jit_u = (torch.rand(shape, generator=gen)
                             for shape in ((n, 4), (n, 3), (n,), (n * S, 3)))
    results = []
    for device in ("cpu", dev):
        tr = PaletteTrainer("ref", cfg, spec, params=params,
                            workspace=os.path.join(WORKSPACE, "palette_reference"),
                            use_checkpoint="scratch", mute=True, device=device)
        tr.grid_state = tr.grid_state._replace(
            bitfield=torch.full_like(tr.grid_state.bitfield, 255))
        tr.freeze_basis_color, tr.require_smooth_loss = False, True
        tr.lambda_palette = cfg.lambda_palette
        before = read_counts()["scatter_add"]
        loss, _ = tr.train_step(*(t.to(tr.device) for t in (o, d, img)), bg=bg.to(tr.device),
                                noise=noise.to(tr.device), jit_u=jit_u.to(tr.device))
        launched = read_counts()["scatter_add"] - before
        fixed = param_leaves({k: tr.params[k] for k in ("encoder", "sigma_net")})
        if any(p.grad is not None and bool((p.grad != 0).any()) for p in fixed):
            raise AssertionError("palette reference: encoder / sigma_net got a gradient")
        mlps = param_leaves(tr.params, skip=("encoder", "sigma_net", "encoder_palette",
                                             "encoder_clip") + FROZEN)
        results.append((float(loss), tr.params["encoder_palette"].grad.cpu(),
                        [p.grad.cpu() for p in mlps], launched))
    (loss_c, tab_c, mlp_c, n_c), (loss_g, tab_g, mlp_g, n_g) = results

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)

    # tolerances as in the train reference: 1e-2 of the largest entry for a table (one
    # bf16 ulp of an update), 1e-4 for the MLPs, the biases and the basis colors
    rel_tab = rel(tab_c, tab_g)
    rel_mlp = max(rel(a, b) for a, b in zip(mlp_c, mlp_g))
    log(f"palette reference: loss cpu {loss_c:.7f} gpu {loss_g:.7f}; max relative gradient "
        f"difference: encoder_palette {rel_tab:.3e}, MLPs and basis colors {rel_mlp:.3e}; "
        f"scatter_add launches cpu {n_c} gpu {n_g}")
    if abs(loss_c - loss_g) > 1e-5 * abs(loss_c) or rel_tab > 1e-2 or rel_mlp > 1e-4:
        raise AssertionError("the -O palette train step on the card disagrees with the CPU")
    if (n_c, n_g) != (0, 2):
        raise AssertionError(f"scatter_add launches in one palette step with the smooth "
                             f"loss: cpu {n_c}, card {n_g} (0 and 2 expected)")


def phase_extraction_split(extractor, pal_ws: str, extract_s: float) -> dict:
    """Where the palette main path's extraction spends its time (``extract_timer``, a
    ``PhaseTimer``: the bake, the sweep renders, the device-to-host moves, the host's rays
    and gathers, the host extraction with the native kernels), then the host extraction
    again on the same inputs with the kernels' plain NumPy versions in their place: its
    seconds, and the palette and weights, which must equal the native run's."""
    import tempfile

    import numpy as np

    from palettenerf_torch import native
    from palettenerf_torch.extraction.extract import palette_extraction
    from palettenerf_torch.extraction.geometry import point_triangle_min_dist_reference
    from palettenerf_torch.extraction.histogram import rgb_histogram_reference

    timer = extractor.extract_timer
    log(f"extraction by phase ({extract_s:.1f} s in all, checkpoint and data load "
        f"included):\n" + timer.report())
    palette = np.load(os.path.join(pal_ws, "palette.npz"))["palette"]
    hist = np.load(os.path.join(pal_ws, "hist_weights.npz"))["hist_weights"]
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "results")) as tmp:
        kernels = (native.rgb_histogram_native, native.point_triangle_min_dist_native)
        # the extraction's calls of the native kernels go to their plain versions
        native.rgb_histogram_native = rgb_histogram_reference
        native.point_triangle_min_dist_native = point_triangle_min_dist_reference
        t0 = time.perf_counter()
        try:
            plain = palette_extraction(extractor.extract_inputs, tmp,
                                       normalize_input=extractor.opt.use_normalized_palette,
                                       error_thres=extractor.opt.error_thres)
        finally:
            native.rgb_histogram_native, native.point_triangle_min_dist_native = kernels
        numpy_s = time.perf_counter() - t0
    split = {k: timer.totals[k] for k in timer.totals}
    split.update(total_s=extract_s, host_extraction_numpy_s=numpy_s,
                 host_extraction_native_s=timer.totals["host extraction"],
                 host_s=sum(timer.totals[k] for k in ("host rays", "host gather",
                                                      "host extraction")))
    log(f"host extraction: native {split['host_extraction_native_s']:.2f} s, NumPy "
        f"{numpy_s:.2f} s on the same {len(extractor.extract_inputs['colors'])} colors")
    if not np.array_equal(plain[0], palette):
        raise AssertionError(f"NumPy extraction gave another palette: {plain[0]} against "
                             f"{palette}")
    if plain[1].shape != hist.shape or np.abs(plain[1] - hist).max() > 1e-10:
        raise AssertionError("NumPy extraction gave other hist weights")
    return split


def phase_palette(torch, dev, train_ds):
    """The palette stages at full width through ``main_palette.main``: extraction, then
    300 training steps, on the stage-1 workspace the train main path wrote. Returns (the
    launch counts of the training run, the palette workspace)."""
    import shutil

    import numpy as np

    from palettenerf_torch import main_palette
    from palettenerf_torch.config import Config
    from palettenerf_torch.data.provider import NeRFDataset
    from palettenerf_torch.extraction.histogram import compute_rgb_histogram
    from palettenerf_torch.extraction.hull import outside_hull_rmse
    from palettenerf_torch.models.mlp import param_leaves
    from palettenerf_torch.ops import scatter
    from palettenerf_torch.train import checkpoint as ckpt_lib
    from palettenerf_torch.train.metrics import psnr

    shutil.rmtree(os.path.join(ROOT, "results_palette", "chip_smoke"), ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # -------------------------------------------------------------- extraction
    t0 = time.perf_counter()
    extractor = main_palette.main(EXTRACT_ARGS, device=dev)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    peak_extract = torch.cuda.max_memory_allocated() / 2 ** 30
    pal_ws = extractor.workspace
    stats = extractor.extract_stats
    extract_split = phase_extraction_split(extractor, pal_ws, extract_s)
    del extractor
    palette = np.load(os.path.join(pal_ws, "palette.npz"))["palette"]
    hist = np.load(os.path.join(pal_ws, "hist_weights.npz"))["hist_weights"]
    P = palette.shape[0]
    # the ground-truth foreground colors (alpha > 0.5), normalized as extraction does,
    # as a 2^5-bin histogram: how far they lie outside the palette's hull
    rgba = train_ds.images.reshape(-1, 4)
    fg = rgba[rgba[:, 3] > 0.5]
    fg = fg[:, :3] * fg[:, 3:] + (1.0 - fg[:, 3:]) + np.float32(0.05)
    fg /= np.linalg.norm(fg, axis=-1, keepdims=True)
    counts, centers = compute_rgb_histogram(fg, np.ones(len(fg), np.float32), 5)
    rmse = outside_hull_rmse(palette, centers[counts > 0].astype(np.float64), counts[counts > 0])
    log(f"palette extraction: {extract_s:.1f} s, P = {P}, {stats['foreground_samples']} "
        f"foreground samples, {stats['fallback_views']} views through the per-ray path, "
        f"outside_hull_rmse of the ground-truth foreground colors {rmse:.5f}, peak memory "
        f"{peak_extract:.2f} GiB; palette " + np.array2string(palette, precision=4).replace("\n", ""))
    if not 4 <= P <= 8 or palette.min() < 0.0 or palette.max() > 1.0:
        raise AssertionError(f"extracted palette: {P} colors in [{palette.min()}, {palette.max()}]")
    # non-negative up to the rounding of the barycentric solve (f64)
    if hist.shape != (32, 32, 32, P) or hist.min() < -1e-12 \
            or np.abs(hist.sum(-1) - 1.0).max() > 1e-6:
        raise AssertionError(f"hist_weights {hist.shape}: min {hist.min()}, bin sums within "
                             f"{np.abs(hist.sum(-1) - 1.0).max()} of 1")
    if not stats["foreground_samples"] > 1_000_000 or not rmse < 5.0 / 255.0 * 2:
        raise AssertionError(f"extraction: {stats['foreground_samples']} foreground samples, "
                             f"outside-hull rmse {rmse}")

    # -------------------------------------------------------------- main path
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    window = LaunchWindow()   # the steps replay a CUDA graph; closes with the training run
    t0 = time.perf_counter()
    trainer = main_palette.main(PALETTE_TRAIN_ARGS, device=dev)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = window.close()
    # -------------------------------------------------------------- checks
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    scatter.check_refused()
    losses, secs = trainer.stats["loss"], trainer.stats["epoch_seconds"]
    n_views = len(train_ds)
    log(f"palette main path: {trainer.global_step} steps in {total_s:.1f} s with data "
        f"loading, checkpoints and the test split's evaluation and renders; epoch losses "
        f"{['%.5f' % v for v in losses]}; steps/s per epoch (colors frozen / + smooth loss / "
        f"+ colors unfrozen) {['%.2f' % (n_views / t) for t in secs]} (traced); peak "
        f"memory {peak_gb:.2f} GiB; launches on the card in the training run {launches}")
    if trainer.global_step != 300 or len(losses) != 3:
        raise AssertionError(f"{trainer.global_step} steps in {len(losses)} epochs")
    if window.steps != 300 or not 0 < window.captures <= 3 or \
            window.replays != window.steps - window.captures:
        raise AssertionError(f"palette steps: {window.steps} in the window, {window.captures} "
                             f"captures, {window.replays} replays (each kind of step: one "
                             f"eager step, then replays)")
    if not all(math.isfinite(v) for v in losses) or not losses[2] < losses[0]:
        raise AssertionError(f"palette loss did not fall: {losses}")
    if launches["scatter_add"] < 300:
        raise AssertionError(f"scatter_add launched {launches['scatter_add']} times on the "
                             f"palette path (500 expected: 100 + 200 + 200)")
    stage1 = ckpt_lib.load_checkpoint(ckpt_lib.latest_checkpoint(
        os.path.join(ROOT, NERF_WS, "checkpoints"), "ngp"))
    for got, want in zip(
            param_leaves({k: trainer.params[k] for k in ("encoder", "sigma_net")}) +
            [trainer.grid_state.bitfield],
            param_leaves({k: stage1["params"][k] for k in ("encoder", "sigma_net")}) +
            [stage1["grid_state"]["bitfield"]]):
        if not torch.equal(got.detach().cpu(), want):
            raise AssertionError("palette training moved encoder, sigma_net or the bitfield")
    ckpts = os.path.join(trainer.workspace, "checkpoints")
    colors = {ep: ckpt_lib.load_checkpoint(os.path.join(ckpts, f"palette_ep{ep:04d}.ckpt"))
              ["params"] for ep in (2, 3)}
    extracted = torch.from_numpy(palette.astype(np.float32))
    if not torch.equal(colors[2]["basis_color"], extracted):
        raise AssertionError("basis_color moved while frozen (epochs 1-2)")
    if torch.equal(colors[3]["basis_color"], extracted):
        raise AssertionError("basis_color did not move after the unfreeze (epoch 3)")
    if not torch.equal(colors[3]["basis_color_origin"], extracted) or not torch.equal(
            colors[3]["hist_weights"], torch.from_numpy(hist.astype(np.float32))):
        raise AssertionError("basis_color_origin or hist_weights moved")
    moved = float((colors[3]["basis_color"] - extracted).abs().max())

    valid_ds = NeRFDataset(Config(path=SCENE, bound=1.0, scale=0.8), type="val")
    data = valid_ds.collate(0)
    trainer.eval_step_full(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = trainer.eval_step_full(data)
    eval_s = time.perf_counter() - t0
    img = data["images"]
    gt = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
    val_psnr = psnr(out["image"], gt)
    acc_err = float(np.abs(out["basis_acc"].sum(-1) - out["weights_sum"]).max())
    log(f"palette main path: eval {eval_s:.3f} s/frame ({data['W']}x{data['H']}), val PSNR "
        f"{val_psnr:.3f} dB, max |sum of basis_acc - weights_sum| {acc_err:.2e}, "
        f"basis_color moved by up to {moved:.4f} in epoch 3")
    if not all(np.isfinite(v).all() for v in out.values()):
        raise AssertionError("non-finite palette render")
    if out["basis_rgb"].shape != (data["H"], data["W"], 3 * P) or acc_err > 1e-4:
        raise AssertionError(f"basis maps {out['basis_rgb'].shape}, basis_acc sums off "
                             f"weights_sum by {acc_err}")
    if not val_psnr > PALETTE_PSNR_FLOOR:
        raise AssertionError(f"palette validation PSNR {val_psnr:.3f} dB <= floor "
                             f"{PALETTE_PSNR_FLOOR}")
    return launches, trainer.workspace, val_psnr, extract_split


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
    """The serving main path at full width, on the workspace the palette phase trained."""
    from palettenerf_torch import main_serve
    from palettenerf_torch.config import Config
    from palettenerf_torch.data.provider import NeRFDataset
    from palettenerf_torch.data.rays import gen_rays
    from palettenerf_torch.models.palette import PaletteSpec
    from palettenerf_torch.render.baking import (bake_palette, fuse_volume,
                                                 mask_with_bitfield, render_baked)
    from palettenerf_torch.render.palette_renderer import make_region_edit, region_edit_delta_hsv
    from palettenerf_torch.render.sweep import build_sweep_volume, render_sweep
    from palettenerf_torch.train.checkpoint import load_palette_checkpoint

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
    params, grid_state = load_palette_checkpoint(main_serve.find_checkpoint(ckpt), device=dev)
    P = params["basis_color"].shape[0]
    spec = PaletteSpec.build(bound=1.0, num_basis=P)
    baked = mask_with_bitfield(bake_palette(params, spec, resolution=256, vd_bands=2),
                               grid_state)
    sv = build_sweep_volume(baked, sigma_thresh=1e-3)
    C = sv.vols[0].shape[2]
    if sv.vols[0].shape != (256, 256, C, 256) or C != 2 + 4 * P + 3 * 4:
        raise AssertionError(f"sweep volume {tuple(sv.vols[0].shape)}")
    palette = params["basis_color"].clamp(0, 1)
    new = palette.cpu().clone()
    new[0] = torch.tensor([0.2, 0.9, 0.2])  # --edit_basis 0 with the default --edit_rgb
    edit = make_region_edit(P, clip_dim=1, std_xyz=0.3)._replace(
        delta_hsv=region_edit_delta_hsv(palette.cpu().numpy(), new.numpy()).numpy())

    ds = NeRFDataset(Config(path=SCENE, bound=1.0, scale=0.8), type="test")
    H, W = ds.H, ds.W
    pose = ds.poses[0]
    out = render_sweep(sv, pose, ds.intrinsics, H, W, u_res=400, basis_color=palette)
    img = out["image"]
    finite = all(bool(torch.isfinite(v).all()) for v in out.values())
    rgba = torch.from_numpy(ds.images[0])
    alpha_psnr = _psnr(torch, out["weights_sum"].reshape(H, W), rgba[..., 3])
    color_psnr = _psnr(torch, img, rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:]))
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
                           edit=make_region_edit(P, clip_dim=1))["image"]
    moved = float((edited - img).abs().max())
    neutral_moved = float((neutral - img).abs().max())
    log(f"serve main path: bake {bake_s:.2f} s (edited run {bake_edit:.2f} s), "
        f"{fps:.2f} fps plain, {fps_edit:.2f} fps edited ({W}x{H}, u_res 400, 60 "
        f"frames), peak memory {peak_plain:.2f} GiB plain / {peak_edit:.2f} GiB edited; "
        f"test view 0: vs its image {color_psnr:.3f} dB, opacity vs ground-truth alpha PSNR "
        f"{alpha_psnr:.3f} dB, sweep vs "
        f"render_baked (512 samples) {psnr_baked:.3f} dB; edit moves {moved:.3f}, neutral "
        f"edit {neutral_moved:.3g}; min weights_sum {ws_min:.3g}; launches {launches}")
    if img.shape != (H, W, 3) or (H, W) != (800, 800) or not finite:
        raise AssertionError(f"sweep frame {tuple(img.shape)}, finite {finite}")
    if not alpha_psnr > ALPHA_PSNR_FLOOR:
        raise AssertionError(f"test view 0 opacity PSNR {alpha_psnr:.3f} dB <= floor "
                             f"{ALPHA_PSNR_FLOOR}")
    if not color_psnr > SERVE_COLOR_PSNR_FLOOR:
        raise AssertionError(f"test view 0 vs its image {color_psnr:.3f} dB <= floor "
                             f"{SERVE_COLOR_PSNR_FLOOR}")
    if not psnr_baked > SWEEP_VS_BAKED_FLOOR:
        raise AssertionError(f"sweep vs render_baked {psnr_baked:.3f} dB <= "
                             f"{SWEEP_VS_BAKED_FLOOR}")
    if not moved > 0.05 or neutral_moved != 0.0:
        raise AssertionError(f"edit moved {moved} (> 0.05 needed), neutral edit moved "
                             f"{neutral_moved} (0 needed)")
    return launches


def phase_edit_reference(torch, dev):
    """A 4-level, 2^13-row palette field (P = 4) on the card and on the CPU from the same
    weights: EditingSession frames by PSNR (the pick, the correspondences and the
    stylizer of the frame are the CPU's), a 20-step stylizer fit (each leaf, relative to
    its largest entry), then one palette GUI step (smooth loss on, colors unfrozen) from
    the same batch and draws (loss, relative)."""
    import numpy as np

    from palettenerf_torch.config import Config
    from palettenerf_torch.gui import EditingSession, fit_stylizer
    from palettenerf_torch.models.palette import PaletteSpec
    from palettenerf_torch.render.palette_renderer import StylizerParams
    from palettenerf_torch.train.palette_trainer import PaletteTrainer

    kw = dict(bound=1.0, log2_hashmap_size=13, grid_levels=4)
    cfg = Config(O=True, fp16=True, grid_size=32, num_rays=512, max_steps=128,
                 train_samples_per_ray=32, infer_samples_per_ray=64, iters=100, **kw)
    spec = PaletteSpec.build(num_basis=4, fp16=True, **kw)
    gen = torch.Generator().manual_seed(8)
    params = _random_palette_params(torch, spec, gen)
    hist = torch.rand((32, 32, 32, 4), generator=gen)
    params["hist_weights"] = hist / hist.sum(-1, keepdim=True)
    n, S = cfg.num_rays, cfg.train_samples_per_ray
    o = torch.randn((n, 3), generator=gen)
    o = o / o.norm(dim=-1, keepdim=True) * 2.0
    d = -o + 0.5 * torch.randn((n, 3), generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    batch = {"rays_o": o.numpy(), "rays_d": d.numpy(),
             "images": torch.rand((n, 4), generator=gen).numpy()}
    draws = {k: torch.rand(shape, generator=gen)
             for k, shape in (("bg", (n, 3)), ("noise", (n,)), ("jit_u", (n * S, 3)))}
    rng = np.random.default_rng(8)
    res, shared = {}, {}
    for device in ("cpu", dev):
        tr = PaletteTrainer("ref", cfg, spec, params=params,
                            workspace=os.path.join(WORKSPACE, "edit_reference"),
                            use_checkpoint="scratch", mute=True, device=device)
        tr.grid_state = tr.grid_state._replace(
            bitfield=torch.full_like(tr.grid_state.bitfield, 255))
        sess = EditingSession(tr, W=64, H=64, radius=2.6)
        frames = {"plain": sess.render()}
        if device == "cpu":
            ys, xs = np.nonzero(frames["plain"]["weights_sum"] > 0.5)
            shared["xyz"] = sess.pick(int(xs[len(xs) // 2]), int(ys[len(xs) // 2]))["xyz"]
            shared["pix"] = [(int(xs[i]), int(ys[i]))
                             for i in rng.choice(len(xs), 8, replace=False)]
            shared["tgt"] = rng.uniform(size=(8, 3))
        sess.set_region(mean_xyz=shared["xyz"], std_xyz=0.05)
        sess.recolor(1, [0.9, 0.1, 0.1])
        frames["region recolor"] = sess.render()
        sess.set_weights(1.0, 0.0)
        sess.set_region(mean_xyz=shared["xyz"], std_xyz=0.3, weight_mode=True)
        frames["weight mode"] = sess.render()
        sess.set_region()
        sess.reset_colors()
        sess.set_weights(0.3, 0.5)
        frames["dials"] = sess.render()
        sess.set_weights(1.0, 1.0)
        for (x, y), t in zip(shared["pix"], shared["tgt"]):
            sess.add_correspondence(x, y, t)
        ro, rd, tgt = (np.stack(c) for c in zip(*sess._corr))
        sty = fit_stylizer(tr, ro, rd, tgt, iters=20)
        if device == "cpu":
            shared["sty"] = sty
        sess.set_stylizer(StylizerParams(*(t.to(tr.device) for t in shared["sty"])))
        frames["stylizer on"] = sess.render()
        tr.freeze_basis_color, tr.require_smooth_loss = False, True
        tr.lambda_palette = cfg.lambda_palette
        loss = float(tr._gui_train_step(batch, **{k: v.to(tr.device) for k, v in draws.items()}))
        res[str(device)] = (frames, [t.cpu() for t in sty], loss)
    (fc, sc, lc), (fg, sg, lg) = res["cpu"], res[str(dev)]
    ps = {name: min(_psnr(torch, torch.from_numpy(fg[name][k]), torch.from_numpy(fc[name][k]))
                    for k in ("image", "weights_sum", "depth_origin", "basis_acc"))
          for name in fc}
    rel_sty = max(float((a - b).abs().max()) / float(a.abs().max()) for a, b in zip(sc, sg))
    moved = {name: float(np.abs(fc[name]["image"] - fc["plain"]["image"]).max())
             for name in fc if name != "plain"}
    log("edit reference: card vs CPU PSNR (lowest of image, weights_sum, depth_origin, "
        "basis_acc) " + ", ".join(f"{k} {v:.2f} dB" for k, v in ps.items())
        + f"; stylizer leaves {rel_sty:.3e} of their largest entry; GUI step loss cpu "
          f"{lc:.7f} gpu {lg:.7f}; each edit moves the CPU frame by "
        + ", ".join(f"{k} {v:.3f}" for k, v in moved.items()))
    if min(ps.values()) < EDIT_CARD_PSNR or min(moved.values()) <= 1e-3:
        raise AssertionError(f"edit reference: frames on the card vs the CPU {ps} dB (floor "
                             f"{EDIT_CARD_PSNR}), edits moved the frame by {moved}")
    if rel_sty > STYLIZER_RTOL or abs(lc - lg) > 1e-5 * abs(lc):
        raise AssertionError(f"edit reference: stylizer leaves {rel_sty} apart (tolerance "
                             f"{STYLIZER_RTOL}), GUI step loss cpu {lc} gpu {lg}")


def phase_edit(torch, dev, stage1):
    """The editing main path at full width on the palette workspace phase 7 trained, then
    the stage-1 mesh export. Returns the launch counts of the edit path."""
    import numpy as np

    from palettenerf_torch import main_palette
    from palettenerf_torch.data.palette_provider import PaletteDataset
    from palettenerf_torch.gui import EditingSession
    from palettenerf_torch.models.mlp import param_leaves
    from palettenerf_torch.ops import scatter
    from palettenerf_torch.utils.mcubes import read_ply

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    # -------------------------------------------------------------- main path
    t0 = time.perf_counter()
    cfg, trainer = main_palette.load_test_trainer(PALETTE_TRAIN_ARGS + ["--test"], device=dev)
    sess = EditingSession(trainer, W=cfg.W, H=cfg.H, radius=cfg.radius, fovy=cfg.fovy)
    test_ds = PaletteDataset(cfg, type="test")
    train_ds = PaletteDataset(cfg, type="train")
    load_s = time.perf_counter() - t0
    frames, secs = {}, {}

    def snap(name):
        t = time.perf_counter()
        frames[name] = sess.render()
        secs[name] = time.perf_counter() - t
        return frames[name]

    sess.jump_to_pose(test_ds.poses, 0)
    snap("test view 0")
    sess.cam.orbit(40, 8)
    plain = snap("orbit")
    ys, xs = np.nonzero(plain["weights_sum"] > 0.5)
    x, y = int(xs[len(xs) // 2]), int(ys[len(xs) // 2])
    pick = sess.pick(x, y)
    sess.set_region(mean_xyz=pick["xyz"], std_xyz=0.35)
    sess.recolor(0, [0.15, 0.85, 0.25])
    snap("region recolor")
    sess.set_weights(1.0, 0.0)
    sess.set_region(mean_xyz=pick["xyz"], std_xyz=0.35, weight_mode=True)
    snap("weight mode")
    sess.set_weights(1.0, 1.0)
    sess.set_region()
    snap("recolor basis 0")
    sess.recolor(min(1, sess.num_basis - 1), [0.2, 0.3, 0.95])
    snap("recolor basis 1")
    sess.reset_colors()
    snap("reset colors")
    sess.set_weights(0.0, 1.0)
    snap("offsets dial 0")
    sess.set_weights(1.0, 0.0)
    snap("view-dep dial 0")
    sess.set_weights(1.0, 1.0)
    snap("dials back")
    cx, cy = int(xs[len(xs) // 3]), int(ys[len(xs) // 3])
    target = np.array([0.9, 0.6, 0.1], np.float32)
    sess.add_correspondence(cx, cy, target)
    t = time.perf_counter()
    sess.optimize_style(iters=150)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    snap("stylizer on")
    sess.use_style(False)
    snap("style off")
    paced = [sess.render_dynamic(target_ms=100.0) for _ in range(4)]
    torch.cuda.synchronize()
    steps0 = trainer.global_step
    launches = read_counts()  # the frames' eager launches; the burst's steps replay a graph
    window = LaunchWindow()
    t = time.perf_counter()
    burst = sess.train_burst(train_ds, steps=16)
    torch.cuda.synchronize()
    burst_s = time.perf_counter() - t
    on_card = window.close()
    launches = {k: n + on_card[k] for k, n in launches.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    # -------------------------------------------------------------- checks
    scatter.check_refused()
    shape = (cfg.H, cfg.W, 3)
    moved = {k: float(np.abs(f["image"] - plain["image"]).max()) for k, f in frames.items()
             if k not in ("test view 0", "orbit")}
    gray = float(np.abs(frames["weight mode"]["image"]
                        - frames["weight mode"]["image"][..., :1]).max())
    before = float(np.abs(plain["image"][cy, cx] - target).max())
    after = float(np.abs(frames["stylizer on"]["image"][cy, cx] - target).max())
    expect = 16 * (2 if trainer.require_smooth_loss else 1)
    log(f"edit main path: {cfg.W}x{cfg.H}, P = {sess.num_basis}, load {load_s:.1f} s; s per "
        "exact frame " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    log("edit main path: |frame - plain| " + ", ".join(f"{k} {v:.3g}" for k, v in moved.items())
        + f"; weight-mode frame off gray by {gray:.2e}; stylized pixel ({cx}, {cy}) off its "
          f"target by {before:.4f} before, {after:.4f} after")
    log("edit main path: render_dynamic (100 ms budget) "
        + ", ".join(f"{p['frame_ms']:.1f} ms -> x{p['downscale']:.3f}" for p in paced)
        + f" (spp {[p['spp'] for p in paced]}); stylizer fit (150 steps, 1 correspondence) "
          f"{fit_s:.3f} s; train burst {16 / burst_s:.2f} steps/s (loss {burst['loss']:.5f}, "
          f"lr {burst['lr']:.3e}); scatter_add launches {launches['scatter_add']} "
          f"({expect} expected); peak memory {peak_gb:.2f} GiB")
    if any(f["image"].shape != shape or not np.isfinite(f["image"]).all()
           for f in frames.values()):
        raise AssertionError(f"edit frames: shapes {[f['image'].shape for f in frames.values()]}")
    if not len(xs) > 1000:
        raise AssertionError(f"the orbit frame has {len(xs)} foreground pixels")
    back = ("reset colors", "dials back", "style off")
    if max(moved[k] for k in back) > 1e-6 or min(
            v for k, v in moved.items() if k not in back) <= 1e-3:
        raise AssertionError(f"edits must move the frame and {back} give it back: {moved}")
    if gray > 1e-5 or not after < before:
        raise AssertionError(f"weight mode off gray by {gray}; stylized pixel {before} -> {after}")
    if [p["spp"] for p in paced][0] != 1 or paced[-1]["downscale"] >= 1.0:
        raise AssertionError(f"render_dynamic: {[(p['spp'], p['downscale']) for p in paced]}")
    if trainer.global_step != steps0 + 16 or not math.isfinite(burst["loss"]):
        raise AssertionError(f"train burst: {trainer.global_step - steps0} steps, "
                             f"loss {burst['loss']}")
    if launches["scatter_add"] != expect:
        raise AssertionError(f"scatter_add launched {launches['scatter_add']} times in the "
                             f"16-step burst ({expect} expected)")
    if not all(bool(torch.isfinite(p).all()) for p in param_leaves(trainer.params)):
        raise AssertionError("non-finite parameters after the burst")
    del sess, trainer, frames, paced
    torch.cuda.empty_cache()

    # -------------------------------------------------------------- main_nerf's tail
    path = stage1.save_mesh(resolution=256, threshold=10)
    st = stage1.mesh_stats
    verts, faces = read_ply(path)
    log(f"mesh: {st['vertices']} vertices, {st['faces']} faces in "
        f"{st['lattice_s'] + st['host_s']:.2f} s (density lattice 256^3 on the card "
        f"{st['lattice_s']:.3f} s, marching tetrahedra + PLY on the host {st['host_s']:.2f} s) "
        f"-> {os.path.relpath(path, ROOT)} ({os.path.getsize(path) / 2 ** 20:.1f} MiB)")
    if not len(faces) > 1000 or faces.min() < 0 or faces.max() >= len(verts):
        raise AssertionError(f"mesh: {len(verts)} vertices, {len(faces)} faces, indices "
                             f"{faces.min(initial=0)}..{faces.max(initial=0)}")
    if not np.isfinite(verts).all() or np.abs(verts).max() > 1.0:
        raise AssertionError(f"mesh vertices outside [-1, 1]: {np.abs(verts).max()}")
    return launches


def lpips_missing() -> bool:
    """Whether the pretrained ``lpips`` package is absent: LPIPS must then read NaN."""
    import importlib.util

    return importlib.util.find_spec("lpips") is None


def phase_options_reference(torch, dev):
    """The model options of the background net, the patch loss and the linear colour
    space on small sizes, card against CPU with the same parameters and draws:
    ``sph_from_ray`` (axis-parallel rays included); the background grid's encoding at full
    width (4 levels, 2^19 rows: three dense, one hashed) and its f32 table gradient;
    ``rlpips_distance`` and its input gradient; one ``-O`` stage-1 step with the background
    net and ``--patch_size 4 --lambda_lpips 0.1`` (loss and every gradient, one B1 launch on
    the card); one palette eval render with the background net in linear colour space.
    Returns the largest difference of each check."""
    from palettenerf_torch.config import Config
    from palettenerf_torch.models.nerf import (NeRFSpec, background_grid, init_background,
                                               init_nerf, param_list)
    from palettenerf_torch.models.palette import PaletteSpec, initialize_palette
    from palettenerf_torch.ops.hashgrid_fast import hashgrid_encode_fast
    from palettenerf_torch.ops.rays import sph_from_ray
    from palettenerf_torch.render.nerf_renderer import RenderSettings
    from palettenerf_torch.render.palette_renderer import render_palette_eval
    from palettenerf_torch.train.metrics import make_rlpips_kernels, rlpips_distance
    from palettenerf_torch.train.trainer import Trainer

    gen = torch.Generator().manual_seed(8)
    devices = (torch.device("cpu"), dev)

    def both(fn):
        """fn(device) -> tensor(s); the results of the CPU and of the card, on the CPU."""
        out = []
        for d in devices:
            r = fn(d)
            out.append([t.detach().float().cpu() for t in (r if isinstance(r, tuple) else (r,))])
        return out

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)

    def rays(n, radius):
        o = torch.randn((n, 3), generator=gen)
        o = o / o.norm(dim=-1, keepdim=True) * radius
        d = -o + 0.8 * torch.randn((n, 3), generator=gen)
        return o, d / d.norm(dim=-1, keepdim=True)

    err = {}
    o, d = rays(4096, 2.0)
    d[:6] = torch.cat([torch.eye(3), -torch.eye(3)])
    (c,), (g,) = both(lambda dv: sph_from_ray(o.to(dv), d.to(dv), BG_RADIUS))
    err["sph_from_ray"] = float((c - g).abs().max())

    spec = background_grid(BG_RADIUS)
    table = torch.empty((spec.total_params, spec.level_dim)).uniform_(-1, 1, generator=gen)
    x = torch.rand((1 << 16, 2), generator=gen)
    cot = torch.randn((1 << 16, spec.output_dim), generator=gen)

    def encode(dv):
        t = table.to(dv, copy=True).requires_grad_(True)
        out = hashgrid_encode_fast(t, x.to(dv), spec)
        (out * cot.to(dv)).sum().backward()
        return out, t.grad

    (fc, gc), (fg, gg) = both(encode)
    err["bg_encoder"], err["bg_encoder_grad"] = float((fc - fg).abs().max()), rel(gc, gg)

    p = torch.rand((16, 16, 16, 3), generator=gen)
    q = (p + 0.1 * torch.randn(p.shape, generator=gen)).clamp(0, 1)

    def distance(dv):
        pp = p.to(dv, copy=True).requires_grad_(True)
        v = rlpips_distance(make_rlpips_kernels(device=dv), pp, q.to(dv))
        v.backward()
        return v, pp.grad

    (vc, dc), (vg, dg) = both(distance)
    err["rlpips"], err["rlpips_grad"] = abs(float(vc - vg)) / float(vc), rel(dc, dg)

    # dt_gamma 0: the march takes no exp, so both devices place the samples bit for bit (with
    # the default 1/128 the card's exp moves them by ulps, and on this lively table the hash
    # grid's gradients follow a sample across a cell boundary by several percent)
    cfg = Config(O=True, fp16=True, bound=1.0, grid_size=32, num_rays=512, max_steps=256,
                 train_samples_per_ray=32, log2_hashmap_size=14, grid_levels=8, iters=100,
                 bg_radius=4.0, patch_size=4, lambda_lpips=0.1, dt_gamma=0.0)
    nspec = NeRFSpec.build(bound=1.0, fp16=True, log2_hashmap_size=14, grid_levels=8,
                           bg_radius=4.0)
    params = init_nerf(nspec, gen)
    params["encoder"].uniform_(-1, 1, generator=gen)
    params["encoder_bg"].uniform_(-1, 1, generator=gen)
    o, d = rays(cfg.num_rays, 2.0)
    img, noise = torch.rand((cfg.num_rays, 4), generator=gen), torch.rand((cfg.num_rays,),
                                                                            generator=gen)
    results = []
    for device in devices:
        tr = Trainer("ref", cfg, nspec, params={k: (v.clone() if torch.is_tensor(v) else
                                                      [w.clone() for w in v])
                                                for k, v in params.items()},
                     workspace=os.path.join(WORKSPACE, "options_reference"),
                     use_checkpoint="scratch", mute=True, device=device)
        tr.grid_state = tr.grid_state._replace(
            bitfield=torch.full_like(tr.grid_state.bitfield, 255))
        before = read_counts()["scatter_add"]
        loss, _ = tr.train_step(*(t.to(device) for t in (o, d, img)), noise=noise.to(device))
        results.append((float(loss), [p.grad.cpu() for p in param_list(tr.params)],
                        read_counts()["scatter_add"] - before))
    (loss_c, grads_c, n_c), (loss_g, grads_g, n_g) = results
    n_fg = len(param_list({k: params[k] for k in ("encoder", "sigma_net", "color_net")}))
    rels = [rel(a, b) for a, b in zip(grads_c, grads_g)]
    err["step_loss"] = abs(loss_c - loss_g) / abs(loss_c)
    err["step_table_grad"], err["step_grad"] = rels[0], max(rels[1:n_fg])
    err["step_bg_grad_l2"] = max(float((a - b).norm() / a.norm())
                                 for a, b in zip(grads_c[n_fg:], grads_g[n_fg:]))
    log(f"options reference: bg + patch step loss cpu {loss_c:.7f} gpu {loss_g:.7f}; "
        f"gradients off by up to {rels[0]:.3e} (encoder, bf16), {err['step_grad']:.3e} "
        f"(sigma and color nets), {max(rels[n_fg:]):.3e} of the largest entry and "
        f"{err['step_bg_grad_l2']:.3e} in L2 (encoder_bg, bg_net); scatter_add launches cpu "
        f"{n_c} gpu {n_g}")

    pspec = PaletteSpec.build(bound=1.0, num_basis=4, log2_hashmap_size=14, grid_levels=8,
                              bg_radius=4.0, color_space="linear")
    pparams = _random_palette_params(torch, pspec, gen)
    pparams.update(init_background(pspec, gen))
    pparams["encoder_bg"].uniform_(-1, 1, generator=gen)
    pparams = initialize_palette(pparams, pspec, PALETTE[:4])
    settings = RenderSettings(bound=1.0, grid_size=32, max_steps=256, num_samples=64,
                              t_thresh=1e-2, min_near=0.05, bg_radius=4.0)
    c32 = (torch.arange(32) + 0.5) / 32 * 2 - 1
    ball = (torch.stack(torch.meshgrid(c32, c32, c32, indexing="ij"), -1) ** 2).sum(-1) < 0.4
    bits = (ball.reshape(-1, 8).int() << torch.arange(8)).sum(-1).to(torch.uint8)
    o, d = rays(2048, 2.2)
    keys = []

    def palette_frame(dv):
        out = render_palette_eval(_to(torch, pparams, dv), pspec, bits.to(dv), o.to(dv),
                                  d.to(dv), settings)
        keys[:] = sorted(out)
        return tuple(out[k] for k in sorted(out))

    frames = both(palette_frame)
    ws = frames[0][keys.index("weights_sum")]
    err["palette_eval"] = max(float((a - b).abs().max()) for a, b in zip(*frames))
    log(f"options reference: sph_from_ray {err['sph_from_ray']:.2e}; bg encoder "
        f"{err['bg_encoder']:.2e}, table gradient {err['bg_encoder_grad']:.2e} (relative); "
        f"rlpips {err['rlpips']:.2e}, input gradient {err['rlpips_grad']:.2e} (relative); "
        f"palette eval, bg + linear, max abs over {len(keys)} outputs "
        f"{err['palette_eval']:.2e} ({100 * float((ws < 0.1).float().mean()):.0f}% "
        f"background rays)")
    limits = {"sph_from_ray": 1e-6, "bg_encoder": 1e-5, "bg_encoder_grad": OPTIONS_GRAD_RTOL,
              "rlpips": 1e-5, "rlpips_grad": OPTIONS_GRAD_RTOL, "step_loss": 1e-5,
              "step_table_grad": 1e-2, "step_grad": OPTIONS_GRAD_RTOL,
              "step_bg_grad_l2": BG_GRAD_L2_RTOL,
              "palette_eval": OPTIONS_RENDER_ATOL}
    bad = {k: v for k, v in err.items() if not v <= limits[k]}
    if bad or (n_c, n_g) != (0, 1):
        raise AssertionError(f"options reference: card vs CPU beyond tolerance {bad} "
                             f"(limits {limits}); scatter_add launches cpu {n_c} gpu {n_g}")
    return err


def phase_bg_patch(torch, dev, train_ds):
    """Stage 1 with the background net and the rLPIPS patch loss through
    ``main_nerf.main`` at full width: 300 steps from scratch (host-sampled batches of 16
    patches of 16x16 pixels), then the CLI's test tail with the JAX meter list (PSNR,
    LPIPS: NaN without the ``lpips`` package, rLPIPS) and its mesh. Then validation view 0
    against the training target: with the background net the target is the straight RGB
    of the RGBA images (black under alpha 0 in proc_toys), while the meters composite the
    ground truth on white, as the JAX package does. Then B1 held and timed on the stream
    of one patch batch marched through the trained grid. Returns (launch counts, what
    was measured, the stream's times and bound)."""
    import shutil

    import numpy as np

    from palettenerf_torch import main_nerf
    from palettenerf_torch.config import Config
    from palettenerf_torch.data.provider import NeRFDataset
    from palettenerf_torch.data.rays import sample_ray_indices
    from palettenerf_torch.models.nerf import param_list
    from palettenerf_torch.ops import hashgrid_fast, scatter
    from palettenerf_torch.train.metrics import psnr

    shutil.rmtree(os.path.join(ROOT, os.path.dirname(BG_PATCH_WS)), ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    # -------------------------------------------------------------- main path
    t0 = time.perf_counter()
    trainer = main_nerf.main(BG_PATCH_ARGS, device=dev, mesh_resolution=BG_MESH_RESOLUTION)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_counts()
    # -------------------------------------------------------------- checks
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses, secs = trainer.stats["loss"], trainer.stats["epoch_seconds"]
    meters = {m.name: m.measure() for m in trainer.metrics}
    n_views = len(train_ds)
    steps_per_s = [n_views / s for s in secs]
    log(f"bg + patch path: {trainer.global_step} steps in {total_s:.1f} s with the test "
        f"split's evaluation, renders and the {BG_MESH_RESOLUTION}^3 mesh; epoch losses "
        f"{['%.5f' % v for v in losses]}; steps/s per epoch {['%.2f' % v for v in steps_per_s]}; "
        f"test meters (gt on white) {meters}; peak memory {peak_gb:.2f} GiB; launches "
        f"{launches}")
    if [m.name for m in trainer.metrics] != ["PSNR", "LPIPS (alex)", "rLPIPS"]:
        raise AssertionError(f"meters {[m.name for m in trainer.metrics]}")
    if trainer.global_step != EPOCHS * n_views or not trainer.host_sampled():
        raise AssertionError(f"{trainer.global_step} steps, host-sampled "
                             f"{trainer.host_sampled()}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"bg + patch loss did not fall: {losses}")
    if launches["scatter_add"] != trainer.global_step:
        raise AssertionError(f"scatter_add launched {launches['scatter_add']} times in "
                             f"{trainer.global_step} steps")
    if lpips_missing() and not math.isnan(meters["LPIPS (alex)"]):
        raise AssertionError("LPIPS reported a number without the lpips package")
    if not (math.isfinite(meters["PSNR"]) and meters["rLPIPS"] > 0
            and math.isfinite(meters["rLPIPS"])):
        raise AssertionError(f"test meters {meters}")
    if not all(bool(torch.isfinite(p).all()) for p in param_list(trainer.params)):
        raise AssertionError("non-finite parameters")

    valid_ds = NeRFDataset(Config(path=SCENE, bound=1.0, scale=0.8), type="val")
    data = valid_ds.collate(0)
    out = trainer.eval_step_full(data)
    img = data["images"]
    target_psnr = psnr(out["image"], img[..., :3])
    white_psnr = psnr(out["image"], img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:]))
    log(f"bg + patch path: val view 0 PSNR {target_psnr:.3f} dB against the training target "
        f"(straight RGB), {white_psnr:.3f} dB against the image on white")
    if not all(np.isfinite(v).all() for v in out.values()):
        raise AssertionError("non-finite render")
    if not target_psnr > BG_PATCH_PSNR_FLOOR:
        raise AssertionError(f"bg + patch validation PSNR {target_psnr:.3f} dB <= floor "
                             f"{BG_PATCH_PSNR_FLOOR}")

    # B1 on the stream of one patch batch: 16 patches of 16x16 of training view 0
    opt, spec = trainer.opt, trainer.spec.grid
    inds, _ = sample_ray_indices(np.random.default_rng(5), train_ds.H, train_ds.W,
                                 opt.num_rays, patch_size=opt.patch_size)
    m, x01, gen = march_train_batch(torch, trainer, train_ds, 5,
                                    torch.as_tensor(inds, device=dev))
    idx = hashgrid_fast.corner_indices(spec, x01)[0].reshape(-1).contiguous()
    U, C = idx.numel(), spec.level_dim
    vals = torch.randn((U, C), generator=gen, device=dev) * 1e-3
    vals = (vals.view(-1, SCATTER_PERIOD, C) * m.mask.reshape(-1, 1, 1)).view(U, C)
    vals = vals.to(torch.bfloat16)
    log(f"bg + patch stream: {len(inds)} rays in {len(inds) // opt.patch_size ** 2} patches "
        f"of {opt.patch_size}x{opt.patch_size}, {100 * float(m.mask.float().mean()):.2f}% of "
        f"the slots hold a sample")
    max_err, _ = check_scatter(torch, scatter, idx, vals, spec.total_params,
                               "bg + patch stream", SCATTER_PERIOD)
    stream_stats(torch, spec, idx, vals, "bg + patch")
    t = time_scatter(torch, scatter, idx, vals, spec.total_params, "bg + patch")
    n_bytes = U * (4 + 2 * C) + spec.total_params * C * 4
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, U * C / FP32_FLOPS * 1e3
    t.update(U=U, max_abs_err=max_err, bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations")
    info = {"steps_per_s": steps_per_s, "losses": losses, "test_meters": meters,
            "val_psnr_target": target_psnr, "val_psnr_white": white_psnr, "total_s": total_s,
            "peak_gib": peak_gb}
    del trainer
    torch.cuda.empty_cache()
    return launches, info, t


def phase_bg_linear_palette(torch, dev):
    """The palette stages with the background net in linear colour space on the workspace
    of ``phase_bg_patch``: extraction from sweep renders through ``main_palette.main``,
    then the CLI's training run (``main_palette.load_train_trainer``, the trainer ``main``
    trains, and ``train`` over three epochs, one per schedule phase) without its test tail
    (16 frames of ~12 s on this cell's field: cut for time, PERF.md §4). The bg net is
    warm-started from stage 1: the trainer holds stage 1's ``encoder_bg`` and ``bg_net`` at
    step 0, and its log counts the tensors it loaded. Then validation view 0 in linear
    space against the training target and, through the CLI's meters, the gt on white.
    Returns (launch counts, what was measured)."""
    import shutil

    import numpy as np

    from palettenerf_torch import main_palette
    from palettenerf_torch.config import Config
    from palettenerf_torch.data.palette_provider import PaletteDataset
    from palettenerf_torch.data.provider import NeRFDataset
    from palettenerf_torch.train import checkpoint as ckpt_lib
    from palettenerf_torch.train.metrics import psnr
    from palettenerf_torch.train.trainer import eval_gt
    from palettenerf_torch.utils.color import srgb_to_linear

    shutil.rmtree(os.path.join(ROOT, "results_palette", "chip_smoke_bg"), ignore_errors=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    extractor = main_palette.main(BG_LINEAR_ARGS + ["--extract_palette", "--extract_via_sweep"],
                                  device=dev)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    pal_ws, stats = extractor.workspace, extractor.extract_stats
    del extractor
    palette = np.load(os.path.join(pal_ws, "palette.npz"))["palette"]
    hist = np.load(os.path.join(pal_ws, "hist_weights.npz"))["hist_weights"]
    P = palette.shape[0]
    log(f"bg + linear extraction: {extract_s:.1f} s, P = {P}, {stats['foreground_samples']} "
        f"foreground samples; palette of the linear ground truth "
        + np.array2string(palette, precision=4).replace("\n", ""))
    if not 4 <= P <= 8 or palette.min() < 0.0 or palette.max() > 1.0 or \
            hist.shape != (32, 32, 32, P) or np.abs(hist.sum(-1) - 1.0).max() > 1e-6:
        raise AssertionError(f"bg + linear extraction: palette {palette}, hist {hist.shape}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    window = LaunchWindow()   # the steps replay a CUDA graph; closes with the training run
    # -------------------------------------------------------------- main path
    t0 = time.perf_counter()
    cfg, trainer = main_palette.load_train_trainer(BG_LINEAR_TRAIN_ARGS, device=dev)
    stage1 = ckpt_lib.load_checkpoint(ckpt_lib.latest_checkpoint(
        os.path.join(ROOT, BG_PATCH_WS, "checkpoints"), "ngp"))["params"]
    warm = all(torch.equal(a.detach().cpu(), b) for a, b in zip(
        [trainer.params["encoder_bg"], *trainer.params["bg_net"]],
        [stage1["encoder_bg"], *stage1["bg_net"]]))
    train_ds = PaletteDataset(cfg, type="train")
    epochs = int(np.ceil(cfg.iters / len(train_ds)))
    trainer.train(train_ds, None, epochs)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = window.close()
    # -------------------------------------------------------------- checks
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses, secs = trainer.stats["loss"], trainer.stats["epoch_seconds"]
    steps_per_s = [len(train_ds) / s for s in secs]
    with open(trainer.log_path) as f:
        loaded = [line.strip() for line in f if "warm-started" in line]
    log(f"bg + linear palette path: {trainer.global_step} steps in {total_s:.1f} s with data "
        f"loading and checkpoints; epoch losses {['%.5f' % v for v in losses]}; steps/s per "
        f"epoch (colors frozen / + smooth loss / + colors unfrozen) "
        f"{['%.2f' % v for v in steps_per_s]}; peak memory {peak_gb:.2f} GiB; launches "
        f"{launches}; bg net at step 0 = stage 1's: {warm}; {loaded}")
    if not warm:
        raise AssertionError("the palette trainer's bg net at step 0 is not stage 1's")
    if len(loaded) != 1 or "warm-started 9 tensors" not in loaded[0]:
        raise AssertionError(f"warm start: {loaded} (9 tensors expected: encoder, 2 sigma_net, "
                             "3 color_net, encoder_bg, 2 bg_net)")
    if trainer.global_step != epochs * len(train_ds) or len(losses) != epochs:
        raise AssertionError(f"{trainer.global_step} steps in {len(losses)} epochs")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"bg + linear palette loss did not fall: {losses}")
    if launches["scatter_add"] < trainer.global_step:
        raise AssertionError(f"scatter_add launched {launches['scatter_add']} times")
    ep2 = ckpt_lib.load_checkpoint(os.path.join(trainer.workspace, "checkpoints",
                                                "palette_ep0002.ckpt"))["params"]
    linear = srgb_to_linear(torch.from_numpy(palette.astype(np.float32)))
    if not torch.allclose(ep2["basis_color"], linear, rtol=0, atol=1e-6):
        raise AssertionError("the frozen basis colors are not the extracted palette taken "
                             "to linear space")

    data = NeRFDataset(Config(path=SCENE, bound=1.0, scale=0.8), type="val").collate(0)
    t0 = time.perf_counter()
    out = trainer.eval_step_full(data)
    eval_s = time.perf_counter() - t0
    img = data["images"]
    target = srgb_to_linear(torch.from_numpy(np.ascontiguousarray(img[..., :3]))).numpy()
    target_psnr = psnr(out["image"], target)
    gt = eval_gt(trainer.opt, img)
    for m in trainer.metrics:
        m.clear()
        m.update(out["image"][None], gt[None])
    meters = {m.name: m.measure() for m in trainer.metrics}
    log(f"bg + linear palette path: val view 0 ({eval_s:.2f} s/frame) PSNR {target_psnr:.3f} "
        f"dB against the training target (straight RGB, linear); the CLI's meters against the "
        f"gt on white (linear) {meters}")
    if not all(np.isfinite(v).all() for v in out.values()):
        raise AssertionError("non-finite palette render")
    if lpips_missing() and not math.isnan(meters["LPIPS (alex)"]):
        raise AssertionError("LPIPS reported a number without the lpips package")
    if not target_psnr > BG_LINEAR_PSNR_FLOOR:
        raise AssertionError(f"bg + linear palette validation PSNR {target_psnr:.3f} dB <= "
                             f"floor {BG_LINEAR_PSNR_FLOOR}")
    info = {"extract_s": extract_s, "P": P, "foreground_samples": stats["foreground_samples"],
            "steps_per_s": steps_per_s, "losses": losses, "val_psnr_target": target_psnr,
            "val_meters": meters, "eval_s": eval_s, "total_s": total_s, "peak_gib": peak_gb}
    del trainer
    torch.cuda.empty_cache()
    return launches, info


MEMORY_MARKER_BYTES = 6136 * 512  # a block no other call asks for: where a part's trace starts
MEMORY_TRACE_ENTRIES = 400_000      # allocator events kept per traced part


def _repo_frames(frames, depth: int = 4) -> str:
    """The innermost ``depth`` frames of an allocation that lie in this repository."""
    own = [f for f in frames if "palettenerf_torch" in f["filename"]
           or f["filename"].endswith("chip_smoke.py")]
    return " < ".join(f"{os.path.relpath(f['filename'], ROOT)}:{f['line']} {f['name']}"
                      for f in own[:depth])


def peak_allocations(trace, top: int = 6):
    """Replay the allocator's events of one traced part (``trace``: its device trace, from
    the marker block on): the largest sum of live blocks the part allocated, and those
    blocks at that moment, largest first, with the repository frames that asked for them."""
    marks = [i for i, e in enumerate(trace)
             if e["action"] == "alloc" and e["size"] == MEMORY_MARKER_BYTES]
    # without the marker the ring buffer has wrapped: its events are the part's last ones,
    # and blocks they free but did not allocate are left out
    start = 1 + marks[-1] if marks else 0

    def replay(stop):
        live, cur, best, at = {}, 0, 0, start
        for i in range(start, stop):
            e = trace[i]
            if e["action"] == "alloc":
                live[e["addr"]] = e
                cur += e["size"]
            elif e["action"] == "free_requested" and e["addr"] in live:
                cur -= live.pop(e["addr"])["size"]
            if cur > best:
                best, at = cur, i + 1
        return live, best, at

    _, best, at = replay(len(trace))
    live, _, _ = replay(at)
    blocks = sorted(live.values(), key=lambda e: -e["size"])[:top]
    return best, [{"MiB": e["size"] / 2 ** 20, "where": _repo_frames(e["frames"])}
                  for e in blocks]


class MemoryParts:
    """Peak device memory of the parts of a run, each above what was allocated when it
    began; for every part, the allocator's history (Python stacks) names the blocks live at
    its peak. ``wrap(cls, method, name, when)`` makes ``method`` one part while the context
    is open (``when(self)`` picks the calls that are traced); ``part(name)`` is one too."""

    def __init__(self, torch):
        self.torch, self.parts, self._patched, self._active = torch, [], [], False

    def part(self, name):
        torch = self.torch

        @contextlib.contextmanager
        def traced():
            if self._active:  # a part inside a part belongs to the outer one
                yield
                return
            self._active = True
            self.rows = 0
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.memory._record_memory_history(max_entries=MEMORY_TRACE_ENTRIES)
            marker = torch.empty(MEMORY_MARKER_BYTES, dtype=torch.uint8, device="cuda")
            del marker
            t0 = time.perf_counter()
            try:
                yield
            finally:
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                trace = torch.cuda.memory._snapshot()["device_traces"][0]
                torch.cuda.memory._record_memory_history(enabled=None)
                self._active = False
            rise, blocks = peak_allocations(trace)
            entry = {"part": name, "base_gib": base / 2 ** 30, "peak_gib": peak / 2 ** 30,
                     "traced_rise_gib": rise / 2 ** 30, "seconds": time.perf_counter() - t0,
                     "events": len(trace), "largest_batch_rows": self.rows,
                     "blocks_at_peak": blocks}
            self.parts.append(entry)
            log(f"memory, {name}: {base / 2 ** 30:.2f} GiB allocated before, peak "
                f"{peak / 2 ** 30:.2f} GiB (traced rise {rise / 2 ** 30:.2f} GiB over "
                f"{len(trace)} events; largest batch of {self.rows} points); blocks live at "
                f"the peak:\n" + "\n".join(
                    f"  {b['MiB']:10.1f} MiB  {b['where']}" for b in blocks))

        return traced()

    def count_rows(self, module, name, arg: int):
        """Keep the largest ``shape[0]`` of argument ``arg`` of ``module.name`` per part."""
        fn = getattr(module, name)
        parts = self

        def counted(*a, **kw):
            parts.rows = max(parts.rows, int(a[arg].shape[0]))
            return fn(*a, **kw)

        setattr(module, name, counted)
        self._patched.append((module, name, fn, True))

    def wrap(self, cls, method, name, when=lambda self: True):
        fn, own = getattr(cls, method), method in cls.__dict__
        parts = self

        def traced(obj, *a, **kw):
            if not when(obj):
                return fn(obj, *a, **kw)
            with parts.part(name):
                return fn(obj, *a, **kw)

        setattr(cls, method, traced)
        self._patched.append((cls, method, fn, own))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for owner, name, fn, own in reversed(self._patched):
            if own:
                setattr(owner, name, fn)
            else:  # inherited: drop the wrapper, the base class's method shows again
                delattr(owner, name)
        self._patched = []
        return False


def phase_real_scene(torch, dev, o_steps_per_s=None, trace_memory=False):
    """The Mip-NeRF 360 recipe on the LLFF-layout JPEG fixture ``data_proc/proc_toys_llff``
    at full width, through the CLIs: every image through the native JPEG decoder against
    ``decoded.json`` (ms per megapixel; the provider's load in seconds); stage 1 with
    ``-O --bound 2`` (two cascades) ``--no_bg --filter_close_point`` for 308 steps with the
    test tail and a 128^3 mesh (steps/s, each cascade's occupied cells, eval s/frame at
    333x250, val PSNR); B1 held and timed on the stream one step's real cotangents give it;
    the per-ray extraction (``--extract_palette`` without ``--extract_via_sweep``) with its
    time by phase; 308 palette steps with ``--datatype mip360`` and the test tail (val PSNR,
    peak memory). Returns (stage-1 launches, palette launches, the B1 stream's numbers,
    what was measured)."""
    import hashlib
    import shutil

    import numpy as np

    from palettenerf_torch import main_nerf, main_palette, native
    from palettenerf_torch.config import Config
    from palettenerf_torch.data.provider import NeRFDataset
    from palettenerf_torch.data.rays import gen_rays_torch
    from palettenerf_torch.models.nerf import param_list
    from palettenerf_torch.ops import scatter
    from palettenerf_torch.ops.occupancy import init_grid_state, mark_untrained_grid, packbits
    from palettenerf_torch.train.metrics import psnr

    res = {}
    # -------------------------------------------------------------- decode
    with open(os.path.join(LLFF_SCENE, "decoded.json")) as f:
        digests = json.load(f)["sha256"]
    blobs = {}
    for rel in digests:
        with open(os.path.join(LLFF_SCENE, rel), "rb") as f:
            blobs[rel] = f.read()
    native.IMAGE_LIBRARY.get()
    t0 = time.perf_counter()
    images = {rel: native.decode_jpeg(b, rel) for rel, b in blobs.items()}
    decode_s = time.perf_counter() - t0
    megapixels = sum(im.shape[0] * im.shape[1] for im in images.values()) / 1e6
    bad = [rel for rel, im in images.items()
           if hashlib.sha256(im.tobytes()).hexdigest() != digests[rel]]
    if bad or len(images) != 32:
        raise AssertionError(f"decoded images differ from decoded.json: {bad}")
    cfg = Config.from_args(main_nerf.build_parser().parse_args(REAL_NERF_ARGS))
    t0 = time.perf_counter()
    loaded = [NeRFDataset(cfg, type=split) for split in ("train", "val", "test")]
    res["provider_load_s"] = time.perf_counter() - t0
    res["decode_ms_per_mp"] = decode_s * 1e3 / megapixels
    n_views = len(loaded[0])
    log(f"real scene: {len(images)} JPEGs ({megapixels:.1f} MP) decoded in {decode_s:.3f} s, "
        f"{res['decode_ms_per_mp']:.2f} ms/MP, every digest equal to decoded.json; the "
        f"provider loads train/val/test ({n_views}/{len(loaded[1])}/{len(loaded[2])} views, "
        f"{loaded[0].W}x{loaded[0].H}) in {res['provider_load_s']:.2f} s")
    del loaded, images, blobs

    # -------------------------------------------------------------- stage 1 main path
    shutil.rmtree(os.path.join(ROOT, "results", "chip_smoke_real"), ignore_errors=True)
    shutil.rmtree(os.path.join(ROOT, "results_palette", "chip_smoke_real"), ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    trainer = main_nerf.main(REAL_NERF_ARGS, device=dev, mesh_resolution=REAL_MESH_RESOLUTION)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses, secs = trainer.stats["loss"], trainer.stats["epoch_seconds"]
    meters = {m.name: m.measure() for m in trainer.metrics}
    steps_per_s = n_views * (len(secs) - 1) / sum(secs[1:])
    bits = np.unpackbits(trainer.grid_state.bitfield.cpu().numpy(), bitorder="little")
    occupied = [int(v) for v in bits.reshape(trainer.grid_state.density_grid.shape[0], -1)
                .sum(1)]
    valid_ds = NeRFDataset(cfg, type="val")
    data = valid_ds.collate(0)
    trainer.eval_step_full(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = trainer.eval_step_full(data)
    eval_s = time.perf_counter() - t0
    val_psnr = psnr(out["image"], data["images"][..., :3])
    white_psnr = psnr(np.ones_like(out["image"]), data["images"][..., :3])
    res.update(steps_per_s=steps_per_s, white_frame_psnr=white_psnr, o_steps_per_s=o_steps_per_s, occupied_cells=occupied,
               eval_s=eval_s, val_psnr=val_psnr, test_meters=meters, stage1_total_s=total_s,
               stage1_peak_gib=peak_gb)
    log(f"real scene stage 1: {trainer.global_step} steps in {total_s:.1f} s with the test "
        f"tail and the {REAL_MESH_RESOLUTION}^3 mesh; epoch losses "
        f"{['%.5f' % v for v in losses]}; {steps_per_s:.2f} steps/s (epochs 2-{len(secs)}; "
        f"one-cascade -O path in this run: {o_steps_per_s}); occupied cells per cascade "
        f"{occupied} of {bits.size // len(occupied)}; eval {eval_s:.3f} s/frame "
        f"({data['W']}x{data['H']}); val PSNR {val_psnr:.3f} dB (an all-white frame "
        f"{white_psnr:.3f}); test meters {meters}; peak "
        f"memory {peak_gb:.2f} GiB; launches {launches}")
    if trainer.spec.bound != 2.0 or len(occupied) != 2 or not all(occupied):
        raise AssertionError(f"bound {trainer.spec.bound}, occupied cells {occupied}")
    if trainer.global_step != n_views * len(secs) or trainer.global_step < 300:
        raise AssertionError(f"{trainer.global_step} steps in {len(secs)} epochs")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"real-scene loss did not fall: {losses}")
    if launches["scatter_add"] != trainer.global_step:
        raise AssertionError(f"scatter_add launched {launches['scatter_add']} times in "
                             f"{trainer.global_step} steps")
    if not all(bool(torch.isfinite(p).all()) for p in param_list(trainer.params)) or \
            not all(np.isfinite(v).all() for v in out.values()):
        raise AssertionError("non-finite parameters or render")
    if out["image"].shape != (250, 333, 3):
        raise AssertionError(f"render shape {out['image'].shape}")
    if not val_psnr > REAL_PSNR_FLOOR:
        raise AssertionError(f"real-scene validation PSNR {val_psnr:.3f} dB <= floor "
                             f"{REAL_PSNR_FLOOR}")

    # how far the train step's 64 slots reach (median over the rays of one batch of view 0
    # of the last slot's t): through every cell the cameras see, as before the grid prunes,
    # and through the trained grid
    train_ds = NeRFDataset(cfg, type="train")
    seen = mark_untrained_grid(init_grid_state(len(occupied), cfg.grid_size, dev),
                               torch.as_tensor(train_ds.poses), train_ds.intrinsics, cfg.bound,
                               cfg.min_near, cfg.filter_close_point, cfg.grid_size)
    reach = {}
    for name, bitfield in (("seen cells", packbits(seen.density_grid.reshape(-1) >= 0)),
                           ("trained grid", trainer.grid_state.bitfield)):
        m, _, _ = march_train_batch(torch, trainer, train_ds, 5, bitfield=bitfield)
        reach[name] = float(m.ts.amax(1)[m.mask.any(1)].median())
    res.update(camera_distance=train_ds.radius, median_reach_t=reach)
    log(f"real scene: cameras {train_ds.radius:.3f} from the centre; the train step's "
        f"{cfg.train_samples_per_ray} slots reach t = {reach} (median; min_near {cfg.min_near})")

    # -------------------------------------------------------------- B1 on this stream
    # one more train step on 4096 pixels of training view 0, its scatter call kept: the
    # rows and bf16 cotangents of a two-cascade backward
    gen = torch.Generator(device=dev).manual_seed(9)
    inds = torch.randint(0, train_ds.H * train_ds.W, (cfg.num_rays,), generator=gen, device=dev)
    rays_o, rays_d = gen_rays_torch(torch.as_tensor(train_ds.poses[0]).to(dev),
                                    [float(v) for v in train_ds.intrinsics], train_ds.H,
                                    train_ds.W, inds)
    pixels = torch.as_tensor(train_ds.images[0]).to(dev).reshape(-1, 3)[inds]
    with last_scatter() as stream:
        trainer.train_step(rays_o, rays_d, pixels)
    torch.cuda.synchronize()
    # 16 levels x 2^19 rows at most: 6,328,848 rows at bound 2
    if stream["period"] != SCATTER_PERIOD:
        raise AssertionError(f"real-scene stream: period {stream['period']}")
    t = stream_numbers(torch, trainer.spec.grid, stream, "real-scene")
    del trainer, train_ds, stream

    # -------------------------------------------------------------- per-ray extraction
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    extractor = main_palette.main(REAL_EXTRACT_ARGS, device=dev)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    stats, timer = extractor.extract_stats, extractor.extract_timer
    pal_ws = extractor.workspace
    del extractor
    palette = np.load(os.path.join(pal_ws, "palette.npz"))["palette"]
    hist = np.load(os.path.join(pal_ws, "hist_weights.npz"))["hist_weights"]
    P = palette.shape[0]
    res.update(extract_s=extract_s, extract_split=dict(timer.totals), palette_size=P,
               foreground_samples=stats["foreground_samples"])
    log(f"real scene per-ray extraction: {extract_s:.1f} s (checkpoint and data load "
        f"included), P = {P}, {stats['foreground_samples']} foreground samples; by phase:\n"
        + timer.report())
    if "per-ray render" not in timer.totals or "bake" in timer.totals:
        raise AssertionError(f"extraction phases {list(timer.totals)}: not the per-ray route")
    if not 4 <= P <= 8 or palette.min() < 0.0 or palette.max() > 1.0:
        raise AssertionError(f"extracted palette: {P} colors in [{palette.min()}, "
                             f"{palette.max()}]")
    if hist.shape != (32, 32, 32, P) or hist.min() < -1e-12 \
            or np.abs(hist.sum(-1) - 1.0).max() > 1e-6:
        raise AssertionError(f"hist_weights {hist.shape}")

    # -------------------------------------------------------------- palette main path
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with MemoryParts(torch) as memory:
        if trace_memory:  # the palette run's peak, split: train, the CLI's test tail, eval
            from palettenerf_torch.render import palette_renderer
            from palettenerf_torch.train.palette_trainer import PaletteTrainer

            memory.count_rows(palette_renderer, "palette_forward", 2)
            memory.wrap(PaletteTrainer, "train_one_epoch", "palette train, epoch 2",
                        when=lambda tr: tr.epoch == 2)
            memory.wrap(PaletteTrainer, "evaluate_one_epoch",
                        "test tail: evaluate_one_epoch (test split)")
            memory.wrap(PaletteTrainer, "test", "test tail: test renders")
        window = LaunchWindow()   # the steps replay a CUDA graph; closes with the training
        t0 = time.perf_counter()
        trainer = main_palette.main(REAL_PALETTE_ARGS, device=dev)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        palette_launches = window.close()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        scatter.check_refused()
        losses, secs = trainer.stats["loss"], trainer.stats["epoch_seconds"]
        with memory.part("val view 0") if trace_memory else contextlib.nullcontext():
            out = trainer.eval_step_full(data)
    if trace_memory:
        res["palette_memory_parts"] = memory.parts
        peak_gb = max(p["peak_gib"] for p in memory.parts)  # each part resets the peak
    pal_psnr = psnr(out["image"], data["images"][..., :3])
    res.update(palette_steps_per_s=[n_views / s for s in secs], palette_val_psnr=pal_psnr,
               palette_peak_gib=peak_gb, palette_total_s=total_s)
    log(f"real scene palette: {trainer.global_step} steps in {total_s:.1f} s with the test "
        f"tail; epoch losses {['%.5f' % v for v in losses]}; steps/s per epoch "
        f"{['%.2f' % (n_views / s) for s in secs]}; val PSNR {pal_psnr:.3f} dB; peak memory "
        f"{peak_gb:.2f} GiB; launches {palette_launches}")
    if trainer.global_step < 300 or not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"real-scene palette: {trainer.global_step} steps, losses {losses}")
    if palette_launches["scatter_add"] < trainer.global_step:
        raise AssertionError(f"scatter_add launched {palette_launches['scatter_add']} times in "
                             f"{trainer.global_step} palette steps")
    if not all(np.isfinite(v).all() for v in out.values()):
        raise AssertionError("non-finite palette render")
    if not pal_psnr > REAL_PALETTE_PSNR_FLOOR:
        raise AssertionError(f"real-scene palette validation PSNR {pal_psnr:.3f} dB <= floor "
                             f"{REAL_PALETTE_PSNR_FLOOR}")
    return launches, palette_launches, t, res


# ---------------------------------------------------------------------- depth modes
# The recipes at their own depth (``--depth-only <mode>``), each run through the port's CLIs
# with the flags of its shell recipe taken verbatim: only --iters, EXTRA_FLAGS and the
# workspace are set (tests/test_torch_depth_flags.py parses the scripts and holds these
# lists to them).
PROC_TOYS = "./data_proc/proc_toys"  # configs_proc/proc_toys.sh: data_dir
LLFF_DATA = "./data_proc/proc_toys_llff"
DEPTH_ITERS = 8000                   # configs_proc/proc_toys.sh: iters


def blender_nerf_args(name, iters, extra=()):
    """``scripts/run_blender.sh -m nerf`` with ``configs_proc/proc_toys.sh``."""
    return [PROC_TOYS, "--workspace", name, "--iters", str(iters), "--bound", "1", "--offset",
            "0", "0", "0", "--scale", "0.8", "--bg_radius", "0", "--density_thresh", "10", "-O",
            "--dt_gamma", "0", *extra]


def blender_extract_args(nerf_model):
    """``scripts/run_blender.sh -m extract`` with ``configs_proc/proc_toys.sh``."""
    return [PROC_TOYS, nerf_model, "-O", "--bound", "1", "--scale", "0.8", "--bg_radius", "0",
            "--density_thresh", "10", "--extract_palette", "--use_normalized_palette"]


def blender_palette_args(nerf_model, iters, extra=()):
    """``scripts/run_blender.sh -m palette`` with ``configs_proc/proc_toys.sh``."""
    return [PROC_TOYS, nerf_model, "-O", "--iters", str(iters), "--bound", "1", "--scale",
            "0.8", "--offset", "0", "0", "0", "--bg_radius", "0", "--density_thresh", "10",
            "--random_size", "0", "--use_initialization_from_rgbxy", "--use_normalized_palette",
            "--dt_gamma", "0", "--datatype", "blender", *extra]


# chain: the README's profile (EXTRA_FLAGS="--fast_grad", README.md:442-445), and the
# extraction at --extract_downscale 2 as the README ran it (README.md:443; per-ray)
CHAIN_WS = "depth_chain"
CHAIN_NERF_ARGS = blender_nerf_args(CHAIN_WS, DEPTH_ITERS, ["--fast_grad"])
CHAIN_EXTRACT_ARGS = blender_extract_args(f"./results/{CHAIN_WS}") + ["--extract_downscale", "2"]
CHAIN_PALETTE_ARGS = blender_palette_args(f"./results/{CHAIN_WS}", DEPTH_ITERS, ["--fast_grad"])
# floors: the README's figures of the JAX package on the same scene (README.md:442-445, a
# TPU run of an earlier round) less 1.0 dB
CHAIN_FLOORS = {
    "stage1_val": 27.25 - 1.0,       # stage 1, 8k -O --fast_grad: val PSNR 27.25
    "palette_val": 27.66 - 1.0,      # palette, 8k: eval PSNR 27.66 on the EMA weights
    "sweep_vs_gt": 25.26 - 1.0,      # scripts/serve_vs_gt.py: sweep vs GT, mean of 8 views
    "exact_vs_gt": 28.06 - 1.0,      # exact vs GT (first two views)
    "sweep_vs_exact": 29.39 - 1.0,   # sweep vs exact (first two views)
}
README_PALETTE = (5, 6.6e6)          # README.md:443: 5 colours from 6.6M foreground samples
# the JAX package's stage-1 grid at step 8000 of this recipe: the frozen grid_state of the
# committed deploy export (deploy/proc_toys/palette_ep0080.ckpt), which its palette stage
# inherited
JAX_STAGE1_GRID = {"occupied_cells": 90_834, "mean_density": 4.4308724}
# deploy-ab: the chain's palette stage on that export's stage-1 half; a copy of the repo
# may leave deploy/ out, so the run copies deploy/proc_toys here (results/ is gitignored)
DEPLOY_COPY = os.path.join("results", "deploy_copy")
AB_WS = "depth_deploy_ab"
AB_PALETTE_ARGS = blender_palette_args(f"./results/{AB_WS}", DEPTH_ITERS, ["--fast_grad"])
# stage1: the chain's stage 1 at plain -O (exact trilinear gradients: held to the chain's
# stage-1 floor) and at -O2 (no JAX figure: scripts/run_ab30k.sh never finished)
STAGE1_RUNS = {"O": blender_nerf_args("depth_stage1_O", DEPTH_ITERS),
               "O2": blender_nerf_args("depth_stage1_O2", DEPTH_ITERS, ["-O2"])}
# bg: the default run's bg + patch flags at 8000 steps (its mesh at 128^3, as there)
BG_DEPTH_ARGS = [("depth_bg" if a == "chip_smoke_bg" else str(DEPTH_ITERS) if a == "300" else a)
                 for a in BG_PATCH_ARGS]
# mip360: run_mip360.sh with configs_mip360/bonsai.sh on the LLFF-layout fixture; the
# exploratory run is stage 1 alone at the most steps the choice of N may take
MIP360_WS = "depth_mip360"
MIP360_EXPLORE_ITERS = 20_000
# the exploratory run (NVIDIA H100 80GB HBM3, 700 W) never cleared the all-white frame: val 7.33-7.68
# dB from step 1400 to 20,020, flat from step 7000 on (7.63-7.68), the cells of both
# cascades near their 20k count by 8400. So N = 8400 (300 epochs), and no PSNR floor: a floor
# may not sit below the all-white frame's 7.59 + 5 dB (ROADMAP C16)
MIP360_ITERS = 8400
MIP360_MESH_RESOLUTION = REAL_MESH_RESOLUTION
WHITE_FRAME_PSNR = 7.59              # an all-white frame on the fixture's val view 0


# llff: run_llff.sh with configs_llff/fern.sh on the forward-facing fixture (no real LLFF
# scene is in the repository; scripts/make_ff_fixture.py), at fern's own iters
FF_DATA = "./data_proc/proc_toys_ff"
LLFF_WS = "depth_llff"
LLFF_ITERS = 10_000                  # configs_llff/fern.sh: iters


def llff_nerf_args(data_dir, name, iters, extra=()):
    """``scripts/run_llff.sh -m nerf`` with ``configs_llff/fern.sh``."""
    return [data_dir, "--workspace", name, "--iters", str(iters), "--bound", "2", "--offset",
            "0", "0", "1.5", "--scale", "0.25", "--bg_radius", "0", "--density_thresh", "10",
            "--lambda_sparse", "0.05", "--min_near", "0.02", "--no_bg", "-O", *extra]


def llff_extract_args(data_dir, nerf_model):
    """``scripts/run_llff.sh -m extract`` with ``configs_llff/fern.sh``: the per-ray
    extraction, and no ``--offset`` (the recipe's extract block passes none)."""
    return [data_dir, nerf_model, "-O", "--bound", "2", "--scale", "0.25", "--bg_radius", "0",
            "--density_thresh", "10", "--min_near", "0.02", "--extract_palette",
            "--use_normalized_palette"]


def llff_palette_args(data_dir, nerf_model, iters, extra=()):
    """``scripts/run_llff.sh -m palette`` with ``configs_llff/fern.sh``."""
    return [data_dir, nerf_model, "-O", "--iters", str(iters), "--bound", "2", "--scale",
            "0.25", "--offset", "0", "0", "1.5", "--bg_radius", "0", "--density_thresh", "10",
            "--min_near", "0.02", "--random_size", "0", "--use_initialization_from_rgbxy",
            "--use_normalized_palette", "--datatype", "llff", *extra]


def _clean(name):
    import shutil

    for top in ("results", "results_palette"):
        shutil.rmtree(os.path.join(ROOT, top, name), ignore_errors=True)


@contextlib.contextmanager
def eval_curve(extra=None):
    """Every ``evaluate_one_epoch`` of either trainer while open: model, split, epoch, step,
    PSNR (the CLI's meter), and ``extra(trainer)`` beside them; logged as it comes."""
    from palettenerf_torch.train.palette_trainer import PaletteTrainer
    from palettenerf_torch.train.trainer import Trainer

    curve, saved = [], [(cls, cls.__dict__["evaluate_one_epoch"])
                        for cls in (Trainer, PaletteTrainer)]

    def recorded(fn):
        def evaluate(self, ds, *a, **kw):
            t0 = time.perf_counter()
            result = fn(self, ds, *a, **kw)
            point = {"model": self.name, "split": ds.type, "views": len(ds),
                     "epoch": self.epoch, "step": self.global_step, "psnr": result,
                     "seconds": time.perf_counter() - t0}
            if extra is not None and self.name == "ngp":
                point.update(extra(self))
            curve.append(point)
            log(f"curve: {json.dumps(point, default=float)}")
            return result
        return evaluate

    for cls, fn in saved:
        setattr(cls, "evaluate_one_epoch", recorded(fn))
    try:
        yield curve
    finally:
        for cls, fn in saved:
            setattr(cls, "evaluate_one_epoch", fn)


def depth_stage1(torch, dev, argv, what, mesh_resolution=256, extra=None):
    """Stage 1 through ``main_nerf.main`` (training with the CLI's evals, its test tail and
    mesh), then the mean val PSNR of the last step's EMA field (the CLI's meter), B1 on the
    last step's update stream. Checks: every step launched B1 once, the loss fell, the
    parameters are finite. Returns (trainer, what was measured)."""
    import numpy as np

    from palettenerf_torch import main_nerf
    from palettenerf_torch.data.provider import NeRFDataset
    from palettenerf_torch.models.nerf import param_list

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with eval_curve(extra) as curve, last_scatter() as stream:
        zero_counts()
        t0 = time.perf_counter()
        trainer = main_nerf.main(argv, device=dev, mesh_resolution=mesh_resolution)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = read_counts()
        val = trainer.evaluate_one_epoch(NeRFDataset(trainer.opt, type="val"),
                                         save_images=False)
    secs, losses = trainer.stats["epoch_seconds"], trainer.stats["loss"]
    steps = trainer.global_step
    n_views = steps // len(secs)
    res = {"steps": steps, "total_s": total_s, "val_psnr": val, "curve": curve,
           "steps_per_s": n_views * (len(secs) - 1) / sum(secs[1:]),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses_every_10_epochs": losses[::10] + losses[-1:], "launches": launches}
    log(f"{what}: {steps} steps in {total_s:.1f} s with the CLI's evals, test tail and "
        f"{mesh_resolution}^3 mesh; {res['steps_per_s']:.2f} steps/s (epochs 2-{len(secs)}); "
        f"val PSNR at step {steps} {val:.3f} dB (mean of the val views); peak "
        f"{res['peak_gib']:.2f} GiB; launches {launches}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: the loss did not fall: {losses[0]} -> {losses[-1]}")
    if launches["scatter_add"] != steps or stream["calls"] != steps:
        raise AssertionError(f"{what}: scatter_add launched {launches['scatter_add']} times "
                             f"({stream['calls']} calls) in {steps} steps")
    if not all(bool(torch.isfinite(p).all()) for p in param_list(trainer.params)) \
            or not np.isfinite(val):
        raise AssertionError(f"{what}: non-finite parameters or val PSNR")
    res["stream"] = stream_numbers(torch, trainer.spec.grid, stream, f"{what} step {steps}")
    stream.clear()
    return trainer, res


def depth_extract(torch, dev, argv, what):
    """The extraction through ``main_palette.main`` (``--extract_palette``, the per-ray
    route): P within 4-8, the weights a partition of one. Returns what was measured."""
    import numpy as np

    from palettenerf_torch import main_palette

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    extractor = main_palette.main(argv, device=dev)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    stats, timer, ws = extractor.extract_stats, extractor.extract_timer, extractor.workspace
    del extractor
    palette = np.load(os.path.join(ws, "palette.npz"))["palette"]
    hist = np.load(os.path.join(ws, "hist_weights.npz"))["hist_weights"]
    P = palette.shape[0]
    log(f"{what} extraction: {extract_s:.1f} s, P = {P}, {stats['foreground_samples']} "
        f"foreground samples; by phase:\n" + timer.report())
    if "per-ray render" not in timer.totals:
        raise AssertionError(f"extraction phases {list(timer.totals)}: not the per-ray route")
    if not 4 <= P <= 8 or palette.min() < 0.0 or palette.max() > 1.0:
        raise AssertionError(f"extracted palette: {P} colors in [{palette.min()}, "
                             f"{palette.max()}]")
    # barycentric weights: a lattice point on a tetrahedron's face within find_simplex's
    # tolerance (1e-8) may take a weight just below 0
    low, off = float(hist.min()), float(np.abs(hist.sum(-1) - 1.0).max())
    if low < -1e-6 or off > 1e-6:
        raise AssertionError(f"hist_weights: min {low}, sums within {off} of 1")
    return {"extract_s": extract_s, "palette_size": P, "palette": palette.tolist(),
            "foreground_samples": stats["foreground_samples"], "split": dict(timer.totals)}


def depth_palette(torch, dev, argv, what):
    """The palette stage through ``main_palette.main`` (training with the CLI's evals and
    its test tail), then the mean val PSNR of the EMA weights (the CLI's meter). Checks:
    B1 launched on every step, the loss fell. Returns (trainer, what was measured)."""
    import numpy as np

    from palettenerf_torch import main_palette
    from palettenerf_torch.data.palette_provider import PaletteDataset
    from palettenerf_torch.ops import scatter

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with eval_curve() as curve:
        window = LaunchWindow(epochs=2)   # the steps replay a CUDA graph: the first 2 epochs
        t0 = time.perf_counter()
        trainer = main_palette.main(argv, device=dev)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = window.close()
        scatter.check_refused()
        val = trainer.evaluate_one_epoch(PaletteDataset(trainer.opt, type="val"),
                                         save_images=False)
    secs, losses = trainer.stats["epoch_seconds"], trainer.stats["loss"]
    steps = trainer.global_step
    n_views = steps // len(secs)
    res = {"steps": steps, "total_s": total_s, "val_psnr": val, "curve": curve,
           "steps_per_s_every_10_epochs": [n_views / s for s in secs[::10]],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses_every_10_epochs": losses[::10] + losses[-1:], "launches": launches}
    log(f"{what} palette: {steps} steps in {total_s:.1f} s with the CLI's evals and test "
        f"tail; steps/s every 10th epoch {['%.2f' % v for v in res['steps_per_s_every_10_epochs']]}; "
        f"val PSNR at step {steps} {val:.3f} dB (EMA weights, mean of the val views); peak "
        f"{res['peak_gib']:.2f} GiB; launches {launches}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{what} palette: the loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    if launches["scatter_add"] < window.steps or not window.steps or not np.isfinite(val):
        raise AssertionError(f"{what} palette: scatter_add launched {launches['scatter_add']} "
                             f"times in the {window.steps} steps of epochs 1-2; val {val}")
    return trainer, res


def _floor(value, floor, what):
    if not value > floor:
        raise AssertionError(f"{what}: {value:.3f} dB <= floor {floor}")


def chain_serve_trace(torch, dev, trainer, ws, served):
    """Where the serve figures' distance to the README's comes from: on test views 0-1 the
    CLI's own exact render (the EMA weights, the eval settings: 1024 candidates, 256 slots,
    no budget) against the image and against ``serve_vs_gt``'s exact frame (the raw
    weights, 512 candidates, 192 slots, a budget of 3/8, 48 group slots) and its dropped
    samples; the sweep at ``main_serve``'s settings (vd_bands 2, u_res 400); the occupied
    cells of the bitfield the bake is masked with."""
    import numpy as np

    from palettenerf_torch.data.palette_provider import PaletteDataset
    from palettenerf_torch.serve_vs_gt import psnr, serve_vs_gt
    from palettenerf_torch.train.trainer import eval_gt

    test_ds = PaletteDataset(trainer.opt, type="test")
    views = []
    for i, ex in enumerate(served.exact_frames):
        data = test_ds.collate(i)
        cli = trainer.eval_step_full(data)["image"]
        views.append({"cli_vs_gt": psnr(cli, eval_gt(trainer.opt, data["images"])),
                      "cli_vs_exact": psnr(cli, ex), "exact_vs_gt": served.exact_vs_gt[i],
                      "exact_dropped": served.exact_dropped[i]})
    sweep2 = serve_vs_gt(ws, PROC_TOYS, device=dev, vd_bands=2, u_res=400, n_exact=0,
                         verbose=False)
    bits = np.unpackbits(trainer.grid_state.bitfield.cpu().numpy(), bitorder="little")
    out = {"views": views, "sweep_vd2_u400_vs_gt": sweep2.means()["sweep_vs_gt"],
           "occupied_cells": int(bits.sum())}
    log("chain serve trace: " + json.dumps(out, default=float))
    return out


@contextlib.contextmanager
def bf16_matmul_operands(torch, grads: bool = False):
    """While open, every f32 ``matmul`` / ``mm`` / ``bmm`` / ``einsum`` / ``@`` that Python
    code calls takes its operands rounded to bf16, with the products and the sum in f32:
    what an f32 matmul at XLA's default precision computes on a TPU (one bf16 pass), where
    the README's JAX figures were trained. The backward's matmuls (autograd's, not Python's)
    take the rounded saved operands and the f32 gradient, and their results are rounded to
    bf16 on the way back through the rounding; with ``grads`` a product of two matrices (the
    MLPs' layers, the ray directions) rounds the gradient it is handed instead and returns
    f32 results, as the TPU's backward dots do. A diagnostic: the port computes these in
    f32."""
    def bf(a):
        return (a.to(torch.bfloat16).to(torch.float32)
                if torch.is_tensor(a) and a.dtype == torch.float32 else a)

    class Matmul(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b):
            a, b = bf(a), bf(b)
            ctx.save_for_backward(a, b)
            return a @ b

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensors
            g = bf(g)
            return g @ b.T, a.T @ g

    ops = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
           torch.Tensor.__rmatmul__, torch.mm, torch.Tensor.mm, torch.bmm, torch.Tensor.bmm,
           torch.einsum}

    class Mode(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func not in ops:
                return func(*args, **(kwargs or {}))
            if (grads and func is not torch.einsum and len(args) == 2 and not kwargs
                    and all(torch.is_tensor(a) and a.dtype == torch.float32 and a.dim() == 2
                            for a in args)):
                a, b = args if func is not torch.Tensor.__rmatmul__ else args[::-1]
                return Matmul.apply(a, b)
            args = tuple([bf(a) for a in a_] if isinstance(a_, (list, tuple)) else bf(a_)
                         for a_ in args)
            return func(*args, **(kwargs or {}))

    with Mode():
        yield


def grid_stats(trainer) -> dict:
    """The stage-1 occupancy grid: occupied cells of the bitfield, ``mean_density``, and
    the refreshes made (``iter_density``), with the JAX package's stage-1 grid beside them
    (``JAX_STAGE1_GRID``)."""
    import numpy as np

    gs = trainer.grid_state
    bits = np.unpackbits(gs.bitfield.cpu().numpy(), bitorder="little")
    out = {"occupied_cells": int(bits.sum()), "cells": int(bits.size),
           "mean_density": float(gs.mean_density), "refreshes": int(gs.iter_density),
           "jax": JAX_STAGE1_GRID}
    log("stage-1 grid: " + json.dumps(out, default=float))
    return out


def serve_figures(torch, dev, ws, **kw) -> tuple:
    """``serve_vs_gt`` on a palette workspace: (its result, its means with the seconds, the
    bake's and the exact frames' seconds, the dropped samples and the per-view PSNRs)."""
    from palettenerf_torch.serve_vs_gt import serve_vs_gt

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    served = serve_vs_gt(ws, PROC_TOYS, device=dev, **kw)
    serve = dict(served.means(), seconds=time.perf_counter() - t0, bake_s=served.bake_s,
                 exact_s=served.exact_s, exact_dropped=served.exact_dropped,
                 sweep_vs_gt_views=served.sweep_vs_gt, exact_vs_gt_views=served.exact_vs_gt,
                 sweep_vs_exact_views=served.sweep_vs_exact, **kw)
    return served, serve


def depth_chain(torch, dev, train_mode=contextlib.nullcontext):
    """``scripts/run_blender.sh`` with ``configs_proc/proc_toys.sh`` at 8000 + 8000 steps in
    the README's profile: stage 1 (with its grid's statistics), the extraction at
    ``--extract_downscale 2``, the palette stage, then ``serve_vs_gt`` on the palette
    workspace (and ``chain_serve_trace``, and the bake at 384^3); each figure held to the
    README's less 1.0 dB, all of them printed before any is held. The three training
    stages run inside ``train_mode()``, the serve figures outside it."""
    _clean(CHAIN_WS)
    with train_mode():
        trainer, stage1 = depth_stage1(torch, dev, CHAIN_NERF_ARGS, "chain stage 1")
    stage1["grid"] = grid_stats(trainer)
    del trainer
    with train_mode():
        extract = depth_extract(torch, dev, CHAIN_EXTRACT_ARGS, "chain")
    log(f"chain extraction: P = {extract['palette_size']} from "
        f"{extract['foreground_samples']} foreground samples (README.md:443: "
        f"{README_PALETTE[0]} from {README_PALETTE[1]:.3g})")
    with train_mode():
        trainer, palette = depth_palette(torch, dev, CHAIN_PALETTE_ARGS, "chain")
    ws = trainer.workspace
    served, serve = serve_figures(torch, dev, ws)
    trace = chain_serve_trace(torch, dev, trainer, ws, served)
    del trainer, served
    # is the field sharper than the 256^3 bake resolves? the same figures from a 384^3 bake
    _, serve384 = serve_figures(torch, dev, ws, resolution=384)
    log("chain serve at 384^3: " + json.dumps(serve384, default=float))
    got = {"stage1_val": stage1["val_psnr"], "palette_val": palette["val_psnr"],
           **{k: serve[k] for k in ("sweep_vs_gt", "exact_vs_gt", "sweep_vs_exact")}}
    log("chain: " + json.dumps({"got": got, "floors": CHAIN_FLOORS}, default=float))
    short = {k: v for k, v in got.items() if not v > CHAIN_FLOORS[k]}
    if short:
        raise AssertionError(f"chain: at or under the floor (README less 1.0 dB): {short}")
    return {"stage1": stage1, "extract": extract, "palette": palette, "serve": serve,
            "serve_trace": trace, "serve_384": serve384, "floors": CHAIN_FLOORS}


def depth_chain_bf16_matmul(torch, dev, grads=False):
    """The chain with the f32 matmuls of its three training stages at a TPU's default
    precision (``bf16_matmul_operands``; with ``grads`` the matrix products' gradients too),
    the serve figures in f32: whether the distance of the port's field to the README's
    comes from the TPU's matmul precision."""
    return depth_chain(torch, dev, train_mode=lambda: bf16_matmul_operands(torch, grads))


def depth_deploy_ab(torch, dev):
    """The chain's palette stage on the JAX package's stage-1 field: the density half
    (``encoder``, ``sigma_net``, ``color_net``) and the frozen grid of the committed deploy
    export, with the palette JAX extracted, as a stage-1 workspace; then 8000 palette steps
    with the chain's flags and ``serve_vs_gt``. A copy of the repo may leave ``deploy/`` out:
    copy ``deploy/proc_toys`` to ``DEPLOY_COPY`` (gitignored) for the run. Sweep-vs-exact
    near JAX's 29.39 dB puts the chain's shortfall on the port's stage-1 field, far under it
    on the palette stage. Diagnostic: the figures are printed beside the chain's floors,
    not held to them."""
    import shutil

    import numpy as np

    from palettenerf_torch.train import checkpoint as ckpt_lib

    src = os.path.join(ROOT, DEPLOY_COPY)
    ckpt = os.path.join(src, "palette_ep0080.ckpt")
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"{ckpt} not found: copy deploy/proc_toys there for the call")
    _clean(AB_WS)
    params, gs = ckpt_lib.load_palette_checkpoint(ckpt)
    nerf_ws = os.path.join(ROOT, "results", AB_WS, "version_1")
    ckpt_lib.save_reference_checkpoint(
        os.path.join(nerf_ws, "checkpoints", "ngp_ep0080.ckpt"),
        {k: params[k] for k in ("encoder", "sigma_net", "color_net")}, epoch=80,
        global_step=8000, grid_state=gs)
    pal_ws = os.path.join(ROOT, "results_palette", AB_WS, "normalized_version_1")
    os.makedirs(pal_ws)
    for name in ("palette.npz", "hist_weights.npz"):
        shutil.copy(os.path.join(src, name), pal_ws)
    bits = np.unpackbits(np.asarray(gs["bitfield"]), bitorder="little")
    grid = {"occupied_cells": int(bits.sum()), "mean_density": float(gs["mean_density"]),
            "refreshes": int(gs["iter_density"])}
    log("deploy A/B: JAX's stage-1 grid " + json.dumps(grid))
    trainer, palette = depth_palette(torch, dev, AB_PALETTE_ARGS, "deploy A/B")
    ws = trainer.workspace
    del trainer
    _, serve = serve_figures(torch, dev, ws)
    got = {"palette_val": palette["val_psnr"],
           **{k: serve[k] for k in ("sweep_vs_gt", "exact_vs_gt", "sweep_vs_exact")}}
    log("deploy A/B: " + json.dumps({"got": got, "chain_floors": CHAIN_FLOORS}, default=float))
    return {"jax_stage1_grid": grid, "palette": palette, "serve": serve}


def depth_stage1_mode(torch, dev):
    """The chain's stage 1 at plain ``-O`` (held to the chain's stage-1 floor) and at
    ``-O2`` (its curve and its gap to ``-O``), 8000 steps each, no palette."""
    out = {}
    for name, argv in STAGE1_RUNS.items():
        _clean(argv[argv.index("--workspace") + 1])
        trainer, out[name] = depth_stage1(torch, dev, argv, f"stage1 -{name}")
        del trainer
    out["O2_minus_O_db"] = out["O2"]["val_psnr"] - out["O"]["val_psnr"]
    log(f"stage1: val PSNR -O {out['O']['val_psnr']:.3f} dB, -O2 {out['O2']['val_psnr']:.3f} "
        f"dB ({out['O2_minus_O_db']:+.3f} dB)")
    _floor(out["O"]["val_psnr"], CHAIN_FLOORS["stage1_val"], "stage1 -O val PSNR")
    return out


def depth_bg(torch, dev):
    """The bg + patch stage 1 at 8000 steps (ROADMAP C11): the val views against the
    training target (the straight RGB) and against the CLI's target (the image on white),
    held to the 300-step floor against the target."""
    import numpy as np

    from palettenerf_torch.data.provider import NeRFDataset
    from palettenerf_torch.train.metrics import psnr

    _clean("depth_bg")
    trainer, out = depth_stage1(torch, dev, BG_DEPTH_ARGS, "bg + patch",
                                mesh_resolution=BG_MESH_RESOLUTION)
    target, white = [], []
    for data in NeRFDataset(trainer.opt, type="val").iter_epoch():
        img, pred = data["images"], trainer.eval_step_full(data)["image"]
        target.append(psnr(pred, img[..., :3]))
        white.append(psnr(pred, img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])))
    out.update(val_psnr_target=float(np.mean(target)), val_psnr_white=float(np.mean(white)),
               val_psnr_target_views=target)
    log(f"bg + patch at step {trainer.global_step}: val PSNR {out['val_psnr_target']:.3f} dB "
        f"against the training target, {out['val_psnr_white']:.3f} dB against the image on "
        f"white (the CLI's meter: {out['val_psnr']:.3f})")
    _floor(out["val_psnr_target"], BG_PATCH_PSNR_FLOOR, "bg + patch val PSNR (target)")
    return out


def _mip360_probe(torch, dev):
    """``extra`` of the mip360 curve: both cascades' occupied cells and the median t the
    train step's slots reach through the trained grid (view 0, 4096 rays)."""
    import numpy as np

    from palettenerf_torch.config import Config
    from palettenerf_torch.data.provider import NeRFDataset
    from palettenerf_torch.main_nerf import build_parser

    train_ds = NeRFDataset(Config.from_args(build_parser().parse_args(
        mip360_nerf_args(LLFF_DATA, MIP360_WS, 1))), type="train")

    def probe(trainer):
        gs = trainer.grid_state
        bits = np.unpackbits(gs.bitfield.cpu().numpy(), bitorder="little")
        m, _, _ = march_train_batch(torch, trainer, train_ds, 5)
        return {"occupied_cells": [int(v) for v in bits.reshape(gs.density_grid.shape[0], -1)
                                   .sum(1)],
                "median_reach_t": float(m.ts.amax(1)[m.mask.any(1)].median())}

    return probe


def depth_mip360_explore(torch, dev):
    """Stage 1 of the mip360 recipe alone at MIP360_EXPLORE_ITERS steps: the curve from
    which the full mode's step count is chosen."""
    _clean(MIP360_WS)
    trainer, out = depth_stage1(
        torch, dev, mip360_nerf_args(LLFF_DATA, MIP360_WS, MIP360_EXPLORE_ITERS),
        "mip360 stage 1 (exploratory)", MIP360_MESH_RESOLUTION, _mip360_probe(torch, dev))
    del trainer
    return out


def depth_mip360(torch, dev):
    """``scripts/run_mip360.sh`` with ``configs_mip360/bonsai.sh`` on the fixture at
    MIP360_ITERS steps: stage 1 with both cascades' cells and the march reach at every
    eval, B1 on the last step's (pruned) stream, the per-ray extraction, the palette."""
    _clean(MIP360_WS)
    trainer, stage1 = depth_stage1(
        torch, dev, mip360_nerf_args(LLFF_DATA, MIP360_WS, MIP360_ITERS), "mip360 stage 1",
        MIP360_MESH_RESOLUTION, _mip360_probe(torch, dev))
    del trainer
    nerf_model = f"./results/{MIP360_WS}"
    extract = depth_extract(torch, dev, mip360_extract_args(LLFF_DATA, nerf_model), "mip360")
    trainer, palette = depth_palette(
        torch, dev, mip360_palette_args(LLFF_DATA, nerf_model, MIP360_ITERS), "mip360")
    del trainer
    log(f"mip360: val PSNR stage 1 {stage1['val_psnr']:.3f} dB, palette "
        f"{palette['val_psnr']:.3f} dB (an all-white frame {WHITE_FRAME_PSNR}; no floor: "
        f"ROADMAP C16)")
    return {"stage1": stage1, "extract": extract, "palette": palette}


def cascade_stats(trainer) -> dict:
    """Each occupancy cascade's occupied cells (bitfield) and mean density over the cells
    the training cameras see (the marked ones, -1, left out), and the grid's
    ``mean_density``."""
    import numpy as np

    gs = trainer.grid_state
    grid = gs.density_grid.cpu().numpy()
    bits = np.unpackbits(gs.bitfield.cpu().numpy(), bitorder="little").reshape(grid.shape)
    return {"occupied_cells": [int(b.sum()) for b in bits],
            "mean_density": [float(g[g >= 0].mean()) if (g >= 0).any() else 0.0 for g in grid],
            "seen_cells": [int((g >= 0).sum()) for g in grid],
            "grid_mean_density": float(gs.mean_density), "refreshes": int(gs.iter_density)}


def frame_baselines(ds) -> dict:
    """PSNR against a split's images of two frames that need no field: the fixture's mean
    colour over its training views (a trivial field's best constant) and black."""
    import numpy as np

    from palettenerf_torch.data.provider import NeRFDataset
    from palettenerf_torch.train.metrics import psnr

    mean = NeRFDataset(ds.opt, type="train").images[..., :3].reshape(-1, 3).mean(0)
    imgs = ds.images[..., :3]
    return {"mean_colour": [float(v) for v in mean],
            "mean_colour_psnr": float(np.mean([psnr(np.broadcast_to(mean, i.shape), i)
                                               for i in imgs])),
            "black_psnr": float(np.mean([psnr(np.zeros_like(i), i) for i in imgs]))}


def split_psnr(trainer, cls, split) -> dict:
    """The CLI's meter on a split (the EMA weights), and the split's baseline frames."""
    ds = cls(trainer.opt, type=split)
    return dict(psnr=trainer.evaluate_one_epoch(ds, save_images=False), views=len(ds),
                **frame_baselines(ds))


def eval_seconds(torch, trainer, cls, frames: int = 3) -> float:
    """Seconds per exact eval frame of val view 0 (``eval_step_full``), after one warm-up
    frame, on the card's clock."""
    data = next(iter(cls(trainer.opt, type="val").iter_epoch()))
    trainer.eval_step_full(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        trainer.eval_step_full(data)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / frames


def frame_depths(trainer, cls, split, view: int = 0) -> dict:
    """Where a view's exact frame puts its opacity: quantiles of the composited distance
    from the camera (``depth_origin``) over the pixels the field makes opaque (weights sum
    > 0.5), and the share of them within 0.3 of the camera (the fixture's toys and
    backdrop lie 0.6-1.5 from its cameras; scripts/make_ff_fixture.py)."""
    import numpy as np

    ds = cls(trainer.opt, type=split)
    out = trainer.eval_step_full(ds.collate(view))
    d = out["depth_origin"][out["weights_sum"] > 0.5]
    q = np.quantile(d, [0.1, 0.5, 0.9]).tolist() if d.size else [None] * 3
    return {"split": split, "view": view, "opaque_share": float(d.size / out["depth_origin"].size),
            "depth_q10_q50_q90": q, "within_0.3": float((d < 0.3).mean()) if d.size else None}


def depth_llff(torch, dev):
    """``scripts/run_llff.sh`` with ``configs_llff/fern.sh`` on the forward-facing fixture,
    the flags verbatim: stage 1 at 10,000 steps with its test tail and 256^3 mesh (each
    cascade's cells and density at every eval, B1 on the last step's stream), the per-ray
    extraction without ``--offset`` as the recipe runs it, then 10,000 palette steps with
    the test tail. Val and test PSNR of both stages beside the fixture's mean-colour frame
    and the black frame, the training views' PSNR and where stage 1 puts its opacity, eval
    seconds per 504x378 frame. No quality floor: the recipe's field does not clear the
    mean-colour frame on this fixture (it hides each training view in a layer just before
    its camera; ROADMAP C22). The floors catch a broken path: every PSNR above the black
    frame's (a NaN or black frame fails)."""
    from palettenerf_torch.data.palette_provider import PaletteDataset
    from palettenerf_torch.data.provider import NeRFDataset

    _clean(LLFF_WS)
    trainer, stage1 = depth_stage1(torch, dev, llff_nerf_args(FF_DATA, LLFF_WS, LLFF_ITERS),
                                   "llff stage 1", extra=cascade_stats)
    stage1["grid"] = cascade_stats(trainer)
    stage1["val"] = split_psnr(trainer, NeRFDataset, "val")
    stage1["test"] = split_psnr(trainer, NeRFDataset, "test")
    # the training views themselves (full frames), and where the field puts its opacity
    stage1["train"] = split_psnr(trainer, NeRFDataset, "traintest")
    stage1["depths"] = [frame_depths(trainer, NeRFDataset, split) for split in ("val", "traintest")]
    stage1["eval_s_per_frame"] = eval_seconds(torch, trainer, NeRFDataset)
    log("llff stage 1: " + json.dumps({k: stage1[k] for k in (
        "grid", "val", "test", "train", "depths", "eval_s_per_frame")}, default=float))
    del trainer
    nerf_model = f"./results/{LLFF_WS}"
    extract = depth_extract(torch, dev, llff_extract_args(FF_DATA, nerf_model), "llff")
    trainer, palette = depth_palette(torch, dev, llff_palette_args(FF_DATA, nerf_model,
                                                                    LLFF_ITERS), "llff")
    palette["val"] = split_psnr(trainer, PaletteDataset, "val")
    palette["test"] = split_psnr(trainer, PaletteDataset, "test")
    palette["eval_s_per_frame"] = eval_seconds(torch, trainer, PaletteDataset)
    log("llff palette: " + json.dumps({k: palette[k] for k in (
        "val", "test", "eval_s_per_frame")}, default=float))
    del trainer
    for stage, res in (("stage 1", stage1), ("palette", palette)):
        for split in ("val", "test"):
            r = res[split]
            _floor(r["psnr"], r["black_psnr"], f"llff {stage} {split} PSNR (the black frame)")
    log(f"llff: stage 1 val {stage1['val']['psnr']:.3f} / test {stage1['test']['psnr']:.3f} dB, "
        f"palette val {palette['val']['psnr']:.3f} / test {palette['test']['psnr']:.3f} dB; the "
        f"mean-colour frame {stage1['val']['mean_colour_psnr']:.3f} / "
        f"{stage1['test']['mean_colour_psnr']:.3f} dB; P = {extract['palette_size']} from "
        f"{extract['foreground_samples']} foreground samples")
    return {"stage1": stage1, "extract": extract, "palette": palette}


DEPTH_MODES = {"chain": depth_chain, "mip360": depth_mip360, "llff": depth_llff,
               "mip360-explore": depth_mip360_explore, "stage1": depth_stage1_mode,
               "bg": depth_bg, "deploy-ab": depth_deploy_ab,
               "chain-bf16-matmul": depth_chain_bf16_matmul,
               "chain-bf16-matmul-grads": lambda torch, dev: depth_chain_bf16_matmul(
                   torch, dev, grads=True)}


USAGE = ("usage: python3 chip_smoke.py [--dp-only | --encode-only | --real-scene-only "
         "[--trace-memory] | --depth-only {" + ",".join(DEPTH_MODES) + "}]")


def parse_mode(args):
    """(mode, argument) of the command line, or None when it is not one of USAGE's."""
    if not args:
        return "all", None
    if args == ["--dp-only"]:
        return "dp", None
    if args == ["--encode-only"]:
        return "encode", None
    if args in (["--real-scene-only"], ["--real-scene-only", "--trace-memory"]):
        return "real", len(args) == 2
    if len(args) == 2 and args[0] == "--depth-only" and args[1] in DEPTH_MODES:
        return "depth", args[1]
    return None


def main() -> int:
    mode = parse_mode(sys.argv[1:])
    if mode is None:
        print(USAGE, file=sys.stderr)
        return 2
    mode, arg = mode
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
    os.chdir(ROOT)
    t_start = time.perf_counter()

    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    from concurrent.futures import ThreadPoolExecutor

    from palettenerf_torch import native
    from palettenerf_torch.ops import hashgrid_fast, scatter, window_gather

    t0 = time.perf_counter()
    libs = [scatter.LIBRARY, window_gather.LIBRARY, hashgrid_fast.LIBRARY, native.LIBRARY,
            native.IMAGE_LIBRARY]
    with ThreadPoolExecutor(len(libs)) as pool:  # one compiler per source, all at once
        for f in [pool.submit(lib.build) for lib in libs]:
            f.result()
    log(f"build: {', '.join(os.path.basename(lib.source) for lib in libs)} in "
        f"{time.perf_counter() - t0:.1f} s (in parallel; the host C++ with: "
        f"{' '.join(native.LIBRARY.build_command[:-1])})")
    for lib in libs[:3]:
        if lib.build_log:
            log(f"nvcc -Xptxas -v ({lib.name}):\n" + lib.build_log.strip())

    if mode == "encode":
        entry = phase_encode(torch, dev)
        log(f"encode phase passed in {time.perf_counter() - t_start:.1f} s")
        print(nvidia_smi())
        print(json.dumps({"kernels": [entry]}))
        return 0
    if mode == "dp":
        _, _, dp = phase_dp(torch, dev)
        log(f"data-parallel phase passed in {time.perf_counter() - t_start:.1f} s")
        print(nvidia_smi())
        print(json.dumps({"dp": dp}, default=float))
        return 0
    if mode == "real":
        _, _, stream, real = phase_real_scene(torch, dev, trace_memory=arg)
        log(f"real-scene phase passed in {time.perf_counter() - t_start:.1f} s")
        print(nvidia_smi())
        print(json.dumps({"real_scene": real, "real_scene_stream": stream}, default=float))
        return 0
    if mode == "depth":
        summary = DEPTH_MODES[arg](torch, dev)
        log(f"depth mode {arg} passed in {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"depth": arg, **summary}, default=float))
        print(nvidia_smi())
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    kernels = phase_kernels(torch, dev)
    encode_entry = phase_encode(torch, dev)
    wg_entry = phase_window_gather(torch, dev)
    phase_reference(torch, dev)
    train_launches, path_times, train_ds, stage1, o_psnr = phase_main_path(torch, dev)
    dp_launches, dp_stream_times, dp = phase_dp(torch, dev)
    compact_ref_err = phase_compaction_reference(torch, dev)
    compact_launches, compact_train, compact_stream = phase_compact_train(torch, dev, train_ds)
    compact_eval = phase_compact_eval(torch, dev)
    o2_ref_err = phase_o2_reference(torch, dev)
    o2_launches, o2 = phase_o2_main_path(torch, dev, train_ds, o_psnr)
    options_err = phase_options_reference(torch, dev)
    bg_launches, bg_patch, bg_stream = phase_bg_patch(torch, dev, train_ds)
    bg_palette_launches, bg_palette = phase_bg_linear_palette(torch, dev)
    phase_palette_reference(torch, dev)
    palette_launches, palette_ws, o_palette_psnr, extract_split = phase_palette(torch, dev,
                                                                                train_ds)
    n_views = len(train_ds)
    del train_ds
    phase_edit_reference(torch, dev)
    edit_launches = phase_edit(torch, dev, stage1)
    secs = stage1.stats["epoch_seconds"]
    o_steps_per_s = n_views * (len(secs) - 1) / sum(secs[1:])  # as the real-scene phase's
    del stage1
    compact_palette, compact_edit = phase_compact_palette(torch, dev)
    o2_palette_launches, o2_edit_launches, o2_palette = phase_o2_palette(
        torch, dev, o_palette_psnr, n_views)
    real_launches, real_palette_launches, real_stream, real = phase_real_scene(
        torch, dev, o_steps_per_s)
    for k in kernels:
        k["path"] = ("train, palette, edit, train-O2, palette-O2, edit-O2, train-compact, "
                     "train-bg-patch, palette-bg-linear")
        k["launches"] = train_launches[k["name"]]
        k["palette_launches"] = palette_launches[k["name"]]
        k["edit_launches"] = edit_launches[k["name"]]
        k["train_O2_launches"] = o2_launches[k["name"]]
        k["palette_O2_launches"] = o2_palette_launches[k["name"]]
        k["edit_O2_launches"] = o2_edit_launches[k["name"]]
        k.update(path_times)
        k["O2_reference_max_abs_err"] = o2_ref_err
        k["O2_stream"] = o2["streams"]["O2"]
        k["fast_grad_stream"] = o2["streams"]["fast_grad"]
        k["train_compact_launches"] = compact_launches[k["name"]]
        k["compact_stream"] = compact_stream
        k["bg_patch_launches"] = bg_launches[k["name"]]
        k["bg_patch_stream"] = bg_stream
        k["palette_bg_linear_launches"] = bg_palette_launches[k["name"]]
        k["dp_launches_per_rank"] = dp_launches[k["name"]]
        k["dp_stream"] = dp_stream_times
        k["path"] += ", train-dp"
        k["real_scene_launches"] = real_launches[k["name"]]
        k["palette_real_scene_launches"] = real_palette_launches[k["name"]]
        k["real_scene_stream"] = real_stream
        k["path"] += ", train-real-scene, palette-real-scene"
    wg_entry["dp_launches_per_rank"] = dp_launches[wg_entry["name"]]
    kernels.append(wg_entry)
    encode_entry.update(path="train, palette, edit", launches=train_launches["hashgrid_encode"],
                        palette_launches=palette_launches["hashgrid_encode"],
                        edit_launches=edit_launches["hashgrid_encode"])
    kernels.append(encode_entry)
    log("compaction summary: " + json.dumps({
        "reference_max_abs_err": compact_ref_err, "train": compact_train,
        "stage1_eval": compact_eval, "palette_eval": compact_palette, "edit": compact_edit}))
    log("-O2 summary: " + json.dumps({"train": {k: v for k, v in o2.items() if k != "streams"},
                                      "palette": o2_palette}))
    log("model options summary: " + json.dumps({"reference": options_err, "bg_patch": bg_patch,
                                                "palette_bg_linear": bg_palette}))
    log("data-parallel and extraction summary: " + json.dumps(
        {"dp": dp, "extraction": extract_split}, default=float))
    log("real-scene summary: " + json.dumps(real, default=float))
    phase_serve_reference(torch, dev)
    phase_serve(torch, dev, palette_ws)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
