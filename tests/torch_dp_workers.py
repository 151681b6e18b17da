"""Rank bodies of ``tests/test_torch_parallel.py``'s ray data-parallel runs.

Spawned ranks import the module of the function they run, so these live apart from the
test file: they import ``palettenerf_torch`` and never JAX (``tests/conftest.py``, which
the test file's process loads, imports JAX). Each body also runs in one process, outside
any rank, to give the single-process reference, and writes what it measured to
``out_dir/rank<r>.pt`` (``rank0.pt`` in one process). ``run_all`` runs several bodies
in one set of ranks, which start once.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np
import torch

from palettenerf_torch import parallel
from palettenerf_torch.config import Config
from palettenerf_torch.data.palette_provider import PaletteDataset
from palettenerf_torch.data.provider import NeRFDataset
from palettenerf_torch.models import nerf as tnerf
from palettenerf_torch.models import palette as tpal
from palettenerf_torch.models.mlp import param_leaves
from palettenerf_torch.ops.occupancy import packbits
from palettenerf_torch.render.nerf_renderer import RenderSettings, render_nerf_train
from palettenerf_torch.train.palette_trainer import PaletteTrainer
from palettenerf_torch.train.trainer import Trainer
from palettenerf_torch.utils import profiling

CPU_THREADS = 1  # as tests/torch_support.py: one intra-op thread (ROADMAP C8)


def _rank() -> int:
    g = parallel.group()
    return 0 if g is None else g.rank


def _save(out_dir: str, result: dict) -> None:
    torch.save(result, os.path.join(out_dir, f"rank{_rank()}.pt"))


def digest(tensors) -> str:
    """A hash of the tensors' bytes: equal on two ranks only if every bit is."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def sharded_grads(inputs_path: str, out_dir: str) -> None:
    """The gradient of tests/test_parallel.py's MSE loss (one-level field, all cells
    open, no jitter) on this rank's rays, summed over the ranks by ``reduce_grads``."""
    torch.set_num_threads(CPU_THREADS)
    inp = torch.load(inputs_path)
    spec = tnerf.NeRFSpec.build(bound=1.0, grid_levels=4, log2_hashmap_size=13)
    settings = RenderSettings(bound=1.0, cascade=1, grid_size=64, max_steps=64,
                              num_samples=16, min_near=0.05)
    bitfield = packbits(torch.ones(64 ** 3, dtype=torch.uint8))
    params = inp["params"]
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    g = parallel.group()
    shard = g.shard(inp["ro"].shape[0])
    ro, rd, gt = (shard.take(inp[k]) for k in ("ro", "rd", "gt"))
    out = render_nerf_train(params, spec, bitfield, ro, rd, settings,
                            bg_color=torch.ones(3), rays_gt=gt)
    loss = ((out["image"] - gt) ** 2).mean() / g.world
    loss.backward()
    total = g.reduce_grads(leaves, loss.detach()[None])
    _save(out_dir, {"loss": float(total[0]), "grads": [p.grad.clone() for p in leaves],
                    "loss_bytes": total.untyped_storage().nbytes()})


def train_sphere(scene: str, ws: str, out_dir: str, cfg_kw: dict, epochs: int) -> None:
    """``epochs`` epochs of the stage-1 trainer on the sphere scene (tests/
    test_trainer_dp_resume.py's configuration at a smaller table): the epoch losses, the
    first step's loss and digests of the parameters, the EMA and the bitfield."""
    torch.set_num_threads(CPU_THREADS)
    g = parallel.group()
    cfg = Config(path=scene, workspace=ws, n_devices=1 if g is None else g.world, **cfg_kw)
    ds = NeRFDataset(cfg, type="train")
    spec = tnerf.NeRFSpec.build(bound=cfg.bound, log2_hashmap_size=cfg.log2_hashmap_size,
                                grid_levels=cfg.grid_levels, fp16=cfg.fp16_enabled)
    tr = Trainer("ngp", cfg, spec, workspace=ws, use_checkpoint="scratch",
                 eval_interval=10_000, mute=True, device="cpu")
    first = []
    orig = tr._update

    def record(*a, **kw):  # the loss of each step as _update returns it
        loss = orig(*a, **kw)
        first.append(float(loss))
        return loss

    tr._update = record
    t0 = time.perf_counter()
    tr.train(ds, None, epochs)
    seconds = time.perf_counter() - t0
    frames = eval_frames(tr, NeRFDataset(cfg, type="val").collate(0))
    _save(out_dir, {"loss": tr.stats["loss"], "steps": first, "seconds": seconds,
                    "frames": frames,
                    "params": digest(param_leaves(tr.params)),
                    "ema": digest(param_leaves(tr.ema_params)),
                    "bitfield": digest([tr.grid_state.bitfield]),
                    "table": tr.params["encoder"].detach().clone(),
                    "global_step": tr.global_step,
                    "compact_overflow": tr.stats.get("compact_overflow")})


def eval_frames(tr, data) -> dict:
    """The eval frame of ``data`` by ``render_image`` in three chunks and in one (on two
    ranks, rank 1 then has no chunk of its own), gathered over the ranks, beside the same
    frame rendered by this process alone: {chunk: (whether every output is equal bit for
    bit, the dropped-sample counts of both, a digest of the frame)}."""
    n = len(data["rays_o"])
    out = {}
    for chunk in (n // 3 + 1, n):
        got = tr.render_image(data["rays_o"], data["rays_d"], chunk=chunk)
        dropped = tr.last_compact_overflow
        dp, tr.dp = tr.dp, None
        try:
            alone = tr.render_image(data["rays_o"], data["rays_d"], chunk=chunk)
        finally:
            tr.dp = dp
        equal = list(got) == list(alone) and all(np.array_equal(got[k], alone[k])
                                                 for k in alone)
        out[chunk] = (equal, (dropped, tr.last_compact_overflow),
                      digest([torch.from_numpy(got[k]) for k in sorted(got)]))
    return out


def palette_step(scene: str, ws: str, out_dir: str, cfg_kw: dict) -> None:
    """Two palette steps on ``--random_size`` batches with the patch-smooth term, the
    smooth loss, unfrozen colors and ``lambda_palette``: the losses and the parameters
    after them."""
    torch.set_num_threads(CPU_THREADS)
    g = parallel.group()
    cfg = Config(path=scene, workspace=ws, n_devices=1 if g is None else g.world, **cfg_kw)
    spec = tpal.PaletteSpec.build(bound=1.0, num_basis=4, grid_levels=4,
                                  log2_hashmap_size=13, fp16=True)
    tr = PaletteTrainer("palette", cfg, spec, workspace=ws, use_checkpoint="scratch",
                        nerf_path=None, mute=True, device="cpu")
    rng = np.random.default_rng(0)
    with torch.no_grad():   # lively tables, so that the field is not flat
        for name in ("encoder", "encoder_palette"):
            tr.params[name].copy_(torch.from_numpy(
                rng.uniform(-2, 2, tr.params[name].shape).astype(np.float32)))
    hist = rng.uniform(size=(32, 32, 32, 4)).astype(np.float32)
    tr.initialize_palette(np.array([[1.0, 0.2, 0.1], [0.1, 0.8, 0.0], [0.2, 0.3, 0.9],
                                    [0.8, 0.8, 0.2]], np.float32),
                          hist / hist.sum(-1, keepdims=True))
    tr.grid_state = tr.grid_state._replace(bitfield=torch.full_like(tr.grid_state.bitfield, 255))
    tr.freeze_basis_color, tr.require_smooth_loss = False, True
    tr.lambda_weight, tr.lambda_palette = 0.05, 1e-3
    ds = PaletteDataset(cfg, type="train")
    profiling.enable()   # the steps' counters (no device work of their own on the CPU)
    try:
        losses = [float(tr._batch_step(ds.collate(i))[0]) for i in range(2)]
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.enable(False)
        profiling.reset()
    _save(out_dir, {"loss": losses,
                    "params": {k: [t.detach().clone() for t in param_leaves({k: v})]
                               for k, v in tr.params.items()},
                    "digest": digest(param_leaves(tr.params) + param_leaves(tr.ema_params)),
                    "counters": counters})


def run_all(runs) -> None:
    """``runs``: (body name, its arguments) pairs, run in turn."""
    for name, args in runs:
        globals()[name](*args)


def fail_on_rank1() -> None:
    """Rank 1 raises; rank 0 waits at a collective that rank 1 never joins."""
    g = parallel.group()
    if g.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    g.all_reduce_(torch.ones(1))


def hang() -> None:
    while True:
        time.sleep(0.5)
