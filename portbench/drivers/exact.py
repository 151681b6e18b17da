"""Validation and test renders: ``Trainer.eval_step_full`` exact frames (the flat path,
with the trainer's alive-ray rounds and its chunks of 16,384 rays, white background) of
the seeded scene's stage-1 field, each returned to the host.

Set-up builds the trainer on the seeded field and occupancy and renders the traffic's
warm-up frames. The window renders the split's views in turn. The frames the seed picks
are kept on the host; ``check`` renders seeded chunks of them again with the plain
reference.
"""

from __future__ import annotations

import dataclasses
import gc
import os
from typing import Dict

import numpy as np
import torch

from portbench import harness, inputs
from portbench.drivers import train
from portbench.precision import tf32


@dataclasses.dataclass
class State:
    ctx: harness.RunContext
    trainer: object
    dataset: object
    params: dict
    occupied: torch.Tensor
    frame: int = 0
    keep_from: int = 0
    kept: Dict[int, dict] = dataclasses.field(default_factory=dict)


def setup(ctx: harness.RunContext, plant=None) -> State:
    """``plant`` (a fault of ``FAULTS``) is applied before the first frame."""
    from palettenerf_torch.data.provider import NeRFDataset
    from palettenerf_torch.models.nerf import NeRFSpec
    from palettenerf_torch.ops.occupancy import GridState
    from palettenerf_torch.train.trainer import Trainer

    c, t, dev = ctx.config, ctx.traffic, ctx.device
    cfg = train.program_config(ctx)
    spec = NeRFSpec.build(bound=cfg.bound, bg_radius=cfg.bg_radius,
                          log2_hashmap_size=cfg.log2_hashmap_size, grid_levels=cfg.grid_levels,
                          grid_level_dim=cfg.grid_level_dim, fp16=cfg.fp16_enabled)
    train.check_spec(spec, c)
    if (cfg.infer_samples_per_ray, cfg.t_thresh_infer) != (t["samples"], t["t_thresh"]):
        raise ValueError("the program's eval march departs from the traffic's")
    gen = inputs.generator(ctx.seed, dev)
    params, occupied = inputs.seeded_field(c, gen, dev)
    ds = NeRFDataset(cfg, type=t["split"])
    tr = Trainer("ngp", cfg, spec, params=params, workspace=ctx.workdir,
                 use_checkpoint="scratch", mute=True, device=dev)
    if tr.eval_settings.compaction_rounds != tuple(tuple(r) for r in t["rounds"]):
        raise ValueError(f"the program's rounds {tr.eval_settings.compaction_rounds} depart "
                         f"from the traffic's {t['rounds']}")
    sigma = torch.where(occupied, torch.exp(torch.tensor(c["scene"]["density_bias"])), 0.0)
    tr.grid_state = GridState(density_grid=sigma[None].to(dev), bitfield=inputs.packbits(occupied),
                              mean_density=sigma.mean().to(dev),
                              iter_density=torch.zeros((), dtype=torch.int32, device=dev))
    state = State(ctx=ctx, trainer=tr, dataset=ds, params=params, occupied=occupied)
    if plant is not None:
        plant(state)
    with ctx.span("warm_s"):
        for _ in range(t["warm_frames"]):
            unit(state)
    r = torch.randint(0, t["check_every"], (1,), generator=gen, device=dev)
    state.keep_from = state.frame + int(r)
    return state


def unit(state: State) -> int:
    """One frame of the next view, returned to the host as the eval returns it."""
    t = state.ctx.traffic
    ds = state.dataset
    view = state.frame % len(ds.poses)
    out = state.trainer.eval_step_full(ds.collate(view))
    k = state.frame - state.keep_from
    if k >= 0 and k % t["check_every"] == 0 and len(state.kept) < t["check_frames"]:
        state.kept[state.frame] = {key: out[key] for key in ("image", "depth", "weights_sum")}
    state.frame += 1
    return 1


def end_to_end(state: State, window: harness.Window) -> dict:
    return {"exact_frame_s": window.seconds / window.units}


def frame_gaps(state: State, gen: torch.Generator, precision=None) -> Dict[str, float]:
    """The 99th percentile of the absolute gaps of image, depth and weights over seeded
    chunks of the kept frames, the worst frame's; ``precision`` (a context) runs the
    reference a second time under it, in the program's place.

    Not the RMS gap: the program makes a view's rays on the host in NumPy and the
    reference on the card, 1.8e-7 apart in direction, and a ray that grazes an occupied
    cell then marches through it on one side and not on the other (a few rays in 640,000,
    up to 0.12 in colour), which decides an RMS gap over a sample of chunks alone."""
    from portbench.reference import exact
    from portbench.reference.scene import Scene

    c, t, dev = state.ctx.config, state.ctx.traffic, state.ctx.device
    scene = Scene(os.path.join(state.ctx.cell.root, t["data"]), t["split"], c["scale"])
    H, W, chunk = scene.H, scene.W, t["chunk"]
    n_chunks = -(-H * W // chunk)
    gaps = {"image_p99": [], "depth_p99": [], "weights_p99": []}
    kw = dict(chunk=chunk, samples=t["samples"], rounds=t["rounds"], t_thresh=t["t_thresh"])
    for i, out in sorted(state.kept.items()):
        view = i % len(scene.poses)
        pick = torch.randperm(n_chunks - 1, generator=gen, device=dev)[:t["check_chunks"] - 1]
        chunks = sorted(int(k) for k in pick) + [n_chunks - 1]  # the padded chunk too
        o, d = scene.rays(view, torch.arange(H * W, device=dev))
        ref = exact.render(c, state.params, state.occupied, o, d, chunks, **kw)
        if precision is not None:
            with precision():
                low = exact.render(c, state.params, state.occupied, o, d, chunks, **kw)
            got = {k: v.cpu().numpy() for k, v in low.items()}
        else:
            rows = np.concatenate([np.arange(k * chunk, min((k + 1) * chunk, H * W))
                                   for k in chunks])
            got = {k: v.reshape(H * W, -1)[rows].reshape(len(rows), *v.shape[2:])
                   for k, v in out.items()}
        for key, name in (("image", "image_p99"), ("depth", "depth_p99"),
                          ("weights_sum", "weights_p99")):
            diff = np.abs(got[key] - ref[key].cpu().numpy())
            gaps[name].append(float(np.percentile(diff, 99)))
    return {k: max(v) for k, v in gaps.items()}


def check(state: State) -> list:
    state.trainer = state.dataset = None
    gc.collect()
    if state.ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    if not state.kept:
        raise ValueError("the window kept no frame to check")
    gen = inputs.generator(state.ctx.seed + 1, state.ctx.device)
    limits = state.ctx.traffic["limits"]
    return [harness.Check(k, v, limits[k]) for k, v in frame_gaps(state, gen).items()]


def control(cell: harness.Cell, seed: int, device) -> dict:
    """The reference with TF32 matmuls against the reference, on seeded chunks of the
    frames a run of ``seed`` would keep first."""
    ctx = harness.RunContext(cell=cell, seed=seed, seconds=0.0, trace=False, device=device,
                             t0=0.0)
    params, occupied = inputs.seeded_field(cell.config, inputs.generator(seed, device), device)
    state = State(ctx=ctx, trainer=None, dataset=None, params=params, occupied=occupied,
                  kept={i: None for i in range(cell.traffic["check_frames"])})
    return frame_gaps(state, inputs.generator(seed + 1, device), precision=tf32)


def _altered_answer(state: State) -> None:
    """Each frame's red channel comes out scaled by 0.9."""
    tr = state.trainer
    step = tr.eval_step_full

    def altered(*a, **kw):
        out = step(*a, **kw)
        out["image"][..., 0] *= 0.9
        return out

    tr.eval_step_full = altered


FAULTS = {"altered_answer": _altered_answer}
