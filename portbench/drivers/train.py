"""The training path: whole epochs of a trainer of ``palettenerf_torch`` on the device-
sampled path (``Trainer.train_one_epoch``), each ending in the host read of its loss.

Set-up builds one trainer from the benchmark's seeded initial weights and draw source,
runs the traffic's warm epochs through the trainer's own ``train`` (which marks the
cells no camera sees, as at the start of every run) and hands that trainer to the
window. The benchmark's draw source keeps the draws of the first ``checked_steps``
steps; the program's loss of each, its first gradient (from Adam's first moment after
one step) and the parameters after them are read as the steps run. ``check`` replays
those steps in the plain reference from the same weights, draws and images.

No checkpoint is written: the trainer's ``save_checkpoint`` is switched off, so a run
writes nothing but the trainer's log lines.
"""

from __future__ import annotations

import dataclasses
import gc
import os
from typing import Optional

import torch

from portbench import compare, harness, inputs
from portbench.precision import tf32

WIDTH_FLAGS = {"num_levels": "--grid_levels", "level_dim": "--grid_level_dim",
               "log2_hashmap_size": "--log2_hashmap_size", "num_rays": "--num_rays",
               "train_samples_per_ray": "--train_samples_per_ray",
               "max_steps": "--max_steps"}


@dataclasses.dataclass
class State:
    ctx: harness.RunContext
    trainer: object
    dataset: object
    draws: inputs.Draws
    init: dict
    losses: list
    occupied: Optional[torch.Tensor] = None  # the seeded scene's occupancy
    first_epoch: int = 1                     # the epoch of the checked steps
    first_grads: Optional[dict] = None
    after: Optional[dict] = None


COMMON = ("grid_size", "density_thresh", "min_near", "lr", "iters", "dt_gamma",
          "update_extra_interval", "grid_update_warmup", "t_thresh_train")
PER_MODEL = {"ngp": ("lambda_sparse",),
             "palette": ("num_basis", "lambda_sparsity", "lambda_offsets", "lambda_view_dep",
                         "lambda_weight", "lambda_smooth", "lambda_palette", "pred_clip",
                         "smooth_sigma_xyz", "smooth_sigma_color", "lweight_decay_epoch",
                         "max_freeze_palette_epoch", "smooth_loss_start_epoch")}


def program_config(ctx: harness.RunContext):
    """The program's ``Config`` of the cell: the configuration's flags and widths on the
    traffic's scene, through the stage's own command-line parser."""
    from palettenerf_torch import main_nerf, main_palette
    from palettenerf_torch.config import Config

    c = ctx.config
    argv = [os.path.join(ctx.cell.root, ctx.traffic["data"])]
    if c["model"] == "palette":
        argv += ["none", "--num_basis", str(c["num_basis"])]
    argv += c["flags"]
    for key, flag in WIDTH_FLAGS.items():
        argv += [flag, str(c[key])]
    parser = (main_palette if c["model"] == "palette" else main_nerf).build_parser()
    cfg = Config.from_args(parser.parse_args(argv))
    for key in COMMON + PER_MODEL[c["model"]]:
        if getattr(cfg, key) != c[key]:
            raise ValueError(f"the program's {key} is {getattr(cfg, key)}, the "
                             f"configuration states {c[key]}")
    return cfg


def check_spec(spec, c: dict) -> None:
    """Raise where the program's model differs from the configuration's widths."""
    got = {"hidden_dim": spec.hidden_dim, "num_layers": spec.num_layers,
           "geo_feat_dim": spec.geo_feat_dim, "hidden_dim_color": spec.hidden_dim_color,
           "num_layers_color": spec.num_layers_color, "sh_degree": spec.sh_degree,
           "num_levels": spec.grid.num_levels, "level_dim": spec.grid.level_dim,
           "base_resolution": spec.grid.base_resolution,
           "log2_hashmap_size": spec.grid.log2_hashmap_size}
    bad = {k: (v, c[k]) for k, v in got.items() if v != c[k]}
    if bad:
        raise ValueError(f"the program's model departs from the configuration: {bad}")


def _ngp(ctx, cfg, gen):
    from palettenerf_torch.data.provider import NeRFDataset
    from palettenerf_torch.models.nerf import NeRFSpec
    from palettenerf_torch.train.trainer import Trainer

    spec = NeRFSpec.build(bound=cfg.bound, bg_radius=cfg.bg_radius,
                          log2_hashmap_size=cfg.log2_hashmap_size, grid_levels=cfg.grid_levels,
                          grid_level_dim=cfg.grid_level_dim, fp16=cfg.fp16_enabled)
    check_spec(spec, ctx.config)
    with ctx.span("data_load_s"):
        ds = NeRFDataset(cfg, type=ctx.traffic["split"])
    params = inputs.ngp_params(ctx.config, gen, ctx.device)
    tr = Trainer("ngp", cfg, spec, params=params, workspace=ctx.workdir,
                 use_checkpoint="scratch", mute=True, device=ctx.device)
    return tr, ds, params, None


def _palette(ctx, cfg, gen):
    """The palette trainer on the seeded scene's stage-1 field and occupancy, at the
    traffic's epoch of the recipe's schedule."""
    from palettenerf_torch.data.palette_provider import PaletteDataset
    from palettenerf_torch.models.palette import PaletteSpec
    from palettenerf_torch.ops.occupancy import GridState
    from palettenerf_torch.train.palette_trainer import PaletteTrainer

    c, dev = ctx.config, ctx.device
    spec = PaletteSpec.build(
        bound=cfg.bound, bg_radius=cfg.bg_radius, num_basis=cfg.num_basis,
        pred_clip=cfg.pred_clip, clip_dim=cfg.clip_dim, color_space=cfg.color_space,
        smooth_sigma_xyz=cfg.smooth_sigma_xyz, smooth_sigma_color=cfg.smooth_sigma_color,
        smooth_sigma_clip=cfg.smooth_sigma_clip, fp16=cfg.fp16_enabled,
        log2_hashmap_size=cfg.log2_hashmap_size, grid_levels=cfg.grid_levels,
        grid_level_dim=cfg.grid_level_dim)
    check_spec(spec, c)
    with ctx.span("data_load_s"):
        ds = PaletteDataset(cfg, type=ctx.traffic["split"])
    field, occupied = inputs.seeded_field(c, gen, dev)
    params = inputs.palette_params(c, field, gen, dev)
    tr = PaletteTrainer("palette", cfg, spec, params=params, workspace=ctx.workdir,
                        use_checkpoint="scratch", nerf_path=None, mute=True, device=dev)
    sigma = torch.where(occupied, torch.exp(torch.tensor(c["scene"]["density_bias"])), 0.0)
    tr.grid_state = GridState(density_grid=sigma[None].to(dev), bitfield=inputs.packbits(occupied),
                              mean_density=sigma.mean().to(dev),
                              iter_density=torch.zeros((), dtype=torch.int32, device=dev))
    tr.epoch = ctx.traffic["palette_epoch"]
    return tr, ds, params, occupied


def setup(ctx: harness.RunContext, plant=None) -> State:
    """``plant`` (a fault of ``portbench.control``) is applied to the state before the
    first step."""
    cfg = program_config(ctx)
    gen = inputs.generator(ctx.seed, ctx.device)
    tr, ds, params, occupied = (_palette if ctx.config["model"] == "palette" else _ngp)(
        ctx, cfg, gen)
    init = inputs.clone(params)
    del params
    tr.save_checkpoint = lambda best=False: None
    state = State(ctx=ctx, trainer=tr, dataset=ds, draws=None, init=init, losses=[],
                  occupied=occupied)
    steps = ctx.traffic["checked_steps"]
    state.draws = inputs.Draws(gen, record_steps=steps,
                               on_step=lambda k: _read_state(state, k, steps))
    program_step = tr.train_step

    def train_step(*a, **kw):  # keeps the loss of each checked step, on the device
        out = program_step(*a, **kw)
        if len(state.losses) < steps:
            state.losses.append(out[0].detach().clone())
        return out

    tr.train_step = train_step
    if plant is not None:
        plant(state)
    state.first_epoch = tr.epoch + 1
    with ctx.span("warm_s"):
        tr.train(ds, None, tr.epoch + ctx.traffic["warm_epochs"], draws=state.draws)
    if state.after is None:
        raise ValueError(f"the warm epochs ran fewer than {steps + 1} steps")
    return state


def _read_state(state: State, k: int, steps: int) -> None:
    """At the start of step ``k``: the first gradient after step 0, the parameters after
    the checked steps."""
    tr = state.trainer
    named = inputs.leaves(tr.params)
    if k == 1:
        b1 = tr.optimizer.param_groups[0]["betas"][0]
        moments = {n: tr.optimizer.state.get(p, {}).get("exp_avg") for n, p in named.items()}
        state.first_grads = {n: (torch.zeros_like(named[n]) if m is None else m / (1.0 - b1))
                             for n, m in moments.items()}
    if k == steps:
        state.after = {n: p.detach().clone() for n, p in named.items()}


def unit(state: State) -> int:
    """One epoch: the palette trainer's ``train`` applies its schedule around it; the
    stage-1 trainer's ``train`` would mark the untrained cells again, which a run does
    once, so its epoch is the body of that loop."""
    tr = state.trainer
    if state.ctx.config["model"] == "palette":
        tr.train(state.dataset, None, tr.epoch + 1, draws=state.draws)
    else:
        tr.epoch += 1
        tr.train_one_epoch(state.dataset, state.draws)
    return len(state.dataset)


RATE = {"ngp": "train_rays_per_s", "palette": "palette_rays_per_s"}


def end_to_end(state: State, window: harness.Window) -> dict:
    """Rays of every step in the window over its seconds, under a metric of the stage's
    own, so that each stage's rate is held to the bound of its own spread."""
    c = state.ctx.config
    return {RATE[c["model"]]: window.units * c["num_rays"] / window.seconds}


def replay(cell: harness.Cell, scene, init: dict, occupied, record: list, first_epoch: int,
           device) -> dict:
    """The plain reference's first ``checked_steps`` steps of the cell's epoch
    ``first_epoch`` from ``init`` with the recorded draws."""
    from portbench.reference import ngp, palette

    c, steps = cell.config, cell.traffic["checked_steps"]
    if c["model"] == "ngp":
        return ngp.replay(c, scene, init, record, steps, device)
    if first_epoch - 1 < c["smooth_loss_start_epoch"]:
        raise NotImplementedError("the reference replays the palette stage's smooth epochs")
    sched = {"lambda_weight": c["lambda_weight"] * max(
                 0.0, 1.0 - first_epoch / c["lweight_decay_epoch"]),
             "freeze_basis_color": first_epoch - 1 < c["max_freeze_palette_epoch"]}
    return palette.replay(c, sched, scene, occupied, init, record, steps, device)


def check(state: State) -> list:
    from portbench.reference.scene import Scene

    ctx, c = state.ctx, state.ctx.config
    start = inputs.leaves(state.init)
    prog = {"losses": [float(x) for x in state.losses],
            "grads": compare.norms(state.first_grads),
            "changes": compare.norms({k: v - start[k] for k, v in state.after.items()})}
    record = state.draws.record
    state.trainer = state.dataset = state.first_grads = state.after = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    scene = Scene(os.path.join(ctx.cell.root, ctx.traffic["data"]), ctx.traffic["split"],
                  c["scale"])
    ref = replay(ctx.cell, scene, state.init, state.occupied, record, state.first_epoch,
                 ctx.device)
    keys = ref["grads"].keys()  # the leaves that train
    gaps = compare.training_gaps(
        prog["losses"], ref["losses"], {k: prog["grads"][k] for k in keys},
        compare.norms(ref["grads"]), {k: prog["changes"][k] for k in keys},
        compare.norms(ref["changes"]))
    limits = ctx.traffic["limits"]
    return [harness.Check(k, v, limits[k]) for k, v in gaps.items()]


def train_inputs(cell: harness.Cell, scene, seed: int, device) -> tuple:
    """The cell's seeded weights (and occupancy) and the draws of its first checked steps,
    made as the driver makes them, the draws in the order the trainer asks for them: the
    epoch's order, the stage-1 refresh's jitter, then per step the pixels, the background,
    the march jitter and the palette stage's smooth-loss jitter."""
    c, steps = cell.config, cell.traffic["checked_steps"]
    gen = inputs.generator(seed, device)
    occupied = None
    if c["model"] == "palette":
        field, occupied = inputs.seeded_field(c, gen, device)
        params = inputs.palette_params(c, field, gen, device)
    else:
        params = inputs.ngp_params(c, gen, device)
    draws = inputs.Draws(gen, record_steps=steps)
    draws.order(len(scene.files))
    if c["model"] == "ngp":
        draws.refresh_noise((1, c["grid_size"] ** 3, 3))
    n = c["num_rays"]
    for _ in range(steps):
        draws.pixels(n, scene.H * scene.W)
        draws.background(n)
        draws.jitter(n)
        if c["model"] == "palette":
            draws.smooth_jitter(n * c["train_samples_per_ray"])
    return params, occupied, draws.record


def control(cell: harness.Cell, seed: int, device) -> dict:
    from portbench.reference.scene import Scene

    scene = Scene(os.path.join(cell.root, cell.traffic["data"]), cell.traffic["split"],
                  cell.config["scale"])
    params, occupied, record = train_inputs(cell, scene, seed, device)
    first = cell.traffic.get("palette_epoch", 0) + 1
    ref = replay(cell, scene, params, occupied, record, first, device)
    with tf32():
        low = replay(cell, scene, params, occupied, record, first, device)
    return compare.training_gaps(
        low["losses"], ref["losses"], compare.norms(low["grads"]), compare.norms(ref["grads"]),
        compare.norms(low["changes"]), compare.norms(ref["changes"]))


def _half_batch(state) -> None:
    """The step takes half of its rays: the loss is the mean over the other half."""
    tr = state.trainer
    step = tr.train_step

    def half(rays_o, rays_d, images, draws=None, **kw):
        n = rays_o.shape[0]
        bg, noise, h = draws.background(n), draws.jitter(n), n // 2
        if hasattr(tr, "palette_spec"):  # the smooth loss's jitter, drawn for every slot
            S = tr.train_settings.num_samples
            kw["jit_u"] = draws.smooth_jitter(n * S)[:h * S]
        return step(rays_o[:h], rays_d[:h], images[:h], bg=bg[:h], noise=noise[:h],
                    draws=draws, **kw)

    tr.train_step = half


def _frozen_state(state) -> None:
    """The optimizer's step leaves the parameters as they are."""
    state.trainer.optimizer.step = lambda *a, **kw: None


FAULTS = {"half_batch": _half_batch, "frozen_state": _frozen_state}
