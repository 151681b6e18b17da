"""The editor's baked view: ``render_sweep`` frames of a palette bake with a region edit
active, one user in a closed loop (each frame's image is copied to the host before the
next frame starts).

Set-up bakes the seeded palette field (``bake_palette``, ``mask_with_bitfield``,
``build_sweep_volume``; the span ``bake_s``) and renders the traffic's warm-up frames.
The window renders the orbit's poses in turn, a new pose each frame. The frames the
seed picks (every ``check_every``-th, from a seeded offset) are kept on the host and
``check`` renders them again with the plain reference from its own float32 bake.
"""

from __future__ import annotations

import dataclasses
import gc
import math
from typing import Dict

import numpy as np
import torch

from portbench import harness, inputs
from portbench.precision import fp8


@dataclasses.dataclass
class State:
    ctx: harness.RunContext
    sv: object
    basis: torch.Tensor
    edit: object
    edit_spec: dict
    params: dict
    occupied: torch.Tensor
    intr: tuple
    render: object = None  # the program's render_sweep
    shown: torch.Tensor = None  # the host's copy of the frame, in pinned memory
    frame: int = 0
    keep_from: int = 0
    kept: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)


def orbit_pose(t: dict, i: int) -> np.ndarray:
    """Pose ``i`` of the y-up orbit (the serve CLI's camera path without a dataset)."""
    ang = 2 * math.pi * i / t["orbit_frames"]
    eye = t["radius"] * np.array([np.sin(ang) * 0.92, 0.40, np.cos(ang) * 0.92])
    fwd = np.array([0.0, -0.1, 0.0]) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, np.cross(fwd, right), fwd, eye
    return pose


def edit_inputs(t: dict, c: dict, occupied: torch.Tensor, gen: torch.Generator) -> dict:
    """The region edit from the seed: a Gaussian of ``edit_std`` centred on an occupied
    cell, a hue shift in ``edit_hue`` degrees on one basis."""
    H = c["grid_size"]
    cells = occupied.nonzero()[:, 0]
    u = torch.rand(3, generator=gen, device=occupied.device).cpu()
    cell = int(cells[int(u[0] * len(cells))])
    b = min(1.0, float(c["bound"]))
    ijk = np.array([cell // (H * H), (cell // H) % H, cell % H], np.float32)
    centre = (2.0 * ijk / (H - 1) - 1.0) * (b - b / H)
    dhsv = np.zeros((c["num_basis"], 3), np.float32)
    dhsv[:, 1:] = 1.0
    lo, hi = t["edit_hue"]
    dhsv[int(u[1] * c["num_basis"]), 0] = lo + (hi - lo) * float(u[2])
    return {"mean": centre, "std": float(t["edit_std"]), "dhsv": dhsv}


def intrinsics(t: dict) -> tuple:
    f = 0.5 * t["H"] / math.tan(math.radians(t["fovy"]) / 2)
    return (f, f, t["W"] / 2, t["H"] / 2)


def scene_inputs(c: dict, t: dict, gen: torch.Generator, device) -> tuple:
    """The seeded palette field, its occupancy and the region edit, in the seed's order."""
    field, occupied = inputs.seeded_field(c, gen, device)
    params = inputs.palette_params(c, field, gen, device)
    return params, occupied, edit_inputs(t, c, occupied, gen)


def setup(ctx: harness.RunContext, plant=None) -> State:
    """``plant`` (a fault of ``FAULTS``) is applied before the first frame."""
    from palettenerf_torch.models.palette import PaletteSpec
    from palettenerf_torch.render.baking import bake_palette, mask_with_bitfield
    from palettenerf_torch.render.palette_renderer import make_region_edit
    from palettenerf_torch.render.sweep import build_sweep_volume, render_sweep

    c, t, dev = ctx.config, ctx.traffic, ctx.device
    gen = inputs.generator(ctx.seed, dev)
    params, occupied, e = scene_inputs(c, t, gen, dev)
    spec = PaletteSpec.build(bound=c["bound"], num_basis=c["num_basis"],
                             log2_hashmap_size=c["log2_hashmap_size"],
                             grid_levels=c["num_levels"], grid_level_dim=c["level_dim"])
    edit = make_region_edit(c["num_basis"], clip_dim=1, mean_xyz=e["mean"],
                            std_xyz=e["std"])._replace(delta_hsv=e["dhsv"])
    H = c["grid_size"]
    with ctx.span("bake_s"):
        baked = bake_palette(params, spec, resolution=t["resolution"], vd_bands=t["vd_bands"],
                             vd_dirs=t["vd_dirs"])
        baked = mask_with_bitfield(baked, {
            "bitfield": inputs.packbits(occupied).cpu().numpy(),
            "density_grid": np.zeros((1, H ** 3), np.float32)})
        sv = build_sweep_volume(baked, sigma_thresh=t["sigma_thresh"])
        del baked
    state = State(ctx=ctx, sv=sv, basis=params["basis_color"].clamp(0, 1), edit=edit,
                  edit_spec=e, params=params, occupied=occupied, intr=intrinsics(t),
                  render=render_sweep,
                  shown=torch.empty((t["H"], t["W"], 3), pin_memory=dev.type == "cuda"))
    if plant is not None:
        plant(state)
    with ctx.span("warm_s"):
        for _ in range(t["warm_frames"]):
            unit(state)
    state.keep_from = state.frame
    r = torch.randint(0, t["check_every"], (1,), generator=gen, device=dev)
    state.keep_from += int(r)
    return state


def unit(state: State) -> int:
    """One frame, its image on the host."""
    t = state.ctx.traffic
    out = state.render(state.sv, orbit_pose(t, state.frame), state.intr, t["H"], t["W"],
                       u_res=t["u_res"], basis_color=state.basis, edit=state.edit,
                       min_near=t["min_near"], t_thresh=t["t_thresh"])
    state.shown.copy_(out["image"])  # returns once the frame is on the host
    k = state.frame - state.keep_from
    if k >= 0 and k % t["check_every"] == 0 and len(state.kept) < t["check_frames"]:
        state.kept[state.frame] = state.shown.numpy().copy()
    state.frame += 1
    return 1


def end_to_end(state: State, window: harness.Window) -> dict:
    import sys

    lat = sorted(window.latencies)
    p95 = lat[min(len(lat) - 1, math.ceil(0.95 * len(lat)) - 1)]
    print(f"portbench: {len(lat)} frames in the window, the p95 over all of them; median "
          f"{1e3 * lat[len(lat) // 2]:.2f} ms, fastest {1e3 * lat[0]:.2f} ms", file=sys.stderr)
    return {"sweep_fps": window.units / window.seconds, "sweep_frame_p95_ms": 1e3 * p95}


def frame_gaps(state: State, low=None) -> list:
    """RMS gap of each kept frame to the reference's (``low``: the reference's own
    frames at a lower precision in place of the program's)."""
    from portbench.reference import bake, sweep

    c, t, dev = state.ctx.config, state.ctx.traffic, state.ctx.device
    vol = bake.bake(c, state.params, state.occupied, t["resolution"], t["vd_bands"],
                    t["vd_dirs"])
    e = {"mean": torch.as_tensor(state.edit_spec["mean"], device=dev),
         "std": state.edit_spec["std"], "dhsv": torch.as_tensor(state.edit_spec["dhsv"],
                                                                device=dev)}
    kw = dict(bound=float(c["bound"]), P=c["num_basis"], vd_bands=t["vd_bands"],
              basis=state.basis, edit=e, intr=state.intr, H=t["H"], W=t["W"], U=t["u_res"],
              min_near=t["min_near"], t_thresh=t["t_thresh"])
    gaps = []
    for i, image in sorted(state.kept.items()):
        ref = sweep.render(vol, pose=orbit_pose(t, i), **kw)
        if low is not None:
            image = sweep.render(low(vol), pose=orbit_pose(t, i), low=low, **kw).cpu().numpy()
        gaps.append(float(np.sqrt(np.mean((image - ref.cpu().numpy()) ** 2))))
    return gaps


def check(state: State) -> list:
    state.sv = None
    gc.collect()
    if state.ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    if not state.kept:
        raise ValueError("the window kept no frame to check")
    gap = max(frame_gaps(state))
    return [harness.Check("frame_rmse", gap, state.ctx.traffic["limits"]["frame_rmse"])]


def control(cell: harness.Cell, seed: int, device) -> dict:
    """The reference with its volume and every per-sample colour rounded to float8 against
    the reference, on the first frames of the orbit."""
    c, t = cell.config, cell.traffic
    ctx = harness.RunContext(cell=cell, seed=seed, seconds=0.0, trace=False, device=device,
                             t0=0.0)
    params, occupied, e = scene_inputs(c, t, inputs.generator(seed, device), device)
    state = State(ctx=ctx, sv=None, basis=params["basis_color"].clamp(0, 1), edit=None,
                  edit_spec=e, params=params, occupied=occupied, intr=intrinsics(t),
                  kept={i * t["check_every"]: None for i in range(t["check_frames"])})
    return {"frame_rmse": max(frame_gaps(state, low=fp8))}


def _altered_answer(state: State) -> None:
    """Each frame's red channel comes out scaled by 0.9."""
    render = state.render

    def altered(*a, **kw):
        out = render(*a, **kw)
        out["image"][..., 0] *= 0.9
        return out

    state.render = altered


FAULTS = {"altered_answer": _altered_answer}
