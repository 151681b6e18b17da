"""Occupancy grid: density EMA state, bit packing, refresh and frustum culling.

Port of ``palettenerf_tpu/ops/occupancy.py`` (reference ``nerf/renderer.py:90-103,
395-561`` and ``raymarching.cu:271-303``). Linear cell layout
``index = cas*H^3 + x*H^2 + y*H + z`` and linear bit order, as in the JAX package.
The refresh jitter is an optional ``noise`` argument so tests can pass in the JAX draw.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class GridState(NamedTuple):
    density_grid: torch.Tensor   # [CAS, H^3] f32; -1 marks untrained cells
    bitfield: torch.Tensor       # [CAS*H^3//8] uint8, linear bit order
    mean_density: torch.Tensor   # scalar f32
    iter_density: torch.Tensor   # scalar int32


def init_grid_state(cascade: int, grid_size: int = 128, device="cpu") -> GridState:
    H3 = grid_size ** 3
    return GridState(
        density_grid=torch.zeros((cascade, H3), dtype=torch.float32, device=device),
        bitfield=torch.zeros((cascade * H3 // 8,), dtype=torch.uint8, device=device),
        mean_density=torch.zeros((), dtype=torch.float32, device=device),
        iter_density=torch.zeros((), dtype=torch.int32, device=device),
    )


def packbits(occ: torch.Tensor) -> torch.Tensor:
    """bool [CAS*H^3] -> uint8 [CAS*H^3//8]; bit i of byte b = cell b*8+i."""
    bits = occ.reshape(-1, 8).to(torch.int32)
    weights = 2 ** torch.arange(8, dtype=torch.int32, device=occ.device)
    return (bits * weights).sum(-1).to(torch.uint8)


def unpackbits(bitfield: torch.Tensor) -> torch.Tensor:
    """uint8 [n] -> uint8 0/1 [n*8], the inverse of ``packbits``."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bitfield.device)
    return ((bitfield[:, None] >> shifts) & 1).reshape(-1)


def occ_lookup(bitfield: torch.Tensor, cell_index: torch.Tensor) -> torch.Tensor:
    """Test occupancy bits for flat cell indices [...] -> bool [...]."""
    byte = bitfield[cell_index >> 3].to(torch.int32)
    return ((byte >> (cell_index & 7).to(torch.int32)) & 1) > 0


def cell_world_coords(cascade: int, grid_size: int, bound: float, device="cpu"):
    """Per-cascade world-space cell centers: xyz [CAS, H^3, 3], half_grid_size [CAS]
    (nerf/renderer.py:493-500)."""
    H = grid_size
    r = torch.arange(H, dtype=torch.float32, device=device)
    gx, gy, gz = torch.meshgrid(r, r, r, indexing="ij")
    unit = torch.stack([gx, gy, gz], -1).reshape(-1, 3)
    unit = 2.0 * unit / (H - 1) - 1.0
    xyzs, hgs = [], []
    for cas in range(cascade):
        b = min(2.0 ** cas, bound)
        half = b / H
        xyzs.append(unit * (b - half))
        hgs.append(half)
    return torch.stack(xyzs), torch.tensor(hgs, dtype=torch.float32, device=device)


@torch.no_grad()
def update_density_grid(
    state: GridState,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    bound: float,
    density_thresh: float,
    density_scale: float = 1.0,
    decay: float = 0.95,
    grid_size: int = 128,
    partial_fraction: int = 1,
    slab_index: int = 0,
    *,
    noise: torch.Tensor,
) -> GridState:
    """One density-grid refresh: EMA ``max(old*decay, new)`` on trained cells, then
    repack at ``min(mean_density, density_thresh)`` (nerf/renderer.py:485-553).

    ``partial_fraction > 1`` refreshes only the rotating slab ``slab_index`` of
    1/fraction of the cells. ``noise`` [CAS, cells, 3] in [-1, 1] is the jitter within
    each refreshed cell (the trainer's ``Draws.refresh_noise``).
    """
    cascade = state.density_grid.shape[0]
    device = state.density_grid.device
    H3 = grid_size ** 3
    xyz, half = cell_world_coords(cascade, grid_size, bound, device)
    if partial_fraction > 1:
        q = H3 // partial_fraction
        start = (slab_index % partial_fraction) * q
        xyz = xyz[:, start:start + q]
    pts = xyz + noise * half[:, None, None]
    tmp = (density_fn(pts.reshape(-1, 3)).reshape(cascade, -1) * density_scale).float()

    old = state.density_grid
    if partial_fraction <= 1:
        new_grid = torch.where(old >= 0, torch.maximum(old * decay, tmp), old)
    else:
        old_slab = old[:, start:start + q]
        new_grid = old.clone()
        new_grid[:, start:start + q] = torch.where(
            old_slab >= 0, torch.maximum(old_slab * decay, tmp), old_slab)
    mean_density = new_grid.clamp_min(0.0).mean()
    thresh = torch.clamp(mean_density, max=density_thresh)
    bitfield = packbits((new_grid > thresh).reshape(-1))
    return GridState(new_grid, bitfield, mean_density, state.iter_density + 1)


def _fine_cell_centres(F: int, b: float, start: int, stop: int, device) -> torch.Tensor:
    """Centres [stop-start, 3] of the fine cells ``start:stop`` (flat ``x*F^2 + y*F + z``)
    of a cascade whose box is ``b``: ``cell_world_coords``' values, for a slice only."""
    i = torch.arange(start, stop, dtype=torch.int64, device=device)
    unit = torch.stack([i // (F * F), (i // F) % F, i % F], -1).to(torch.float32)
    unit = 2.0 * unit / (F - 1) - 1.0
    return unit * (b - b / F)


@torch.no_grad()
def bake_fine_bitfield(
    state: GridState,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    bound: float,
    density_thresh: float,
    fine_size: int = 256,
    grid_size: int = 128,
    density_scale: float = 1.0,
    chunk: int = 1 << 19,
) -> torch.Tensor:
    """Bake a finer eval-time occupancy bitfield from the trained field (JAX
    ``ops/occupancy.py:138-213``), on the state's device, without a host round trip.

    - the threshold ``min(mean_density, density_thresh)`` of the refresh, applied to the
      density at the centres of the ``fine_size``^3 cells of each cascade, queried
      ``chunk`` points at a time;
    - a 3^3 dilation with zeroed borders (a max-pool over the 0/1 volume padded with
      zeros, which is what JAX's rolls with zeroed wrap-around give);
    - ANDed with the train bitfield upsampled to the fine grid, so the fine grid only
      refines: every cell the train grid culls stays culled.

    Returns uint8 [CAS * F^3 // 8] in the marcher's linear bit order, for
    ``march_rays(..., bitfield=(train_bits, fine_bits), fine_grid_size=F)``.
    """
    cascade = state.density_grid.shape[0]
    device = state.density_grid.device
    F_ = fine_size
    if F_ % grid_size:
        raise ValueError(f"fine grid {F_} is not a multiple of the train grid {grid_size}")
    rep = F_ // grid_size
    thresh = torch.clamp(state.mean_density, max=density_thresh)
    coarse = unpackbits(state.bitfield).reshape(cascade, grid_size, grid_size, grid_size)
    n = F_ ** 3
    out = []
    for cas in range(cascade):
        b = min(2.0 ** cas, bound)
        occ = torch.empty((n,), dtype=torch.float32, device=device)
        for s in range(0, n, chunk):
            pts = _fine_cell_centres(F_, b, s, min(s + chunk, n), device)
            occ[s:s + pts.shape[0]] = (density_fn(pts) * density_scale > thresh).float()
        occ = torch.nn.functional.max_pool3d(occ.reshape(1, 1, F_, F_, F_), 3, stride=1,
                                             padding=1).reshape(F_, F_, F_) > 0
        up = coarse[cas].bool()
        for ax in range(3):
            up = up.repeat_interleave(rep, dim=ax)
        out.append(packbits((occ & up).reshape(-1)))
    return torch.cat(out)


@torch.no_grad()
def mark_untrained_grid(
    state: GridState,
    poses: torch.Tensor,     # [B, 4, 4] c2w
    intrinsics,              # (fx, fy, cx, cy)
    bound: float,
    min_near: float = 0.2,
    filter_close_point: bool = False,
    grid_size: int = 128,
) -> GridState:
    """Mark cells that no training camera sees (or sees closer than ``min_near``)
    with density -1 (nerf/renderer.py:395-465)."""
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    cascade = state.density_grid.shape[0]
    device = state.density_grid.device
    xyz, half = cell_world_coords(cascade, grid_size, bound, device)
    poses = poses.to(device=device, dtype=torch.float32)
    rot, trans = poses[:, :3, :3], poses[:, :3, 3]
    counts, closes = [], []
    for cas in range(cascade):
        # world -> camera: (xyz - t) @ R for c2w poses (:443-444)
        cam = (torch.einsum("nc,bcd->bnd", xyz[cas], rot)
               - torch.einsum("bc,bcd->bd", trans, rot)[:, None, :])
        hgs = half[cas]
        mz = cam[..., 2] > 0
        mx = cam[..., 0].abs() < cx / fx * cam[..., 2] + hgs * 2
        my = cam[..., 1].abs() < cy / fy * cam[..., 2] + hgs * 2
        seen = mz & mx & my
        close = (seen & (cam[..., 2] < min_near)).sum(0)
        if filter_close_point:
            close = close + (torch.linalg.norm(cam, dim=-1) < min_near).sum(0)
        counts.append(seen.sum(0))
        closes.append(close)
    covered = torch.stack(counts) * (torch.stack(closes) == 0)
    grid = torch.where(covered == 0, torch.full_like(state.density_grid, -1.0),
                       state.density_grid)
    return state._replace(density_grid=grid)
