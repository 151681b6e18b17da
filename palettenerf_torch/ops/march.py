"""Fixed-width occupancy-guided ray marching.

Port of ``palettenerf_tpu/ops/march.py``. Because the step
``dt = clamp(t*dt_gamma, dt_min, dt_max)`` depends only on ``t``, the reference marcher's
samples are a subsequence of a closed-form candidate sequence: all K candidates of a ray
are tested against the occupancy bitfield at once, and the first S occupied ones are
compacted into ``[N, S]`` slots with one ``topk`` on ``K - k`` (slot order == t order).

Two opt-in refinements, as in the JAX package:

- the hierarchical march (``--march_groups``, :93-290): one test of a dilated global
  supercell per group of 8 candidates, then the candidate tests of the first ``Sg``
  passing groups only (``build_super_bitfield``, ``_march_rays_hier``);
- the fine eval grid (``--eval_fine_grid``, :154-176): a finer baked bitfield
  (``ops.occupancy.bake_fine_bitfield``) ANDed into the test wherever the step cannot
  skip a fine cell (``_fine_occ_and``).

Cell indices are int64 throughout.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .occupancy import occ_lookup, packbits, unpackbits

SQRT3 = 1.7320508075688772


class MarchResult(NamedTuple):
    xyzs: torch.Tensor   # [N, S, 3] sample positions (clamped to the AABB)
    dts: torch.Tensor    # [N, S] integration step of each sample
    t_cum: torch.Tensor  # [N, S] cumulative real delta since t0 (for depth)
    ts: torch.Tensor     # [N, S] sample t values
    mask: torch.Tensor   # [N, S] bool, slot holds a real sample


def candidate_ts(t0: torch.Tensor, num: int, dt_min: float, dt_max: float,
                 dt_gamma: float) -> torch.Tensor:
    """Closed-form candidates of ``t += clamp(t*dt_gamma, dt_min, dt_max)``: [N] -> [N, num]."""
    k = torch.arange(num, dtype=torch.float32, device=t0.device)[None, :]
    t0 = t0[:, None]
    if dt_gamma <= 0:
        return t0 + k * dt_min
    g = dt_gamma
    t_a = dt_min / g
    t_b = dt_max / g
    n1 = torch.ceil((t_a - t0).clamp_min(0.0) / dt_min)
    t_s = t0 + n1 * dt_min
    log1pg = math.log1p(g)
    n2 = torch.ceil(torch.log((t_b / t_s).clamp_min(1.0)).clamp_min(0.0) / log1pg)
    t_e = t_s * torch.exp(n2 * log1pg)
    t_phase1 = t0 + k * dt_min
    t_phase2 = t_s * torch.exp((k - n1).clamp_min(0.0) * log1pg)
    t_phase3 = t_e + (k - n1 - n2).clamp_min(0.0) * dt_max
    return torch.where(k <= n1, t_phase1, torch.where(k <= n1 + n2, t_phase2, t_phase3))


def _float_exponent(x: torch.Tensor) -> torch.Tensor:
    """frexp exponent: x = m * 2^e with m in [0.5, 1), from the f32 bits."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits >> 23) & 0xFF) - 126


def mip_level(xyz: torch.Tensor, dt: torch.Tensor, grid_size: int, cascade: int) -> torch.Tensor:
    """max(mip_from_pos, mip_from_dt) (raymarching.cu:45-57), clamped to [0, CAS-1]."""
    e_pos = _float_exponent(xyz.abs().amax(-1))
    e_dt = _float_exponent(dt * grid_size * 0.5)
    return torch.maximum(e_pos, e_dt).clamp(0, cascade - 1)


SUPER_FACTOR = 4  # occupancy supercell = 4^3 fine cells


def packbits_u8(occ: torch.Tensor) -> torch.Tensor:
    """0/1 values [n*8] -> uint8 [n], little-endian bits (``occupancy.packbits``)."""
    return packbits(occ.reshape(-1) > 0)


def build_super_bitfield(bitfield: torch.Tensor, grid_size: int, cascade: int,
                         factor: int = SUPER_FACTOR) -> Optional[torch.Tensor]:
    """Dilated global coarse occupancy mip for the hierarchical march (:93-131).

    One [Hs^3] supergrid (Hs = H / factor) over the top cascade's frame: supercell
    (X, Y, Z) is set iff an occupied cell of ANY cascade intersects it or a 3^3
    neighbour. Cascade c's cells block-reduce into supercells by the ratio
    ``factor * 2^(cascade-1-c)`` and land in the centred sub-cube of that side. The
    dilation clamps at the edges (a max-pool padded with -inf). Returns uint8
    [Hs^3 // 8], or None when a cascade's grid is smaller than one supercell (callers
    gate on ``super_bitfield_ok``).
    """
    H = grid_size
    Hs = H // factor
    occ = unpackbits(bitfield).reshape(cascade, H, H, H)
    sup = torch.zeros((Hs, Hs, Hs), dtype=torch.uint8, device=bitfield.device)
    for c in range(cascade):
        r = factor * 2 ** (cascade - 1 - c)
        if r > H:
            return None
        side = H // r
        blk = occ[c].reshape(side, r, side, r, side, r).amax(dim=(1, 3, 5))
        o = (Hs - side) // 2
        view = sup[o:o + side, o:o + side, o:o + side]
        view.copy_(torch.maximum(view, blk))
    sup = F.max_pool3d(sup[None, None].float(), 3, stride=1, padding=1)[0, 0]
    return packbits_u8(sup)


def super_bitfield_ok(bound: float, grid_size: int, cascade: int,
                      factor: int = SUPER_FACTOR) -> bool:
    """Static soundness gate of the hierarchical march (:134-145): the supergrid's
    frame needs ``bound == 2^(cascade-1)``, and every cascade's ratio must fit the grid."""
    if cascade > 1 and abs(bound - 2 ** (cascade - 1)) > 1e-6:
        return False
    return factor * 2 ** (cascade - 1) <= grid_size


def _fine_occ_and(occ, fine_bitfield, fine_grid_size: int, xyz, dts, mip_bound, lvl,
                  cascade: int):
    """AND the fine bitfield's test into ``occ`` wherever ``dt <= 2 * mip_bound / F``
    (a step cannot skip a fine cell there); elsewhere the train grid's result stands
    (:154-176). ``mip_bound`` is a float or a tensor shaped like ``dts``."""
    Ff = fine_grid_size
    safe = dts <= 2.0 * mip_bound / Ff
    denom = mip_bound[..., None] if torch.is_tensor(mip_bound) else mip_bound
    cell = (0.5 * (xyz / denom + 1.0) * Ff).to(torch.int64).clamp(0, Ff - 1)
    flat = cell[..., 0] * (Ff * Ff) + cell[..., 1] * Ff + cell[..., 2]
    if cascade > 1:
        flat = lvl.to(torch.int64) * Ff ** 3 + flat
    return occ & (occ_lookup(fine_bitfield, flat) | ~safe)


def _compact_first(mask: torch.Tensor, num: int) -> tuple:
    """The first ``num`` set columns of each row of ``mask`` [N, K], in order: (slot
    mask [N, num], column [N, num] int64, 0 in empty slots). ``topk`` on ``K - k``; ties
    are all at 0, and only the values are read."""
    K = mask.shape[1]
    k_idx = torch.arange(K, dtype=torch.int32, device=mask.device)[None, :]
    score = torch.where(mask, K - k_idx, torch.zeros_like(k_idx))
    vals = torch.topk(score, min(num, K), dim=1).values   # descending => k ascending
    if num > K:  # fewer columns than slots: pad the slots
        vals = F.pad(vals, (0, num - K))
    slot = vals > 0
    return slot, torch.where(slot, K - vals, torch.zeros_like(vals)).to(torch.int64)


def _samples(rays_o, rays_d, t0, t_kept, dt_kept, slot, bound) -> MarchResult:
    """The MarchResult of the kept candidates' ``t_kept`` / ``dt_kept`` [N, S]; zeros in
    the slots ``slot`` leaves empty."""
    xyz_kept = (rays_o[:, None, :] + t_kept[..., None] * rays_d[:, None, :]).clamp(-bound, bound)
    zero = torch.zeros((), dtype=torch.float32, device=t_kept.device)
    return MarchResult(
        xyzs=torch.where(slot[..., None], xyz_kept, zero),
        dts=torch.where(slot, dt_kept, zero),
        t_cum=torch.where(slot, t_kept + dt_kept - t0[:, None], zero),
        ts=torch.where(slot, t_kept, zero),
        mask=slot,
    )


def _march_rays_hier(rays_o, rays_d, t0, fars, bitfield, sup_bitfield, bound: float,
                     H: int, K: int, S: int, dt_min: float, dt_max: float,
                     dt_gamma: float, cascade: int, g: int, Sg: int,
                     fine_bitfield=None, fine_grid_size: int = 0) -> MarchResult:
    """Two-phase hierarchical march (:179-290). Phase 1 tests one dilated supercell per
    group of ``g`` consecutive candidates at the group's midpoint and keeps the first
    ``Sg`` passing groups; phase 2 tests their ``Sg*g`` candidates as the flat march
    does (own mip level each). With ``dt_gamma > 0`` a group whose half-span exceeds a
    supercell is forced to pass (``safe``); at ``dt_gamma == 0`` the gate in
    ``march_rays`` checked the span, and the groups are closed-form. Equal to the flat
    march whenever at most ``Sg`` groups pass; valid samples of later groups are
    dropped otherwise."""
    N = rays_o.shape[0]
    dev = rays_o.device
    Hs = H // SUPER_FACTOR
    Kg = K // g
    H3 = H ** 3

    if dt_gamma > 0:
        ts_all = candidate_ts(t0, K, dt_min, dt_max, dt_gamma)           # [N, K]
        tg = ts_all.reshape(N, Kg, g)
        t_first, t_last = tg[:, :, 0], tg[:, :, -1]
        t_mid = 0.5 * (t_first + t_last)
    else:
        i_g = torch.arange(Kg, dtype=torch.float32, device=dev)[None, :]
        t_first = t0[:, None] + (i_g * g) * dt_min
        t_last = t_first + (g - 1) * dt_min
        t_mid = t_first + (g - 1) * 0.5 * dt_min

    # phase 1: group-midpoint supercell tests (global frame, all cascades)
    xyz_rep = (rays_o[:, None, :] + t_mid[..., None] * rays_d[:, None, :]).clamp(-bound, bound)
    cell_s = (0.5 * (xyz_rep / bound + 1.0) * Hs).to(torch.int64).clamp(0, Hs - 1)
    flat_s = cell_s[..., 0] * (Hs * Hs) + cell_s[..., 1] * Hs + cell_s[..., 2]
    gmask = occ_lookup(sup_bitfield, flat_s)
    if dt_gamma > 0:
        gmask = gmask | ~((t_last - t_first) * 0.5 <= 2.0 * bound / Hs)
    gmask = gmask & (t_first < fars[:, None])                              # [N, Kg]
    gslot, kept_g = _compact_first(gmask, Sg)                              # [N, Sg]

    # phase 2: candidate tests of the kept groups' members
    if dt_gamma > 0:
        t_f = torch.gather(tg, 1, kept_g[..., None].expand(N, Sg, g)).reshape(N, Sg * g)
        dt_f = (t_f * dt_gamma).clamp(dt_min, dt_max)
    else:
        j = torch.arange(g, dtype=torch.float32, device=dev)[None, None, :]
        t_f = (t0[:, None, None] + (kept_g.to(torch.float32)[..., None] * g + j) * dt_min
               ).reshape(N, Sg * g)
        dt_f = torch.full_like(t_f, dt_min)
    xyz = (rays_o[:, None, :] + t_f[..., None] * rays_d[:, None, :]).clamp(-bound, bound)
    if cascade > 1:
        lvl = mip_level(xyz, dt_f, H, cascade)
        mip_bound = torch.exp2(lvl.to(torch.float32)).clamp(max=bound)
        cell = (0.5 * (xyz / mip_bound[..., None] + 1.0) * H).to(torch.int64).clamp(0, H - 1)
        flat = lvl.to(torch.int64) * H3 + cell[..., 0] * (H * H) + cell[..., 1] * H + cell[..., 2]
    else:
        lvl, mip_bound = None, bound
        cell = (0.5 * (xyz / bound + 1.0) * H).to(torch.int64).clamp(0, H - 1)
        flat = cell[..., 0] * (H * H) + cell[..., 1] * H + cell[..., 2]
    occ = occ_lookup(bitfield, flat)
    if fine_bitfield is not None and fine_grid_size > 0:
        occ = _fine_occ_and(occ, fine_bitfield, fine_grid_size, xyz, dt_f, mip_bound, lvl,
                            cascade)
    fmask = occ & (t_f < fars[:, None]) & gslot.repeat_interleave(g, dim=1)

    # the first S samples of the kept candidates (t-ascending by construction)
    slot, kept = _compact_first(fmask, S)
    t_kept = torch.gather(t_f, 1, kept)
    dt_kept = ((t_kept * dt_gamma).clamp(dt_min, dt_max) if dt_gamma > 0
               else torch.full_like(t_kept, dt_min))
    return _samples(rays_o, rays_d, t0, t_kept, dt_kept, slot, bound)


def march_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    nears: torch.Tensor,
    fars: torch.Tensor,
    bitfield,
    bound: float,
    cascade: int,
    grid_size: int,
    dt_gamma: float,
    max_steps: int,
    num_samples: int,
    noise: Optional[torch.Tensor] = None,
    sup_bitfield: Optional[torch.Tensor] = None,
    max_groups: int = 0,
    fine_grid_size: int = 0,
) -> MarchResult:
    """Compact the first ``num_samples`` occupied candidates of each ray.

    ``noise`` [N] in [0, 1) jitters the start by that fraction of its step (train).
    ``sup_bitfield`` (``build_super_bitfield``) with ``max_groups > 0`` takes the
    hierarchical march where it is sound (the gate of :328-341). ``bitfield`` may be the
    pair ``(train_bits, fine_bits)`` of the fine eval grid with ``fine_grid_size``.
    """
    fine_bitfield = None
    if isinstance(bitfield, (tuple, list)):
        bitfield, fine_bitfield = bitfield
    H = grid_size
    H3 = H ** 3
    dt_min = 2.0 * SQRT3 / max_steps
    dt_max = 2.0 * SQRT3 * (2 ** (cascade - 1)) / H

    t0 = nears
    if noise is not None:
        t0 = t0 + (t0 * dt_gamma).clamp(dt_min, dt_max) * noise

    if (sup_bitfield is not None and max_groups > 0
            and super_bitfield_ok(bound, H, cascade)):
        g = 8
        # at dt_gamma == 0 the group's span is static: it must lie within the dilation
        if max_steps % g == 0 and (
                dt_gamma > 0 or (g - 1) * dt_min * 0.5 <= SUPER_FACTOR * 2.0 * bound / H):
            return _march_rays_hier(
                rays_o, rays_d, t0, fars, bitfield, sup_bitfield, bound, H, max_steps,
                num_samples, dt_min, dt_max, dt_gamma, cascade, g,
                min(max_groups, max_steps // g), fine_bitfield, fine_grid_size)

    ts = candidate_ts(t0, max_steps, dt_min, dt_max, dt_gamma)   # [N, K]
    dts = (ts * dt_gamma).clamp(dt_min, dt_max)
    in_range = ts < fars[:, None]

    xyz = (rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]).clamp(-bound, bound)
    lvl = mip_level(xyz, dts, H, cascade)
    mip_bound = torch.exp2(lvl.to(torch.float32)).clamp(max=bound)
    cell = (0.5 * (xyz / mip_bound[..., None] + 1.0) * H).to(torch.int64).clamp(0, H - 1)
    flat = lvl.to(torch.int64) * H3 + cell[..., 0] * (H * H) + cell[..., 1] * H + cell[..., 2]
    occ = occ_lookup(bitfield, flat)
    if fine_bitfield is not None and fine_grid_size > 0:
        occ = _fine_occ_and(occ, fine_bitfield, fine_grid_size, xyz, dts, mip_bound, lvl,
                            cascade)
    slot, kept = _compact_first(occ & in_range, num_samples)
    t_kept = torch.gather(ts, 1, kept)
    return _samples(rays_o, rays_d, t0, t_kept, (t_kept * dt_gamma).clamp(dt_min, dt_max),
                    slot, bound)
