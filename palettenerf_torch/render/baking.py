"""Baking: sample a trained field into dense feature volumes for serving.

Port of ``palettenerf_tpu/render/baking.py``. The hash-grid MLP field is evaluated once
on the dense ``linspace(-bound, bound, R)^3`` voxel grid, on the device, producing

- ``density``  [R, R, R]        (sigma)
- ``diffuse``  [R, R, R, 3]     (view-independent color)
- palette extras for a PaletteNeRF: ``omega`` [R^3, P], ``offsets`` [R^3, 3P],
  ``radiance`` [R^3], so the palette blend stays editable at render time;
- ``view_sh`` [R^3, 3B]: per-voxel SH coefficients (B = vd_bands^2) of the
  view-dependent color, least-squares fitted over ``vd_dirs`` directions;
- ``clip_feat`` [R^3, clip_dim] when the model predicts clip features.

``mask_with_bitfield`` zeroes density in occupancy cells the trained marcher never
sampled. ``render_baked`` is the golden per-ray renderer over a bake (uniform samples,
trilinear fetches), against which the sweep renderer (``render/sweep.py``) is checked.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.composite import composite_rays
from ..ops.rays import near_far_from_aabb
from ..ops.sh import sh_encode


class BakedVolume(NamedTuple):
    resolution: int
    bound: float
    density: torch.Tensor               # [R, R, R]
    diffuse: torch.Tensor               # [R, R, R, 3]
    omega: Optional[torch.Tensor]       # [R, R, R, P] or None (plain NeRF bake)
    offsets: Optional[torch.Tensor]     # [R, R, R, 3P], per-basis interleaved rgb
    radiance: Optional[torch.Tensor]    # [R, R, R]
    # channel-major [.., 3B]: [r coeffs | g coeffs | b coeffs], B = vd_bands^2
    view_sh: Optional[torch.Tensor] = None
    vd_bands: int = 0
    clip_feat: Optional[torch.Tensor] = None  # [R, R, R, clip_dim]


def _fibonacci_dirs(n: int) -> np.ndarray:
    """n roughly-uniform unit directions (spherical Fibonacci lattice)."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(phi)], -1).astype(np.float32)


def _sh_fit(dirs: np.ndarray, bands: int) -> np.ndarray:
    """Least-squares SH projection weights W [B, Nd]: coeffs = W @ samples."""
    Y = sh_encode(torch.from_numpy(dirs), bands).numpy()    # [Nd, B]
    return np.linalg.pinv(Y).astype(np.float32)


def _bake_grid(bound: float, resolution: int, chunk: int, eval_chunk, device):
    """Evaluate ``eval_chunk(x[m, 3]) -> tuple of [m, ...]`` over the dense R^3 voxel grid
    (row-major, z fastest). Chunk coordinates are generated on the device from an
    index range and results stay there; returns a tuple of [R^3, ...] tensors."""
    R = resolution
    n = R ** 3
    lin = torch.linspace(-bound, bound, R, dtype=torch.float32, device=device)
    outs = None
    with torch.no_grad():
        for start in range(0, n, chunk):
            idx = torch.arange(start, min(start + chunk, n), device=device)
            x = torch.stack([lin[idx // (R * R)], lin[(idx // R) % R], lin[idx % R]], -1)
            res = eval_chunk(x)
            if outs is None:
                outs = tuple(torch.empty((n,) + r.shape[1:], dtype=r.dtype, device=device)
                             for r in res)
            for o, r in zip(outs, res):
                o[start:start + r.shape[0]] = r
    return outs


def _view_sh_coeffs(view_dep_fn, W: torch.Tensor, dirs: torch.Tensor, m: int) -> torch.Tensor:
    """SH coefficients [m, 3B] of ``view_dep_fn(d [m, 3]) -> [m, 3]`` over ``dirs``."""
    vd = torch.stack([view_dep_fn(d.expand(m, 3)) for d in dirs])   # [Nd, m, 3]
    return torch.einsum("bn,nmc->mcb", W, vd).reshape(m, -1)


def bake_nerf(params, spec, resolution: int = 256, chunk: int = 131072,
              vd_bands: int = 0, vd_dirs: int = 32) -> BakedVolume:
    """Bake a stage-1 NeRF: density + diffuse color (queried at a fixed canonical
    direction) and, when ``vd_bands > 0``, per-voxel SH coefficients of the full
    view-dependent color minus the canonical diffuse."""
    from ..models.nerf import nerf_color, nerf_density

    dev = params["encoder"].device
    d_canon = torch.tensor([0.0, 0.0, 1.0], device=dev)
    B = vd_bands * vd_bands
    if vd_bands:
        dirs = _fibonacci_dirs(vd_dirs)
        W = torch.from_numpy(_sh_fit(dirs, vd_bands)).to(dev)
        dirs_t = torch.from_numpy(dirs).to(dev)

    def eval_chunk(x):
        dens = nerf_density(params, spec, x)
        geo = dens["geo_feat"]
        diffuse = nerf_color(params, spec, d_canon.expand(x.shape[0], 3), geo)
        out = (dens["sigma"], diffuse)
        if vd_bands:
            out += (_view_sh_coeffs(lambda d: nerf_color(params, spec, d, geo) - diffuse,
                                    W, dirs_t, x.shape[0]),)
        return out

    outs = _bake_grid(spec.bound, resolution, chunk, eval_chunk, dev)
    R = resolution
    return BakedVolume(R, spec.bound, outs[0].reshape(R, R, R),
                       outs[1].reshape(R, R, R, 3), None, None, None,
                       view_sh=outs[2].reshape(R, R, R, 3 * B) if vd_bands else None,
                       vd_bands=vd_bands)


def bake_palette(params, spec, resolution: int = 256, chunk: int = 131072,
                 vd_bands: int = 3, vd_dirs: int = 32,
                 bake_clip: bool = True) -> BakedVolume:
    """Bake a PaletteNeRF: density + palette quantities (recoloring stays editable),
    per-voxel SH coefficients of ``view_dep`` (``vd_bands`` > 0) and, when the model
    predicts clip features, the clip volume. The density's geo feature is computed once
    per chunk and shared by the palette heads and every view-dependent query."""
    from ..models.palette import palette_clip, palette_color, palette_density, palette_view_dep

    dev = params["encoder"].device
    P = spec.num_basis
    d_canon = torch.tensor([0.0, 0.0, 1.0], device=dev)
    B = vd_bands * vd_bands
    if vd_bands:
        dirs = _fibonacci_dirs(vd_dirs)
        W = torch.from_numpy(_sh_fit(dirs, vd_bands)).to(dev)
        dirs_t = torch.from_numpy(dirs).to(dev)
    want_clip = bool(bake_clip and spec.pred_clip)

    def eval_chunk(x):
        m = x.shape[0]
        dens = palette_density(params, spec, x)
        geo = dens["geo_feat"]
        omega, off_rad, _vd, diffuse = palette_color(params, spec, x,
                                                     d_canon.expand(m, 3), geo)
        out = (dens["sigma"], diffuse, omega, off_rad)
        if vd_bands:
            out += (_view_sh_coeffs(lambda d: palette_view_dep(params, spec, d, geo),
                                    W, dirs_t, m),)
        if want_clip:
            out += (palette_clip(params, spec, x, dens["sigma"]),)
        return out

    outs = _bake_grid(spec.bound, resolution, chunk, eval_chunk, dev)
    R = resolution
    off_rad = outs[3]
    k = 4
    vsh = None
    if vd_bands:
        vsh = outs[k].reshape(R, R, R, 3 * B)
        k += 1
    clp = outs[k].reshape(R, R, R, spec.clip_dim) if want_clip else None
    return BakedVolume(R, spec.bound, outs[0].reshape(R, R, R),
                       outs[1].reshape(R, R, R, 3),
                       outs[2].reshape(R, R, R, P),
                       off_rad[:, :-1].reshape(R, R, R, 3 * P),
                       off_rad[:, -1].reshape(R, R, R),
                       view_sh=vsh, vd_bands=vd_bands, clip_feat=clp)


def mask_with_bitfield(baked: BakedVolume, grid_state: Dict) -> BakedVolume:
    """Zero baked density in occupancy cells the trained marcher never sampled.

    ``grid_state`` is the checkpoint's grid-state dict (``bitfield`` uint8 bytes +
    ``density_grid`` [cascades, G^3]); cascade 0 covers |x| < bound. Voxel centers lie
    on ``linspace(-b, b, R)``, so voxel i maps to cell ``i * G // (R - 1)``; the
    occupancy is dilated one cell (3x3x3 max) so a voxel on a cell edge keeps its real
    surface density. The bits are unpacked on the device (bit k of byte i is cell 8i+k).
    """
    dev = baked.density.device
    G = round(np.asarray(grid_state["density_grid"]).shape[-1] ** (1 / 3) + 1e-6)
    R = baked.resolution
    bf = torch.as_tensor(np.asarray(grid_state["bitfield"])[: G ** 3 // 8]).to(dev)
    bits = (bf[:, None] >> torch.arange(8, dtype=torch.uint8, device=dev)) & 1
    occ = bits.reshape(-1)[: G ** 3].reshape(G, G, G).to(torch.float32)
    dil = F.max_pool3d(occ[None, None], kernel_size=3, stride=1, padding=1)[0, 0]
    cell = torch.clamp(torch.arange(R, device=dev) * G // max(R - 1, 1), max=G - 1)
    occ_up = dil[cell][:, cell][:, :, cell]
    return baked._replace(density=baked.density * occ_up)


def fuse_volume(baked: BakedVolume) -> torch.Tensor:
    """All channels in one [R^3, C_total] tensor, one row per voxel.
    Layout: [density, diffuse(3), (omega P, offsets 3P, radiance), (view_sh 3B)]."""
    R = baked.resolution
    parts = [baked.density.reshape(R ** 3, 1), baked.diffuse.reshape(R ** 3, 3)]
    if baked.omega is not None:
        P = baked.omega.shape[-1]
        parts += [baked.omega.reshape(R ** 3, P), baked.offsets.reshape(R ** 3, 3 * P),
                  baked.radiance.reshape(R ** 3, 1)]
    if baked.view_sh is not None:
        parts.append(baked.view_sh.reshape(R ** 3, -1))
    return torch.cat(parts, -1)


def _f32(a, device) -> torch.Tensor:
    """A tensor, numpy array or number -> f32 tensor on ``device``."""
    a = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a, np.float32))
    return a.to(device=device, dtype=torch.float32)


def _trilinear_flat(flat: torch.Tensor, R: int, x01: torch.Tensor) -> torch.Tensor:
    """flat [R^3, C]; x01 [N, 3] in [0,1] -> [N, C] trilinear (row-major, z fastest)."""
    g = x01.clamp(0.0, 1.0) * (R - 1)
    i0 = torch.clamp(torch.floor(g).to(torch.int64), 0, R - 2)
    f = g - i0
    out = 0.0
    for c in range(8):
        b = [(c >> k) & 1 for k in range(3)]
        w = 1.0
        for k in range(3):
            w = w * (f[:, k] if b[k] else 1.0 - f[:, k])
        idx = ((i0[:, 0] + b[0]) * R + (i0[:, 1] + b[1])) * R + (i0[:, 2] + b[2])
        out = out + flat.index_select(0, idx) * w[:, None]
    return out


def render_baked(baked: BakedVolume, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 num_samples: int = 192, t_thresh: float = 1e-2, bg_color=1.0,
                 min_near: float = 0.05, basis_color=None, density_scale: float = 1.0,
                 fused: Optional[torch.Tensor] = None, view_dep_weight: float = 1.0):
    """Golden per-ray renderer over a baked volume: ``num_samples`` uniform samples
    between the ray's AABB near/far, one trilinear fetch each, ``composite_rays``.

    For palette bakes pass ``basis_color`` [P, 3] (edited colors recolor without a
    re-bake): rgb = sum_p omega_p * softplus(radiance) * (basis_color_p + offsets_p).
    Pass ``fused = fuse_volume(baked)`` to fuse once for many calls. With view-SH
    coefficients the color adds ``view_dep_weight * Y(d) . coeffs``. The caller picks
    the ray batch: memory grows as rays x samples x channels.
    """
    b = baked.bound
    R = baked.resolution
    dev = rays_o.device
    n = rays_o.shape[0]
    aabb = torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32, device=dev)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    t = torch.linspace(0.0, 1.0, num_samples, device=dev)[None]
    ts = nears[:, None] + (fars - nears)[:, None] * t
    dts = torch.diff(ts, dim=1)
    dts = torch.cat([dts, dts[:, -1:]], 1)
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * ts[..., None]
    x01 = (xyz.reshape(-1, 3) + b) / (2 * b)

    if fused is None:
        fused = fuse_volume(baked)
    feats = _trilinear_flat(fused, R, x01)  # [n*S, C_total]

    sig = feats[:, 0].reshape(n, num_samples) * density_scale
    if baked.omega is not None and basis_color is not None:
        P = baked.omega.shape[-1]
        om = feats[:, 4:4 + P, None]
        off = feats[:, 4 + P:4 + 4 * P].reshape(-1, P, 3)
        rad = feats[:, 4 + 4 * P:4 + 4 * P + 1, None]
        bc = _f32(basis_color, dev).clamp(0, 1)[None]
        rgb = (om * (F.softplus(rad) * (bc + off))).sum(-2)
        vd_at = 5 + 4 * P
    else:
        rgb = feats[:, 1:4]
        vd_at = 4
    if baked.view_sh is not None and baked.vd_bands:
        B = baked.vd_bands * baked.vd_bands
        Y = sh_encode(rays_d, baked.vd_bands)                    # [n, B]
        coef = feats[:, vd_at:vd_at + 3 * B].reshape(-1, num_samples, 3, B)
        vd = torch.einsum("nb,nscb->nsc", Y, coef).reshape(-1, 3)
        rgb = rgb + view_dep_weight * vd
    rgb = rgb.reshape(n, num_samples, 3)

    mask = ts < fars[:, None]
    t_cum = torch.where(mask, ts - nears[:, None] + dts, torch.zeros_like(ts))
    ws, depth, image = composite_rays(sig, rgb, dts, t_cum, mask, t_thresh)
    image = image + (1.0 - ws)[:, None] * _f32(bg_color, dev)
    return {"image": image, "depth": depth, "weights_sum": ws}
