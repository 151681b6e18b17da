"""NeRF volume renderer (stage 1): train path and exact eval paths.

Port of ``palettenerf_tpu/render/nerf_renderer.py``:

    near/far -> closed-form candidate march (ops.march) -> network over [N*S] samples
             -> masked composite (ops.composite)

``render_nerf_train`` (:142-217) is differentiable; its march jitter ``noise`` [N],
background ``bg_color`` and encode draws ``rand`` (``models.nerf.encode_rand_for`` over
all N*S sample slots, padding included) are arguments (drawn by the trainer).
``render_nerf_eval`` (:414-475) renders without jitter; with ``compaction_rounds`` it dispatches to
``render_nerf_eval_compact`` (:299-411), the fixed-schedule version of the
reference's alive-ray loop. Sample compaction (``compact_frac``), the hierarchical
march, the fine eval grid and the background net are not ported yet.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from ..models.nerf import NeRFSpec, Params, nerf_forward
from ..ops.composite import composite_rays, composite_weights
from ..ops.hashgrid_fast import EncodeRand
from ..ops.march import march_rays
from ..ops.rays import near_far_from_aabb


@dataclass(frozen=True)
class RenderSettings:
    bound: float = 1.0
    cascade: int = 1
    grid_size: int = 128
    dt_gamma: float = 0.0
    max_steps: int = 1024       # candidate budget K (reference max_steps)
    num_samples: int = 128      # retained sample slots S
    density_scale: float = 1.0
    t_thresh: float = 1e-4
    min_near: float = 0.2
    # eval compaction schedule ((ray_divisor, samples), ...); round 0 has divisor 1.
    # Empty = one fixed-width pass.
    compaction_rounds: tuple = ()


@functools.lru_cache(maxsize=None)
def _aabb_of(bound: float, device: torch.device) -> torch.Tensor:
    b = bound
    return torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32, device=device)


def _aabb(settings: RenderSettings, device) -> torch.Tensor:
    """The scene box [6] on ``device`` (read-only; uploaded once, not per render)."""
    return _aabb_of(settings.bound, torch.device(device))


def _march(rays_o, rays_d, nears, fars, bitfield, settings: RenderSettings,
           num_samples: int, noise=None):
    return march_rays(rays_o, rays_d, nears, fars, bitfield, settings.bound,
                      settings.cascade, settings.grid_size, settings.dt_gamma,
                      settings.max_steps, num_samples, noise)


def _background(bg_color, device) -> torch.Tensor:
    if bg_color is None:
        return torch.ones((3,), dtype=torch.float32, device=device)
    return bg_color


def render_nerf_train(
    params: Params,
    spec: NeRFSpec,
    bitfield: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    settings: RenderSettings,
    bg_color: Optional[torch.Tensor] = None,
    rays_gt: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    rand: Optional[EncodeRand] = None,
):
    """Differentiable render of a flat ray batch [N, 3]. The network runs in training
    mode (``-O2``: the stochastic trilerp and level subsampling over ``rand``, whose ``u``
    has N * num_samples rows; without ``rand`` the corner draw hashes the positions and
    every level is scattered).

    Returns dict(image [N,3], depth [N], weights_sum [N], rgb_norm [N]).
    """
    n = rays_o.shape[0]
    nears, fars = near_far_from_aabb(rays_o, rays_d, _aabb(settings, rays_o.device),
                                     settings.min_near)
    bg = _background(bg_color, rays_o.device)
    m = _march(rays_o, rays_d, nears, fars, bitfield, settings, settings.num_samples, noise)
    dirs = rays_d[:, None, :].expand_as(m.xyzs)
    sigmas, rgbs = nerf_forward(params, spec, m.xyzs.reshape(-1, 3), dirs.reshape(-1, 3),
                                training=True, rand=rand)
    sigmas = sigmas.reshape(n, -1) * settings.density_scale
    rgbs = rgbs.reshape(n, -1, 3)

    ws, depth, image = composite_rays(sigmas, rgbs, m.dts, m.t_cum, m.mask, settings.t_thresh)
    if rays_gt is not None:
        # per-sample GT error composited back to rays (sparsity term, renderer.py:301-307)
        err = ((rays_gt[:, None, :] - rgbs) ** 2).sum(-1)
        w, _, _ = composite_weights(sigmas, m.dts, m.mask, settings.t_thresh)
        rgb_norm = (w * err).sum(-1)
    else:
        rgb_norm = torch.zeros((n,), dtype=torch.float32, device=rays_o.device)

    image = image + (1.0 - ws)[:, None] * bg
    depth_out = (depth - nears).clamp_min(0.0) / (fars - nears).clamp_min(1e-6)
    return {"image": image, "depth": depth_out, "weights_sum": ws, "rgb_norm": rgb_norm}


@torch.no_grad()
def render_nerf_eval_compact(
    params: Params,
    spec: NeRFSpec,
    bitfield: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    settings: RenderSettings,
    bg_color: Optional[torch.Tensor] = None,
):
    """Eval render with static alive-ray compaction rounds: round 0 marches every
    ray for a few samples; each later round continues only the top 1/divisor rays by
    remaining transmittance (nerf/renderer.py:336-386 semantics)."""
    rounds = settings.compaction_rounds
    if not rounds or rounds[0][0] != 1:
        raise ValueError(f"compaction round 0 must cover all rays, got {rounds}")
    n = rays_o.shape[0]
    device = rays_o.device
    nears, fars = near_far_from_aabb(rays_o, rays_d, _aabb(settings, device), settings.min_near)
    bg = _background(bg_color, device)
    m = _march(rays_o, rays_d, nears, fars, bitfield, settings, sum(s for _, s in rounds))

    image = torch.zeros((n, 3), dtype=torch.float32, device=device)
    depth = torch.zeros((n,), dtype=torch.float32, device=device)
    ws = torch.zeros((n,), dtype=torch.float32, device=device)
    trans = torch.ones((n,), dtype=torch.float32, device=device)

    offset = 0
    for divisor, s_r in rounds:
        n_r = n // divisor
        cols = slice(offset, offset + s_r)
        if divisor == 1:
            sel = None
            xyz, dts, t_cum, mask = m.xyzs[:, cols], m.dts[:, cols], m.t_cum[:, cols], m.mask[:, cols]
            rd_r, t_in = rays_d, trans
        else:
            alive = torch.where(m.mask[:, offset], trans, torch.zeros_like(trans))
            sel = torch.topk(alive, n_r).indices
            xyz, dts = m.xyzs[sel, cols], m.dts[sel, cols]
            t_cum, mask = m.t_cum[sel, cols], m.mask[sel, cols]
            rd_r, t_in = rays_d[sel], trans[sel]

        dirs = rd_r[:, None, :].expand_as(xyz)
        sig, rgb = nerf_forward(params, spec, xyz.reshape(-1, 3), dirs.reshape(-1, 3))
        sig = sig.reshape(n_r, s_r).float() * settings.density_scale
        rgb = rgb.reshape(n_r, s_r, 3).float()

        sig = torch.where(mask, sig, torch.zeros_like(sig))
        alpha = 1.0 - torch.exp(-sig * dts)
        t_rel = torch.cumprod(1.0 - alpha, dim=-1)
        t_enter = t_in[:, None] * torch.cat([torch.ones_like(t_rel[:, :1]), t_rel[:, :-1]], -1)
        w = alpha * t_enter * (t_enter >= settings.t_thresh) * mask

        d_img = torch.einsum("ns,nsc->nc", w, rgb)
        d_ws = w.sum(-1)
        d_depth = (w * t_cum).sum(-1)
        t_out = t_in * t_rel[:, -1]
        if sel is None:
            image, ws, depth, trans = image + d_img, ws + d_ws, depth + d_depth, t_out
        else:
            image.index_add_(0, sel, d_img)
            ws.index_add_(0, sel, d_ws)
            depth.index_add_(0, sel, d_depth)
            trans[sel] = t_out
        offset += s_r

    image = image + (1.0 - ws)[:, None] * bg
    depth_abs = depth + ws * nears
    depth_out = (depth_abs - nears).clamp_min(0.0) / (fars - nears).clamp_min(1e-6)
    return {"image": image, "depth": depth_out, "depth_origin": depth_abs, "weights_sum": ws}


@torch.no_grad()
def render_nerf_eval(
    params: Params,
    spec: NeRFSpec,
    bitfield: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    settings: RenderSettings,
    bg_color: Optional[torch.Tensor] = None,
):
    """Eval render (no jitter). Returns image, depth, depth_origin (absolute composited
    distance, palette/renderer.py:526) and weights_sum."""
    if settings.compaction_rounds and rays_o.shape[0] >= 64:
        # tiny batches skip compaction: top-k over n//16 rays needs a population
        return render_nerf_eval_compact(params, spec, bitfield, rays_o, rays_d,
                                        settings, bg_color)
    n = rays_o.shape[0]
    nears, fars = near_far_from_aabb(rays_o, rays_d, _aabb(settings, rays_o.device),
                                     settings.min_near)
    bg = _background(bg_color, rays_o.device)
    m = _march(rays_o, rays_d, nears, fars, bitfield, settings, settings.num_samples)
    dirs = rays_d[:, None, :].expand_as(m.xyzs)
    sigmas, rgbs = nerf_forward(params, spec, m.xyzs.reshape(-1, 3), dirs.reshape(-1, 3))
    sigmas = sigmas.reshape(n, -1) * settings.density_scale
    rgbs = rgbs.reshape(n, -1, 3)
    ws, depth, image = composite_rays(sigmas, rgbs, m.dts, m.t_cum, m.mask, settings.t_thresh)
    image = image + (1.0 - ws)[:, None] * bg
    # inference depth is absolute in the reference (raymarching.cu:1078-1079)
    depth_abs = depth + ws * nears
    depth_out = (depth_abs - nears).clamp_min(0.0) / (fars - nears).clamp_min(1e-6)
    return {"image": image, "depth": depth_out, "depth_origin": depth_abs, "weights_sum": ws}
