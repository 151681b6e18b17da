"""Palette volume renderer: training branch, eval branch with edit hooks.

Port of ``palettenerf_tpu/render/palette_renderer.py`` (reference ``palette/renderer.py``,
PaletteRenderer.run_cuda). Same fixed-width pipeline as the NeRF renderer; the palette
blend

    rgbs = sum_p omega_p * softplus(radiance) * (basis_color_p + offsets_p) + view_dep

(renderer.py:349-351) runs per sample, sigma is detached in training (:335), and all
auxiliary channel maps (sparsity / offset / view-dep / smooth norms, view-dep / direct /
diffuse rgb, clip features, per-basis omegas and rgbs) are composited with one shared
weight computation.

Edit hooks (eval): ``RegionEdit`` per-palette HSV recolor with optional spatial /
semantic Gaussian masks (:83-147), the ``Stylizer`` style transfer (:151-183), and the
scalar ``offsets_weight`` / ``view_dep_weight`` dials (:484, :494).

Where the JAX functions draw from a key, these take the draws as arguments: the march
jitter ``noise`` [N], the smooth-loss jitter ``jit_u`` [N*S, 3] and the encode draws
``rand`` (``models.nerf.encode_rand_for`` over ``nerf_renderer.train_rows`` rows: the N*S
slots, or the compact budget), which every encoder of the step shares, the smooth loss's
jittered pass included. With ``compact_frac`` every per-sample computation runs on the
march-valid samples in the compact budget (``nerf_renderer.forward_compact``), ``jit_u``
compacted with them, and the outputs carry ``compact_overflow``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.palette import (PaletteSpec, palette_clip, palette_color, palette_density,
                              palette_forward)
from ..ops.composite import composite_channels, composite_weights
from ..ops.hashgrid_fast import EncodeRand
from ..ops.rays import near_far_from_aabb
from ..utils import profiling
from ..utils.color import hsv_to_rgb, rgb_to_hsv
from .nerf_renderer import (RenderSettings, _aabb, _compact_budget, _march, _resolve_bg,
                            compact_overflow, forward_compact, padded_overflow)


class RegionEdit(NamedTuple):
    """Render-time recoloring state (palette/renderer.py:83-147). The fields are host
    (numpy) arrays, read per frame by the sweep renderer; ``delta_hsv`` may also be a
    tensor. Build with ``make_region_edit``."""

    delta_hsv: object             # [P, 3]: dH (deg), S scale, V scale
    mean_xyz: np.ndarray          # [3]
    use_xyz: np.ndarray           # [] bool
    std_xyz: np.ndarray           # []
    mean_clip: np.ndarray         # [clip_dim]
    use_clip: np.ndarray          # [] bool
    std_clip: np.ndarray          # []
    weight_mode: bool = False     # visualize the mask instead of recoloring


def make_region_edit(num_basis: int, clip_dim: int = 16,
                     mean_xyz=None, std_xyz=1.0, mean_clip=None, std_clip=1.0,
                     weight_mode: bool = False) -> RegionEdit:
    dh = np.zeros((num_basis, 3), np.float32)
    dh[:, 1:] = 1.0
    return RegionEdit(
        delta_hsv=dh,
        mean_xyz=np.zeros(3, np.float32) if mean_xyz is None
        else np.asarray(mean_xyz, np.float32),
        use_xyz=np.asarray(mean_xyz is not None),
        std_xyz=np.asarray(float(std_xyz), np.float32),
        mean_clip=np.zeros(clip_dim, np.float32) if mean_clip is None
        else np.asarray(mean_clip, np.float32),
        use_clip=np.asarray(mean_clip is not None),
        std_clip=np.asarray(float(std_clip), np.float32),
        weight_mode=weight_mode,
    )


def _as_f32(a) -> torch.Tensor:
    return a.float() if torch.is_tensor(a) else torch.as_tensor(np.asarray(a, np.float32))


def region_edit_delta_hsv(rgb_orig, rgb_new) -> torch.Tensor:
    """Per-palette (dH, S-scale, V-scale) [P, 3] from original / modified palette colors
    (renderer.py:105-119)."""
    hsv_o = rgb_to_hsv(_as_f32(rgb_orig))
    hsv_n = rgb_to_hsv(_as_f32(rgb_new))
    dh = torch.remainder(hsv_n[:, 0] - hsv_o[:, 0] + 360.0, 360.0)
    ds = hsv_n[:, 1] / (hsv_o[:, 1] + 1e-9)
    dv = hsv_n[:, 2] / (hsv_o[:, 2] + 1e-9)
    return torch.stack([dh, ds, dv], -1)


def apply_region_edit(edit: RegionEdit, rgbs: torch.Tensor, xyz: torch.Tensor,
                      clip_feat: torch.Tensor) -> torch.Tensor:
    """rgbs [M, P, 3] per-sample per-basis colors; xyz [M, 3]; clip_feat [M, C].
    Returns the edited rgbs (renderer.py:121-147)."""
    dev = rgbs.device
    hsv = rgb_to_hsv(rgbs)
    w = torch.ones(rgbs.shape[:-2] + (1,), device=dev)
    if bool(edit.use_xyz):
        mean = torch.as_tensor(edit.mean_xyz, device=dev)
        w = w * torch.exp(-((xyz - mean) ** 2).sum(-1, keepdim=True) / float(edit.std_xyz))
    if bool(edit.use_clip):
        mean = torch.as_tensor(edit.mean_clip, device=dev)
        w = w * torch.exp(-((clip_feat - mean) ** 2).sum(-1, keepdim=True)
                          / float(edit.std_clip))
    if edit.weight_mode:
        return torch.broadcast_to(w[..., None], rgbs.shape) * torch.ones_like(rgbs)
    dhsv = _as_f32(edit.delta_hsv).to(dev)
    hsv_new = torch.stack([
        torch.remainder(hsv[..., 0] + dhsv[:, 0] + 360.0, 360.0),
        (hsv[..., 1] * dhsv[:, 1]).clamp_min(0.0),
        (hsv[..., 2] * dhsv[:, 2]).clamp_min(0.0),
    ], -1)
    return rgbs + w[..., None] * (hsv_to_rgb(hsv_new) - rgbs)


class StylizerParams(NamedTuple):
    """Style-transfer parameters (palette/renderer.py:151-183)."""

    dI: torch.Tensor      # [P] intensity offsets
    dP: torch.Tensor      # [1, P, 3] palette color offsets
    ddelta: torch.Tensor  # [P, 3, 3] per-palette offset transforms


def init_stylizer(num_basis: int, device="cpu") -> StylizerParams:
    return StylizerParams(
        dI=torch.zeros((num_basis,), device=device),
        dP=torch.zeros((1, num_basis, 3), device=device),
        ddelta=torch.eye(3, device=device)[None].repeat(num_basis, 1, 1),
    )


def stylizer_arap_loss(s: StylizerParams) -> torch.Tensor:
    """Orthogonality (as-rigid-as-possible) penalty on ddelta (renderer.py:162-164)."""
    eye = torch.eye(3, device=s.ddelta.device)[None]
    return ((torch.einsum("pij,pkj->pik", s.ddelta, s.ddelta) - eye) ** 2).sum()


def apply_stylizer(s: StylizerParams, radiance, omega, palette, offsets, view_dep=None):
    """radiance [M,1,1], omega [M,P,1], palette [1|M,P,3], offsets [M,P,3]
    -> rgbs [M,3] (renderer.py:166-183)."""
    pal = palette + s.dP
    offs = torch.einsum("npi,pij->npj", offsets, s.ddelta)
    basis_rgb = ((F.softplus(radiance) + s.dI[None, :, None]).clamp_min(0.0)
                 * (pal + offs)).clamp(0.0, 1.0)
    rgbs = (omega * basis_rgb).sum(-2)
    if view_dep is not None:
        rgbs = rgbs + view_dep.detach()
    return rgbs


# --------------------------------------------------------------------------- render

class _Clip01(torch.autograd.Function):
    """clamp(x, 0, 1) with the gradient of ``jnp.clip``: all of it inside, none outside,
    half where x equals a bound (``torch.clamp`` passes all of it there). An extracted
    palette has entries that are exactly 0 or 1, so the rule is met in training."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp(0.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inside = ((x > 0.0) & (x < 1.0)).to(g.dtype)
        tie = ((x == 0.0) | (x == 1.0)).to(g.dtype)
        return g * (inside + 0.5 * tie)


def clip01(x: torch.Tensor) -> torch.Tensor:
    return _Clip01.apply(x)


def _train_forward(params, spec: PaletteSpec, x: torch.Tensor, d: torch.Tensor,
                   rand: Optional[EncodeRand]):
    """``palette_forward(training=True)`` for the train render, with the density branch
    outside autograd. The render detaches sigma and the model detaches the geo feature,
    so no gradient can reach ``encoder`` or ``sigma_net``: the values are the same (under
    ``-O2`` that branch's forward is stochastic, as in JAX), and autograd neither keeps
    that encode's corner indices nor scatters a gradient of zeros for it."""
    with torch.no_grad():
        dens = palette_density(params, spec, x, True, rand)
    clip_feat = palette_clip(params, spec, x, dens["sigma"], True, rand)
    return (dens["sigma"], clip_feat) + palette_color(params, spec, x, d, dens["geo_feat"],
                                                      True, rand)


def render_palette_train(
    params,
    spec: PaletteSpec,
    bitfield: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    settings: RenderSettings,
    bg_color: Optional[torch.Tensor] = None,
    freeze_basis_color: bool = True,
    require_smooth_loss: bool = False,
    noise: Optional[torch.Tensor] = None,
    jit_u: Optional[torch.Tensor] = None,
    rand: Optional[EncodeRand] = None,
):
    """Differentiable palette train render (palette/renderer.py:321-429).

    ``noise`` [N] jitters the march (None: no jitter); ``jit_u`` [N*S, 3] in [0, 1) is the
    smooth loss's position jitter, needed with ``require_smooth_loss``; ``rand`` the
    encode draws of every encoder of both passes (None: see ``render_nerf_train``).
    Returns the reference's full result dict: image, depth, weights_sum, plus the
    composited aux maps (omega_sparsity, view_dep_norm, offsets_norm, smooth_norm,
    view_dep_rgb, direct_rgb, diffuse_rgb, clip_feat, basis_acc). Sigma and the geo
    feature carry no gradient, so ``encoder`` and ``sigma_net`` get none. A padded sample
    slot has weight zero and adds exactly zero to every map.
    """
    n = rays_o.shape[0]
    P = spec.num_basis
    b = settings.bound
    dev = rays_o.device
    nears, fars = near_far_from_aabb(rays_o, rays_d, _aabb(settings, dev), settings.min_near)
    bg = _resolve_bg(params, spec, rays_o, rays_d, bg_color, settings)
    m = _march(rays_o, rays_d, nears, fars, bitfield, settings, settings.num_samples, noise)
    profiling.count_device("train.valid_samples", m.mask)
    S = settings.num_samples
    x = m.xyzs.reshape(-1, 3)
    d = rays_d[:, None, :].expand_as(m.xyzs).reshape(-1, 3)
    if require_smooth_loss and jit_u is None:
        raise ValueError("require_smooth_loss needs jit_u [N*S, 3]")

    def sample_fields(x, d, jit_u=None):
        """Every per-sample quantity of a [B, ...] batch: (sigma, rgbs, omega_sparsity,
        offsets_norm, view_dep_norm, smooth_norm, view_dep, direct_rgb, diffuse,
        clip_feat, omega)."""
        mb = x.shape[0]
        sigma, clip_feat, omega, offsets_radiance, view_dep, diffuse = _train_forward(
            params, spec, x, d, rand)
        sigma = sigma * settings.density_scale                # detached: renderer.py:334-335

        offsets = offsets_radiance[..., :-1].reshape(mb, P, 3)
        radiance = offsets_radiance[..., -1:].reshape(mb, 1, 1)
        basis_color = clip01(params["basis_color"])[None]
        if freeze_basis_color:
            basis_color = basis_color.detach()
        final_color = F.softplus(radiance) * (basis_color + offsets)
        rgbs = (omega.reshape(mb, P, 1) * final_color).sum(-2) + view_dep.detach()  # :349-351
        direct_rgb = diffuse + view_dep

        # per-sample regularizer channels (:357-359)
        omega_sparsity = omega.sum(-1, keepdim=True) / ((omega ** 2).sum(-1, keepdim=True)
                                                        + 1e-6) - 1.0
        offsets_norm = (offsets ** 2).sum(-1).sum(-1, keepdim=True)
        view_dep_norm = (view_dep ** 2).sum(-1, keepdim=True)

        if require_smooth_loss:
            # jittered re-forward with bilateral weight (:360-378)
            x_diff = (x + jit_u * b * 0.03).clamp(-b, b)
            _, clip_d, omega_d, _, _, diffuse_d = _train_forward(params, spec, x_diff, d, rand)
            with torch.no_grad():
                xyz_w = ((x - x_diff) ** 2).sum(-1, keepdim=True) / b ** 2 / spec.smooth_sigma_xyz
                rgb_w = ((diffuse - diffuse_d) ** 2).sum(-1, keepdim=True) / spec.smooth_sigma_color
                if spec.pred_clip and spec.smooth_sigma_clip > 0:
                    clip_w = torch.sqrt(((clip_feat - clip_d) ** 2).sum(-1, keepdim=True)
                                        + 1e-12) / spec.smooth_sigma_clip
                else:
                    clip_w = 0.0
                smooth_w = torch.exp(-xyz_w - rgb_w - clip_w)
            smooth_norm = ((omega_d - omega) ** 2).sum(-1, keepdim=True) * smooth_w
            if spec.pred_clip:
                smooth_norm = smooth_norm + ((clip_d - clip_feat) ** 2).sum(-1, keepdim=True) * smooth_w
        else:
            smooth_norm = torch.zeros_like(omega_sparsity)
        return (sigma, rgbs, omega_sparsity, offsets_norm, view_dep_norm, smooth_norm,
                view_dep, direct_rgb, diffuse, clip_feat, omega)

    per_sample = (x, d, jit_u) if require_smooth_loss else (x, d)
    overflow = None
    if settings.compact_frac > 0:
        budget = _compact_budget(settings, x.shape[0])
        valid = m.mask.reshape(-1)
        overflow = compact_overflow(valid, budget)
        outs = forward_compact(sample_fields, valid, budget, *per_sample)
    else:
        outs = sample_fields(*per_sample)
    (sigma, rgbs, omega_sparsity, offsets_norm, view_dep_norm, smooth_norm, view_dep,
     direct_rgb, diffuse, clip_feat, omega) = outs

    # composite everything with one weight pass
    w, ws, _ = composite_weights(sigma.reshape(n, S), m.dts, m.mask, settings.t_thresh)
    depth = (w * m.t_cum).sum(-1)
    image = composite_channels(w, rgbs.reshape(n, S, 3))
    aux = torch.cat([omega_sparsity, view_dep_norm, offsets_norm, smooth_norm,
                     view_dep, direct_rgb, diffuse, clip_feat, omega], -1).reshape(n, S, -1)
    aux_map = composite_channels(w, aux)

    c0, C = 4, spec.clip_dim
    rest = (1.0 - ws)[:, None] * bg
    out = {
        "image": image + rest,
        "depth": (depth - nears).clamp_min(0.0) / (fars - nears).clamp_min(1e-6),
        "weights_sum": ws,
        "omega_sparsity": aux_map[:, 0],
        "view_dep_norm": aux_map[:, 1],
        "offsets_norm": aux_map[:, 2],
        "smooth_norm": aux_map[:, 3],
        "view_dep_rgb": aux_map[:, c0:c0 + 3],
        "direct_rgb": aux_map[:, c0 + 3:c0 + 6] + rest,
        "diffuse_rgb": aux_map[:, c0 + 6:c0 + 9],
        "clip_feat": aux_map[:, c0 + 9:c0 + 9 + C],
        "basis_acc": aux_map[:, c0 + 9 + C:c0 + 9 + C + P],
    }
    if overflow is not None:
        out["compact_overflow"] = overflow
    return out


@torch.no_grad()
def render_palette_eval(
    params,
    spec: PaletteSpec,
    bitfield: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    settings: RenderSettings,
    bg_color: Optional[torch.Tensor] = None,
    edit: Optional[RegionEdit] = None,
    stylizer: Optional[StylizerParams] = None,
    offsets_weight: float = 1.0,
    view_dep_weight: float = 1.0,
    gui_mode: bool = False,
    pad_to: Optional[int] = None,
):
    """Eval / editing render (palette/renderer.py:430-552): one pass over the [N, S]
    sample slots, no alive-ray loop. Returns the reference's eval dict including the
    per-basis maps (not with ``gui_mode``). With ``pad_to`` > N the batch counts as
    ``pad_to`` rays, the rest copies of the last one, as JAX pads a frame's last chunk:
    the compact budget is the padded batch's, and the dropped samples counted include
    the copies' (``nerf_renderer.padded_overflow``).

    The field is evaluated only in the slots that hold a sample: those are gathered (one
    host read of their count), or with ``compact_frac`` packed into the static compact
    budget (no host read; the output then carries ``compact_overflow``). The other slots
    keep zeros, and their compositing weight is zero either way.
    """
    n = rays_o.shape[0]
    P = spec.num_basis
    dev = rays_o.device
    nears, fars = near_far_from_aabb(rays_o, rays_d, _aabb(settings, dev), settings.min_near)
    bg = _resolve_bg(params, spec, rays_o, rays_d, bg_color, settings)
    m = _march(rays_o, rays_d, nears, fars, bitfield, settings, settings.num_samples)
    S = settings.num_samples
    x_all = m.xyzs.reshape(-1, 3)
    d_all = rays_d[:, None, :].expand_as(m.xyzs).reshape(-1, 3)

    def sample_fields(x, d):
        """(sigma, rgbs, clip_feat, view_dep, direct_rgb, omega, basis_rgb, unscaled) of a
        [B, 3] batch, each [B, C]."""
        mb = x.shape[0]
        sigma, clip_feat, omega, offsets_radiance, view_dep, diffuse = palette_forward(
            params, spec, x, d)
        sigma = sigma * settings.density_scale
        offsets = offsets_radiance[..., :-1].reshape(mb, P, 3)
        radiance = offsets_radiance[..., -1:].reshape(mb, 1, 1)
        omega_c = omega.reshape(mb, P, 1)
        basis_color = params["basis_color"].clamp(0.0, 1.0)[None]
        unscaled = basis_color + offsets
        if stylizer is not None:
            rgbs = apply_stylizer(stylizer, radiance, omega_c, basis_color, offsets, view_dep)
            basis_rgb = omega_c * (F.softplus(radiance) * unscaled).clamp(0.0, 1.0)
        else:
            final_color = F.softplus(radiance) * (basis_color + offsets_weight * offsets)
            if edit is not None:
                final_color = apply_region_edit(edit, final_color, x, clip_feat)
            basis_rgb = omega_c * final_color
            rgbs = basis_rgb.sum(-2) + view_dep_weight * view_dep  # :494
        return (sigma[:, None], rgbs, clip_feat, view_dep, diffuse + view_dep, omega,
                basis_rgb.reshape(mb, P * 3), unscaled.reshape(mb, P * 3))

    overflow = None
    if settings.compact_frac > 0:
        budget = _compact_budget(settings, max(n, pad_to or n) * S)
        overflow = padded_overflow(m.mask, budget, max(n, pad_to or n))
        outs = [o.reshape(n, S, -1) for o in forward_compact(
            sample_fields, m.mask.reshape(-1), budget, x_all, d_all)]
    else:
        held = m.mask.reshape(-1).nonzero(as_tuple=True)[0]

        def slots(v):
            """[held, C] -> [n, S, C], zeros in the slots without a sample."""
            full = torch.zeros((n * S, v.shape[-1]), dtype=v.dtype, device=dev)
            return full.index_copy_(0, held, v).reshape(n, S, -1)

        outs = [slots(o) for o in sample_fields(x_all[held], d_all[held])]
    sigma, rgbs, clip_feat, view_dep, direct_rgb, omega, basis_rgb, unscaled = outs

    w, ws, _ = composite_weights(sigma[..., 0], m.dts, m.mask, settings.t_thresh)
    depth = (w * m.t_cum).sum(-1)
    rest = (1.0 - ws)[:, None] * bg
    depth_abs = depth + ws * nears  # absolute, matching raymarching.cu:1078-1079
    out = {
        "image": composite_channels(w, rgbs) + rest,
        "depth": (depth_abs - nears).clamp_min(0.0) / (fars - nears).clamp_min(1e-6),
        "depth_origin": depth_abs,
        "weights_sum": ws,
        "clip_feat": composite_channels(w, clip_feat),
    }
    if not gui_mode:
        aux_map = composite_channels(w, torch.cat(
            [direct_rgb, view_dep, omega, basis_rgb, unscaled], -1))
        out["direct_rgb"] = aux_map[:, 0:3] + rest
        out["view_dep_rgb"] = aux_map[:, 3:6]
        out["basis_acc"] = aux_map[:, 6:6 + P]
        out["basis_rgb"] = aux_map[:, 6 + P:6 + 4 * P]
        out["unscaled_basis_rgb"] = aux_map[:, 6 + 4 * P:6 + 7 * P]
    if overflow is not None:
        out["compact_overflow"] = overflow
    return out
