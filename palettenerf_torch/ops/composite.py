"""Volume compositing over the fixed ``[N, S]`` sample axis.

Port of ``palettenerf_tpu/ops/composite.py`` (reference ``raymarching.cu:504-580``):
``alpha = 1 - exp(-sigma*dt)``, transmittance = exclusive cumprod of ``1 - alpha``,
early termination as the mask ``T_enter >= t_thresh``. Gradients by autograd.
"""

from __future__ import annotations

import torch


def composite_weights(sigmas, dts, mask, t_thresh: float):
    """sigmas/dts/mask: [N, S] -> (weights [N,S], weights_sum [N], trans_enter [N,S])."""
    sig = torch.where(mask, sigmas, torch.zeros_like(sigmas))
    alpha = 1.0 - torch.exp(-sig * dts)
    t_inclusive = torch.cumprod(1.0 - alpha, dim=-1)
    t_enter = torch.cat([torch.ones_like(t_inclusive[..., :1]), t_inclusive[..., :-1]], -1)
    include = t_enter >= t_thresh
    w = alpha * t_enter * include * mask
    return w, w.sum(-1), t_enter


def composite_channels(weights, values):
    """weights [N,S] x values [N,S,C] -> [N,C]."""
    return torch.einsum("ns,nsc->nc", weights, values)


def composite_rays(sigmas, rgbs, dts, t_cum, mask, t_thresh: float):
    """Returns (weights_sum [N], depth [N], image [N,3]); depth = sum_j w_j * t_cum_j."""
    w, ws, _ = composite_weights(sigmas, dts, mask, t_thresh)
    depth = (w * t_cum).sum(-1)
    image = composite_channels(w, rgbs)
    return ws, depth, image
