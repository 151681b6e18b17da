"""Loss functions: MAPE, Huber and the O(N) efficient distortion loss.

Port of ``palettenerf_tpu/ops/losses.py`` (reference ``loss.py``): ``mape_loss``
(:7-16), ``huber_loss`` (:18-26) and ``eff_dist_loss`` (:30-77, the mip-NeRF-360
distortion regulariser by prefix sums; autograd gives the reference's hand-written
backward). No product path calls them.
"""

from __future__ import annotations

import torch


def mape_loss(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean"):
    loss = (pred - target).abs() / (target.abs() + 1e-2)
    return loss.mean() if reduction == "mean" else loss


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 0.1,
               reduction: str = "mean"):
    rel = (pred - target).abs()
    loss = torch.where(rel > delta, rel - 0.5 * delta, 0.5 / delta * rel * rel)
    return loss.mean() if reduction == "mean" else loss


def eff_dist_loss(w: torch.Tensor, m: torch.Tensor, interval) -> torch.Tensor:
    """Distortion loss of weights w [B, N] at sample midpoints m [B, N] with interval
    (a scalar or [B, N]): a scalar, normalised by the ray count."""
    n_rays = w.shape[0] if w.ndim > 1 else 1
    w_cs = torch.cumsum(w, -1)
    wm_cs = torch.cumsum(w * m, -1)
    w_prefix = torch.cat([torch.zeros_like(w_cs[..., :1]), w_cs[..., :-1]], -1)
    wm_prefix = torch.cat([torch.zeros_like(wm_cs[..., :1]), wm_cs[..., :-1]], -1)
    loss_uni = (1.0 / 3.0) * interval * w ** 2
    loss_bi = 2.0 * w * (m * w_prefix - wm_prefix)
    return (loss_bi.sum() + loss_uni.sum()) / n_rays
