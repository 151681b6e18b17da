"""Hierarchical importance sampling (``sample_pdf``).

Port of ``palettenerf_tpu/ops/sampling.py`` (the reference's inverse-CDF sampler,
``nerf/renderer.py:12-46``): weights -> pdf -> cdf -> inverse transform with
piecewise-linear interpolation. The JAX function draws its uniforms from a key; this one
takes them as ``u``, so both packages can be handed the same noise.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: Optional[torch.Tensor] = None, det: bool = False) -> torch.Tensor:
    """bins [B, T] (z values), weights [B, T-1] -> new z samples [B, n_samples].

    ``det``: the midpoints of n_samples equal strata; otherwise ``u`` [B, n_samples] in
    [0, 1) are the uniforms of the inverse transform."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)  # [B, T]
    if det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           device=cdf.device).expand(cdf.shape[:-1] + (n_samples,))
    elif u is None:
        raise ValueError("sample_pdf needs the uniforms u unless det")
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(cdf.shape[-1] - 1)
    cdf_lo = torch.gather(cdf, -1, below)
    cdf_hi = torch.gather(cdf, -1, above)
    bin_lo = torch.gather(bins, -1, below)
    bin_hi = torch.gather(bins, -1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_lo) / denom
    return bin_lo + t * (bin_hi - bin_lo)
