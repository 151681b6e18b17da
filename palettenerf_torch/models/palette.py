"""PaletteNeRF network (stage 3), eval forward, as functions on a parameter dict.

Port of ``palettenerf_tpu/models/palette.py:46-245`` (``PaletteSpec``,
``palette_density``, ``palette_color``, ``palette_view_dep``, ``palette_forward``) for
inference: the serving bake evaluates the trained field through these. Three hash
encoders (``encoder`` for sigma, ``encoder_palette``, ``encoder_clip``) on the port's
``hashgrid_encode_fast_bounded``; bias-free MLPs except ``offsets_radiance_net``
(Linear 15 -> 3P+1 with a bias); ``basis_net`` with ELU activations; ``omega`` =
softplus + 0.05, normalized to sum 1.

Parameters (``train/checkpoint.py:palette_params_from_jax``): ``encoder``,
``encoder_palette`` [T, C] tables, ``encoder_clip`` + ``clip_net`` with ``pred_clip``,
the MLP layer lists ``sigma_net``, ``color_net``, ``diff_net``, ``basis_net``,
``offsets_radiance_net``, ``omega_net``, and ``basis_color`` [P, 3].

Not ported yet: the training-only encoder options (``stochastic_trilerp``,
``grad_levels``, ``fast_grad``), the background net (``bg_radius > 0``), and
``init_palette`` / ``initialize_palette`` (they come with the palette trainer).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.activation import trunc_exp
from ..ops.hashgrid import HashGridSpec
from ..ops.hashgrid_fast import hashgrid_encode_fast_bounded
from ..ops.sh import sh_encode
from .mlp import apply_mlp


@dataclass(frozen=True)
class PaletteSpec:
    """Static model hyperparameters (the inference fields of the JAX package's spec;
    the training-only encoder options and the background net raise when set)."""

    bound: float = 1.0
    num_basis: int = 4
    clip_dim: int = 16
    pred_clip: bool = False
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    sh_degree: int = 4
    bg_radius: float = -1.0
    grid: HashGridSpec = None  # type: ignore[assignment]

    fp16: bool = False
    fast_grad: bool = False
    stochastic_trilerp: bool = False
    grad_levels: int = 0

    def __post_init__(self):
        if self.bg_radius > 0:
            raise NotImplementedError("the background net (bg_radius > 0) is not ported yet")
        if self.fast_grad or self.stochastic_trilerp or self.grad_levels:
            raise NotImplementedError(
                "the training-only encoder options (fast_grad, stochastic_trilerp, "
                "grad_levels) are not ported yet")

    @classmethod
    def build(cls, bound: float = 1.0, bg_radius: float = -1.0, num_basis: int = 4,
              pred_clip: bool = False, clip_dim: int = 16, log2_hashmap_size: int = 19,
              grid_levels: int = 16, grid_level_dim: int = 2, gridtype: str = "hash",
              **kw) -> "PaletteSpec":
        grid = HashGridSpec.build(
            desired_resolution=2048 * bound, num_levels=grid_levels,
            level_dim=grid_level_dim, log2_hashmap_size=log2_hashmap_size,
            gridtype=gridtype,
        )
        return cls(bound=bound, bg_radius=bg_radius, num_basis=num_basis,
                   pred_clip=pred_clip, clip_dim=clip_dim, grid=grid, **kw)

    @property
    def scatter_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.fp16 else None

    @property
    def sh_dim(self) -> int:
        return self.sh_degree ** 2


Params = Dict[str, object]


def _encode(params: Params, name: str, spec: PaletteSpec, x: torch.Tensor) -> torch.Tensor:
    return hashgrid_encode_fast_bounded(params[name], x, spec.grid, spec.bound,
                                        scatter_dtype=spec.scatter_dtype)


def palette_density(params: Params, spec: PaletteSpec, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """x [..., 3] in [-bound, bound] -> dict(sigma [...], geo_feat [..., 15])."""
    h = apply_mlp(params["sigma_net"], _encode(params, "encoder", spec, x))
    return {"sigma": trunc_exp(h[..., 0]), "geo_feat": h[..., 1:]}


def palette_color(params: Params, spec: PaletteSpec, x: torch.Tensor, d: torch.Tensor,
                  geo_feat: torch.Tensor):
    """Palette heads (palette/network.py:223-280).

    Returns (omega [...,P], offsets_radiance [...,3P+1], view_dep [...,3], diffuse [...,3]).
    """
    geo = geo_feat.detach()
    diffuse = apply_mlp(params["diff_net"], geo, final_activation=torch.sigmoid)
    view_dep = palette_view_dep(params, spec, d, geo)

    hp = torch.cat([_encode(params, "encoder_palette", spec, x), diffuse.detach()], -1)
    palette_feat = apply_mlp(params["basis_net"], hp, activation=F.elu)

    offsets_radiance = apply_mlp(params["offsets_radiance_net"], palette_feat)
    omega = F.softplus(apply_mlp(params["omega_net"], palette_feat)) + 0.05
    omega = omega / omega.sum(-1, keepdim=True)
    return omega, offsets_radiance, view_dep, diffuse


def palette_view_dep(params: Params, spec: PaletteSpec, d: torch.Tensor,
                     geo_feat: torch.Tensor) -> torch.Tensor:
    """View-dependent color only: color_net on SH(d) + the geo feature
    (palette/network.py:58-74); the baker's per-direction query."""
    h = torch.cat([sh_encode(d, spec.sh_degree), geo_feat], -1)
    return apply_mlp(params["color_net"], h, final_activation=torch.sigmoid)


def palette_clip(params: Params, spec: PaletteSpec, x: torch.Tensor,
                 like: torch.Tensor) -> torch.Tensor:
    """clip features [..., clip_dim]: clip_net on encoder_clip with ``pred_clip``, else
    zeros shaped after ``like`` [...]."""
    if spec.pred_clip:
        return apply_mlp(params["clip_net"], _encode(params, "encoder_clip", spec, x))
    return torch.zeros(like.shape + (spec.clip_dim,), dtype=like.dtype, device=like.device)


def palette_forward(params: Params, spec: PaletteSpec, x: torch.Tensor, d: torch.Tensor):
    """Full per-sample forward (palette/network.py:156-185).

    Returns (sigma, clip_feat, omega, offsets_radiance, view_dep, diffuse).
    """
    dens = palette_density(params, spec, x)
    sigma = dens["sigma"]
    clip_feat = palette_clip(params, spec, x, sigma)
    omega, offsets_radiance, view_dep, diffuse = palette_color(params, spec, x, d,
                                                               dens["geo_feat"])
    return sigma, clip_feat, omega, offsets_radiance, view_dep, diffuse
