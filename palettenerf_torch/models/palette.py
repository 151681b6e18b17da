"""PaletteNeRF network (stage 3) as functions on a parameter dict.

Port of ``palettenerf_tpu/models/palette.py`` (``PaletteSpec``, ``init_palette``,
``initialize_palette``, ``palette_density``, ``palette_color``, ``palette_view_dep``,
``palette_forward``, ``palette_background``, ``get_palette_weight_with_hist``): the
palette trainer and the serving bake evaluate the field through these. Three hash
encoders (``encoder`` for sigma, ``encoder_palette``, ``encoder_clip``) on the port's
``hashgrid_encode_fast_bounded``; bias-free MLPs except ``offsets_radiance_net``
(Linear 15 -> 3P+1 with a bias); ``basis_net`` with ELU activations; ``omega`` =
softplus + 0.05, normalized to sum 1.

Parameters (``train/checkpoint.py:palette_params_from_jax``): ``encoder``,
``encoder_palette`` [T, C] tables, ``encoder_clip`` + ``clip_net`` with ``pred_clip``,
``encoder_bg`` + ``bg_net`` with ``bg_radius > 0`` (the NeRF's background net), the MLP
layer lists ``sigma_net``, ``color_net``, ``diff_net``, ``basis_net``,
``offsets_radiance_net``, ``omega_net``, the trainable ``basis_color`` [P, 3], its frozen
copy ``basis_color_origin`` and, after ``initialize_palette``, the frozen
``hist_weights`` [32, 32, 32, P].

Gradient stops as in the JAX package: the geo feature is detached before every palette
head and ``diffuse`` before ``basis_net``; the palette renderer detaches sigma.

The training-only encoder options (``fast_grad``, ``stochastic_trilerp``,
``grad_levels``) act as in ``models/nerf.py``: with ``training`` every encoder of one
forward (``encoder``, ``encoder_palette``, ``encoder_clip``) takes the same ``rand``.
With ``color_space="linear"`` the palette is stored in linear space
(``initialize_palette``); the renders stay linear.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.activation import trunc_exp
from ..ops.hashgrid import HashGridSpec, init_hashgrid
from ..ops.hashgrid_fast import EncodeRand
from ..ops.sh import sh_encode
from ..utils.color import srgb_to_linear
from .mlp import apply_mlp, init_mlp
from .nerf import background_grid, encode_field, init_background, nerf_background


@dataclass(frozen=True)
class PaletteSpec:
    """Static model hyperparameters."""

    bound: float = 1.0
    num_basis: int = 4
    clip_dim: int = 16
    pred_clip: bool = False
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    num_layers_bg: int = 2
    hidden_dim_bg: int = 64
    sh_degree: int = 4
    bg_radius: float = -1.0
    color_space: str = "srgb"
    smooth_sigma_xyz: float = 0.005
    smooth_sigma_color: float = 0.2
    smooth_sigma_clip: float = 0.0
    grid: HashGridSpec = None  # type: ignore[assignment]
    grid_bg: Optional[HashGridSpec] = None

    fp16: bool = False
    fast_grad: bool = False
    stochastic_trilerp: bool = False
    grad_levels: int = 0

    @classmethod
    def build(cls, bound: float = 1.0, bg_radius: float = -1.0, num_basis: int = 4,
              pred_clip: bool = False, clip_dim: int = 16, color_space: str = "srgb",
              log2_hashmap_size: int = 19, grid_levels: int = 16, grid_level_dim: int = 2,
              gridtype: str = "hash", **kw) -> "PaletteSpec":
        grid = HashGridSpec.build(
            desired_resolution=2048 * bound, num_levels=grid_levels,
            level_dim=grid_level_dim, log2_hashmap_size=log2_hashmap_size,
            gridtype=gridtype,
        )
        return cls(bound=bound, bg_radius=bg_radius, num_basis=num_basis,
                   pred_clip=pred_clip, clip_dim=clip_dim, color_space=color_space,
                   grid=grid, grid_bg=background_grid(bg_radius), **kw)

    @property
    def scatter_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.fp16 else None

    @property
    def sh_dim(self) -> int:
        return self.sh_degree ** 2


Params = Dict[str, object]

# leaves of the parameter dict that no optimizer step ever moves
FROZEN = ("basis_color_origin", "hist_weights")


def _dims(in_dim, hidden, out_dim, n) -> List[int]:
    return [in_dim] + [hidden] * (n - 1) + [out_dim]


def init_palette(spec: PaletteSpec, generator: torch.Generator, device="cpu") -> Params:
    """A fresh parameter dict with the shapes and distributions of the JAX package's
    ``init_palette`` (its draws come from ``generator``, as ``init_nerf``'s do)."""
    P, n, g = spec.num_basis, spec.grid.output_dim, spec.geo_feat_dim
    mlp = lambda dims, **kw: init_mlp(dims, generator, device, **kw)  # noqa: E731
    params = {
        "encoder": init_hashgrid(spec.grid, generator, device),
        "encoder_palette": init_hashgrid(spec.grid, generator, device),
        "encoder_clip": init_hashgrid(spec.grid, generator, device),
        "sigma_net": mlp(_dims(n, spec.hidden_dim, 1 + g, spec.num_layers)),
        "color_net": mlp(_dims(spec.sh_dim + g, spec.hidden_dim_color, 3,
                               spec.num_layers_color)),
        "diff_net": mlp(_dims(g, spec.hidden_dim_color, 3, spec.num_layers_color)),
        "basis_net": mlp(_dims(n + 3, spec.hidden_dim, g, spec.num_layers)),
        "offsets_radiance_net": mlp([g, P * 3 + 1], bias=True),
        "omega_net": mlp([g, P]),
        # palette state; re-initialized by initialize_palette (renderer.py:248-268)
        "basis_color": torch.full((P, 3), 0.5, device=device),
        "basis_color_origin": torch.full((P, 3), 0.5, device=device),
    }
    if spec.pred_clip:
        params["clip_net"] = mlp(_dims(n, spec.hidden_dim, spec.clip_dim, spec.num_layers))
    params.update(init_background(spec, generator, device))
    return params


def initialize_palette(params: Params, spec: PaletteSpec, color_list=None,
                       hist_weights=None) -> Params:
    """Set the basis colors (and their frozen origin) and the optional hist-weight
    volume (palette/renderer.py:248-268); with ``color_space="linear"`` the colors go
    through ``srgb_to_linear`` first. Returns an updated shallow copy; the new leaves are
    on the device of ``basis_color`` and need no gradient yet."""
    params = dict(params)
    dev = params["basis_color"].device
    if color_list is not None:
        bc = torch.as_tensor(np.asarray(color_list, np.float32), device=dev)
        if spec.color_space == "linear":
            bc = srgb_to_linear(bc)
        params["basis_color"] = bc
        params["basis_color_origin"] = bc.clone()
    if hist_weights is not None:
        params["hist_weights"] = torch.as_tensor(np.asarray(hist_weights, np.float32),
                                                 device=dev)
    return params


def palette_density(params: Params, spec: PaletteSpec, x: torch.Tensor, training: bool = False,
                    rand: Optional[EncodeRand] = None) -> Dict[str, torch.Tensor]:
    """x [..., 3] in [-bound, bound] -> dict(sigma [...], geo_feat [..., 15])."""
    h = apply_mlp(params["sigma_net"], encode_field(params["encoder"], spec, x, training, rand))
    return {"sigma": trunc_exp(h[..., 0]), "geo_feat": h[..., 1:]}


def palette_color(params: Params, spec: PaletteSpec, x: torch.Tensor, d: torch.Tensor,
                  geo_feat: torch.Tensor, training: bool = False,
                  rand: Optional[EncodeRand] = None):
    """Palette heads (palette/network.py:223-280).

    Returns (omega [...,P], offsets_radiance [...,3P+1], view_dep [...,3], diffuse [...,3]).
    """
    geo = geo_feat.detach()
    diffuse = apply_mlp(params["diff_net"], geo, final_activation=torch.sigmoid)
    view_dep = palette_view_dep(params, spec, d, geo)

    hp = torch.cat([encode_field(params["encoder_palette"], spec, x, training, rand),
                    diffuse.detach()], -1)
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


def palette_clip(params: Params, spec: PaletteSpec, x: torch.Tensor, like: torch.Tensor,
                 training: bool = False, rand: Optional[EncodeRand] = None) -> torch.Tensor:
    """clip features [..., clip_dim]: clip_net on encoder_clip with ``pred_clip``, else
    zeros shaped after ``like`` [...]."""
    if spec.pred_clip:
        return apply_mlp(params["clip_net"],
                         encode_field(params["encoder_clip"], spec, x, training, rand))
    return torch.zeros(like.shape + (spec.clip_dim,), dtype=like.dtype, device=like.device)


def palette_forward(params: Params, spec: PaletteSpec, x: torch.Tensor, d: torch.Tensor,
                    training: bool = False, rand: Optional[EncodeRand] = None):
    """Full per-sample forward (palette/network.py:156-185).

    Returns (sigma, clip_feat, omega, offsets_radiance, view_dep, diffuse).
    """
    dens = palette_density(params, spec, x, training, rand)
    sigma = dens["sigma"]
    clip_feat = palette_clip(params, spec, x, sigma, training, rand)
    omega, offsets_radiance, view_dep, diffuse = palette_color(
        params, spec, x, d, dens["geo_feat"], training, rand)
    return sigma, clip_feat, omega, offsets_radiance, view_dep, diffuse


def palette_background(params: Params, spec: PaletteSpec, sph: torch.Tensor,
                       d: torch.Tensor) -> torch.Tensor:
    """The background net, as the NeRF's (``models.nerf.nerf_background``)."""
    return nerf_background(params, spec, sph, d)


def get_palette_weight_with_hist(rgb: torch.Tensor, hist_weights: torch.Tensor) -> torch.Tensor:
    """Trilinear lookup of the extraction's blending weights at colors.

    hist_weights [32, 32, 32, P] indexed by (r, g, b) * 31 (``grid_sample`` with
    align_corners, palette/utils.py:117-124); rgb [..., 3] in [0, 1] -> [..., P].
    """
    shape = rgb.shape[:-1]
    g = rgb.reshape(-1, 3).clamp(0.0, 1.0) * 31.0
    i0 = torch.floor(g).to(torch.int64).clamp(0, 30)
    f = g - i0
    out = 0.0
    for corner in range(8):
        bits = [(corner >> k) & 1 for k in range(3)]
        idx = [(i0[:, k] + bits[k]).clamp(0, 31) for k in range(3)]
        w = 1.0
        for k in range(3):
            w = w * (f[:, k] if bits[k] else 1.0 - f[:, k])
        out = out + hist_weights[idx[0], idx[1], idx[2]] * w[:, None]
    return out.reshape(*shape, hist_weights.shape[-1])
