"""Instant-NGP NeRF network (stage 1) as functions on a parameter dict.

Port of ``palettenerf_tpu/models/nerf.py``: hash encoder (16 levels x 2 features,
desired resolution 2048*bound) -> bias-free sigma MLP -> [sigma (trunc_exp), 15-dim geo
feature]; SH degree-4 direction encoding + geo feature -> bias-free color MLP -> sigmoid
rgb. With ``bg_radius > 0`` the background net (network.py:70-92, 145-160): a 2D hash
encoding (4 levels, desired resolution 2048) of where the ray leaves the background
sphere, after the SH encoding of the direction, -> bias-free MLP -> sigmoid rgb.

Parameters: ``{"encoder": [T, C], "sigma_net": [W...], "color_net": [W...]}``, plus
``"encoder_bg"`` and ``"bg_net"`` with ``bg_radius > 0``, with every weight ``[in, out]``
— the JAX package's tree with ``{"w": W}`` layers flattened to tensors
(``train/checkpoint.py:params_from_jax`` converts).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from ..ops.activation import trunc_exp
from ..ops.hashgrid import HashGridSpec, init_hashgrid
from ..ops.hashgrid_fast import (EncodeRand, hashgrid_encode_fast, hashgrid_encode_fast_bounded,
                                 make_encode_rand)
from ..ops.sh import sh_encode
from .mlp import apply_mlp, init_mlp


@dataclass(frozen=True)
class NeRFSpec:
    """Static model hyperparameters."""

    bound: float = 1.0
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    num_layers_bg: int = 2
    hidden_dim_bg: int = 64
    sh_degree: int = 4
    bg_radius: float = -1.0
    fp16: bool = False  # -O: bf16 hash-grid backward scatter; forward stays f32
    fast_grad: bool = False  # nearest-corner hash backward (8x fewer scatter updates)
    stochastic_trilerp: bool = False  # train-only 1-corner Monte-Carlo trilerp
    grad_levels: int = 0  # backward-only level subsampling (0 = all levels)
    grid: HashGridSpec = None  # type: ignore[assignment]
    grid_bg: Optional[HashGridSpec] = None

    @classmethod
    def build(cls, bound: float = 1.0, bg_radius: float = -1.0,
              log2_hashmap_size: int = 19, grid_levels: int = 16,
              grid_level_dim: int = 2, gridtype: str = "hash", **kw) -> "NeRFSpec":
        grid = HashGridSpec.build(
            desired_resolution=2048 * bound, num_levels=grid_levels,
            level_dim=grid_level_dim, log2_hashmap_size=log2_hashmap_size,
            gridtype=gridtype,
        )
        return cls(bound=bound, bg_radius=bg_radius, grid=grid,
                   grid_bg=background_grid(bg_radius), **kw)

    @property
    def sh_dim(self) -> int:
        return self.sh_degree ** 2

    @property
    def scatter_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.fp16 else None


Params = Dict[str, object]


def background_grid(bg_radius: float) -> Optional[HashGridSpec]:
    """The background net's 2D grid (levels 16, 81, 407, 2048: three dense, one
    hashed), or None without a background net."""
    if bg_radius <= 0:
        return None
    return HashGridSpec.build(input_dim=2, num_levels=4, desired_resolution=2048)


def init_background(spec, generator: torch.Generator, device="cpu") -> Params:
    """``encoder_bg`` and ``bg_net`` of ``spec`` (a NeRFSpec or PaletteSpec) with
    ``bg_radius > 0``, else nothing."""
    if spec.bg_radius <= 0:
        return {}
    return {
        "encoder_bg": init_hashgrid(spec.grid_bg, generator, device),
        "bg_net": init_mlp(_mlp_dims(spec.grid_bg.output_dim + spec.sh_dim, spec.hidden_dim_bg,
                                     3, spec.num_layers_bg), generator, device),
    }


def _mlp_dims(in_dim, hidden, out_dim, num_layers) -> List[int]:
    return [in_dim] + [hidden] * (num_layers - 1) + [out_dim]


def init_nerf(spec: NeRFSpec, generator: torch.Generator, device="cpu") -> Params:
    params = {
        "encoder": init_hashgrid(spec.grid, generator, device),
        "sigma_net": init_mlp(_mlp_dims(spec.grid.output_dim, spec.hidden_dim,
                                        1 + spec.geo_feat_dim, spec.num_layers),
                              generator, device),
        "color_net": init_mlp(_mlp_dims(spec.sh_dim + spec.geo_feat_dim,
                                        spec.hidden_dim_color, 3, spec.num_layers_color),
                              generator, device),
    }
    params.update(init_background(spec, generator, device))
    return params


def param_list(params: Params) -> List[torch.Tensor]:
    """Every tensor of the parameter dict, in a fixed order (the background net's
    last, where there is one)."""
    out = [params["encoder"], *params["sigma_net"], *params["color_net"]]
    if "encoder_bg" in params:
        out += [params["encoder_bg"], *params["bg_net"]]
    return out


def encode_rand_for(generator: torch.Generator, spec, n_samples: int) -> Optional[EncodeRand]:
    """One train step's encode draws (corner draw + backward level subset) for ``spec``
    (a NeRFSpec or PaletteSpec), or None when its training profile uses none."""
    if not (spec.stochastic_trilerp or spec.grad_levels):
        return None
    return make_encode_rand(generator, n_samples, spec.grid, spec.grad_levels)


def encode_field(table: torch.Tensor, spec, x: torch.Tensor, training: bool = False,
                 rand: Optional[EncodeRand] = None) -> torch.Tensor:
    """One hash encoder of ``spec``'s field at x [..., 3] in [-bound, bound].
    ``training`` enables the train-only stochastic trilerp and level subsampling of the
    spec; eval always interpolates exactly and scatters every level."""
    return hashgrid_encode_fast_bounded(
        table, x, spec.grid, spec.bound, scatter_dtype=spec.scatter_dtype,
        nearest_corner_grad=spec.fast_grad, stochastic=training and spec.stochastic_trilerp,
        rand=rand if training else None, grad_levels=spec.grad_levels if training else 0)


def nerf_density(params: Params, spec: NeRFSpec, x: torch.Tensor, training: bool = False,
                 rand: Optional[EncodeRand] = None) -> Dict[str, torch.Tensor]:
    """x [..., 3] in [-bound, bound] -> dict(sigma [...], geo_feat [..., 15]).
    ``training`` / ``rand``: see ``encode_field``."""
    h = encode_field(params["encoder"], spec, x, training, rand)
    h = apply_mlp(params["sigma_net"], h)
    return {"sigma": trunc_exp(h[..., 0]), "geo_feat": h[..., 1:]}


def nerf_color(params: Params, spec: NeRFSpec, d: torch.Tensor,
               geo_feat: torch.Tensor) -> torch.Tensor:
    """d [..., 3] unit dirs; geo_feat [..., 15] -> rgb [..., 3] (sigmoid)."""
    h = torch.cat([sh_encode(d, spec.sh_degree), geo_feat], dim=-1)
    return apply_mlp(params["color_net"], h, final_activation=torch.sigmoid)


def nerf_forward(params: Params, spec: NeRFSpec, x: torch.Tensor, d: torch.Tensor,
                 training: bool = False, rand: Optional[EncodeRand] = None):
    dens = nerf_density(params, spec, x, training, rand)
    return dens["sigma"], nerf_color(params, spec, d, dens["geo_feat"])


def nerf_background(params: Params, spec, sph: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Background rgb [..., 3] of ``spec`` (a NeRFSpec or PaletteSpec): sph [..., 2] in
    [-1, 1] (``ops.rays.sph_from_ray``), d [..., 3] unit directions (network.py:145-160).
    The grid encoding is f32 with an f32 ``index_add_`` backward, as the JAX package's
    XLA scatter; the SH encoding comes first in the MLP's input."""
    h = hashgrid_encode_fast(params["encoder_bg"], (sph + 1.0) * 0.5, spec.grid_bg)
    h = torch.cat([sh_encode(d, spec.sh_degree), h], dim=-1)
    return apply_mlp(params["bg_net"], h, final_activation=torch.sigmoid)
