"""Per-ray geometry: the ray/AABB slab test and the background-sphere coordinates.

Port of ``palettenerf_tpu/ops/rays.py`` (reference ``raymarching.cu:95-159`` and
``:166-212``).
"""

from __future__ import annotations

import math

import torch

BIG = 1e10


def near_far_from_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor, aabb: torch.Tensor,
                       min_near: float = 0.2):
    """rays_o/d: [N,3]; aabb: [6] (xmin,ymin,zmin,xmax,ymax,zmax) -> (near [N], far [N]).
    Rays that miss the box get near == far == 1e10."""
    inv_d = 1.0 / rays_d
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    near = torch.minimum(t0, t1).amax(-1)
    far = torch.maximum(t0, t1).amin(-1)
    miss = near > far
    near = near.clamp_min(min_near)
    big = torch.full_like(near, BIG)
    return torch.where(miss, big, near), torch.where(miss, big, far)


def sph_from_ray(rays_o: torch.Tensor, rays_d: torch.Tensor, radius: float) -> torch.Tensor:
    """Where rays [N, 3] leave the background sphere of ``radius``, as (theta, phi)
    normalised to [-1, 1]: [N, 2] = (2 theta / pi - 1, phi / pi), y up. The larger root
    of the ray/sphere quadratic, with the discriminant clamped at 0."""
    a = (rays_d * rays_d).sum(-1)
    b = (rays_o * rays_d).sum(-1)  # b/2 of the quadratic
    c = (rays_o * rays_o).sum(-1) - radius * radius
    disc = (b * b - a * c).clamp_min(0.0)
    t = (-b + torch.sqrt(disc)) / a
    p = rays_o + t[..., None] * rays_d
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    theta = torch.atan2(torch.sqrt(x * x + z * z), y)  # [0, pi]
    phi = torch.atan2(z, x)  # [-pi, pi]
    return torch.stack([2.0 * theta / math.pi - 1.0, phi / math.pi], -1)
