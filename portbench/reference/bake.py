"""The palette model baked to a dense volume in plain float32 (PaletteNeRF's serving
bake): every channel the sweep reads, at the ``R^3`` lattice ``linspace(-b, b, R)``
(x-major, z fastest), with the view-dependent colour fitted per voxel by least squares
onto ``vd_bands^2`` real SH functions over ``vd_dirs`` spherical-Fibonacci directions,
and the density zeroed outside the occupancy grid dilated by one cell (voxel ``i`` lies
in cell ``i * G // (R - 1)``).

Channels, world order [R, R, R, C]: sigma, omega (P), offsets r (P), g (P), b (P),
radiance, then the SH coefficients of r, g and b (B each).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import field, palette


def fibonacci_dirs(n: int) -> np.ndarray:
    i = np.arange(n) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = math.pi * (1.0 + 5.0 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                     np.cos(phi)], -1).astype(np.float32)


@torch.no_grad()
def bake(cfg: dict, params: dict, occupied: torch.Tensor, R: int, vd_bands: int,
         vd_dirs: int, chunk: int = 1 << 17) -> torch.Tensor:
    dev = occupied.device
    grid = field.Grid(cfg)
    P, b, B = cfg["num_basis"], float(cfg["bound"]), vd_bands * vd_bands
    dirs = torch.from_numpy(fibonacci_dirs(vd_dirs)).to(dev)
    Y = field.sh4(dirs)[:, :B].double()
    fit = torch.linalg.pinv(Y).float()                                    # [B, Nd]
    lin = torch.linspace(-b, b, R, dtype=torch.float32, device=dev)
    out = torch.empty((R ** 3, 2 + 4 * P + 3 * B), dtype=torch.float32, device=dev)
    for s in range(0, R ** 3, chunk):
        i = torch.arange(s, min(s + chunk, R ** 3), device=dev)
        x = torch.stack([lin[i // (R * R)], lin[(i // R) % R], lin[i % R]], -1)
        m = x.shape[0]
        sigma, geo = field.density(grid, params, x)
        omega, offsets, radiance, _ = palette.heads(grid, params, x, geo, P)
        vd = torch.stack([field.color(params, d.expand(m, 3), geo) for d in dirs])
        coef = torch.einsum("bn,nmc->mcb", fit, vd).reshape(m, 3 * B)
        out[s:s + m] = torch.cat([sigma[:, None], omega, offsets[..., 0], offsets[..., 1],
                                  offsets[..., 2], radiance, coef], -1)
    G = cfg["grid_size"]
    occ = F.max_pool3d(occupied.reshape(1, 1, G, G, G).float(), 3, stride=1, padding=1)[0, 0]
    cell = (torch.arange(R, device=dev) * G // (R - 1)).clamp(max=G - 1)
    keep = occ[cell][:, cell][:, :, cell].reshape(-1)
    out[:, 0] *= keep
    return out.reshape(R, R, R, -1)
