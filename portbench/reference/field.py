"""The Instant-NGP field in plain float32 PyTorch: multiresolution hash encoding
(torch-ngp ``gridencoder``: primes 1, 2654435761, 805459861, level scale
``base * s^l - 1``, corners at ``floor(x * scale + 0.5)``), bias-free MLPs on ``[in, out]``
weights, the degree-4 real spherical harmonics of torch-ngp ``shencoder``, and
``trunc_exp`` (exp forward, exp of the input clamped to [-15, 15] backward).

Written from the published description; imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import List

import torch

PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


class Grid:
    """The levels of one hash-grid encoder: resolution, scale, size, offset, hashed."""

    def __init__(self, cfg: dict):
        L, base = cfg["num_levels"], cfg["base_resolution"]
        self.C = cfg["level_dim"]
        self.bound = float(cfg["bound"])
        desired = cfg["desired_resolution_per_bound"] * cfg["bound"]
        s = 2.0 ** (math.log2(desired / base) / (L - 1))
        self.levels = []
        off = 0
        for lvl in range(L):
            res = int(math.ceil(base * s ** lvl))
            side = res + 1
            size = int(math.ceil(min(2 ** cfg["log2_hashmap_size"], side ** 3) / 8) * 8)
            self.levels.append(dict(scale=base * s ** lvl - 1.0, side=side, size=size,
                                    offset=off, hashed=side ** 3 > size))
            off += size
        self.rows = off

    def encode(self, table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """x [M, 3] world positions in [-bound, bound] -> [M, L * C] (level-major)."""
        x01 = (x + self.bound) / (2.0 * self.bound)
        outside = ((x01 < 0.0) | (x01 > 1.0)).any(-1, keepdim=True)
        feats = []
        for lv in self.levels:
            pos = x01 * torch.tensor(lv["scale"], dtype=torch.float32, device=x.device) + 0.5
            cell = torch.floor(pos)
            frac = pos - cell
            cell = cell.to(torch.int64)
            acc = torch.zeros((x.shape[0], self.C), dtype=torch.float32, device=x.device)
            for corner in range(8):
                bits = [(corner >> d) & 1 for d in range(3)]
                p = [(cell[:, d] + bits[d]) & _U32 for d in range(3)]
                if lv["hashed"]:
                    idx = torch.zeros_like(p[0])
                    for d in range(3):
                        idx = idx ^ ((p[d] * PRIMES[d]) & _U32)
                else:
                    idx = p[0] + p[1] * lv["side"] + p[2] * lv["side"] ** 2
                idx = idx % lv["size"] + lv["offset"]
                w = torch.ones((x.shape[0],), dtype=torch.float32, device=x.device)
                for d in range(3):
                    w = w * (frac[:, d] if bits[d] else 1.0 - frac[:, d])
                acc = acc + table[idx] * w[:, None]
            feats.append(acc)
        out = torch.cat(feats, -1)
        return torch.where(outside, torch.zeros_like(out), out)


def mlp(layers: List[torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    for i, w in enumerate(layers):
        h = h @ w
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)


def sh4(d: torch.Tensor) -> torch.Tensor:
    """Degree-4 real spherical harmonics of unit directions [M, 3] -> [M, 16]."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xy, yz, xz, x2, y2, z2 = x * y, y * z, x * z, x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999, -1.0925484305920792 * xz,
        0.54627421529603959 * (x2 - y2),
        0.59004358992664352 * y * (-3.0 * x2 + y2), 2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2), 0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2), 1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2),
    ], -1)


def density(grid: Grid, params: dict, x: torch.Tensor):
    """(sigma [M], geo feature [M, 15]) of the stage-1 field."""
    h = mlp(params["sigma_net"], grid.encode(params["encoder"], x))
    return trunc_exp(h[:, 0]), h[:, 1:]


def color(params: dict, d: torch.Tensor, geo: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(mlp(params["color_net"], torch.cat([sh4(d), geo], -1)))
