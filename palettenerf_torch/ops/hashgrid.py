"""Multiresolution hash-grid encoding (Instant-NGP): spec, init and the golden encoder.

Port of ``palettenerf_tpu/ops/hashgrid.py``. Construction rules (``HashGridSpec.build``)
are the same integer/float arithmetic, so offsets and resolutions match exactly.
``hashgrid_encode`` is the plain reference (autograd through gather); the trained path
uses ``ops/hashgrid_fast.py``.

``gridtype="hash_xadd"`` (a hash of the JAX package, no reference analog) hashes
``x + (y * pi1 ^ z * pi2)``: the x-neighbour of a row is the next row of its level.

Hashing: the JAX code hashes in ``uint32`` with wraparound. PyTorch has little uint32
arithmetic, so indices are computed in int64 and masked with ``& 0xFFFFFFFF`` after each
multiply (XOR of two masked values stays in range); the result matches bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

PRIMES = (1, 2654435761, 805459861)  # gridencoder.cu:42
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class HashGridSpec:
    """Static description of a hash-grid encoder."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    per_level_scale: float = 2.0
    gridtype: str = "hash"  # "hash" | "tiled" | "hash_xadd"
    align_corners: bool = False
    offsets: Tuple[int, ...] = ()
    resolutions: Tuple[int, ...] = ()

    @classmethod
    def build(
        cls,
        input_dim: int = 3,
        num_levels: int = 16,
        level_dim: int = 2,
        base_resolution: int = 16,
        log2_hashmap_size: int = 19,
        desired_resolution: Optional[float] = 2048,
        per_level_scale: float = 2.0,
        gridtype: str = "hash",
        align_corners: bool = False,
    ) -> "HashGridSpec":
        if gridtype not in ("hash", "tiled", "hash_xadd"):
            raise ValueError(f"unknown gridtype {gridtype!r} (hash | tiled | hash_xadd)")
        if desired_resolution is not None:
            per_level_scale = float(
                2.0 ** (math.log2(desired_resolution / base_resolution) / (num_levels - 1))
            )
        max_params = 2 ** log2_hashmap_size
        offsets = [0]
        resolutions = []
        off = 0
        for lvl in range(num_levels):
            res = int(math.ceil(base_resolution * per_level_scale ** lvl))
            resolutions.append(res)
            side = res if align_corners else res + 1
            params_in_level = min(max_params, side ** input_dim)
            params_in_level = int(math.ceil(params_in_level / 8) * 8)
            off += params_in_level
            offsets.append(off)
        return cls(
            input_dim=input_dim,
            num_levels=num_levels,
            level_dim=level_dim,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            per_level_scale=per_level_scale,
            gridtype=gridtype,
            align_corners=align_corners,
            offsets=tuple(offsets),
            resolutions=tuple(resolutions),
        )

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def total_params(self) -> int:
        return self.offsets[-1]

    def level_scale(self, lvl: int) -> float:
        # gridencoder.cu:125 — scale = exp2(level * log2(pls)) * H - 1
        return self.base_resolution * self.per_level_scale ** lvl - 1.0

    def level_layout(self, lvl: int):
        """(hashmap_size, per-dim strides with None past the overflow, hashed?)."""
        size = self.offsets[lvl + 1] - self.offsets[lvl]
        side = self.resolutions[lvl] + (0 if self.align_corners else 1)
        strides, s = [], 1
        for _ in range(self.input_dim):
            strides.append(s if s <= size else None)
            s *= side
        return size, strides, s > size and self.gridtype in ("hash", "hash_xadd")


def init_hashgrid(spec: HashGridSpec, generator: torch.Generator,
                  device="cpu", dtype=torch.float32) -> torch.Tensor:
    """Uniform(-1e-4, 1e-4) table init (grid.py:131-133)."""
    t = torch.empty((spec.total_params, spec.level_dim), dtype=dtype, device=device)
    return t.uniform_(-1e-4, 1e-4, generator=generator)


def corner_index(spec: HashGridSpec, lvl: int, pg: torch.Tensor) -> torch.Tensor:
    """Level-local table index (int64) of integer grid coords pg [..., D] at ``lvl``
    (get_grid_index, gridencoder.cu:55-72)."""
    size, strides, hashed = spec.level_layout(lvl)
    pg = pg.to(torch.int64) & _U32
    index = torch.zeros(pg.shape[:-1], dtype=torch.int64, device=pg.device)
    if hashed:
        # hash_xadd: x enters additively, so corner (x + 1, y, z) is row index + 1 (mod
        # size) and the two x-corners of a cell form one overlapped pair row
        xadd = spec.gridtype == "hash_xadd"
        for d in range(1 if xadd else 0, spec.input_dim):
            index = index ^ ((pg[..., d] * (PRIMES[d] & _U32)) & _U32)
        if xadd:
            index = (index + pg[..., 0]) & _U32
    else:
        for d, st in enumerate(strides):
            if st is not None:
                index = (index + pg[..., d] * st) & _U32
    return index % size


def hashgrid_encode(table: torch.Tensor, x01: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Golden encoder: table [total, C]; x01 [..., D] in [0, 1] -> [..., L*C]
    (level-major per point). Inputs outside [0, 1] encode to zeros."""
    D, C = spec.input_dim, spec.level_dim
    lead = x01.shape[:-1]
    x = x01.reshape(-1, D).to(torch.float32)
    M = x.shape[0]
    oob = ((x < 0.0) | (x > 1.0)).any(-1)
    outs = []
    for lvl in range(spec.num_levels):
        scale = torch.tensor(spec.level_scale(lvl), dtype=torch.float32, device=x.device)
        pos = x * scale + (0.0 if spec.align_corners else 0.5)
        pg0 = torch.floor(pos)
        frac = pos - pg0
        pg0 = pg0.to(torch.int64)
        level_table = table[spec.offsets[lvl]:spec.offsets[lvl + 1]]
        acc = torch.zeros((M, C), dtype=table.dtype, device=table.device)
        for corner in range(2 ** D):
            bits = [(corner >> d) & 1 for d in range(D)]
            pg = pg0 + torch.tensor(bits, dtype=torch.int64, device=x.device)
            w = torch.ones((M,), dtype=torch.float32, device=x.device)
            for d in range(D):
                w = w * (frac[:, d] if bits[d] else 1.0 - frac[:, d])
            acc = acc + level_table[corner_index(spec, lvl, pg)] * w[:, None].to(table.dtype)
        outs.append(acc)
    out = torch.cat(outs, dim=-1)
    out = torch.where(oob[:, None], torch.zeros((), dtype=out.dtype, device=out.device), out)
    return out.reshape(*lead, spec.output_dim)
