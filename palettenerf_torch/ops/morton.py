"""Morton (Z-order) 3D encode and decode.

Port of ``palettenerf_tpu/ops/morton.py`` (reference ``raymarching.cu:59-84``,
``__expand_bits`` / ``__morton3D`` / ``__morton3D_invert``). The JAX code multiplies in
``uint32`` with wraparound; PyTorch has little ``uint32`` arithmetic, so this works in
``int64`` and masks with ``0xFFFFFFFF`` after each multiply: the results are the same
bits. Indices come back as ``int64`` holding the uint32 value. No product path calls it
(the occupancy grid is linear).
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.int64) & _U32
    v = ((v * 0x00010001) & _U32) & 0xFF0000FF
    v = ((v * 0x00000101) & _U32) & 0x0F00F00F
    v = ((v * 0x00000011) & _U32) & 0xC30C30C3
    v = ((v * 0x00000005) & _U32) & 0x49249249
    return v


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """coords [..., 3] integers in [0, 1024) -> [...] Z-order index (uint32 value in
    int64)."""
    x = _expand_bits(coords[..., 0])
    y = _expand_bits(coords[..., 1])
    z = _expand_bits(coords[..., 2])
    return (x | (y << 1) | (z << 2)) & _U32


def _compact_bits(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3d_invert(indices: torch.Tensor) -> torch.Tensor:
    """indices [...] (uint32 values) -> [..., 3] int32 coordinates."""
    i = indices.to(torch.int64) & _U32
    return torch.stack([_compact_bits(i), _compact_bits(i >> 1), _compact_bits(i >> 2)],
                       -1).to(torch.int32)
