"""Frequency (sin/cos) positional encoding.

Port of ``palettenerf_tpu/ops/freq.py`` (reference ``freqencoder/src/freqencoder.cu:30-94``).
Output layout of the CUDA version: the input first, then per frequency [sin, cos] of the
whole input vector: ``[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...]``.
"""

from __future__ import annotations

import torch


def freq_encode(x: torch.Tensor, degree: int = 6) -> torch.Tensor:
    """x: [..., D] -> [..., D * (1 + 2*degree)]."""
    out = [x]
    for i in range(degree):
        s = x * (2.0 ** i)
        out += [torch.sin(s), torch.cos(s)]
    return torch.cat(out, dim=-1)


def freq_output_dim(input_dim: int, degree: int) -> int:
    return input_dim * (1 + 2 * degree)
