"""Weighted RGB histogram over a uniform 2^bpc-per-channel grid.

The port's own copy of ``palettenerf_tpu/extraction/histogram.py``:
``compute_rgb_histogram`` runs the C++ kernel of ``native/``, the JAX package's default
path; ``rgb_histogram_reference`` is its plain NumPy version (the same bins and the same
summation order, so the same bits). Bin packing matches the reference
(``palette/src/bindings.cpp:40-91``): index = (r_bin << 2*bpc) | (g_bin << bpc) | b_bin
with channel values clamped to [0, 0.999]; bin centers at (bin + 0.5) / 2^bpc.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .. import native


def compute_rgb_histogram(
    colors_rgb: np.ndarray, weights: np.ndarray, bits_per_channel: int
) -> Tuple[np.ndarray, np.ndarray]:
    """colors [N,3] in [0,1], weights [N] -> (bin_weights [B], bin_centers [B,3]),
    B = 2^(3*bpc)."""
    _check(colors_rgb, bits_per_channel)
    return native.rgb_histogram_native(colors_rgb, weights, bits_per_channel)


def _check(colors_rgb: np.ndarray, bits_per_channel: int) -> None:
    if colors_rgb.ndim != 2 or colors_rgb.shape[1] != 3:
        raise ValueError(f"colors must be [N, 3], got {colors_rgb.shape}")
    if not 1 <= bits_per_channel <= 8:
        raise ValueError(f"bits_per_channel {bits_per_channel} outside 1..8")


def rgb_histogram_reference(
    colors_rgb: np.ndarray, weights: np.ndarray, bits_per_channel: int
) -> Tuple[np.ndarray, np.ndarray]:
    """``compute_rgb_histogram`` in NumPy: the native kernel's plain version."""
    _check(colors_rgb, bits_per_channel)
    bpc = bits_per_channel
    n_side = 1 << bpc
    num_bins = n_side ** 3

    c = np.clip(colors_rgb, 0.0, 0.999)
    bins = (c * n_side).astype(np.uint32)
    idx = (bins[:, 0] << (2 * bpc)) | (bins[:, 1] << bpc) | bins[:, 2]
    bin_weights = np.bincount(idx, weights=weights.astype(np.float64), minlength=num_bins)

    codes = np.arange(num_bins, dtype=np.uint32)
    r = (codes >> (2 * bpc)) & (n_side - 1)
    g = (codes >> bpc) & (n_side - 1)
    b = codes & (n_side - 1)
    centers = (np.stack([r, g, b], -1).astype(np.float32) + 0.5) / n_side
    return bin_weights, centers
