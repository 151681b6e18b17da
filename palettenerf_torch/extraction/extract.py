"""RGBXY palette extraction orchestrator.

The port's own copy of ``palettenerf_tpu/extraction/extract.py`` (reference
``palette/utils.py:167-254``, palette_extraction): coarse 2^3-bin histogram thresholded
at tau -> K, weighted k-means on the fine 2^5-bin histogram, hull simplification to the
palette, then Tan18 star-tetra weights on the 32^3 bin-center grid ->
``hist_weights.npz`` [32,32,32,P] + ``palette.npz``.

Two things differ from the JAX package's file: the weighted k-means is written out here
(``weighted_lloyd``, scikit-learn's Lloyd iteration from given centers, in its float32
arithmetic, so that the package needs no scikit-learn), and the swatch strip is written with the port's own PNG
writer.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..data.png import write_png
from .histogram import compute_rgb_histogram
from .hull import hull_simplification
from .tan18 import star_tetra_weights


def _assign(x: np.ndarray, centers: np.ndarray):
    """Nearest center of every point -> (labels [N], |c|^2 - 2 x.c [N]: the squared
    distance less |x|^2), in the arithmetic of scikit-learn's Lloyd step."""
    d = (centers * centers).sum(1)[None, :] - 2.0 * (x @ centers.T)
    labels = d.argmin(1)
    return labels, d[np.arange(len(x)), labels]


def weighted_lloyd(points: np.ndarray, init: np.ndarray, sample_weight: np.ndarray,
                   tol: float = 1e-4, max_iter: int = 300):
    """Weighted Lloyd iteration from the centers ``init`` [K, D] -> (centers, labels).

    What ``sklearn.cluster.KMeans(init=init, n_init=1)`` runs: assign every point to its
    nearest center, move each center to the weighted mean of its points, stop when the
    labels repeat or the summed squared center shift is at most ``tol`` times the mean
    per-dimension variance of the points. A cluster left empty takes the point farthest
    from its own center (out of that center's sum), as scikit-learn relocates it.

    The arithmetic is scikit-learn's too: float32 (the histogram's bin centers are),
    points and centers shifted by the points' mean, distances as |c|^2 - 2 x.c. The bin
    centers lie on a lattice, where many points are exactly as far from one center as
    from another; which one such a point goes to is decided by the rounding of that
    expression, and the palette follows it.
    """
    x = np.asarray(points, np.float32)
    mean = x.mean(axis=0)
    limit = tol * float(np.mean(np.var(x, axis=0)))
    x = x - mean
    w = np.asarray(sample_weight, np.float32)
    centers = np.asarray(init, np.float32) - mean
    K = len(centers)
    sq_norm = (x * x).sum(1)
    labels = np.full(len(x), -1)
    converged = False
    for _ in range(max_iter):
        old_labels = labels
        labels, d = _assign(x, centers)
        sums = np.zeros_like(centers)
        np.add.at(sums, labels, x * w[:, None])
        mass = np.bincount(labels, weights=w, minlength=K).astype(np.float32)
        empty = np.flatnonzero(mass == 0)
        for k, far in zip(empty, np.argsort(-(d + sq_norm))[:len(empty)]):
            sums[labels[far]] -= x[far] * w[far]
            mass[labels[far]] -= w[far]
            sums[k], mass[k] = x[far] * w[far], w[far]
        new = sums / np.maximum(mass, np.float32(1e-30))[:, None]
        shift = float(((new - centers) ** 2).sum())
        centers = new
        if np.array_equal(labels, old_labels):
            converged = True
            break
        if shift <= limit:
            break
    if not converged:
        labels = _assign(x, centers)[0]
    return (centers + mean).astype(np.float64), labels


def run_kmeans(n_clusters: int, points: np.ndarray, init: np.ndarray, sample_weight: np.ndarray):
    """Weighted kmeans, clusters sorted by total weight desc (palette/utils.py:148-165)."""
    centers, labels = weighted_lloyd(points, init, sample_weight)
    w = np.array([sample_weight[labels == i].sum() for i in range(n_clusters)])
    order = np.argsort(-w)
    return centers[order], w[order]


def save_palette_image(palette_rgb: np.ndarray, path: str, cell: int = 50):
    """Palette swatch strip (get_bigger_palette_to_show analog)."""
    img = np.ones((cell, len(palette_rgb) * cell, 3))
    for i, c in enumerate(palette_rgb):
        img[:, i * cell:(i + 1) * cell] = c
    write_png(path, (img * 255).round().clip(0, 255).astype(np.uint8))


def write_palette_txt(palette_rgb: np.ndarray, path: str):
    lines = [f"{c[0]} {c[1]} {c[2]}" for c in palette_rgb]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def palette_extraction(
    inputs: dict,
    output_dir: str,
    tau: float = 8e-3,
    palette_size: Optional[int] = None,
    normalize_input: bool = False,
    error_thres: float = 5.0 / 255.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """inputs = {'colors': [N,3] in [0,1]}; writes palette.npz + hist_weights.npz.

    Returns (palette_rgb [P,3], hist_weights [32,32,32,P]). The histograms and the
    point-triangle distances run in the C++ kernels of ``native/``, the JAX package's
    default path.
    """
    if palette_size is not None and palette_size < 4:
        raise ValueError(f"palette_size {palette_size}: a hull in rgb has at least 4 vertices")
    os.makedirs(output_dir, exist_ok=True)
    prefix = os.path.join(output_dir, "extract")

    colors = np.asarray(inputs["colors"], np.float32).reshape(-1, 3)
    weights = np.ones(len(colors), np.float32)

    # coarse histogram -> K init centers
    bw_c, bc_c = compute_rgb_histogram(colors, weights, bits_per_channel=3)
    total = bw_c.sum()
    bw_c = bw_c / total
    keep = bw_c > tau
    bw_c, bc_c = bw_c[keep], bc_c[keep]

    # fine histogram -> weighted points
    bw_f, bc_f = compute_rgb_histogram(colors, weights, bits_per_channel=5)
    nz = bw_f > 0
    bw_f_nz = bw_f[nz] / total
    bc_f_nz = bc_f[nz]

    centers, center_weights = run_kmeans(len(bw_c), bc_f_nz, bc_c, bw_f_nz)

    palette_rgb = hull_simplification(
        centers.astype(np.float64),
        pixel_counts=center_weights,
        error_thres=error_thres,
        target_size=palette_size,
    )

    # per-bin mixing weights over the full 32^3 grid
    hist_rgb = bc_f.astype(np.float64)  # all bin centers, including empty
    if normalize_input:
        hist_rgb = hist_rgb + 0.05
        hist_rgb = hist_rgb / np.linalg.norm(hist_rgb, axis=-1, keepdims=True)
    hist_weights = star_tetra_weights(hist_rgb, palette_rgb, order=0)
    hist_weights = hist_weights.reshape(32, 32, 32, palette_rgb.shape[0])

    save_palette_image(palette_rgb, prefix + "-palette.png")
    write_palette_txt(palette_rgb, prefix + "-palette.txt")
    np.savez(os.path.join(output_dir, "palette.npz"), palette=palette_rgb)
    np.savez(os.path.join(output_dir, "hist_weights.npz"), hist_weights=hist_weights)
    return palette_rgb, hist_weights
