"""Evaluation metrics: PSNR, SSIM and the palette Sparsity / TV meters (NumPy).

Port of ``palettenerf_tpu/train/metrics.py`` without the LPIPS meters. Meter API as the
reference (``nerf/utils.py:220-330``): ``clear`` / ``update`` / ``measure`` / ``report``.
SSIM is the standard Wang et al. windowed formulation (11x11 Gaussian, sigma 1.5,
K1/K2 = 0.01/0.03). Palette-stage meters (``palette/utils.py:52-114``): SparsityMeter =
mean over foreground pixels of the L1/L2 ratio of the per-pixel basis weights; TVMeter =
total variation of the basis accumulation maps x100. Both carry ``basis_metric = True``,
so eval feeds them ``basis_acc`` (palette/utils.py:826-828).
"""

from __future__ import annotations

import numpy as np


def psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    return float(-10.0 * np.log10(np.mean((pred - gt) ** 2) + 1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - size // 2
    k = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k /= k.sum()
    return np.outer(k, k)


def ssim(pred: np.ndarray, gt: np.ndarray, window_size: int = 11) -> float:
    """pred/gt [H, W, C] in [0,1]; mean SSIM over channels (valid padding)."""
    from scipy.signal import fftconvolve

    k = _gaussian_kernel(window_size)
    c1, c2 = 0.01 ** 2, 0.03 ** 2

    def filt(x):
        return np.stack(
            [fftconvolve(x[..., c], k, mode="valid") for c in range(x.shape[-1])], -1
        )

    mu_p, mu_g = filt(pred), filt(gt)
    mu_p2, mu_g2, mu_pg = mu_p ** 2, mu_g ** 2, mu_p * mu_g
    s_p = filt(pred ** 2) - mu_p2
    s_g = filt(gt ** 2) - mu_g2
    s_pg = filt(pred * gt) - mu_pg
    m = ((2 * mu_pg + c1) * (2 * s_pg + c2)) / ((mu_p2 + mu_g2 + c1) * (s_p + s_g + c2))
    return float(m.mean())


class _MeterBase:
    name = ""
    basis_metric = False

    def __init__(self):
        self.V, self.N = 0.0, 0

    def clear(self):
        self.V, self.N = 0.0, 0

    def measure(self) -> float:
        return self.V / max(self.N, 1)

    def report(self) -> str:
        return f"{self.name} = {self.measure():.6f}"


class PSNRMeter(_MeterBase):
    name = "PSNR"

    def update(self, preds, truths):
        self.V += psnr(np.asarray(preds), np.asarray(truths))
        self.N += 1


class SSIMMeter(_MeterBase):
    name = "SSIM"

    def update(self, preds, truths):
        p, t = np.asarray(preds), np.asarray(truths)
        if p.ndim == 4:  # [B, H, W, C]
            for i in range(p.shape[0]):
                self.V += ssim(p[i], t[i])
                self.N += 1
        else:
            self.V += ssim(p, t)
            self.N += 1


class SparsityMeter(_MeterBase):
    """Mean L1/L2 sparsity of per-pixel palette weights over foreground pixels
    (palette/utils.py:52-81)."""

    name = "Sparsity"
    basis_metric = True

    def update(self, basis_acc, weights_sum=None):
        w = np.asarray(basis_acc)  # [..., P]
        w = w.reshape(-1, w.shape[-1])
        if weights_sum is not None:
            fg = np.asarray(weights_sum).reshape(-1) > 0.5
            w = w[fg]
        if w.size == 0:
            return
        l1 = np.abs(w).sum(-1)
        l2 = np.sqrt((w ** 2).sum(-1)) + 1e-6
        self.V += float((l1 / l2).mean())
        self.N += 1


class TVMeter(_MeterBase):
    """Total variation of basis accumulation maps x100 (palette/utils.py:83-114)."""

    name = "TV"
    basis_metric = True

    def update(self, basis_acc, weights_sum=None):
        w = np.asarray(basis_acc)  # [H, W, P] or [B, H, W, P]
        if w.ndim == 3:
            w = w[None]
        tv = np.abs(np.diff(w, axis=1)).mean() + np.abs(np.diff(w, axis=2)).mean()
        self.V += float(tv * 100.0)
        self.N += 1
