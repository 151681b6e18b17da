"""Evaluation metrics: PSNR, SSIM, LPIPS, the random-feature rLPIPS, and the palette
Sparsity / TV meters.

Port of ``palettenerf_tpu/train/metrics.py``. Meter API as the reference
(``nerf/utils.py:220-330``): ``clear`` / ``update`` / ``measure`` / ``report``. PSNR and
SSIM are NumPy; SSIM is the standard Wang et al. windowed formulation (11x11 Gaussian,
sigma 1.5, K1/K2 = 0.01/0.03). ``LPIPSMeter`` needs the pretrained ``lpips`` package and
reports NaN without it, as the JAX meter does. ``rlpips_distance`` is the LPIPS recipe
over an AlexNet-shaped stack of random convolutions (``make_rlpips_kernels``): the
differentiable patch loss of the stage-1 trainer (``--patch_size > 1 --lambda_lpips``)
and ``RLPIPSMeter``. Palette-stage meters (``palette/utils.py:52-114``): SparsityMeter =
mean over foreground pixels of the L1/L2 ratio of the per-pixel basis weights; TVMeter =
total variation of the basis accumulation maps x100. Both carry ``basis_metric = True``,
so eval feeds them ``basis_acc`` (palette/utils.py:826-828).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


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


class LPIPSMeter(_MeterBase):
    """Perceptual metric of the pretrained ``lpips`` package (nerf/utils.py:256-290);
    without that package it reports NaN rather than failing, as the JAX meter does."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        self.net = net
        self.name = f"LPIPS ({net})"
        try:
            import lpips

            self._fn = lpips.LPIPS(net=net).eval()
        except Exception:
            self._fn = None

    def update(self, preds, truths):
        if self._fn is None:
            return  # measure() reports nan
        p = torch.from_numpy(np.asarray(preds)).permute(0, 3, 1, 2).float()
        g = torch.from_numpy(np.asarray(truths)).permute(0, 3, 1, 2).float()
        with torch.no_grad():
            self.V += float(self._fn(g, p, normalize=True).item())
        self.N += 1

    def measure(self) -> float:
        if self._fn is None or self.N == 0:
            return float("nan")
        return super().measure()


# AlexNet-shaped random feature pyramid: (out_channels, kernel, stride)
_RLPIPS_TOPOLOGY = ((64, 11, 4), (192, 5, 2), (384, 3, 2), (256, 3, 2), (256, 3, 2))


def make_rlpips_kernels(seed: int = 0, device="cpu"):
    """The random conv stack of ``rlpips_distance``: per stage (w [O, I, k, k], b [O]),
    He-init weights and 0.2 N(0, 1) biases (the biases make the stack affine, so the
    per-pixel unit normalisation does not cancel global contrast changes). Drawn on the
    host from a ``torch.Generator`` seeded with ``seed``, then moved to ``device``, so
    every device gets the same stack. The JAX package draws its own from ``jax.random``:
    scores compare across runs of the port only."""
    gen = torch.Generator().manual_seed(seed)
    kernels, c_in = [], 3
    for c_out, k, _s in _RLPIPS_TOPOLOGY:
        w = torch.randn((c_out, c_in, k, k), generator=gen) * math.sqrt(2.0 / (c_in * k * k))
        b = torch.randn((c_out,), generator=gen) * 0.2
        kernels.append((w.to(device), b.to(device)))
        c_in = c_out
    return kernels


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Pad NCHW x as XLA's "SAME" for kernel k at stride s: ceil(size / s) outputs, the
    total padding split with the smaller half before (asymmetric at stride > 1)."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):  # F.pad takes the last dimension first
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def rlpips_distance(kernels, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Differentiable random-feature perceptual distance of p, g [B, H, W, 3] in [0, 1]:
    per conv stage, each pixel's channel vector unit-normalised, the squared difference
    summed over channels and averaged over pixels; summed over stages, averaged over the
    batch. ``kernels``: ``make_rlpips_kernels``'s (or arrays of the same shapes)."""
    ks = [(torch.as_tensor(w, device=p.device), torch.as_tensor(b, device=p.device))
          for w, b in kernels]

    def feats(x):
        h = x.permute(0, 3, 1, 2) * 2.0 - 1.0  # NCHW in [-1, 1]
        out = []
        for (w, b), (_c, k, s) in zip(ks, _RLPIPS_TOPOLOGY):
            h = torch.relu(F.conv2d(_same_pad(h, k, s), w, stride=s) + b[None, :, None, None])
            out.append(h)
        return out

    total = 0.0
    for fp, fg in zip(feats(p), feats(g)):
        fp = fp / (torch.linalg.vector_norm(fp, dim=1, keepdim=True) + 1e-10)
        fg = fg / (torch.linalg.vector_norm(fg, dim=1, keepdim=True) + 1e-10)
        total = total + ((fp - fg) ** 2).sum(1).mean((-2, -1))
    return total.mean()


class RLPIPSMeter(_MeterBase):
    """``rlpips_distance`` with the stack of ``make_rlpips_kernels(seed)`` as a meter, on
    ``device``: a proxy of LPIPS that needs no pretrained weights (random-feature
    perceptual distances, Amir & Weiss 2021). Its scores compare with its own only."""

    name = "rLPIPS"

    def __init__(self, seed: int = 0, device="cpu"):
        super().__init__()
        self.device = torch.device(device)
        self._kernels = make_rlpips_kernels(seed, self.device)

    def update(self, preds, truths):
        p = torch.as_tensor(np.asarray(preds, np.float32), device=self.device)
        g = torch.as_tensor(np.asarray(truths, np.float32), device=self.device)
        if p.ndim == 3:
            p, g = p[None], g[None]
        with torch.no_grad():
            self.V += float(rlpips_distance(self._kernels, p, g))
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
