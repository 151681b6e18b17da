"""Color-space conversions (sRGB <-> linear, RGB <-> HSV).

Port of ``palettenerf_tpu/utils/color.py``. sRGB conversions mirror the reference
(``nerf/utils.py:42-49``); the HSV conversions follow the reference CUDA kernels
(``palette/src/palette.cu:46-133``): H in degrees [0, 360), S and V in **percent**
[0, 100]. ``torch.remainder`` takes the sign of the divisor, as ``jnp.mod`` does. The
planar forms work on separate channel tensors, as the sweep renderer calls them.
"""

from __future__ import annotations

import torch


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.where(x < 0.0031308, 12.92 * x,
                       1.055 * torch.pow(x.clamp_min(1e-8), 0.41666) - 0.055)


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.where(x < 0.04045, x / 12.92, torch.pow((x + 0.055) / 1.055, 2.4))


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """rgb [..., 3] in [0,1] -> hsv [..., 3], H in deg [0,360), S,V in [0,100]."""
    return torch.stack(rgb_to_hsv_planar(rgb[..., 0], rgb[..., 1], rgb[..., 2]), -1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """hsv [..., 3] (H deg, S,V percent) -> rgb [..., 3] in [0,1]."""
    return torch.stack(hsv_to_rgb_planar(hsv[..., 0], hsv[..., 1], hsv[..., 2]), -1)


def rgb_to_hsv_planar(r, g, b):
    cmax = torch.maximum(torch.maximum(r, g), b)
    cmin = torch.minimum(torch.minimum(r, g), b)
    diff = cmax - cmin
    safe = torch.where(diff == 0, 1.0, diff)

    h_r = torch.remainder(60.0 * ((g - b) / safe) + 360.0, 360.0)
    h_g = torch.remainder(60.0 * ((b - r) / safe) + 120.0 + 360.0, 360.0)
    h_b = torch.remainder(60.0 * ((r - g) / safe) + 240.0 + 360.0, 360.0)
    h = torch.where(diff == 0, 0.0,
                    torch.where(cmax == r, h_r, torch.where(cmax == g, h_g, h_b)))
    s = torch.where(cmax == 0, 0.0, diff / torch.where(cmax == 0, 1.0, cmax) * 100.0)
    v = cmax * 100.0
    return h, s, v


def hsv_to_rgb_planar(h, s, v):
    s = s / 100.0
    v = v / 100.0
    h = torch.remainder(h, 360.0) / 60.0
    i = torch.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(c0, c1, c2, c3, c4, c5):
        out = c5
        for k, c in ((4, c4), (3, c3), (2, c2), (1, c1), (0, c0)):
            out = torch.where(i == k, c, out)
        return out

    return select(v, q, p, p, t, v), select(t, v, v, q, p, p), select(p, p, t, v, v, q)
