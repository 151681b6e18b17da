"""Palette edits: RegionEdit recoloring and the Stylizer parameters.

Port of the edit half of ``palettenerf_tpu/render/palette_renderer.py:42-131``
(reference ``palette/renderer.py:83-183``): ``RegionEdit`` per-palette HSV recolor with
optional spatial / semantic Gaussian masks, ``region_edit_delta_hsv`` (the per-basis
edit from an original and an edited palette), ``apply_region_edit`` (the per-sample
recolor of the exact renderer, the sweep's reference), and the ``StylizerParams``
that the sweep renderer applies. The palette train / eval renderers
(``render_palette_train``, ``render_palette_eval``) come with the palette trainer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.color import hsv_to_rgb, rgb_to_hsv


class RegionEdit(NamedTuple):
    """Render-time recoloring state (palette/renderer.py:83-147). The fields are host
    (numpy) arrays, read per frame by the sweep renderer; ``delta_hsv`` may also be a
    tensor. Build with ``make_region_edit``."""

    delta_hsv: object             # [P, 3]: dH (deg), S scale, V scale
    mean_xyz: np.ndarray          # [3]
    use_xyz: np.ndarray           # [] bool
    std_xyz: np.ndarray           # []
    mean_clip: np.ndarray         # [clip_dim]
    use_clip: np.ndarray          # [] bool
    std_clip: np.ndarray          # []
    weight_mode: bool = False     # visualize the mask instead of recoloring


def make_region_edit(num_basis: int, clip_dim: int = 16,
                     mean_xyz=None, std_xyz=1.0, mean_clip=None, std_clip=1.0,
                     weight_mode: bool = False) -> RegionEdit:
    dh = np.zeros((num_basis, 3), np.float32)
    dh[:, 1:] = 1.0
    return RegionEdit(
        delta_hsv=dh,
        mean_xyz=np.zeros(3, np.float32) if mean_xyz is None
        else np.asarray(mean_xyz, np.float32),
        use_xyz=np.asarray(mean_xyz is not None),
        std_xyz=np.asarray(float(std_xyz), np.float32),
        mean_clip=np.zeros(clip_dim, np.float32) if mean_clip is None
        else np.asarray(mean_clip, np.float32),
        use_clip=np.asarray(mean_clip is not None),
        std_clip=np.asarray(float(std_clip), np.float32),
        weight_mode=weight_mode,
    )


def _as_f32(a) -> torch.Tensor:
    return a.float() if torch.is_tensor(a) else torch.as_tensor(np.asarray(a, np.float32))


def region_edit_delta_hsv(rgb_orig, rgb_new) -> torch.Tensor:
    """Per-palette (dH, S-scale, V-scale) [P, 3] from original / modified palette colors
    (renderer.py:105-119)."""
    hsv_o = rgb_to_hsv(_as_f32(rgb_orig))
    hsv_n = rgb_to_hsv(_as_f32(rgb_new))
    dh = torch.remainder(hsv_n[:, 0] - hsv_o[:, 0] + 360.0, 360.0)
    ds = hsv_n[:, 1] / (hsv_o[:, 1] + 1e-9)
    dv = hsv_n[:, 2] / (hsv_o[:, 2] + 1e-9)
    return torch.stack([dh, ds, dv], -1)


def apply_region_edit(edit: RegionEdit, rgbs: torch.Tensor, xyz: torch.Tensor,
                      clip_feat: torch.Tensor) -> torch.Tensor:
    """rgbs [M, P, 3] per-sample per-basis colors; xyz [M, 3]; clip_feat [M, C].
    Returns the edited rgbs (renderer.py:121-147)."""
    dev = rgbs.device
    hsv = rgb_to_hsv(rgbs)
    w = torch.ones(rgbs.shape[:-2] + (1,), device=dev)
    if bool(edit.use_xyz):
        mean = torch.as_tensor(edit.mean_xyz, device=dev)
        w = w * torch.exp(-((xyz - mean) ** 2).sum(-1, keepdim=True) / float(edit.std_xyz))
    if bool(edit.use_clip):
        mean = torch.as_tensor(edit.mean_clip, device=dev)
        w = w * torch.exp(-((clip_feat - mean) ** 2).sum(-1, keepdim=True)
                          / float(edit.std_clip))
    if edit.weight_mode:
        return torch.broadcast_to(w[..., None], rgbs.shape) * torch.ones_like(rgbs)
    dhsv = _as_f32(edit.delta_hsv).to(dev)
    hsv_new = torch.stack([
        torch.remainder(hsv[..., 0] + dhsv[:, 0] + 360.0, 360.0),
        (hsv[..., 1] * dhsv[:, 1]).clamp_min(0.0),
        (hsv[..., 2] * dhsv[:, 2]).clamp_min(0.0),
    ], -1)
    return rgbs + w[..., None] * (hsv_to_rgb(hsv_new) - rgbs)


class StylizerParams(NamedTuple):
    """Style-transfer parameters (palette/renderer.py:151-183)."""

    dI: torch.Tensor      # [P] intensity offsets
    dP: torch.Tensor      # [1, P, 3] palette color offsets
    ddelta: torch.Tensor  # [P, 3, 3] per-palette offset transforms


def init_stylizer(num_basis: int, device="cpu") -> StylizerParams:
    return StylizerParams(
        dI=torch.zeros((num_basis,), device=device),
        dP=torch.zeros((1, num_basis, 3), device=device),
        ddelta=torch.eye(3, device=device)[None].repeat(num_basis, 1, 1),
    )
