"""Palette-stage dataset provider.

Port of ``palettenerf_tpu/data/palette_provider.py`` (reference ``palette/provider.py``)
on the port's ``NeRFDataset``:

- ``type='video'`` loads ``transforms_video.json`` poses whose ``file_path`` doesn't
  exist -> poses only, no images (:152,198,246); ``type='traintest'`` (the training
  views without ray sampling, which extraction renders) is the base class's.
- LSeg feature maps from ``<root>/lseg_feature/<img>.npy`` when ``pred_clip``,
  bilinear-resized to the frame size (``bilinear_resize``: what ``cv2.resize`` computes
  with ``INTER_LINEAR``, without cv2) and gathered per ray in ``collate`` (:235-238,
  :272-283, :383-403).
"""

from __future__ import annotations

import json
import os

import numpy as np

from .provider import NeRFDataset


def _taps(n_src: int, n_dst: int):
    """Source taps of a bilinear resize with pixel centers at half integers."""
    src = (np.arange(n_dst, dtype=np.float64) + 0.5) * (n_src / n_dst) - 0.5
    i0 = np.floor(src).astype(np.int64)
    f = (src - i0).astype(np.float32)
    return np.clip(i0, 0, n_src - 1), np.clip(i0 + 1, 0, n_src - 1), f


def bilinear_resize(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """float [h, w, C] -> [H, W, C]; edge pixels are replicated outside the image."""
    img = np.asarray(img, np.float32)
    y0, y1, fy = _taps(img.shape[0], H)
    x0, x1, fx = _taps(img.shape[1], W)
    rows = img[y0] * (1.0 - fy)[:, None, None] + img[y1] * fy[:, None, None]
    return rows[:, x0] * (1.0 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]


class PaletteDataset(NeRFDataset):
    def __init__(self, opt, type: str = "train", downscale: int = 1, n_test: int = 10):
        super().__init__(opt, type=type, downscale=downscale, n_test=n_test)
        self.feat_images = None
        if getattr(opt, "pred_clip", False) and type in ("train", "trainval", "traintest", "all"):
            self.feat_images = self._load_lseg_features()

    def _load_transform(self, type: str) -> dict:
        if type == "video":
            with open(os.path.join(self.root_path, "transforms_video.json")) as f:
                return json.load(f)
        return super()._load_transform(type)

    def _load_lseg_features(self):
        """Per-frame LSeg features [B, H, W, clip_dim] (palette/provider.py:272-283), or
        None when the dump (made offline by the third-party LSeg tool) is not there."""
        feat_dir = os.path.join(self.root_path, "lseg_feature")
        suffix = getattr(self.opt, "ablation_name", "")
        if suffix:
            feat_dir = feat_dir + "_" + suffix
        if not os.path.isdir(feat_dir):
            return None
        feats = []
        for f in super()._load_transform(self.type)["frames"]:
            base = os.path.splitext(os.path.basename(f["file_path"]))[0]
            p = os.path.join(feat_dir, base + ".npy")
            if not os.path.exists(p):
                return None
            feat = np.load(p)  # [h, w, C]
            if feat.shape[0] != self.H or feat.shape[1] != self.W:
                feat = bilinear_resize(feat, self.H, self.W)
            feats.append(feat.astype(np.float32))
        return np.stack(feats)

    def _collate(self, index: int) -> dict:
        out = super()._collate(index)
        if self.feat_images is not None and "inds" in out:
            C = self.feat_images.shape[-1]
            out["feat_images"] = self.feat_images[index].reshape(-1, C)[out["inds"]]
        elif self.feat_images is not None and "images" in out:
            out["feat_images"] = self.feat_images[index]
        return out
