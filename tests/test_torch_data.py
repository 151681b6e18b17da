"""The port's data layer: the zlib/NumPy PNG reader against cv2 (test-only here),
the provider against the JAX package's provider, and on-device ray generation
against the numpy version."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from palettenerf_tpu.config import Config as JConfig
from palettenerf_tpu.data.provider import NeRFDataset as JDataset
from palettenerf_torch.config import Config as TConfig
from palettenerf_torch.data import png
from palettenerf_torch.data.provider import NeRFDataset as TDataset, area_resize
from palettenerf_torch.data.rays import gen_rays, gen_rays_torch
from synthetic import make_sphere_dataset
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cv2_rgb(path):
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][: img.shape[-1]]] if img.shape[-1] == 4 else img[..., ::-1]
    return img


@pytest.mark.parametrize("name", ["train/r_0.png", "train/r_57.png", "val/r_3.png"])
def test_png_matches_cv2_on_proc_toys(name):
    path = os.path.join(REPO, "data_proc", "proc_toys", name)
    got = png.read_png(path)
    assert got.shape == (800, 800, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _cv2_rgb(path))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _write_png_all_filters(path, img):
    """Encoder whose row r uses filter r % 5 (None, Sub, Up, Average, Paeth)."""
    H, W, C = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[C]
    rows = img.reshape(H, W * C).astype(np.int32)
    out = []
    for r in range(H):
        cur = rows[r]
        prev = rows[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(C, np.int32), cur[:-C]])
        upleft = np.concatenate([np.zeros(C, np.int32), prev[:-C]])
        f = r % 5
        pred = [0 * cur, left, prev, (left + prev) >> 1, _paeth(left, prev, upleft)][f]
        out.append(np.concatenate([[f], (cur - pred) & 0xFF]).astype(np.uint8))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_all_row_filters(tmp_path, channels):
    img = np.random.default_rng(channels).integers(0, 256, (23, 17, channels)).astype(np.uint8)
    img[5:9] = img[4:5]  # smooth runs so every predictor matters
    path = str(tmp_path / "f.png")
    _write_png_all_filters(path, img)
    got = png.read_png(path)
    np.testing.assert_array_equal(got, img)
    ref = _cv2_rgb(path)
    np.testing.assert_array_equal(got.reshape(ref.shape), ref)


def test_write_png_roundtrip(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (9, 11, 3)).astype(np.uint8)
    path = str(tmp_path / "w.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(_cv2_rgb(path), img)


def test_png_16_bit_matches_cv2(tmp_path):
    """16-bit PNGs read as cv2 reads them: uint16, channels in RGB(A) order."""
    rng = np.random.default_rng(16)
    for c in (1, 3, 4):
        img = rng.integers(0, 65536, (5, 7, c)).astype(np.uint16)
        path = str(tmp_path / f"d16_{c}.png")
        cv2.imwrite(path, img if c == 1 else img[..., [2, 1, 0, 3][:c]])
        got = png.read_png(path)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(got.reshape(_cv2_rgb(path).shape), _cv2_rgb(path))


def test_area_downscale_matches_cv2():
    """``area_resize`` against cv2's INTER_AREA: an integer factor (2) and a fractional
    one (24 -> 10 rows), bit for bit."""
    img = np.random.default_rng(1).integers(0, 256, (24, 16, 4)).astype(np.uint8)
    for H, W in [(12, 8), (10, 8)]:
        ref = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
        got = area_resize(img, H, W)
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def sphere(tmp_path_factory):
    return make_sphere_dataset(str(tmp_path_factory.mktemp("sph")), n_train=4, n_val=1,
                               n_test=1, H=32, W=32)


@pytest.mark.parametrize("split,downscale", [("train", 1), ("val", 2)])
def test_provider_matches_jax_provider(sphere, split, downscale):
    kw = dict(path=sphere, scale=0.5, bound=1.0, num_rays=64)
    j = JDataset(JConfig(**kw), type=split, downscale=downscale)
    t = TDataset(TConfig(**kw), type=split, downscale=downscale)
    assert (t.H, t.W) == (j.H, j.W)
    np.testing.assert_array_equal(t.poses, j.poses)
    np.testing.assert_allclose(t.intrinsics, j.intrinsics)
    np.testing.assert_allclose(t.images, j.images, rtol=0, atol=1.5 / 255)


def test_gen_rays_torch_matches_numpy():
    rng = np.random.default_rng(2)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    pose[:3, 3] = rng.normal(size=3)
    intr = (40.0, 42.0, 16.0, 15.5)
    inds = rng.integers(0, 32 * 30, 500)
    ro, rd = gen_rays(pose, intr, 30, 32, inds)
    to, td = gen_rays_torch(torch.from_numpy(pose), intr, 30, 32, torch.from_numpy(inds))
    np.testing.assert_allclose(to.numpy(), ro, rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), rd, rtol=0, atol=1e-6)
