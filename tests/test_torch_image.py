"""The port's image input against cv2 (test-only here): the native JPEG decoder
(``palettenerf_torch/native/image_native.cpp``) on images ``cv2.imencode`` makes, the PNG
reader on every depth, colour type, tRNS and Adam7 (the files cv2 cannot write come from
this module's own encoder), ``area_resize`` against ``cv2.resize(INTER_AREA)``, and the
committed fixture ``data_proc/proc_toys_llff`` against its recorded cv2 digests.

Every case is bit-exact: no mode of the decoder, the reader or the resize differs from
cv2 here (largest difference 0)."""

import hashlib
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from palettenerf_torch import native
from palettenerf_torch.data.image import read_image
from palettenerf_torch.data.png import _ADAM7, read_png
from palettenerf_torch.data.provider import area_resize
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "data_proc", "proc_toys_llff")

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
SIZES = [(1, 1), (9, 17), (250, 333)]  # (H, W): 1x1, 17x9 and 333x250 pixels


def _rgb(img):
    """cv2's BGR(A) / 2D gray -> the port's RGB(A) / [H, W, 1]."""
    if img.ndim == 2:
        return img[..., None]
    return img[..., [2, 1, 0, 3][: img.shape[-1]]] if img.shape[-1] == 4 else img[..., ::-1]


def _photo(rng, h, w, c):
    """Smooth colour fields with grain: a camera-like image with every AC band busy."""
    base = rng.integers(0, 256, (h // 8 + 3, w // 8 + 3, c)).astype(np.float32)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC).reshape(h, w, c)
    return np.clip(img + rng.normal(0, 10, img.shape), 0, 255).astype(np.uint8)


def _jpeg(img, quality=95, progressive=0, restart=0, sampling="420"):
    ok, enc = cv2.imencode(".jpg", img[..., 0] if img.shape[-1] == 1 else img[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, quality,
                            cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
                            cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    assert ok
    return enc.tobytes()


def _cv2_decode(data: bytes):
    return _rgb(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("quality", [50, 95, 100])
@pytest.mark.parametrize("progressive", [0, 1])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "411", "440", "gray"])
def test_jpeg_matches_cv2(sampling, progressive, quality):
    """Bit-exact over sizes 1x1, 17x9 and 333x250, each without and with a restart
    interval (3 MCUs)."""
    rng = np.random.default_rng(quality + 7 * progressive)
    for (h, w) in SIZES:
        img = _photo(rng, h, w, 1 if sampling == "gray" else 3)
        for restart in (0, 3):
            data = _jpeg(img, quality, progressive, restart,
                         "444" if sampling == "gray" else sampling)
            ref = _cv2_decode(data)
            got = native.decode_jpeg(data)
            assert got.shape == ref.shape and got.dtype == np.uint8, (h, w, restart)
            np.testing.assert_array_equal(got, ref, err_msg=f"{h}x{w} restart {restart}")


def test_jpeg_ignores_exif_orientation():
    """IMREAD_UNCHANGED ignores the EXIF orientation tag (IMREAD_COLOR would rotate):
    the decoder does too."""
    data = _jpeg(_photo(np.random.default_rng(3), 16, 24, 3))
    ifd = struct.pack(">H", 1) + struct.pack(">HHII", 0x0112, 3, 1, 6 << 16) + b"\0" * 4
    exif = b"Exif\0\0" + b"MM\0\x2a" + struct.pack(">I", 8) + ifd
    data = data[:2] + b"\xff\xe1" + struct.pack(">H", len(exif) + 2) + exif + data[2:]
    ref = _cv2_decode(data)
    assert ref.shape == (16, 24, 3)
    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR).shape == (24, 16, 3)
    np.testing.assert_array_equal(native.decode_jpeg(data), ref)


def _sof_at(data: bytes) -> int:
    pos = 2
    while data[pos + 1] not in (0xC0, 0xC2):
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    return pos


def _set_byte(data: bytes, pos: int, value: int) -> bytes:
    return data[:pos] + bytes([value]) + data[pos + 1:]


def _scans_cut(data: bytes, keep: int) -> bytes:
    """A progressive stream cut after its first ``keep`` scans, with an EOI after them."""
    pos, seen = 2, 0
    while True:
        marker = data[pos + 1]
        if marker == 0xDA:
            if seen == keep:
                return data[:pos] + b"\xff\xd9"
            seen += 1
            pos += 2
            while not (data[pos] == 0xFF and data[pos + 1] not in (0x00,) and
                       not 0xD0 <= data[pos + 1] <= 0xD7):
                pos += 1
        else:
            pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]


REFUSED = {
    "truncated": (lambda d: d[: len(d) // 2], "truncated|runs out"),
    "no EOI": (lambda d: d[:-2], "truncated|no marker"),
    "arithmetic": (lambda d: _set_byte(d, _sof_at(d) + 1, 0xC9), "arithmetic coding"),
    "12-bit": (lambda d: _set_byte(d, _sof_at(d) + 4, 12), "12-bit samples"),
    "lossless": (lambda d: _set_byte(d, _sof_at(d) + 1, 0xC3), "lossless"),
    "hierarchical": (lambda d: _set_byte(d, _sof_at(d) + 1, 0xC5), "hierarchical"),
    "CMYK": (lambda d: _set_byte(d, _sof_at(d) + 9, 4), "CMYK"),
    "bad restart marker": (lambda d: d.replace(b"\xff\xd1", b"\xff\xd5", 1), "restart marker"),
    "incomplete progression": (lambda d: _scans_cut(d, 3), "incomplete progressive"),
    "not a JPEG": (lambda d: b"\x00" + d[1:], "not a JPEG"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_jpeg_refuses(case):
    img = _photo(np.random.default_rng(5), 64, 80, 3)
    data = _jpeg(img, restart=2, progressive=int(case == "incomplete progression"))
    cut, message = REFUSED[case]
    with pytest.raises(ValueError, match=f"where.jpg: .*({message})"):
        native.decode_jpeg(cut(data), "where.jpg")


def test_jpeg_corrupt_streams_raise_or_decode():
    """Random byte changes and cuts in baseline, progressive and restart streams: each one
    either decodes or raises ValueError; none crashes the process."""
    rng = np.random.default_rng(11)
    img = _photo(rng, 30, 40, 3)
    bases = [_jpeg(img, 90, p, r, s) for p in (0, 1) for r in (0, 2) for s in ("420", "444")]
    refused = 0
    for it in range(1500):
        data = bytearray(bases[it % len(bases)])
        for _ in range(int(rng.integers(1, 6))):
            data[int(rng.integers(2, len(data)))] = int(rng.integers(0, 256))
        if it % 7 == 0:
            data = data[: int(rng.integers(2, len(data)))]
        try:
            out = native.decode_jpeg(bytes(data))
        except ValueError:
            refused += 1
            continue
        assert out.dtype == np.uint8 and out.ndim == 3
    assert 0 < refused < 1500


# ---------------------------------------------------------------------------------- PNG

def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _pack_rows(samples, depth):
    """[h, w * spp] ints -> the rows' bytes at ``depth`` bits per sample."""
    h = samples.shape[0]
    if depth == 16:
        return np.stack([samples >> 8, samples & 255], -1).reshape(h, -1)
    if depth == 8:
        return samples
    per = 8 // depth
    pad = (-samples.shape[1]) % per
    s = np.concatenate([samples, np.zeros((h, pad), samples.dtype)], 1).reshape(h, -1, per)
    return (s << np.arange(8 - depth, -1, -depth)).sum(-1)


def _filtered(rows, bpp):
    """Row r takes filter r % 5 (None, Sub, Up, Average, Paeth)."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for r, cur in enumerate(rows.astype(np.int64)):
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])[: len(cur)]
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])[: len(cur)]
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        pred = [0 * cur, left, prev, (left + prev) >> 1, paeth][r % 5]
        out.append(np.concatenate([[r % 5], (cur - pred) & 255]).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def _write_png(path, samples, depth, ctype, interlace=0, plte=None, trns=None):
    """samples [H, W, samples per pixel] -> a PNG of any depth / colour type / interlace."""
    H, W, spp = samples.shape
    bpp = max(1, spp * depth // 8)

    def image(s):
        h, w, _ = s.shape
        return _filtered(_pack_rows(s.reshape(h, w * spp).astype(np.int64), depth), bpp)

    if interlace:
        raw = b"".join(image(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in _ADAM7
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = image(samples)
    body = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                                              0, 0, interlace))
    if plte is not None:
        body += _chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        body += _chunk(b"tRNS", trns)
    with open(path, "wb") as f:
        f.write(body + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
             (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype,depth", PNG_KINDS)
def test_png_matches_cv2(tmp_path, ctype, depth, interlace):
    """Each colour type and depth, without and with tRNS where the type takes one, at
    sizes that leave Adam7 passes empty (1x1, 3x2) and full (13x11): channels, dtype and
    every value as cv2 reads them."""
    rng = np.random.default_rng(16 * ctype + depth + 100 * interlace)
    spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    for (H, W), trn in [((1, 1), False), ((2, 3), True), ((13, 11), False), ((13, 11), True)]:
        if trn and ctype in (4, 6):
            continue
        plte = trns = None
        if ctype == 3:
            n = min(1 << depth, 7)
            samples = rng.integers(0, n, (H, W, 1))
            plte = rng.integers(0, 256, (n, 3))
            trns = bytes(rng.integers(0, 256, max(n - 2, 1)).astype(np.uint8)) if trn else None
        else:
            samples = rng.integers(0, 1 << depth, (H, W, spp))
            if trn:
                trns = struct.pack(">" + "H" * spp, *map(int, samples[0, 0]))
        path = str(tmp_path / f"k{H}{trn}.png")
        _write_png(path, samples, depth, ctype, interlace, plte, trns)
        ref = _rgb(cv2.imread(path, cv2.IMREAD_UNCHANGED))
        got = read_png(path)
        assert got.shape == ref.shape and got.dtype == ref.dtype, (H, W, trn)
        np.testing.assert_array_equal(got, ref, err_msg=f"{H}x{W} tRNS {trn}")
        np.testing.assert_array_equal(read_image(path), ref)


def test_read_image_dispatches_on_magic_bytes(tmp_path):
    """A JPEG named .png is read as a JPEG, a PNG named .jpg as a PNG; other bytes raise."""
    img = _photo(np.random.default_rng(9), 20, 30, 3)
    jpg_as_png = tmp_path / "photo.png"
    jpg_as_png.write_bytes(_jpeg(img))
    np.testing.assert_array_equal(read_image(str(jpg_as_png)), _cv2_decode(_jpeg(img)))
    png_as_jpg = str(tmp_path / "pixels.jpg")
    cv2.imwrite(png_as_jpg + ".png", img[..., ::-1])
    os.replace(png_as_jpg + ".png", png_as_jpg)
    np.testing.assert_array_equal(read_image(png_as_jpg), img)
    (tmp_path / "x.bmp").write_bytes(b"BM" + bytes(60))
    with pytest.raises(ValueError, match="unsupported image format"):
        read_image(str(tmp_path / "x.bmp"))


# ------------------------------------------------------------------------------- resize

@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("src,dst", [((750, 1000), (250, 333)), ((800, 800), (266, 266)),
                                     ((800, 800), (400, 400)), ((800, 800), (200, 200))])
def test_area_resize_matches_cv2(src, dst, channels):
    """The fixture's 1000x750 -> 333x250 (x fractional, y by 3), ``--extract_downscale 3``
    on proc_toys (800 -> 266, both fractional), and the integer factors 2 and 4 of cv2's
    fast path: bit-exact."""
    img = np.random.default_rng(channels).integers(0, 256, src + (channels,)).astype(np.uint8)
    ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(area_resize(img, *dst), ref)


def test_area_resize_uint16_and_refuses_enlarging():
    img = np.random.default_rng(4).integers(0, 65536, (30, 40, 3)).astype(np.uint16)
    for dst in [(11, 17), (15, 20), (10, 10)]:
        ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(area_resize(img, *dst), ref)
    with pytest.raises(ValueError, match="shrinks only"):
        area_resize(img, 31, 40)


# ------------------------------------------------------------------------------ fixture

def test_fixture_digests_match_cv2_and_the_decoder():
    """``data_proc/proc_toys_llff/decoded.json`` holds cv2's decode of every image: cv2
    here and the native decoder both reproduce it; the views take every route the
    fixture's script names (baseline and progressive 4:2:0, baseline 4:4:4, restarts)."""
    with open(os.path.join(FIXTURE, "decoded.json")) as f:
        digests = json.load(f)["sha256"]
    assert len(digests) == 32
    routes = set()
    for rel, want in digests.items():
        path = os.path.join(FIXTURE, rel)
        ref = _rgb(cv2.imread(path, cv2.IMREAD_UNCHANGED))
        assert hashlib.sha256(np.ascontiguousarray(ref).tobytes()).hexdigest() == want, rel
        got = read_image(path)
        assert got.shape == (750, 1000, 3)
        assert hashlib.sha256(got.tobytes()).hexdigest() == want, rel
        with open(path, "rb") as f:
            data = f.read()
        sof = data[_sof_at(data) + 1]
        sampling = data[_sof_at(data) + 11]
        routes.add((sof, sampling, b"\xff\xdd" in data))
    assert routes == {(0xC0, 0x22, False), (0xC2, 0x22, False), (0xC0, 0x11, False),
                      (0xC0, 0x22, True)}
    size = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(FIXTURE)
               for f in fs)
    assert size < 6 * 2 ** 20
