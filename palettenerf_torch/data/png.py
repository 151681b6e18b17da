"""PNG reader/writer on ``zlib`` + NumPy (no cv2/PIL/imageio dependency).

Reads every PNG that ``cv2.imread(path, IMREAD_UNCHANGED)`` reads, and returns what it
returns, in RGB(A) channel order instead of BGR(A):

- bit depths 1, 2, 4, 8 and 16 (uint16 at 16 bits; gray below 8 bits scaled to 0..255,
  as libpng's ``png_set_expand_gray_1_2_4_to_8``);
- gray -> 1 channel (a tRNS chunk is dropped), gray + alpha -> 4 channels (the gray
  replicated), RGB -> 3 channels (4 with a tRNS colour: alpha 0 where a pixel equals it),
  palette -> 3 channels (4 with tRNS alphas, 255 past their end), RGBA -> 4;
- Adam7 interlace and the five row filters (None, Sub, Up, Average, Paeth).

Gray comes back as ``[H, W, 1]`` where cv2 returns ``[H, W]``. Writes 8-bit RGB/RGBA with
the None filter (enough for validation renders).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk header")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if pos + 12 + n > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _unfilter_row(ftype: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Undo one row's filter. row/prev: int32 [row bytes] (prev is the reconstructed row
    above); bpp is the filter's byte distance, at least 1."""
    if ftype == 0:
        return row
    if ftype == 1:  # Sub: recon[x] = filt[x] + recon[x - bpp]  (a running sum mod 256)
        return np.cumsum(row.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
    if ftype == 2:  # Up
        return (row + prev) & 0xFF
    if ftype not in (3, 4):
        raise ValueError(f"unknown PNG filter type {ftype}")
    # Average / Paeth depend on the reconstructed left neighbour: sequential per pixel,
    # vectorized over the pixel's bytes
    out = np.empty_like(row)
    px = row.reshape(-1, bpp)
    up = prev.reshape(-1, bpp)
    rec = out.reshape(-1, bpp)
    zero = np.zeros(bpp, np.int32)
    for x in range(px.shape[0]):
        a = rec[x - 1] if x else zero
        b = up[x]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = up[x - 1] if x else zero
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        rec[x] = (px[x] + pred) & 0xFF
    return out


def _decode_pass(raw: np.ndarray, pos: int, W: int, H: int, depth: int, spp: int, path: str):
    """One (sub-)image of W x H pixels starting at raw[pos] -> (samples [H, W, spp] as
    uint16, next position)."""
    row_bytes = (W * spp * depth + 7) // 8
    bpp = max(1, spp * depth // 8)
    stride = 1 + row_bytes
    if pos + H * stride > raw.size:
        raise ValueError(f"{path}: PNG image data too short")
    rows = raw[pos:pos + H * stride].reshape(H, stride)
    out = np.empty((H, row_bytes), np.int32)
    prev = np.zeros(row_bytes, np.int32)
    for r in range(H):
        prev = out[r] = _unfilter_row(int(rows[r, 0]), rows[r, 1:].astype(np.int32), prev, bpp)
    if depth == 16:
        samples = (out[:, 0::2] << 8) | out[:, 1::2]
    elif depth == 8:
        samples = out
    else:  # pack of 8/depth samples per byte, most significant first
        shifts = np.arange(8 - depth, -1, -depth)
        samples = ((out[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(H, -1)
        samples = samples[:, :W * spp]
    return samples.reshape(H, W, spp).astype(np.uint16), pos + H * stride


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file -> [H, W, C] uint8 (uint16 at 16 bits), C = 1, 3 or 4 in RGB(A)
    order: the channels and values ``cv2.imread(path, IMREAD_UNCHANGED)`` returns."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, plte, trns, idat = None, None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = header
    if ctype not in _DEPTHS or depth not in _DEPTHS[ctype] or interlace not in (0, 1):
        raise ValueError(f"{path}: invalid PNG (bit depth {depth}, color type {ctype}, "
                         f"interlace {interlace})")
    if ctype == 3 and plte is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    spp = _SAMPLES[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace == 0:
        img, end = _decode_pass(raw, 0, W, H, depth, spp, path)
    else:
        img = np.empty((H, W, spp), np.uint16)
        end = 0
        for x0, y0, dx, dy in _ADAM7:
            w, h = (W - x0 + dx - 1) // dx, (H - y0 + dy - 1) // dy
            if w > 0 and h > 0:
                img[y0::dy, x0::dx], end = _decode_pass(raw, end, w, h, depth, spp, path)
    if end != raw.size:
        raise ValueError(f"{path}: PNG image data is {raw.size} bytes, expected {end}")

    dtype = np.uint16 if depth == 16 else np.uint8
    top = np.iinfo(dtype).max
    if ctype == 3:
        if img.max(initial=0) >= len(plte):
            raise ValueError(f"{path}: palette index past the PLTE entries")
        idx = img[..., 0]
        out = plte[idx]
        if trns is not None and len(trns):
            alpha = np.full(len(plte), 255, np.uint8)
            n = min(len(trns), len(plte))
            alpha[:n] = np.frombuffer(trns[:n], np.uint8)
            out = np.concatenate([out, alpha[idx][..., None]], -1)
        return out
    if ctype == 0:
        if depth < 8:
            img = img * (255 // ((1 << depth) - 1))
        return img.astype(dtype)
    if ctype == 4:
        return np.concatenate([img[..., :1].repeat(3, -1), img[..., 1:]], -1).astype(dtype)
    if ctype == 2 and trns is not None and len(trns) == 6:
        key = np.array(struct.unpack(">HHH", trns), np.uint16)
        alpha = np.where((img == key).all(-1), 0, top).astype(np.uint16)
        img = np.concatenate([img, alpha[..., None]], -1)
    return img.astype(dtype)


def write_png(path: str, img: np.ndarray) -> None:
    """Encode uint8 [H, W, 3|4] (RGB(A) order) with filter type 0."""
    img = np.ascontiguousarray(img, np.uint8)
    H, W, C = img.shape
    ctype = {3: 2, 4: 6}[C]
    raw = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))
