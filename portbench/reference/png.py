"""A plain PNG reader for the reference's ground truth: 8-bit, non-interlaced, gray,
RGB or RGBA (what the benchmark's scenes hold).

The scanlines are unfiltered along anti-diagonals: a byte depends only on the bytes to
its left, above and above-left, which all lie on earlier diagonals of the (row, pixel)
grid, so each diagonal is one vectorised step over every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def read_png(path: str) -> np.ndarray:
    """[H, W, C] uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIG):
        raise ValueError(f"{path}: not a PNG")
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    W, H, depth, ctype, _, _, interlace = head
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB/RGBA is read here")
    C = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, 1 + W * C)
    kind, filt = raw[:, 0].astype(np.int64), raw[:, 1:].reshape(H, W, C).astype(np.int64)
    out = np.zeros((H + 1, W + 1, C), np.int64)  # a zero row above and column to the left
    for d in range(H + W - 1):
        r = np.arange(max(0, d - W + 1), min(H, d + 1))
        c = d - r
        x = filt[r, c]
        a, b, up_left = out[r + 1, c], out[r, c + 1], out[r, c]
        k = kind[r][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) // 2, _paeth(a, b, up_left)], 0)
        out[r + 1, c + 1] = (x + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)
