"""Image files -> arrays: the port's counterpart of ``cv2.imread(path, IMREAD_UNCHANGED)``.

``read_image`` dispatches on the file's magic bytes, not its extension:

- JPEG (``FF D8 FF``) goes to the native C++ decoder (``native/image_native.cpp``), which
  reproduces libjpeg-turbo's arithmetic under cv2's defaults (islow IDCT, fancy chroma
  upsampling, fixed-point YCbCr -> RGB, EXIF orientation ignored);
- PNG goes to ``data/png.py``.

Both return what cv2 returns, in RGB(A) order instead of BGR(A), and gray as ``[H, W, 1]``
instead of ``[H, W]``. Other formats raise ``ValueError``.
"""

from __future__ import annotations

import numpy as np

from .. import native
from .png import _SIGNATURE as _PNG_SIGNATURE, read_png

_JPEG_SIGNATURE = b"\xff\xd8\xff"


def read_image(path: str) -> np.ndarray:
    """[H, W, C] uint8 (uint16 for 16-bit PNGs), C = 1, 3 or 4, RGB(A) order."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(_JPEG_SIGNATURE):
        with open(path, "rb") as f:
            return native.decode_jpeg(f.read(), path)
    if head.startswith(_PNG_SIGNATURE):
        return read_png(path)
    raise ValueError(f"{path}: unsupported image format (the port reads JPEG and PNG)")


__all__ = ["read_image"]
