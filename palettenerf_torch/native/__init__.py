"""The host-side C++ kernels, bound with ctypes: the extraction's (``palette_native.cpp``)
and the JPEG decoder of the data layer (``image_native.cpp``).

``palette_native.cpp`` is the port's counterpart of ``palettenerf_tpu/native/``; the JPEG
decoder stands in for the ``cv2.imread`` the JAX package's loader calls. Each source is
built with ``g++`` at first use into ``palettenerf_torch/build/`` (listed in
``.gitignore``), under a file name that carries a hash of the source and the command, so an
edited source is rebuilt and a stale build is never loaded. The two command lines are the
JAX package's: with ``-march=native -fopenmp`` first, without them where that fails; the
one that built is printed and kept in ``build_command``.

Unlike the JAX package, nothing falls back quietly: a build that fails raises with the
compiler's output. The plain versions of the extraction kernels are NumPy functions,
``extraction.histogram.rgb_histogram_reference`` and
``extraction.geometry.point_triangle_min_dist_reference``, which the extraction never
calls: the tests and ``chip_smoke.py`` hold the kernels against them. The JPEG decoder has
no plain version in the port; the tests hold it against ``cv2.imread``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from typing import List, Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "palette_native.cpp")
IMAGE_SOURCE = os.path.join(_PKG, "native", "image_native.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
COMMANDS = (["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"],
            ["g++", "-O3", "-shared", "-fPIC"])

_F, _D = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)
_U8, _I32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "rgb_histogram": ([_F, _F, ctypes.c_int64, ctypes.c_int, _D], None),
    "rgb_histogram_centers": ([ctypes.c_int, _F], None),
    "point_triangle_min_dist": ([_D, ctypes.c_int64, _D, ctypes.c_int64, _D, _D], None),
}
_IMAGE_SIGNATURES = {
    "jpeg_header": ([_U8, ctypes.c_int64, _I32, ctypes.c_char_p, ctypes.c_int64], ctypes.c_int),
    "jpeg_decode": ([_U8, ctypes.c_int64, _U8, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64],
                    ctypes.c_int),
}


class NativeLibrary:
    """A C++ source built into a shared library and loaded on first ``get()``; ``signatures``
    maps each exported function to its (argtypes, restype)."""

    def __init__(self, source: str = SOURCE, signatures=None):
        self.source = source
        self.signatures = _SIGNATURES if signatures is None else signatures
        self.build_command: Optional[List[str]] = None
        self.build_seconds: Optional[float] = None
        self._lib = None

    def _target(self, flags) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"lib{stem}.{digest[:12]}.so")

    def build(self) -> str:
        """The path of a build of this source: an existing one, or a new one made with the
        first command line that compiles. Raises with every compiler output otherwise."""
        for flags in COMMANDS:
            if os.path.exists(self._target(flags)):
                self.build_command = [*flags, self.source]
                return self._target(flags)
        os.makedirs(BUILD_DIR, exist_ok=True)
        errors = []
        for flags in COMMANDS:
            target = self._target(flags)
            tmp = f"{target}.{os.getpid()}.tmp"
            cmd = [*flags, self.source, "-o", tmp]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                errors.append(f"$ {' '.join(cmd)}\n{e}")
                continue
            if proc.returncode != 0:
                errors.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
                continue
            os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
            self.build_seconds = time.perf_counter() - t0
            self.build_command = [*flags, self.source]
            print(f"[native] built {os.path.basename(target)} in {self.build_seconds:.1f} s: "
                  f"{' '.join(flags)}", flush=True)
            return target
        raise RuntimeError(f"g++ could not build {self.source}:\n" + "\n".join(errors))

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(self.build())
            for name, (argtypes, restype) in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            self._lib = lib
        return self._lib


LIBRARY = NativeLibrary()
IMAGE_LIBRARY = NativeLibrary(IMAGE_SOURCE, _IMAGE_SIGNATURES)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def rgb_histogram_native(colors: np.ndarray, weights: np.ndarray,
                         bpc: int) -> Tuple[np.ndarray, np.ndarray]:
    """colors [N, 3] in [0, 1], weights [N], 1 <= bpc <= 8 -> (bin weights [2^(3 bpc)]
    f64, bin centers [2^(3 bpc), 3] f32), as ``extraction.histogram``'s NumPy version."""
    colors = np.ascontiguousarray(colors, np.float32)
    weights = np.ascontiguousarray(weights, np.float32)
    if colors.ndim != 2 or colors.shape[1] != 3 or weights.shape != (len(colors),):
        raise ValueError(f"need colors [N, 3] and weights [N], got {colors.shape} and "
                         f"{weights.shape}")
    if not 1 <= bpc <= 8:
        raise ValueError(f"bits per channel {bpc} outside 1..8")
    lib = LIBRARY.get()
    num_bins = 1 << (3 * bpc)
    bw = np.zeros(num_bins, np.float64)
    lib.rgb_histogram(_ptr(colors, ctypes.c_float), _ptr(weights, ctypes.c_float),
                      len(weights), bpc, _ptr(bw, ctypes.c_double))
    centers = np.zeros((num_bins, 3), np.float32)
    lib.rgb_histogram_centers(bpc, _ptr(centers, ctypes.c_float))
    return bw, centers


def point_triangle_min_dist_native(points: np.ndarray,
                                   tris: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """points [N, 3], triangles [T, 9] (three corners each) -> (the distance to the
    nearest triangle [N], the closest point on it [N, 3]), in f64."""
    points = np.ascontiguousarray(points, np.float64)
    tris = np.ascontiguousarray(tris, np.float64)
    if points.ndim != 2 or points.shape[1] != 3 or tris.ndim != 2 or tris.shape[1] != 9:
        raise ValueError(f"need points [N, 3] and triangles [T, 9], got {points.shape} and "
                         f"{tris.shape}")
    if len(tris) == 0:
        raise ValueError("no triangles")
    lib = LIBRARY.get()
    n, t = len(points), len(tris)
    dist = np.zeros(n, np.float64)
    closest = np.zeros((n, 3), np.float64)
    lib.point_triangle_min_dist(_ptr(points, ctypes.c_double), n,
                                _ptr(tris, ctypes.c_double), t,
                                _ptr(dist, ctypes.c_double), _ptr(closest, ctypes.c_double))
    return dist, closest


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A JPEG stream -> uint8 [H, W, 3] RGB or [H, W, 1] gray: the pixels
    ``cv2.imread(..., IMREAD_UNCHANGED)`` returns (as BGR) under libjpeg-turbo's defaults.
    Raises ``ValueError`` naming ``name`` and what is refused or corrupt."""
    lib = IMAGE_LIBRARY.get()
    src = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(512)
    hwc = np.zeros(3, np.int32)
    if lib.jpeg_header(_ptr(src, ctypes.c_uint8), src.size, _ptr(hwc, ctypes.c_int32), err,
                       len(err)):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty(tuple(int(v) for v in hwc), np.uint8)
    if lib.jpeg_decode(_ptr(src, ctypes.c_uint8), src.size, _ptr(out, ctypes.c_uint8), out.size,
                       err, len(err)):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


__all__ = ["LIBRARY", "IMAGE_LIBRARY", "NativeLibrary", "rgb_histogram_native",
           "point_triangle_min_dist_native", "decode_jpeg"]
