"""The extraction's host-side C++ kernels (``palette_native.cpp``), bound with ctypes.

The port's counterpart of ``palettenerf_tpu/native/__init__.py``. The source is built
with ``g++`` at first use into ``palettenerf_torch/build/`` (listed in ``.gitignore``),
under a file name that carries a hash of the source and the command, so an edited
source is rebuilt and a stale build is never loaded. The two command lines are the JAX
package's: with ``-march=native -fopenmp`` first, without them where that fails; the
one that built is printed and kept in ``LIBRARY.build_command``.

Unlike the JAX package, nothing falls back quietly: a build that fails raises with the
compiler's output. The plain versions of these kernels are NumPy functions,
``extraction.histogram.rgb_histogram_reference`` and
``extraction.geometry.point_triangle_min_dist_reference``, which the extraction never
calls: the tests and ``chip_smoke.py`` hold the kernels against them.
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
BUILD_DIR = os.path.join(_PKG, "build")
COMMANDS = (["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"],
            ["g++", "-O3", "-shared", "-fPIC"])

_F, _D = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "rgb_histogram": [_F, _F, ctypes.c_int64, ctypes.c_int, _D],
    "rgb_histogram_centers": [ctypes.c_int, _F],
    "point_triangle_min_dist": [_D, ctypes.c_int64, _D, ctypes.c_int64, _D, _D],
}


class NativeLibrary:
    """``palette_native.cpp`` built into a shared library and loaded on first ``get()``."""

    def __init__(self, source: str = SOURCE):
        self.source = source
        self.build_command: Optional[List[str]] = None
        self.build_seconds: Optional[float] = None
        self._lib = None

    def _target(self, flags) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
        return os.path.join(BUILD_DIR, f"libpalette_native.{digest[:12]}.so")

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
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, None
            self._lib = lib
        return self._lib


LIBRARY = NativeLibrary()


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


__all__ = ["LIBRARY", "NativeLibrary", "rgb_histogram_native", "point_triangle_min_dist_native"]
