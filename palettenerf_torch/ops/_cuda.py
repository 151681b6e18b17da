"""Build and load the hand-written CUDA kernels under ``palettenerf_torch/csrc``.

Each ``csrc/<name>.cu`` exposes plain C functions. It is compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library under ``palettenerf_torch/build/`` (listed
in ``.gitignore``) at first use, and loaded with ``ctypes``. No PyTorch headers are
included, so a build takes seconds. The library file name carries a hash of the
source and flags, so an edited source is rebuilt and a stale build is never loaded.

A kernel never reads outside its arrays: input it refuses (an index out of range) is
counted in a ``RefusedCounter`` on the device, which the caller reads where the host
synchronises anyway, so a wrapper needs no device-to-host read of its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
                       "kernels are built from csrc/ at first use and need the CUDA toolkit")


class CudaLibrary:
    """One ``csrc/<name>.cu`` built into a shared library, loaded on first ``get()``.

    ``signatures`` maps each C function to its ctypes argument types; they are set once,
    when the library is loaded. Every function returns a ``cudaError_t`` as an int.
    """

    def __init__(self, name: str, signatures: dict):
        self.name = name
        self.signatures = signatures
        self.source = os.path.join(CSRC_DIR, f"{name}.cu")
        self._lib = None
        self.build_seconds = None
        self.build_log = ""

    def _target(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return os.path.join(BUILD_DIR, f"lib{self.name}.{digest[:12]}.so")

    def build(self) -> str:
        """Compile the source unless a build of this exact source exists; return its path."""
        target = self._target()
        if os.path.exists(target):
            return target
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                              capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source}:\n{self.build_log}")
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
        return target

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(self.build())
            for fn_name, argtypes in self.signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            self._lib = lib
        return self._lib


class RefusedCounter:
    """Per CUDA device, one int32 that a kernel increments for each input element it
    refuses (and does not use). ``check`` reads the counters back, which synchronises
    with the device, so call it where the host waits for the device anyway."""

    def __init__(self, what: str):
        self.what = what
        self._counters = {}

    def on(self, device: torch.device) -> torch.Tensor:
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._counters:
            self._counters[device] = torch.zeros(1, dtype=torch.int32, device=device)
        return self._counters[device]

    def check(self, reduce=None) -> None:
        """Raise ValueError if a launch since the last check refused anything. ``reduce``
        (optional) maps this process's count to the count over every process of a run
        (a sum over the ranks), so that all of them raise or none does."""
        refused = {}
        for device, counter in self._counters.items():  # read and zero every device first
            n = int(counter)
            if n:
                counter.zero_()
                refused[str(device)] = n
        total = sum(refused.values())
        if reduce is not None:
            total = reduce(total)
        if total:
            raise ValueError(f"{self.what}: {total} indices outside their range were "
                             f"refused ({refused or 'on another rank'}; nothing was read "
                             f"or written at them)")


def check_launch(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a kernel's C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
