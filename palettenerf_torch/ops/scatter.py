"""Dense scatter-add for the hash-grid backward: the CUDA kernel and its plain version.

Counterpart of ``palettenerf_tpu/ops/pallas_scatter.py:tile_scatter_add``:
``out[idx[u], c] += vals[u, c]`` into a zeroed ``[total_rows, C]`` f32 table, with
duplicate rows summing. The kernel (``csrc/scatter_add.cu``) reads bf16 values, which
is what the ``-O`` backward produces, and accumulates in f32.

``scatter_add`` launches the kernel for CUDA tensors (or raises) and runs the plain
version for CPU tensors; there is no fallback between the two.

Rows outside ``[0, total_rows)``: on the CPU the wrapper raises ``ValueError`` before
anything is summed. On the card nothing is read back in the wrapper (a read would stall
the launch queue in the middle of every backward pass): the kernel never writes such a
row and counts it in ``REFUSED`` instead, and ``check_refused()`` raises ``ValueError``
for it. The trainer calls ``check_refused()`` where it reads the epoch's loss; any other
caller does so at its next synchronisation point.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._cuda import CudaLibrary, RefusedCounter, check_launch

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LIBRARY = CudaLibrary("scatter_add", {
    # idx, vals, out, n_updates, channels, total_rows, period, scalar, refused, stream
    "scatter_add_bf16": [_P, _P, _P, _LL, _I, _LL, _LL, _I, _P, _P]})
REFUSED = RefusedCounter("scatter_add")
check_refused = REFUSED.check

_VECTOR_CHANNELS = (1, 2, 4, 8)


def build() -> str:
    """Compile the kernel now (otherwise it is compiled at its first launch)."""
    return LIBRARY.build()


def scatter_add_reference(idx: torch.Tensor, vals: torch.Tensor, total_rows: int) -> torch.Tensor:
    """Plain PyTorch version: vals [U, C] at rows idx [U] -> f32 [total_rows, C]."""
    out = torch.zeros((total_rows, vals.shape[1]), dtype=torch.float32, device=vals.device)
    return out.index_add_(0, idx.long(), vals.float())


def _check_rows(idx: torch.Tensor, total_rows: int) -> None:
    if idx.numel() == 0:
        return
    lo, hi = (int(v) for v in torch.aminmax(idx))
    if lo < 0 or hi >= total_rows:
        raise ValueError(f"scatter_add: row indices span [{lo}, {hi}], outside "
                         f"[0, {total_rows})")


def scatter_add(idx: torch.Tensor, vals: torch.Tensor, total_rows: int,
                period: Optional[int] = None) -> torch.Tensor:
    """vals [U, C] at rows idx [U] -> f32 [total_rows, C]; duplicate rows accumulate.

    ``period`` (optional, must divide U) tells how the stream is laid out: it is
    ``[U / period, period]`` flattened, and a column's rows lie in one region of the
    table (the hash-grid backward: period = levels x corners, one level's rows per 8
    columns). The kernel then works through the table a few columns at a time, which
    keeps the rows it adds to in cache. It changes the order of the walk, never the result.

    CUDA tensors go to the kernel: idx int32, vals bf16, both contiguous on one device,
    vals aligned to a whole row for C in 1, 2, 4, 8. The wrapper reads nothing back from
    the device; rows out of range are refused by the kernel (see ``check_refused``).
    CPU tensors go to ``scatter_add_reference`` after a range check.

    The kernel follows the arguments: with a period it walks the columns, without one the
    stream in its own order, one vector atomic per nonzero row either way; a C other than
    1, 2, 4, 8 takes scalar atomics.
    """
    return _scatter_add(idx, vals, total_rows, period, scalar=False)


def _scatter_add(idx, vals, total_rows, period, scalar):
    """``scatter_add``; ``scalar`` forces the scalar-atomics kernel, the first design,
    which the card's smoke test times the others against. No product path sets it."""
    if idx.dim() != 1 or vals.dim() != 2 or vals.shape[0] != idx.shape[0]:
        raise ValueError(f"scatter_add: need idx [U] and vals [U, C], got "
                         f"{tuple(idx.shape)} and {tuple(vals.shape)}")
    U, C = vals.shape
    if period is not None and (period < 1 or U % period != 0):
        raise ValueError(f"scatter_add: period {period} does not divide U = {U}")
    if vals.device.type == "cpu" and idx.device.type == "cpu":
        _check_rows(idx, total_rows)
        return scatter_add_reference(idx, vals, total_rows)
    if vals.device.type != "cuda" or idx.device != vals.device:
        raise ValueError(f"scatter_add: idx on {idx.device} and vals on {vals.device}; "
                         f"need both on one CUDA device (or both on the CPU)")
    if idx.dtype != torch.int32 or vals.dtype != torch.bfloat16:
        raise TypeError(f"scatter_add kernel takes int32 idx and bf16 vals, got "
                        f"{idx.dtype} and {vals.dtype}")
    if not (idx.is_contiguous() and vals.is_contiguous()):
        raise ValueError("scatter_add kernel needs contiguous idx and vals")
    if not 1 <= total_rows < 2 ** 31 or C < 1:
        raise ValueError(f"scatter_add kernel needs 1 <= total_rows < 2^31 and C >= 1, got "
                         f"{total_rows} and {C}")
    out = torch.zeros((total_rows, C), dtype=torch.float32, device=vals.device)
    if C in _VECTOR_CHANNELS and (vals.data_ptr() % (2 * C) or out.data_ptr() % 16):
        raise ValueError(f"scatter_add kernel loads a row of vals as one {2 * C}-byte word: "
                         f"vals must be aligned to it (a view at an odd offset is not)")
    if U == 0:
        return out
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = LIBRARY.get().scatter_add_bf16(
            idx.data_ptr(), vals.data_ptr(), out.data_ptr(), U, C, total_rows, period or 0,
            int(scalar), REFUSED.on(vals.device).data_ptr(), stream)
    check_launch(err, "scatter_add_bf16")
    scatter_add.launches += 1
    return out


scatter_add.launches = 0
