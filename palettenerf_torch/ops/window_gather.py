"""Window gather: the CUDA kernel and its plain version.

Counterpart of ``palettenerf_tpu/ops/pallas_window_gather.py:window_gather``:
``out[i, j] = W[r[i, j], c[i, j]]`` for a small window ``W [Rw, 128]`` (1 <= Rw <= 32,
f32 or bf16) and int32 index tiles ``r, c [M8, 128]`` with ``r`` in [0, Rw) and ``c`` in
[0, 128). It is the building block of a tiled renderer that neither package has built
yet (``docs/tiled_renderer_design.md`` §3-4), so no product path calls it.

``window_gather`` launches the kernel (``csrc/window_gather.cu``) for CUDA tensors (or
raises) and runs the plain version for CPU tensors; there is no fallback between the two.

Indices outside the window: on the CPU the wrapper raises ``ValueError`` first. On the
card the wrapper reads nothing back (the read cost three times the kernel): the kernel
never uses such an index as an address, writes zero bits at its output element and
counts it in ``REFUSED``; ``check_refused()`` raises ``ValueError`` for it at the
caller's next synchronisation point.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda import CudaLibrary, RefusedCounter, check_launch

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LIBRARY = CudaLibrary("window_gather", {
    # W, rows, elem_bytes, r, c, out, n, refused, stream
    "window_gather": [_P, _I, _I, _P, _P, _P, _LL, _P, _P]})
REFUSED = RefusedCounter("window_gather")
check_refused = REFUSED.check
LANES = 128
MAX_ROWS = 32
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def build() -> str:
    """Compile the kernel now (otherwise it is compiled at its first launch)."""
    return LIBRARY.build()


def window_gather_reference(W: torch.Tensor, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: W [Rw, 128], r, c [M8, 128] -> W[r, c] [M8, 128]."""
    return W[r.long(), c.long()]


def _check(W: torch.Tensor, r: torch.Tensor, c: torch.Tensor) -> None:
    if W.dim() != 2 or W.shape[1] != LANES or not 1 <= W.shape[0] <= MAX_ROWS:
        raise ValueError(f"window_gather: need W [1..{MAX_ROWS}, {LANES}], got "
                         f"{tuple(W.shape)}")
    if r.shape != c.shape or r.dim() != 2 or r.shape[1] != LANES:
        raise ValueError(f"window_gather: need r, c [M8, {LANES}], got {tuple(r.shape)} "
                         f"and {tuple(c.shape)}")
    if r.dtype != torch.int32 or c.dtype != torch.int32:
        raise TypeError(f"window_gather takes int32 r and c, got {r.dtype} and {c.dtype}")


def _check_range(W: torch.Tensor, r: torch.Tensor, c: torch.Tensor) -> None:
    if r.numel() == 0:
        return
    for name, idx, hi in (("r", r, W.shape[0]), ("c", c, LANES)):
        lo_v, hi_v = (int(v) for v in torch.aminmax(idx))
        if lo_v < 0 or hi_v >= hi:
            raise ValueError(f"window_gather: {name} spans [{lo_v}, {hi_v}], outside "
                             f"[0, {hi})")


def window_gather(W: torch.Tensor, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """W [Rw, 128] (f32 or bf16), r, c [M8, 128] int32 -> W[r, c] [M8, 128] of W's dtype.

    CUDA tensors go to the kernel: all three contiguous on one device and aligned to 16
    bytes (it moves four elements per request). The wrapper reads nothing back from the
    device; indices out of range are refused by the kernel (see ``check_refused``). CPU
    tensors go to ``window_gather_reference`` after a range check.
    """
    _check(W, r, c)
    devs = {W.device, r.device, c.device}
    if devs == {torch.device("cpu")}:
        _check_range(W, r, c)
        return window_gather_reference(W, r, c)
    if len(devs) != 1 or W.device.type != "cuda":
        raise ValueError(f"window_gather: W, r, c on {W.device}, {r.device}, {c.device}; "
                         f"need all on one CUDA device (or all on the CPU)")
    if W.dtype not in _ELEM_BYTES:
        raise TypeError(f"window_gather kernel takes f32 or bf16 W, got {W.dtype}")
    if not (W.is_contiguous() and r.is_contiguous() and c.is_contiguous()):
        raise ValueError("window_gather kernel needs contiguous W, r and c")
    out = torch.empty(r.shape, dtype=W.dtype, device=W.device)
    if any(t.data_ptr() % 16 for t in (W, r, c, out)):
        raise ValueError("window_gather kernel moves 16 bytes per request: W, r and c must "
                         "be aligned to 16 bytes (a view at an odd offset is not)")
    if r.numel() == 0:
        return out
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = LIBRARY.get().window_gather(
            W.data_ptr(), W.shape[0], _ELEM_BYTES[W.dtype], r.data_ptr(), c.data_ptr(),
            out.data_ptr(), r.numel(), REFUSED.on(W.device).data_ptr(), stream)
    check_launch(err, "window_gather")
    window_gather.launches += 1
    return out


window_gather.launches = 0
