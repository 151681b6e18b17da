"""The precisions of the controls: the reference at the next precision below the one a
configuration states."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32():
    """float32 matmuls in TF32 (the step below float32 with TF32 off)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 (the step below bfloat16), back in float32."""
    return t.to(torch.float8_e4m3fn).to(torch.float32)
