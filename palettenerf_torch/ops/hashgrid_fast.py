"""Hash-grid encoder used for training and rendering, as a ``torch.autograd.Function``.

Port of ``palettenerf_tpu/ops/hashgrid_fast.py`` (``hashgrid_encode_fast``), exact
trilinear forward and exact all-corner backward:

- Forward: the global (concatenated-table) indices and trilinear weights of all
  ``L * 2^D`` corners of every point are computed in one vector pass over levels,
  then ONE flat gather over the table (``_encode_T``, hashgrid_fast.py:320-332).
- Backward (``_bwd``, :529-545): the cotangent of every (point, level) is spread to
  its corners by weight and scatter-added into the table gradient in one call
  (``_scatter_global``, :409-434). With ``scatter_dtype=torch.bfloat16`` (``-O``) the
  updates are rounded to bf16 and go through the CUDA scatter kernel
  (``ops/scatter.py``); otherwise an f32 ``index_add_`` (the JAX package's
  counterpart there is a plain XLA scatter, not a Pallas kernel).

The ``-O2`` modes (stochastic corner draw, ``grad_levels``, nearest-corner backward)
and ``hash_xadd`` are not ported yet. The TPU-only chunking and transposed layout of
the JAX version are not needed here.
"""

from __future__ import annotations

from typing import Optional

import torch

from .hashgrid import PRIMES, HashGridSpec
from .scatter import scatter_add

_U32 = 0xFFFFFFFF


def _level_constants(spec: HashGridSpec, device):
    """Per-level [L] tensors: scale (f32), table size, offset, hashed?, strides [L, D]."""
    scales, sizes, offs, hashed, strides = [], [], [], [], []
    for lvl in range(spec.num_levels):
        size, st, h = spec.level_layout(lvl)
        scales.append(spec.level_scale(lvl))
        sizes.append(size)
        offs.append(spec.offsets[lvl])
        hashed.append(h)
        strides.append([0 if s is None else s for s in st])
    i64 = dict(dtype=torch.int64, device=device)
    return (torch.tensor(scales, dtype=torch.float32, device=device),
            torch.tensor(sizes, **i64), torch.tensor(offs, **i64),
            torch.tensor(hashed, dtype=torch.bool, device=device),
            torch.tensor(strides, **i64))


def corner_indices(spec: HashGridSpec, x: torch.Tensor):
    """x [M, D] in [0, 1] -> (idx [M, L*2^D] int32 global table rows, w [M, L*2^D] f32).

    Columns are level-major (``l * 2^D + k``); corner ``k`` takes bit ``d`` of ``k``
    as its offset along dimension ``d`` — the residual layout of the JAX encoder.
    """
    D, L = spec.input_dim, spec.num_levels
    K = 2 ** D
    scales, sizes, offs, hashed, strides = _level_constants(spec, x.device)
    pos = x[:, None, :] * scales[None, :, None] + (0.0 if spec.align_corners else 0.5)
    pg0f = torch.floor(pos)
    frac = pos - pg0f                                    # [M, L, D]
    pg0 = pg0f.to(torch.int64)
    idxs, ws = [], []
    for corner in range(K):
        bits = [(corner >> d) & 1 for d in range(D)]
        w = torch.ones(frac.shape[:2], dtype=torch.float32, device=x.device)
        lin = torch.zeros(frac.shape[:2], dtype=torch.int64, device=x.device)
        h = torch.zeros_like(lin)
        for d in range(D):
            w = w * (frac[..., d] if bits[d] else 1.0 - frac[..., d])
            p = (pg0[..., d] + bits[d]) & _U32
            lin = (lin + p * strides[:, d]) & _U32
            h = h ^ ((p * (PRIMES[d] & _U32)) & _U32)
        idx = torch.where(hashed, h, lin) % sizes + offs  # [M, L]
        idxs.append(idx.to(torch.int32))
        ws.append(w)
    M = x.shape[0]
    return (torch.stack(idxs, -1).reshape(M, L * K), torch.stack(ws, -1).reshape(M, L * K))


def scatter_table_grad(idx: torch.Tensor, upd: torch.Tensor, total_rows: int,
                       scatter_dtype: Optional[torch.dtype],
                       period: Optional[int] = None) -> torch.Tensor:
    """One batched scatter-add of updates upd [U, C] at rows idx [U] (``_scatter_global``).

    bf16: updates rounded to bf16, summed in f32 by the scatter kernel (CPU: its plain
    version). Otherwise an f32 ``index_add_``. ``period``: the number of corner columns
    per point when idx is ``[M, period]`` flattened; the kernel then works through the
    table a few levels at a time (``ops/scatter.py``).
    """
    if scatter_dtype == torch.bfloat16:
        return scatter_add(idx, upd.to(torch.bfloat16).contiguous(), total_rows, period)
    if scatter_dtype not in (None, torch.float32):
        raise ValueError(f"unsupported scatter_dtype {scatter_dtype}")
    out = torch.zeros((total_rows, upd.shape[1]), dtype=torch.float32, device=upd.device)
    return out.index_add_(0, idx.long(), upd.float())


class _HashGridEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, x, spec, scatter_dtype):
        D, C, L = spec.input_dim, spec.level_dim, spec.num_levels
        K = 2 ** D
        M = x.shape[0]
        oob = ((x < 0.0) | (x > 1.0)).any(-1)
        idx, w = corner_indices(spec, x)
        rows = table.index_select(0, idx.reshape(-1)).reshape(M, L, K, C)
        acc = torch.zeros((M, L, C), dtype=table.dtype, device=table.device)
        wt = w.reshape(M, L, K, 1).to(table.dtype)
        for k in range(K):  # corner order of the JAX encoder's accumulation
            acc = acc + rows[:, :, k] * wt[:, :, k]
        out = torch.where(oob[:, None], torch.zeros((), dtype=acc.dtype, device=acc.device),
                          acc.reshape(M, L * C))
        ctx.save_for_backward(idx, w, oob)
        ctx.spec, ctx.scatter_dtype = spec, scatter_dtype
        ctx.table_dtype = table.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        idx, w, oob = ctx.saved_tensors
        spec = ctx.spec
        C, L = spec.level_dim, spec.num_levels
        K = 2 ** spec.input_dim
        M = idx.shape[0]
        g = g.reshape(M, L, C).masked_fill(oob[:, None, None], 0)
        upd = (g[:, :, None, :] * w.reshape(M, L, K, 1)).reshape(M * L * K, C)
        grad = scatter_table_grad(idx.reshape(-1), upd, spec.total_params, ctx.scatter_dtype,
                                  period=L * K)
        return grad.to(ctx.table_dtype), None, None, None


def hashgrid_encode_fast(table: torch.Tensor, x01: torch.Tensor, spec: HashGridSpec,
                         scatter_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """table [total, C]; x01 [..., D] in [0, 1] -> [..., L*C]. Differentiable in
    ``table`` only (as the JAX encoder). ``scatter_dtype=torch.bfloat16`` is the
    ``-O`` backward."""
    lead = x01.shape[:-1]
    x = x01.reshape(-1, spec.input_dim).to(torch.float32)
    out = _HashGridEncode.apply(table, x, spec, scatter_dtype)
    return out.reshape(*lead, spec.output_dim)


def hashgrid_encode_fast_bounded(table, x, spec: HashGridSpec, bound: float,
                                 scatter_dtype: Optional[torch.dtype] = None):
    """Encode world positions in [-bound, bound] (grid.py:138-150)."""
    return hashgrid_encode_fast(table, (x + bound) / (2.0 * bound), spec, scatter_dtype)
