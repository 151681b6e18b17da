"""Hash-grid encoder used for training and rendering, as a ``torch.autograd.Function``.

Port of ``palettenerf_tpu/ops/hashgrid_fast.py`` (``hashgrid_encode_fast``) with its
whole mode matrix:

- Exact forward: the global (concatenated-table) indices and trilinear weights of all
  corners of every point are computed in one vector pass over levels, then ONE flat
  gather over the table (``_encode_T``, hashgrid_fast.py:320-332). On the card, for
  ``hash`` and ``tiled`` grids of three dimensions and an f32 table, this is one launch of
  the CUDA kernel ``csrc/hashgrid_encode.cu`` (``encode_kernel``), which hashes, weights
  and gathers in registers and gives what the plain version (``_encode_plain``) gives on
  the card, bit for bit; every other mode and the CPU take the plain version. For
  ``gridtype="hash_xadd"`` the two x-corners of a cell are neighbouring rows, so the
  gather reads K = 4 rows of the overlapped pair table (``pair_table``) per (point,
  level), interpolates along x inside the wide row, then weights by y and z (:269-283).
- Stochastic forward (``stochastic``, :286-318): one corner (one x-pair for
  ``hash_xadd``) per (point, level), drawn with probability equal to its weight by an
  inverse-CDF select over the uniforms ``rand.u`` [M, L] (``make_encode_rand``), or over
  a position hash when ``rand`` is None.
- Backward (``_bwd``, :459-545): the cotangent of every (point, level) goes to its
  corners by weight (exact), to its drawn row (``stochastic``; for pairs the x1 row with
  probability fx), or to its largest-weight corner (``nearest_corner_grad``); with
  ``grad_levels`` only the levels ``rand.lvls`` are scattered, scaled by L/K. Each mode
  ends in ONE scatter-add into the table gradient (``scatter_table_grad``). With
  ``scatter_dtype=torch.bfloat16`` (``-O``, ``-O2``) the updates are rounded to bf16
  and go through the CUDA scatter kernel (``ops/scatter.py``); otherwise an f32
  ``index_add_`` (the JAX package's counterpart there is a plain XLA scatter).

The TPU-only chunking and transposed layout of the JAX version are not needed here.
Every result has the JAX version's rounding order: corners are accumulated, and the
stochastic draw's weight sum is built, corner by corner in f32.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..utils import profiling
from ._cuda import CudaLibrary, check_launch
from .hashgrid import PRIMES, HashGridSpec
from .scatter import scatter_add

_U32 = 0xFFFFFFFF
# Points per pass of a plain encode that no gradient follows (eval renders, bakes, density
# queries; the CUDA kernel takes all points in one launch and writes only the features).
# Each pass materializes every corner's rows, indices and weights ([n, L, K, C]
# f32 and [n, L, K] twice: 1 KiB a point at 16 levels), which over an eval chunk of 16,384
# rays x 256 slots took 18.7 GiB (ROADMAP C17). The JAX encoder maps over chunks of 32,768
# points (``_ENCODE_CHUNK``) and, outside autograd, keeps no residuals; this caps the port's
# passes at the points of one train batch (4096 rays x 64 slots), whose buffers every
# train step already holds.
NO_GRAD_CHUNK = 1 << 18
# Below this many columns per point the scatter kernel's column walk leaves over half the
# lanes of a warp idle (a warp walks 32 columns), so such streams go in their own order.
# On the -O2 (8 columns) and --fast_grad (16) streams the two orders time within their
# run-to-run spread on the H100 (chip_smoke.py; PERF.md).
MIN_COLUMN_PERIOD = 16

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARR_F, _ARR_LL, _ARR_I = (ctypes.POINTER(t) for t in (ctypes.c_float, _LL, _I))
LIBRARY = CudaLibrary("hashgrid_encode", {
    # x, table, total_rows, channels, n_levels, scales, sizes, offsets, strides, hashed,
    # half, n_points, out, idx, w, oob, stream
    "hashgrid_encode": [_P, _P, _LL, _I, _I, _ARR_F, _ARR_LL, _ARR_LL, _ARR_LL, _ARR_I,
                        ctypes.c_float, _LL, _P, _P, _P, _P, _P]})
KERNEL_CHANNELS = (1, 2, 4, 8)  # the kernel moves a table row as one word
KERNEL_MAX_LEVELS = 32


class EncodeRand(NamedTuple):
    """Per-call randomness of the stochastic paths.

    u:    [M, L] uniforms for the corner draw (None: the position-hash fallback).
    lvls: [K] int64 level subset of the backward scatter (None: all levels).
    """

    u: Optional[torch.Tensor] = None
    lvls: Optional[torch.Tensor] = None


def make_encode_rand(generator: torch.Generator, n_samples: int, spec: HashGridSpec,
                     grad_levels: int = 0) -> EncodeRand:
    """Draw one call's randomness from ``generator`` (on its device): ``u`` first, then
    the permutation whose first ``grad_levels`` entries are ``lvls``."""
    dev = generator.device
    L = spec.num_levels
    u = torch.rand((n_samples, L), generator=generator, device=dev)
    lvls = None
    if grad_levels and grad_levels < L:
        lvls = torch.randperm(L, generator=generator, device=dev)[:grad_levels]
    return EncodeRand(u=u, lvls=lvls)


@functools.lru_cache(maxsize=None)
def _level_constants(spec: HashGridSpec, device: torch.device):
    """Per-level [L] tensors: scale (f32), table size, offset, hashed?, strides [L, D],
    and the L + 1 offsets. Made once per (spec, device): an upload per encode would stall
    the launch queue."""
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
            torch.tensor(strides, **i64), torch.tensor(spec.offsets, **i64))


@functools.lru_cache(maxsize=None)
def _kernel_levels(spec: HashGridSpec):
    """The kernel's per-level arguments as host arrays: ``_level_constants``' scales,
    sizes, offsets, strides [L, D] flattened and hashed flags."""
    scales, sizes, offs, hashed, strides, _ = _level_constants(spec, torch.device("cpu"))
    L, n = spec.num_levels, strides.numel()
    return ((ctypes.c_float * L)(*scales.tolist()), (_LL * L)(*sizes.tolist()),
            (_LL * L)(*offs.tolist()), (_LL * n)(*strides.reshape(-1).tolist()),
            (_I * L)(*hashed.int().tolist()))


def _on_card(table: torch.Tensor) -> bool:
    return table.is_cuda


def _kernel_takes(table: torch.Tensor, spec: HashGridSpec, stochastic: bool) -> bool:
    """Whether an encode goes to the CUDA kernel: the exact forward of a ``hash`` or
    ``tiled`` grid over three dimensions, of an f32 table on the card. The rest (the CPU,
    ``stochastic``, ``hash_xadd``, other dimensions, other table dtypes) takes
    ``_encode_plain``."""
    return (not stochastic and spec.gridtype in ("hash", "tiled") and spec.input_dim == 3
            and spec.level_dim in KERNEL_CHANNELS and spec.num_levels <= KERNEL_MAX_LEVELS
            and table.dtype == torch.float32 and _on_card(table))


def encode_kernel(table: torch.Tensor, spec: HashGridSpec, x: torch.Tensor,
                  residuals: bool = True):
    """The exact forward in one launch of ``csrc/hashgrid_encode.cu``: x [M, 3] f32 on the
    table's card -> (out [M, L*C], residuals), what ``_encode_plain`` gives there, bit for
    bit. Residuals (``residuals``): (idx [M, L, 8] int32, w [M, L, 8], None, None, oob
    [M]), else None. Reads nothing back from the card."""
    table, x = table.contiguous(), x.contiguous()
    M, L, C = x.shape[0], spec.num_levels, spec.level_dim
    dev = table.device
    if table.shape != (spec.total_params, C) or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"hashgrid_encode: need table [{spec.total_params}, {C}] and x "
                         f"[M, 3], got {tuple(table.shape)} and {tuple(x.shape)}")
    if x.device != dev or x.dtype != torch.float32 or table.dtype != torch.float32:
        raise ValueError(f"hashgrid_encode kernel takes an f32 table and f32 x on one CUDA "
                         f"device, got {table.dtype} on {dev} and {x.dtype} on {x.device}")
    if table.data_ptr() % min(16, 4 * C):
        raise ValueError("hashgrid_encode kernel loads a table row as one word: the table "
                         "must be aligned to it (a view at an odd offset is not)")
    out = torch.empty((M, L * C), dtype=torch.float32, device=dev)
    res = None
    if residuals:
        res = (torch.empty((M, L, 8), dtype=torch.int32, device=dev),
               torch.empty((M, L, 8), dtype=torch.float32, device=dev), None, None,
               torch.empty((M,), dtype=torch.bool, device=dev))
    if M == 0:
        return out, res
    idx, w, _, _, oob = res or (None,) * 5
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = LIBRARY.get().hashgrid_encode(
            x.data_ptr(), table.data_ptr(), spec.total_params, C, L, *_kernel_levels(spec),
            0.0 if spec.align_corners else 0.5, M, out.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (idx, w, oob)), stream)
    check_launch(err, "hashgrid_encode")
    encode_kernel.launches += 1
    return out, res


encode_kernel.launches = 0


def _pairs(spec: HashGridSpec) -> bool:
    return spec.gridtype == "hash_xadd"


def _corner_bits(spec: HashGridSpec):
    """Per-dimension offsets of each corner the forward reads. ``hash_xadd`` reads the
    x0 row of each of the 2^(D-1) (y, z) corners (the pair row holds x1 beside it)."""
    D = spec.input_dim
    if _pairs(spec):
        return [[0] + [(k >> i) & 1 for i in range(D - 1)] for k in range(2 ** (D - 1))]
    return [[(k >> d) & 1 for d in range(D)] for k in range(2 ** D)]


def _geometry(spec: HashGridSpec, consts, x: torch.Tensor):
    """x [M, D] -> (cell origin [M, L, D] int64, position in the cell [M, L, D] f32)."""
    pos = x[:, None, :] * consts[0][None, :, None] + (0.0 if spec.align_corners else 0.5)
    pg0f = torch.floor(pos)
    return pg0f.to(torch.int64), pos - pg0f


def _corner(spec: HashGridSpec, consts, pg0, frac, bits):
    """Global row [M, L] int64 and weight [M, L] f32 of one corner."""
    _, sizes, offs, hashed, strides, _ = consts
    xadd = _pairs(spec)
    lin = torch.zeros(pg0.shape[:2], dtype=torch.int64, device=pg0.device)
    h = torch.zeros_like(lin)
    w = torch.ones(frac.shape[:2], dtype=torch.float32, device=frac.device)
    for d in range(spec.input_dim):
        p = (pg0[..., d] + bits[d]) & _U32
        lin = (lin + p * strides[:, d]) & _U32
        if not (xadd and d == 0):
            h = h ^ ((p * (PRIMES[d] & _U32)) & _U32)
            w = w * (frac[..., d] if bits[d] else 1.0 - frac[..., d])
    if xadd:
        h = (h + ((pg0[..., 0] + bits[0]) & _U32)) & _U32
    return torch.where(hashed, h, lin) % sizes + offs, w


def corner_indices(spec: HashGridSpec, x: torch.Tensor):
    """x [M, D] in [0, 1] -> (idx [M, L*K] int32 global table rows, w [M, L*K] f32).

    Columns are level-major (``l * K + k``); corner ``k`` takes bit ``d`` of ``k`` as its
    offset along dimension ``d`` — the residual layout of the JAX encoder. For
    ``hash_xadd`` K = 2^(D-1): the x0 rows of the (y, z) corners, weighted by y and z.
    """
    consts = _level_constants(spec, x.device)
    pg0, frac = _geometry(spec, consts, x)
    idx, w = _stack_corners([_corner(spec, consts, pg0, frac, b) for b in _corner_bits(spec)])
    return idx.reshape(x.shape[0], -1), w.reshape(x.shape[0], -1)


def _stack_corners(corners):
    """[(row [M, L], weight [M, L]) per corner] -> (idx [M, L, K] int32, w [M, L, K])."""
    return (torch.stack([c[0] for c in corners], -1).to(torch.int32),
            torch.stack([c[1] for c in corners], -1))


def pair_table(table: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """[total, C] -> [total, 2C] overlapped x-pair view: row q = [T[q], T[q + 1]].

    The +1 neighbour wraps within each level segment (the ``% size`` of the additive-x
    hash; linear levels never address a wrapping base row)."""
    parts = []
    for lvl in range(spec.num_levels):
        seg = table[spec.offsets[lvl]:spec.offsets[lvl + 1]]
        parts.append(torch.cat([seg, torch.roll(seg, -1, dims=0)], dim=1))
    return torch.cat(parts, dim=0)


def _wrap_plus_one(idx: torch.Tensor, spec: HashGridSpec, lvl_ids: torch.Tensor):
    """Level-local +1 neighbour of global rows ``idx`` whose level is ``lvl_ids``
    (broadcast against idx): the pair row's second half, as ``pair_table`` rolls it."""
    offsets = _level_constants(spec, idx.device)[5]
    lo = offsets[lvl_ids]
    return lo + (idx.to(torch.int64) - lo + 1) % (offsets[lvl_ids + 1] - lo)


def _position_hash_u(frac: torch.Tensor) -> torch.Tensor:
    """[M, L] uniforms from a hash of the finest level's cell position, mixed with the
    level index (the JAX fallback without ``rand``, :287-296)."""
    M, L, D = frac.shape
    coef = torch.tensor([12.9898, 78.233, 37.719][:D], dtype=torch.float32, device=frac.device)
    base = 0
    for d in range(D):
        base = base + frac[:, L - 1, d] * coef[d]
    lvl = torch.arange(L, dtype=torch.float32, device=frac.device)[None, :]
    s = torch.sin(base[:, None] + lvl * 1.6180339887) * 43758.5453
    return s - torch.floor(s)


def _encode(table, spec: HashGridSpec, x, u, stochastic: bool, residuals: bool = True):
    """x [M, D] -> (out [M, L*C], residuals), through the CUDA kernel where it takes the
    call (``_kernel_takes``; without ``residuals`` it writes the features alone, and
    returns None for them), else ``_encode_plain``; counted as ``encode.fused`` or
    ``encode.plain`` points (``utils.profiling``)."""
    M = x.shape[0]
    if _kernel_takes(table, spec, stochastic):
        profiling.count("encode.fused", M)
        return encode_kernel(table, spec, x, residuals)
    profiling.count("encode.plain", M)
    return _encode_plain(table, spec, x, u, stochastic)


def _encode_plain(table, spec: HashGridSpec, x, u, stochastic: bool):
    """x [M, D] -> (out [M, L*C], residuals). Residuals: exact (idx [M, L, K] int32,
    w [M, L, K], fx [M, L] for pairs, None); stochastic (drawn idx [M, L] int32, None,
    fx, rem [M, L] for pairs: the x-corner variate of the backward)."""
    C, L = spec.level_dim, spec.num_levels
    M = x.shape[0]
    pairs = _pairs(spec)
    consts = _level_constants(spec, x.device)
    pg0, frac = _geometry(spec, consts, x)
    fx = frac[..., 0] if pairs else None
    src = pair_table(table, spec) if pairs else table

    def interp(rows):
        """Gathered rows [..., Csrc] -> features [..., C] (x-interpolation for pairs)."""
        if not pairs:
            return rows
        f = fx[..., None].to(rows.dtype)
        return rows[..., :C] * (1 - f) + rows[..., C:] * f

    corners = [_corner(spec, consts, pg0, frac, b) for b in _corner_bits(spec)]
    rem = w = None
    if stochastic:
        if u is None:
            u = _position_hash_u(frac)
        csum = torch.zeros((M, L), dtype=torch.float32, device=x.device)
        for k, (idx_k, w_k) in enumerate(corners):
            if k == 0:
                chosen, prev, wsel = idx_k, csum, w_k
            else:  # the last corner k with u >= sum_{j<k} w_j wins
                sel = u >= csum
                chosen = torch.where(sel, idx_k, chosen)
                prev = torch.where(sel, csum, prev)
                wsel = torch.where(sel, w_k, wsel)
            csum = csum + w_k
        idx = chosen.to(torch.int32)
        acc = interp(src.index_select(0, idx.reshape(-1)).reshape(M, L, src.shape[1]))
        if pairs:
            rem = ((u - prev) / wsel.clamp_min(1e-9)).clamp(0.0, 1.0 - 1e-6)
    else:
        K = len(corners)
        idx, w = _stack_corners(corners)                                   # [M, L, K]
        rows = src.index_select(0, idx.reshape(-1)).reshape(M, L, K, src.shape[1])
        wt = w.to(table.dtype)
        acc = torch.zeros((M, L, C), dtype=table.dtype, device=table.device)
        for k in range(K):  # corner order of the JAX encoder's accumulation
            acc = acc + interp(rows[:, :, k]) * wt[:, :, k, None]
    oob = ((x < 0.0) | (x > 1.0)).any(-1)
    out = torch.where(oob[:, None], torch.zeros((), dtype=acc.dtype, device=acc.device),
                      acc.reshape(M, L * C))
    return out, (idx, w, fx, rem, oob)


def scatter_table_grad(idx: torch.Tensor, upd: torch.Tensor, total_rows: int,
                       scatter_dtype: Optional[torch.dtype],
                       period: Optional[int] = None) -> torch.Tensor:
    """One batched scatter-add of updates upd [U, C] at rows idx [U] (``_scatter_global``).

    bf16: updates rounded to bf16, summed in f32 by the scatter kernel (CPU: its plain
    version). Otherwise an f32 ``index_add_``. ``period``: the number of columns per
    point when idx is ``[M, period]`` flattened; with at least ``MIN_COLUMN_PERIOD`` of
    them the kernel works through the table a few levels at a time (``ops/scatter.py``),
    with fewer it takes the stream in its own order.
    """
    if scatter_dtype == torch.bfloat16:
        if period is not None and period < MIN_COLUMN_PERIOD:
            period = None
        return scatter_add(idx, upd.to(torch.bfloat16).contiguous(), total_rows, period)
    if scatter_dtype not in (None, torch.float32):
        raise ValueError(f"unsupported scatter_dtype {scatter_dtype}")
    out = torch.zeros((total_rows, upd.shape[1]), dtype=torch.float32, device=upd.device)
    return out.index_add_(0, idx.long(), upd.float())


def _backward_stream(spec: HashGridSpec, residuals, lvls, g, nearest_corner_grad: bool,
                     stochastic: bool, grad_levels: int):
    """The rows [U] int32, updates [U, C] and columns per point of the table gradient's
    one scatter (``_bwd``, hashgrid_fast.py:459-545)."""
    idx, w, fx, rem, oob = residuals
    C, L = spec.level_dim, spec.num_levels
    pairs = _pairs(spec)
    M = oob.shape[0]
    g = g.reshape(M, L, C).masked_fill(oob[:, None, None], 0)
    if grad_levels and grad_levels < L and lvls is not None:
        g = g[:, lvls] * (L / float(grad_levels))
        lvl_ids = lvls
        sel = lambda a: a[:, lvls]  # noqa: E731
    else:
        lvl_ids = torch.arange(L, device=g.device)
        sel = lambda a: a  # noqa: E731
    Leff = g.shape[1]

    if stochastic or nearest_corner_grad:
        if stochastic:
            rows = sel(idx)                                        # [M, Leff]
            x1 = (sel(rem) < sel(fx)) if pairs else None           # P(x1) = fx
        else:
            idx_s = sel(idx)                                       # [M, Leff, K]
            best = torch.argmax(sel(w), dim=-1, keepdim=True)      # first index on ties
            rows = torch.gather(idx_s, -1, best)[..., 0]
            x1 = (sel(fx) > 0.5) if pairs else None                # the nearer x-corner
        if pairs:
            rows = torch.where(x1, _wrap_plus_one(rows, spec, lvl_ids), rows.to(torch.int64))
        return rows.reshape(-1).to(torch.int32), g.reshape(M * Leff, C), Leff

    idx_s = sel(idx)                                               # [M, Leff, K]
    K = idx_s.shape[-1]
    gw = g[:, :, None, :] * sel(w)[..., None]                      # [M, Leff, K, C]
    if pairs:
        # both x-corners of every base pair, as two C-wide halves of one stream
        f = sel(fx)[:, :, None, None]
        rows = torch.cat([idx_s.reshape(-1).to(torch.int64),
                          _wrap_plus_one(idx_s, spec, lvl_ids[:, None]).reshape(-1)])
        upd = torch.cat([(gw * (1 - f)).reshape(-1, C), (gw * f).reshape(-1, C)])
        return rows.to(torch.int32), upd, Leff * K
    return idx_s.reshape(-1), gw.reshape(-1, C), Leff * K


class _HashGridEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, x, u, lvls, spec, scatter_dtype, nearest_corner_grad,
                stochastic, grad_levels):
        out, (idx, w, fx, rem, oob) = _encode(table, spec, x, u, stochastic)
        ctx.save_for_backward(idx, w, fx, rem, oob, lvls)
        ctx.spec, ctx.scatter_dtype, ctx.table_dtype = spec, scatter_dtype, table.dtype
        ctx.modes = (nearest_corner_grad, stochastic, grad_levels)
        return out

    @staticmethod
    def backward(ctx, g):
        idx, w, fx, rem, oob, lvls = ctx.saved_tensors
        spec = ctx.spec
        rows, upd, period = _backward_stream(spec, (idx, w, fx, rem, oob), lvls, g,
                                             *ctx.modes)
        grad = scatter_table_grad(rows.contiguous(), upd, spec.total_params,
                                  ctx.scatter_dtype, period=period)
        return (grad.to(ctx.table_dtype),) + (None,) * 8


def hashgrid_encode_fast(table: torch.Tensor, x01: torch.Tensor, spec: HashGridSpec,
                         scatter_dtype: Optional[torch.dtype] = None,
                         nearest_corner_grad: bool = False, stochastic: bool = False,
                         rand: Optional[EncodeRand] = None,
                         grad_levels: int = 0) -> torch.Tensor:
    """table [total, C]; x01 [..., D] in [0, 1] -> [..., L*C]. Differentiable in
    ``table`` only (as the JAX encoder).

    ``scatter_dtype=torch.bfloat16`` is the ``-O`` backward. ``nearest_corner_grad``:
    the backward routes each (point, level) to its largest-weight corner only (biased;
    the forward stays exact). ``stochastic``: the Monte-Carlo corner draw of the forward
    (training only), whose backward goes to the drawn row. ``rand``: the draws of
    ``make_encode_rand`` (u [..., L] for the corner draw, lvls for ``grad_levels``).
    ``grad_levels``: the backward scatters the K levels ``rand.lvls`` only, scaled by
    L/K (all levels without ``rand.lvls``).
    """
    L = spec.num_levels
    lead = x01.shape[:-1]
    x = x01.reshape(-1, spec.input_dim).to(torch.float32)
    u = lvls = None
    if rand is not None:
        u = None if rand.u is None else rand.u.reshape(-1, L)
        lvls = rand.lvls
    if not (torch.is_grad_enabled() and table.requires_grad):  # no backward
        if _kernel_takes(table, spec, stochastic):  # all points in one launch, no residuals
            out = _encode(table, spec, x, u, stochastic, residuals=False)[0]
        else:  # passes of NO_GRAD_CHUNK points (each point's features depend on that point
            #    alone, so the result is the same bit for bit)
            out = torch.cat([
                _encode(table, spec, x[s:s + NO_GRAD_CHUNK],
                        None if u is None else u[s:s + NO_GRAD_CHUNK], stochastic)[0]
                for s in range(0, max(x.shape[0], 1), NO_GRAD_CHUNK)])
    else:
        out = _HashGridEncode.apply(table, x, u, lvls, spec, scatter_dtype,
                                    bool(nearest_corner_grad), bool(stochastic),
                                    int(grad_levels))
    return out.reshape(*lead, spec.output_dim)


def hashgrid_encode_fast_bounded(table, x, spec: HashGridSpec, bound: float,
                                 scatter_dtype: Optional[torch.dtype] = None,
                                 nearest_corner_grad: bool = False, stochastic: bool = False,
                                 rand: Optional[EncodeRand] = None, grad_levels: int = 0):
    """Encode world positions in [-bound, bound] (grid.py:138-150)."""
    return hashgrid_encode_fast(table, (x + bound) / (2.0 * bound), spec, scatter_dtype,
                                nearest_corner_grad, stochastic, rand, grad_levels)
