"""The hash-grid encoder's exact forward kernel (``csrc/hashgrid_encode.cu``) and the
dispatch that sends an encode to it or to the plain version.

This file imports neither JAX nor the JAX package. The tests marked ``cuda`` hold the
kernel against the plain version (``hashgrid_fast._encode_plain``) on the card, bit for
bit; they skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_hashgrid_cuda.py

The others run on the CPU, with the kernel's entry stubbed.
"""

import ctypes

import numpy as np
import pytest
import torch

from palettenerf_torch.models.nerf import background_grid
from palettenerf_torch.ops import hashgrid_fast as hf
from palettenerf_torch.ops import scatter
from palettenerf_torch.ops.hashgrid import HashGridSpec
from palettenerf_torch.utils import profiling
from torch_support import CPU_THREADS, cuda_device  # noqa: F401  (fixture)

torch.set_num_threads(CPU_THREADS)

# the cells' encoder (ngp-nerf and palettenerf): 16 levels x 2, 2^19 rows a level
FULL = dict(num_levels=16, level_dim=2, log2_hashmap_size=19, desired_resolution=2048)
SMALL = dict(num_levels=6, level_dim=2, log2_hashmap_size=12, desired_resolution=512)


def _points(n, seed, device="cpu"):
    """n points over [-0.05, 1.05]^3 whose first ones sit on the box's faces (0 and 1
    exactly, and corners of the box) and just outside them."""
    x = np.random.default_rng(seed).uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    faces = np.array([[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0.25, 0], [0.5, 0.5, 1],
                      [-1e-7, 0.5, 0.5], [0.5, 1 + 1e-7, 0.5], [0.3, 0.6, 0.9]], np.float32)
    k = min(n, len(faces))
    x[:k] = faces[:k]
    return torch.from_numpy(x).to(device)


def _table(spec, seed, device="cpu", dtype=torch.float32):
    t = np.random.default_rng(seed).uniform(-1, 1, (spec.total_params, spec.level_dim))
    return torch.from_numpy(t.astype(np.float32)).to(device=device, dtype=dtype)


# ---------------------------------------------------------------- dispatch, on the CPU

def _stub_kernel(monkeypatch, on_card: bool):
    """The kernel's entry replaced by the plain version, counting its calls; with
    ``on_card`` the dispatch takes CPU tensors for card tensors."""
    calls = []

    def stub(table, spec, x, residuals=True):
        calls.append(x.shape[0])
        out, res = hf._encode_plain(table, spec, x, None, False)
        return out, (res if residuals else None)

    monkeypatch.setattr(hf, "encode_kernel", stub)
    monkeypatch.setattr(hf, "_on_card", lambda table: on_card)
    return calls


# (spec kwargs, table dtype, stochastic) of each call the kernel must not take
PLAIN_CASES = {
    "stochastic": (dict(SMALL), torch.float32, True),
    "hash_xadd": (dict(SMALL, gridtype="hash_xadd"), torch.float32, False),
    "input_dim_2": (None, torch.float32, False),
    "bf16_table": (dict(SMALL), torch.bfloat16, False),
    "channels_3": (dict(SMALL, level_dim=3), torch.float32, False),
}


def _encode_both_ways(table, spec, x, stochastic):
    """The encoder's two entries: without a backward, and with one (the table's grad)."""
    rand = hf.EncodeRand(u=torch.rand((x.shape[0], spec.num_levels),
                                      generator=torch.Generator().manual_seed(3)))
    with torch.no_grad():
        out = hf.hashgrid_encode_fast(table, x, spec, stochastic=stochastic, rand=rand)
    t = table.detach().clone().requires_grad_(True)
    out_g = hf.hashgrid_encode_fast(t, x, spec, stochastic=stochastic, rand=rand)
    out_g.float().sum().backward()
    return out, out_g.detach(), t.grad


@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_dispatch_keeps_the_plain_path(monkeypatch, case):
    """Every mode the kernel does not take gives what it gave before, without a call to
    the kernel, even where the table counts as lying on the card."""
    kw, dtype, stochastic = PLAIN_CASES[case]
    spec = background_grid(1.0) if kw is None else HashGridSpec.build(**kw)
    table = _table(spec, 1, dtype=dtype)
    x = torch.rand((500, spec.input_dim), generator=torch.Generator().manual_seed(2))
    want = _encode_both_ways(table, spec, x, stochastic)
    calls = _stub_kernel(monkeypatch, on_card=True)
    got = _encode_both_ways(table, spec, x, stochastic)
    assert calls == []
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [dict(SMALL), dict(SMALL, gridtype="tiled"),
                                dict(SMALL, align_corners=True), dict(SMALL, level_dim=4)],
                         ids=["hash", "tiled", "align_corners", "channels_4"])
def test_dispatch_sends_the_exact_forward_to_the_kernel(monkeypatch, kw):
    """On the card the exact forward is one kernel call per encode, over all points with
    no backward (no passes of NO_GRAD_CHUNK), with residuals where one follows; the
    backward modes that change only the backward keep it. CPU tensors never reach it."""
    spec = HashGridSpec.build(**kw)
    table = _table(spec, 4)
    x = _points(700, 5)
    calls = _stub_kernel(monkeypatch, on_card=False)
    want = _encode_both_ways(table, spec, x, False)
    assert calls == []
    monkeypatch.setattr(hf, "_on_card", lambda table: True)
    monkeypatch.setattr(hf, "NO_GRAD_CHUNK", 128)
    got = _encode_both_ways(table, spec, x, False)
    assert calls == [700, 700]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    t = table.clone().requires_grad_(True)
    hf.hashgrid_encode_fast(t, x, spec, nearest_corner_grad=True, grad_levels=2,
                            rand=hf.EncodeRand(lvls=torch.tensor([3, 0]))).sum().backward()
    assert calls == [700, 700, 700] and t.grad.abs().sum() > 0


def test_encode_counters_name_the_path(monkeypatch):
    """``encode.plain`` counts every point of a plain encode (once, whatever its passes)
    and ``encode.fused`` none; the kernel's encodes count the other way round."""
    spec = HashGridSpec.build(**SMALL)
    table = _table(spec, 6)
    x = _points(600, 7)
    monkeypatch.setattr(hf, "NO_GRAD_CHUNK", 256)
    profiling.reset()
    profiling.enable()
    try:
        _encode_both_ways(table, spec, x, False)
        plain = dict(profiling.snapshot()["counters"])
        profiling.reset()
        _stub_kernel(monkeypatch, on_card=True)
        _encode_both_ways(table, spec, x, False)
        fused = dict(profiling.snapshot()["counters"])
    finally:
        profiling.enable(False)
        profiling.reset()
    assert plain.get("encode.plain") == 2 * 600 and "encode.fused" not in plain
    assert fused.get("encode.fused") == 2 * 600 and "encode.plain" not in fused


@pytest.mark.parametrize("kw", [dict(FULL), dict(SMALL, gridtype="tiled", align_corners=True),
                                dict(num_levels=32, level_dim=1, log2_hashmap_size=14,
                                     desired_resolution=4096)],
                         ids=["full", "tiled_align_corners", "levels_32"])
def test_kernel_level_arguments_are_the_plain_versions_constants(kw):
    """The host arrays the kernel gets per level hold what the plain version computes
    with: the f32 scales bit for bit, sizes, first rows, strides and the hashed flags."""
    spec = HashGridSpec.build(**kw)
    L = spec.num_levels
    scales, sizes, offs, strides, hashed = hf._kernel_levels(spec)
    c = hf._level_constants(spec, torch.device("cpu"))
    assert torch.equal(torch.tensor(scales[:L], dtype=torch.float32), c[0])
    assert sizes[:L] == c[1].tolist() and offs[:L] == c[2].tolist()
    assert strides[:3 * L] == c[4].reshape(-1).tolist()
    assert [bool(h) for h in hashed[:L]] == c[3].tolist()
    assert isinstance(scales, ctypes.Array) and len(strides) == 3 * L
    assert all(0 <= s < 2 ** 32 for s in strides[:3 * L])


# ---------------------------------------------------------------- the kernel, on the card

def _plain_on_card(monkeypatch):
    """Route every encode of the test to the plain version, on the card too."""
    monkeypatch.setattr(hf, "_kernel_takes", lambda table, spec, stochastic: False)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [0, 1, 255, 1000 + 3])
@pytest.mark.parametrize("kw", [dict(SMALL), dict(SMALL, gridtype="tiled"),
                                dict(SMALL, align_corners=True),
                                dict(SMALL, gridtype="tiled", align_corners=True),
                                dict(SMALL, level_dim=1), dict(SMALL, level_dim=8)],
                         ids=["hash", "tiled", "hash_align", "tiled_align", "C1", "C8"])
def test_kernel_equals_the_plain_version(cuda_device, kw, M):
    """Features, rows, weights and the out-of-box mask equal the plain version's on the
    card bit for bit, with and without residuals, on points that include the box's faces
    and points outside it, and point counts that no block divides."""
    spec = HashGridSpec.build(**kw)
    table = _table(spec, 8, cuda_device)
    x = _points(M, 9, cuda_device)
    out_p, res_p = hf._encode_plain(table, spec, x, None, False)
    before = hf.encode_kernel.launches
    out_k, res_k = hf.encode_kernel(table, spec, x, True)
    out_n, res_n = hf.encode_kernel(table, spec, x, False)
    torch.cuda.synchronize()
    assert hf.encode_kernel.launches == before + (2 if M else 0)
    assert res_n is None and res_k[2] is None and res_k[3] is None
    assert torch.equal(out_k, out_p) and torch.equal(out_n, out_p)
    for got, want in zip((res_k[0], res_k[1], res_k[4]), (res_p[0], res_p[1], res_p[4])):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("scatter_dtype", [torch.bfloat16, None], ids=["B1", "f32"])
def test_kernel_backward_equals_the_plain_versions(cuda_device, monkeypatch, scatter_dtype):
    """With a backward the kernel's forward, its residuals and so the update stream of the
    table gradient are the plain version's bit for bit; the gradient itself agrees to the
    f32 atomics' order (the same stream summed twice on the card)."""
    spec = HashGridSpec.build(num_levels=8, desired_resolution=512, log2_hashmap_size=14)
    table = _table(spec, 10, cuda_device)
    x = _points(20_000, 11, cuda_device)
    co = torch.randn((20_000, spec.output_dim), generator=torch.Generator().manual_seed(12)
                     ).to(cuda_device)
    before = hf.encode_kernel.launches
    t_k = table.clone().requires_grad_(True)
    out_k = hf.hashgrid_encode_fast(t_k, x, spec, scatter_dtype)
    (out_k * co).sum().backward()
    assert hf.encode_kernel.launches == before + 1
    _plain_on_card(monkeypatch)
    t_p = table.clone().requires_grad_(True)
    out_p = hf.hashgrid_encode_fast(t_p, x, spec, scatter_dtype)
    (out_p * co).sum().backward()
    assert hf.encode_kernel.launches == before + 1
    assert torch.equal(out_k, out_p)
    stream_k = hf._backward_stream(spec, hf.encode_kernel(table, spec, x)[1], None, co,
                                   False, False, 0)
    stream_p = hf._backward_stream(spec, hf._encode_plain(table, spec, x, None, False)[1],
                                   None, co, False, False, 0)
    assert torch.equal(stream_k[0], stream_p[0]) and torch.equal(stream_k[1], stream_p[1])
    scale = scatter.scatter_add_reference(stream_p[0], stream_p[1].abs(), spec.total_params)
    torch.cuda.synchronize()
    scatter.check_refused()
    assert bool(((t_k.grad - t_p.grad).abs() <= 1e-5 * scale + 1e-12).all())


@pytest.mark.cuda
@pytest.mark.parametrize("M, grad", [(1 << 18, True), (1 << 20, False)],
                         ids=["train_262144", "exact_round0_1048576"])
def test_kernel_equals_the_plain_version_at_the_cells_shapes(cuda_device, monkeypatch, M, grad):
    """The ngp-nerf encoder (16 levels x 2, 6,119,864 rows) at a train batch's points
    with residuals and at round 0 of an exact chunk's without: equal bit for bit."""
    spec = HashGridSpec.build(**FULL)
    table = _table(spec, 13, cuda_device)
    x = _points(M, 14, cuda_device)
    if grad:
        got, res_k = hf.encode_kernel(table, spec, x)
        want, res_p = hf._encode_plain(table, spec, x, None, False)
        assert all(torch.equal(res_k[i], res_p[i]) for i in (0, 1, 4))
    else:
        with torch.no_grad():
            got = hf.hashgrid_encode_fast(table, x, spec)
            _plain_on_card(monkeypatch)
            want = hf.hashgrid_encode_fast(table, x, spec)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("gridtype", ["hash", "tiled"])
def test_kernel_reads_nothing_outside_the_table(cuda_device, gridtype):
    """NaN, inf and huge coordinates: rows stay inside the table (a table set between
    rows of NaN shows any read outside it), and the results are the plain version's."""
    spec = HashGridSpec.build(**dict(SMALL, gridtype=gridtype))
    pad = 64
    buf = torch.full((spec.total_params + 2 * pad, 2), float("nan"), device=cuda_device)
    table = buf[pad:pad + spec.total_params]
    table.copy_(_table(spec, 15, cuda_device))
    nan, inf = float("nan"), float("inf")
    odd = torch.tensor([[nan, 0.5, 0.5], [0.5, nan, nan], [inf, 0.5, 0.5], [-inf, 0.2, 0.3],
                        [0.5, 0.5, inf], [1e30, 0.5, 0.5], [-1e30, -1e30, -1e30],
                        [3.5e9, 0.1, 0.1], [0.5, -4.3e9, 0.5], [0.5, 0.5, 0.5]],
                       device=cuda_device)
    x = torch.cat([odd, _points(500, 16, cuda_device)])
    out_k, res_k = hf.encode_kernel(table, spec, x)
    out_p, res_p = hf._encode_plain(table, spec, x, None, False)
    torch.cuda.synchronize()
    finite = torch.isfinite(x).all(-1)
    assert not out_k[finite].isnan().any()
    assert not out_k[~finite & ~x.isnan().any(-1)].any()  # inf: outside the box, zero
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(res_k[0], res_p[0]) and torch.equal(res_k[4], res_p[4])
    assert int(res_k[0].min()) >= 0 and int(res_k[0].max()) < spec.total_params


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    spec = HashGridSpec.build(**SMALL)
    table = _table(spec, 17, cuda_device)
    x = _points(8, 18, cuda_device)
    with pytest.raises(ValueError, match="need table"):
        hf.encode_kernel(table[:-8], spec, x)
    with pytest.raises(ValueError, match="need table"):
        hf.encode_kernel(table, spec, x[:, :2])
    with pytest.raises(ValueError, match="one CUDA device"):
        hf.encode_kernel(table, spec, x.cpu())
    with pytest.raises(ValueError, match="one CUDA device"):
        hf.encode_kernel(table, spec, x.double())
    flat = torch.zeros(2 * spec.total_params + 1, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        hf.encode_kernel(flat[1:].view(spec.total_params, 2), spec, x)


@pytest.mark.cuda
def test_kernel_wrapper_reads_nothing_back_from_the_card(cuda_device):
    """No device-to-host read in the kernel's wrapper or in the encoder around it, with
    and without a backward: PyTorch's sync debug mode turns any synchronising call into
    an error."""
    spec = HashGridSpec.build(**SMALL)
    table = _table(spec, 19, cuda_device)
    x = _points(4096, 20, cuda_device)
    hf.encode_kernel(table, spec, x)             # builds and loads outside the guard
    t = table.clone().requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, res = hf.encode_kernel(table, spec, x)
        with torch.no_grad():
            feats = hf.hashgrid_encode_fast(table, x, spec)
        out_g = hf.hashgrid_encode_fast(t, x, spec, torch.bfloat16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out_g.sum().backward()
    torch.cuda.synchronize()
    assert torch.equal(out, feats) and torch.equal(out, out_g.detach())
    assert res[0].shape == (4096, spec.num_levels, 8)
