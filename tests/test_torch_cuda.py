"""Tests of the port that need the card (marker ``cuda``; they skip without one).

This file imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch + CUDA:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each CUDA result is held against the port's own plain version of the same function,
run on the same inputs.
"""

import numpy as np
import pytest
import torch

from palettenerf_torch.config import Config
from palettenerf_torch.models.nerf import NeRFSpec, init_nerf, param_list
from palettenerf_torch.ops import hashgrid_fast, scatter, window_gather
from palettenerf_torch.ops.hashgrid import HashGridSpec
from palettenerf_torch.train.trainer import Trainer
from torch_support import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda


def _within(got, ref, scale, rtol):
    return bool(((got - ref).abs() <= rtol * scale + 1e-12).all())


@pytest.mark.parametrize("C", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("period", [None, 128])
def test_scatter_kernel_matches_plain_version(cuda_device, C, period):
    gen = torch.Generator(device=cuda_device).manual_seed(C)
    total, U = 100_003, 1 << 20
    idx = torch.randint(0, total, (U,), generator=gen, device=cuda_device, dtype=torch.int32)
    vals = torch.randn((U, C), generator=gen, device=cuda_device).to(torch.bfloat16)
    before = scatter.scatter_add.launches
    got = scatter.scatter_add(idx, vals, total, period)
    assert scatter.scatter_add.launches == before + 1
    ref = scatter.scatter_add_reference(idx, vals, total)
    scale = scatter.scatter_add_reference(idx, vals.abs(), total)
    torch.cuda.synchronize()
    scatter.check_refused()
    assert _within(got, ref, scale, 1e-5)  # f32 atomics sum in another order


# the path's call (column walk), the call without a period (one vector atomic per row in
# stream order) and the yardstick they are timed against: (period, scalar) of _scatter_add
KERNELS = {"columns": (128, False), "rows": (None, False), "scalar": (128, True)}


@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_scatter_kernel_exact_on_periodic_duplicates(cuda_device, C, kernel):
    """Equal rows one period apart (12 points in a row share each row), a zero-valued
    stretch, and a point count that no walk length or block divides: counts are exact."""
    n_pts, P = 1000 + 3, 128
    point = torch.arange(n_pts, device=cuda_device, dtype=torch.int32)
    idx = ((point // 12)[:, None] * P
           + torch.arange(P, device=cuda_device, dtype=torch.int32)[None, :]).reshape(-1)
    vals = torch.ones((n_pts, P, C), device=cuda_device, dtype=torch.bfloat16)
    vals[200:300] = 0
    vals = vals.reshape(-1, C)
    total = int(idx.max()) + 7
    got = scatter._scatter_add(idx, vals, total, *KERNELS[kernel])
    torch.cuda.synchronize()
    scatter.check_refused()
    assert torch.equal(got, scatter.scatter_add_reference(idx, vals, total))
    assert float(got.max()) == 12.0 and float(got[-6:].abs().max()) == 0.0


def test_scatter_kernel_exact_on_duplicates_and_empty_rows(cuda_device):
    idx = (torch.arange(1 << 16, device=cuda_device, dtype=torch.int32) % 5).contiguous()
    got = scatter.scatter_add(idx, torch.ones((1 << 16, 2), device=cuda_device,
                                              dtype=torch.bfloat16), 1000)
    torch.cuda.synchronize()
    counts = torch.bincount(idx.long(), minlength=1000).float()
    assert torch.equal(got[:, 0], counts) and torch.equal(got[:, 1], counts)
    before = scatter.scatter_add.launches
    empty = scatter.scatter_add(torch.zeros(0, dtype=torch.int32, device=cuda_device),
                                torch.zeros((0, 2), dtype=torch.bfloat16, device=cuda_device), 7)
    assert empty.shape == (7, 2) and float(empty.abs().max()) == 0.0
    assert scatter.scatter_add.launches == before  # nothing to launch


def test_scatter_kernel_rejects_what_it_does_not_take(cuda_device):
    idx = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    ones = torch.ones((4, 2), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        scatter.scatter_add(idx, torch.ones((4, 2), device=cuda_device), 8)  # f32 vals
    with pytest.raises(TypeError):
        scatter.scatter_add(idx.long(), ones, 8)
    with pytest.raises(ValueError):
        scatter.scatter_add(idx, torch.ones((4, 2), dtype=torch.bfloat16), 8)  # mixed devices
    with pytest.raises(ValueError, match="period"):
        scatter.scatter_add(idx, ones, 8, 3)
    with pytest.raises(ValueError, match="contiguous"):
        scatter.scatter_add(idx, torch.ones((4, 4), device=cuda_device,
                                            dtype=torch.bfloat16)[:, ::2], 8)
    flat = torch.ones(9, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        scatter.scatter_add(idx, flat[1:].view(4, 2), 8)  # rows at an odd 2-byte offset


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_scatter_kernel_refuses_rows_out_of_range(cuda_device, kernel):
    """A row outside [0, total_rows) is never written and never silent: the call
    returns without reading the device, the next check_refused() raises, once."""
    idx = torch.tensor([0, 1, 9, 3, 0, 1, -1, 3], dtype=torch.int32, device=cuda_device)
    period, scalar = KERNELS[kernel]
    got = scatter._scatter_add(idx, torch.ones((8, 2), device=cuda_device, dtype=torch.bfloat16),
                               8, period and 4, scalar)
    torch.cuda.synchronize()
    want = torch.zeros((8, 2), device=cuda_device)
    want[[0, 1, 3]] = 2.0
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="2 indices outside"):
        scatter.check_refused()
    scatter.check_refused()


def test_wrappers_read_nothing_back_from_the_card(cuda_device):
    """No device-to-host read (which would stall the launch queue) in either wrapper:
    PyTorch's sync debug mode turns any synchronising call into an error."""
    idx = torch.arange(1 << 12, dtype=torch.int32, device=cuda_device) % 77
    vals = torch.ones((1 << 12, 2), device=cuda_device, dtype=torch.bfloat16)
    W = torch.randn((8, 128), device=cuda_device)
    r = torch.zeros((4, 128), dtype=torch.int32, device=cuda_device)
    scatter.scatter_add(idx, vals, 100, 128)      # builds and loads outside the guard
    window_gather.window_gather(W, r, r)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = scatter.scatter_add(idx, vals, 100, 128)
        got_rows = scatter.scatter_add(idx, vals, 100)
        picked = window_gather.window_gather(W, r, r)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(got, got_rows) and float(got.sum()) == 2.0 * (1 << 12)
    assert torch.equal(picked, W[0, 0].expand(4, 128))


def test_bf16_table_grad_on_card_matches_cpu(cuda_device):
    spec = HashGridSpec.build(num_levels=8, desired_resolution=512, log2_hashmap_size=14)
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.total_params, 2)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0, 1, (4096, 3)).astype(np.float32))
    co = torch.from_numpy(rng.normal(size=(4096, spec.output_dim)).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda_device):
        t = table.to(dev, copy=True).requires_grad_(True)
        out = hashgrid_fast.hashgrid_encode_fast(t, x.to(dev), spec, torch.bfloat16)
        (out * co.to(dev)).sum().backward()
        grads.append((out.detach().cpu(), t.grad.cpu()))
    (out_c, g_c), (out_g, g_g) = grads
    torch.testing.assert_close(out_g, out_c, rtol=0, atol=1e-6)
    # one bf16 ulp of an update (2^-8 relative) when the f32 update differs in its last bit
    assert float((g_g - g_c).abs().max()) <= 1e-2 * float(g_c.abs().max())


def test_train_step_on_card_matches_cpu(cuda_device, tmp_path):
    cfg = Config(O=True, fp16=True, bound=1.0, grid_size=32, num_rays=512, max_steps=256,
                 train_samples_per_ray=32, log2_hashmap_size=14, grid_levels=8, iters=100)
    spec = NeRFSpec.build(bound=1.0, fp16=True, log2_hashmap_size=14, grid_levels=8)
    gen = torch.Generator().manual_seed(1)
    params = init_nerf(spec, gen)
    params["encoder"].uniform_(-1, 1, generator=gen)
    n = cfg.num_rays
    o = torch.randn((n, 3), generator=gen)
    o = o / o.norm(dim=-1, keepdim=True) * 2.0
    d = -o + 0.5 * torch.randn((n, 3), generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    img, bg, noise = (torch.rand((n, 4), generator=gen), torch.rand((n, 3), generator=gen),
                      torch.rand((n,), generator=gen))
    out = []
    for dev in ("cpu", cuda_device):
        tr = Trainer("t", cfg, spec, params={k: (v.clone() if torch.is_tensor(v)
                                                 else [w.clone() for w in v])
                                             for k, v in params.items()},
                     workspace=str(tmp_path), use_checkpoint="scratch", mute=True, device=dev)
        tr.grid_state = tr.grid_state._replace(
            bitfield=torch.full_like(tr.grid_state.bitfield, 255))
        before = scatter.scatter_add.launches
        loss, _ = tr.train_step(o.to(tr.device), d.to(tr.device), img.to(tr.device),
                                bg=bg.to(tr.device), noise=noise.to(tr.device))
        launched = scatter.scatter_add.launches - before
        out.append((float(loss), [p.grad.cpu() for p in param_list(tr.params)], launched))
    (loss_c, g_c, n_c), (loss_g, g_g, n_g) = out
    assert (n_c, n_g) == (0, 1)
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    for a, b in zip(g_c, g_g):
        assert float((a - b).abs().max()) <= 1e-2 * float(a.abs().max())


@pytest.mark.parametrize("rows", [1, 8, 32])
@pytest.mark.parametrize("m8", [1, 3, 100, 65536])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_gather_kernel_is_bit_exact(cuda_device, rows, m8, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(rows + m8)
    W = torch.randn((rows, 128), generator=gen, device=cuda_device).to(dtype)
    r = torch.randint(0, rows, (m8, 128), generator=gen, device=cuda_device, dtype=torch.int32)
    c = torch.randint(0, 128, (m8, 128), generator=gen, device=cuda_device, dtype=torch.int32)
    before = window_gather.window_gather.launches
    got = window_gather.window_gather(W, r, c)
    assert window_gather.window_gather.launches == before + 1
    ref = window_gather.window_gather_reference(W, r, c)
    torch.cuda.synchronize()
    window_gather.check_refused()
    assert got.dtype == dtype and torch.equal(got, ref)


def test_window_gather_kernel_rejects_what_it_does_not_take(cuda_device):
    W = torch.zeros((8, 128), device=cuda_device)
    r = torch.zeros((4, 128), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        window_gather.window_gather(W.double(), r, r)
    with pytest.raises(ValueError):
        window_gather.window_gather(W.cpu(), r, r)  # mixed devices
    with pytest.raises(ValueError):
        window_gather.window_gather(W.t().contiguous().t(), r, r.t().contiguous().t())
    flat = torch.zeros(4 * 128 + 1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        window_gather.window_gather(W, flat[1:].view(4, 128), r)  # 4 bytes off a 16-byte line


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_gather_kernel_refuses_indices_out_of_range(cuda_device, dtype):
    """An index outside the window is never used as an address: its output is zero
    bits, every other output is right, and the next check_refused() raises, once."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    W = (torch.rand((8, 128), generator=gen, device=cuda_device) + 1.0).to(dtype)
    r = torch.randint(0, 8, (5, 128), generator=gen, device=cuda_device, dtype=torch.int32)
    c = torch.randint(0, 128, (5, 128), generator=gen, device=cuda_device, dtype=torch.int32)
    want = window_gather.window_gather_reference(W, r, c)
    r[0, 1], r[4, 127], c[2, 64], c[3, 3] = 8, -1, 128, -5
    for i, j in ((0, 1), (4, 127), (2, 64), (3, 3)):
        want[i, j] = 0
    got = window_gather.window_gather(W, r, c)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="4 indices outside"):
        window_gather.check_refused()
    window_gather.check_refused()
