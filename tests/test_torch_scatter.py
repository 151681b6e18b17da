"""Port parity: palettenerf_torch scatter_add (plain version on the CPU) against the
JAX Pallas kernel ``tile_scatter_add`` run in interpret mode, on the cases of
tests/test_pallas_scatter.py, and on a path-like stream (points ordered along rays
through the encoder's corner indices, so that equal rows lie one period apart). Values
are bf16-representable, so both sums are exact up to summation order (atol 1e-5; on the
path-like stream 1e-5 of each row's summed |update|)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.ops.pallas_scatter import TILE, TPP, tile_scatter_add
from palettenerf_torch.ops import hashgrid_fast
from palettenerf_torch.ops import scatter as port_scatter
from palettenerf_torch.ops._cuda import RefusedCounter
from palettenerf_torch.ops.hashgrid import HashGridSpec
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
ATOL = 1e-5


def _both(idx_np, vals_np, total, period=None):
    ref = np.asarray(tile_scatter_add(jnp.asarray(idx_np), jnp.asarray(vals_np), total,
                                      interpret=True))
    got = port_scatter.scatter_add(torch.from_numpy(idx_np),
                                   torch.from_numpy(np.array(vals_np)).to(torch.bfloat16), total,
                                   period)
    assert got.dtype == torch.float32 and tuple(got.shape) == (total, vals_np.shape[1])
    return ref, got.numpy()


@pytest.mark.parametrize("total,U,C", [
    (TILE * TPP * 2, 4096, 2),
    (TILE * 3 + 17, 2048, 2),
    (TILE * TPP + 1, 8192, 1),
])
def test_matches_pallas_tile_scatter(total, U, C):
    rng = np.random.default_rng(0)
    idx = rng.integers(0, total, U).astype(np.int32)
    vals = np.asarray(jnp.asarray(rng.normal(size=(U, C)), jnp.bfloat16).astype(jnp.float32))
    ref, got = _both(idx, vals, total)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_heavy_duplicates_accumulate():
    total, U = TILE * 2, 4096
    idx = np.zeros(U, np.int32)
    idx[1:] = np.arange(1, U) % 7
    ref, got = _both(idx, np.ones((U, 2), np.float32), total)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert got[0, 0] == (U + 6) // 7 and got[7:].max() == 0.0


def test_empty_tiles_zero():
    total = TILE * TPP
    idx = np.arange(256, dtype=np.int32)
    ref, got = _both(idx, np.ones((256, 2), np.float32), total)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert np.abs(got[TILE:]).max() == 0.0


@pytest.mark.parametrize("bad", [-1, 100])
def test_rejects_rows_out_of_range(bad):
    idx = torch.tensor([0, bad], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        port_scatter.scatter_add(idx, torch.ones((2, 2), dtype=torch.bfloat16), 100)


def test_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        port_scatter.scatter_add(torch.zeros(3, dtype=torch.int32),
                                 torch.ones((2, 2), dtype=torch.bfloat16), 10)


def test_cpu_path_does_not_count_kernel_launches():
    before = port_scatter.scatter_add.launches
    port_scatter.scatter_add(torch.zeros(4, dtype=torch.int32),
                             torch.ones((4, 2), dtype=torch.bfloat16), 8)
    assert port_scatter.scatter_add.launches == before


# ------------------------------------------------------------------ path-like stream

SPEC = HashGridSpec.build(num_levels=8, desired_resolution=512, log2_hashmap_size=14)
PERIOD = SPEC.num_levels * 8  # corner columns per point


def _path_like_stream(C, n_rays=16, n_samples=32, seed=0):
    """Points ordered along rays (ray-major, short steps), through the encoder's corner
    indices: idx [M * PERIOD] int32, bf16-representable vals [M * PERIOD, C]."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.1, 0.4, (n_rays, 1, 3))
    d = rng.normal(size=(n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = (np.arange(n_samples) * 0.004)[None, :, None]
    x = np.clip(o + np.abs(d) * t, 0.0, 1.0).reshape(-1, 3).astype(np.float32)
    idx = hashgrid_fast.corner_indices(SPEC, torch.from_numpy(x))[0].reshape(-1).numpy()
    vals = np.array(jnp.asarray(rng.normal(size=(idx.size, C)), jnp.bfloat16)
                    .astype(jnp.float32))
    return idx, vals


def test_path_like_stream_has_equal_rows_one_period_apart():
    idx, _ = _path_like_stream(2)
    cols = idx.reshape(-1, PERIOD)
    repeats = cols[1:] == cols[:-1]
    # neighbouring samples of a ray share their cell on the coarse levels, rarely on the fine
    assert repeats[:, :8].mean() > 0.8 and repeats.mean() > 0.3
    assert repeats[:, -8:].mean() < repeats[:, :8].mean()
    assert (idx[1:] == idx[:-1]).mean() < 0.05  # and are not adjacent in the flat stream


@pytest.mark.parametrize("C", [2, 4, 1])
def test_path_like_stream_matches_pallas_tile_scatter(C):
    idx, vals = _path_like_stream(C, seed=C)
    total = SPEC.total_params
    ref, got = _both(idx, vals, total, PERIOD)
    scale = np.zeros((total, C), np.float32)
    np.add.at(scale, idx, np.abs(vals))
    # both sum the same bf16 values in f32, in another order
    assert np.all(np.abs(got - ref) <= 1e-5 * scale + 1e-12)
    assert np.abs(got).max() > 1.0


@pytest.mark.parametrize("period", [PERIOD, 1, 8])
def test_period_does_not_change_the_result(period):
    idx, vals = _path_like_stream(2)
    args = (torch.from_numpy(idx), torch.from_numpy(vals).to(torch.bfloat16), SPEC.total_params)
    assert torch.equal(port_scatter.scatter_add(*args, period), port_scatter.scatter_add(*args))


@pytest.mark.parametrize("period", [0, -64, 3, 100])
def test_rejects_period_that_does_not_divide_the_stream(period):
    with pytest.raises(ValueError, match="period"):
        port_scatter.scatter_add(torch.zeros(128, dtype=torch.int32),
                                 torch.ones((128, 2), dtype=torch.bfloat16), 10, period)


def test_refused_counter_reads_and_zeroes_every_device_before_it_raises():
    """One check reports what every device's kernels refused and leaves all counters at
    zero (CPU tensors stand in for the per-device counters)."""
    counter = RefusedCounter("scatter_add")
    counter.check()  # nothing launched yet
    counter._counters = {"cuda:0": torch.tensor([2], dtype=torch.int32),
                         "cuda:1": torch.tensor([0], dtype=torch.int32),
                         "cuda:2": torch.tensor([3], dtype=torch.int32)}
    with pytest.raises(ValueError, match="5 indices outside"):
        counter.check()
    assert all(int(c) == 0 for c in counter._counters.values())
    counter.check()


@pytest.mark.parametrize("bad", [-1, 100])
def test_rejects_rows_out_of_range_with_period(bad):
    idx = torch.zeros(128, dtype=torch.int32)
    idx[77] = bad
    with pytest.raises(ValueError, match="outside"):
        port_scatter.scatter_add(idx, torch.ones((128, 2), dtype=torch.bfloat16), 100, 64)
    port_scatter.check_refused()  # the CPU path raises at the call and leaves nothing behind


def test_cpu_path_takes_views_the_kernel_would_refuse():
    """Alignment and contiguity are the kernel's needs: the plain version takes a
    strided, offset view and sums it like its contiguous copy."""
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, 50, 64).astype(np.int32))
    flat = torch.from_numpy(rng.normal(size=(64 * 4 + 1)).astype(np.float32)).to(torch.bfloat16)
    view = flat[1:].view(64, 4)[:, ::2]
    assert not view.is_contiguous()
    assert torch.equal(port_scatter.scatter_add(idx, view, 50, 32),
                       port_scatter.scatter_add(idx, view.contiguous(), 50))


def test_encoder_backward_passes_its_period(monkeypatch):
    seen = {}

    def recorder(idx, vals, total_rows, period=None):
        seen.update(period=period, U=idx.shape[0], dtype=vals.dtype)
        return port_scatter.scatter_add(idx, vals, total_rows, period)

    monkeypatch.setattr(hashgrid_fast, "scatter_add", recorder)
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.uniform(-1, 1, (SPEC.total_params, 2)).astype(np.float32))
    table.requires_grad_(True)
    x = torch.from_numpy(rng.uniform(0, 1, (96, 3)).astype(np.float32))
    hashgrid_fast.hashgrid_encode_fast(table, x, SPEC, torch.bfloat16).sum().backward()
    assert seen == dict(period=PERIOD, U=96 * PERIOD, dtype=torch.bfloat16)
    assert float(table.grad.abs().sum()) > 0
