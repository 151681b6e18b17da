"""Port parity: palettenerf_torch hash grid against palettenerf_tpu.

Same numpy inputs through both packages. Forward f32 (atol 1e-6); table gradients
for the f32 backward (atol 1e-6) and the ``-O`` bf16 backward, whose JAX side runs the
Pallas tile scatter in interpret mode (atol 1e-5: both sum the same bf16-rounded
updates in f32, in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.ops import hashgrid as jhg
from palettenerf_tpu.ops import hashgrid_fast as jfast
from palettenerf_torch.ops import hashgrid as thg
from palettenerf_torch.ops import hashgrid_fast as tfast
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)


def _specs(**kw):
    return jhg.HashGridSpec.build(**kw), thg.HashGridSpec.build(**kw)


def _table(spec, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (spec.total_params, spec.level_dim)
                                               ).astype(np.float32)


def test_spec_full_width_matches():
    # the -O training configuration: 16 levels x 2, 2^19 rows/level, bound 1
    js, ts = _specs(desired_resolution=2048, num_levels=16, level_dim=2, log2_hashmap_size=19)
    assert ts.total_params == js.total_params == 6_119_864
    assert ts.offsets == js.offsets and ts.resolutions == js.resolutions
    assert ts.per_level_scale == js.per_level_scale


@pytest.mark.parametrize("gridtype", ["hash", "tiled"])
def test_forward_matches(gridtype):
    js, ts = _specs(num_levels=4, desired_resolution=256, log2_hashmap_size=12,
                    gridtype=gridtype)
    table = _table(js, 0)
    x = np.random.default_rng(1).uniform(-0.05, 1.05, (300, 3)).astype(np.float32)
    ref = np.asarray(jfast.hashgrid_encode_fast(jnp.asarray(table), jnp.asarray(x), None, js))
    got = tfast.hashgrid_encode_fast(torch.from_numpy(table), torch.from_numpy(x), ts)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    gold = thg.hashgrid_encode(torch.from_numpy(table), torch.from_numpy(x), ts)
    np.testing.assert_allclose(gold.numpy(), ref, rtol=0, atol=1e-6)


def test_corner_indices_bit_exact_on_overflowing_level():
    js, ts = _specs(num_levels=4, desired_resolution=512, log2_hashmap_size=10)
    # the finest level's grid has far more corners than its table rows: it hashes
    assert (ts.resolutions[-1] + 1) ** 3 > ts.offsets[-1] - ts.offsets[-2]
    x = np.random.default_rng(2).uniform(0, 1, (500, 3)).astype(np.float32)
    ref_idx, ref_w = jfast._all_indices(js, jnp.asarray(x))
    idx, w = tfast.corner_indices(ts, torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), rtol=0, atol=1e-7)
    # and the uint32 hash itself on large coordinates, level by level
    pg = np.random.default_rng(3).integers(0, 2 ** 12, (1000, 3)).astype(np.int32)
    for lvl in range(4):
        ref = np.asarray(jhg._corner_index(js, lvl, jnp.asarray(pg)))
        got = thg.corner_index(ts, lvl, torch.from_numpy(pg)).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_table_grad_matches(bf16):
    js, ts = _specs(num_levels=4, desired_resolution=128, log2_hashmap_size=11)
    table = _table(js, 4)
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.02, 1.02, (200, 3)).astype(np.float32)
    co = rng.normal(size=(200, js.output_dim)).astype(np.float32)
    sd_j = jnp.bfloat16 if bf16 else None
    ref = jax.grad(lambda t: (jfast.hashgrid_encode_fast(
        t, jnp.asarray(x), None, js, sd_j) * jnp.asarray(co)).sum())(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    out = tfast.hashgrid_encode_fast(t, torch.from_numpy(x), ts,
                                     torch.bfloat16 if bf16 else None)
    (out * torch.from_numpy(co)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 if bf16 else 1e-6)


def test_bounded_matches():
    js, ts = _specs(num_levels=4, desired_resolution=2048 * 1.0, log2_hashmap_size=12)
    table = _table(js, 6)
    x = np.random.default_rng(7).uniform(-1, 1, (128, 3)).astype(np.float32)
    ref = jfast.hashgrid_encode_fast_bounded(jnp.asarray(table), jnp.asarray(x), js, 1.0)
    got = tfast.hashgrid_encode_fast_bounded(torch.from_numpy(table), torch.from_numpy(x),
                                             ts, 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_unported_gridtype_raises():
    # every gridtype of the JAX package is ported (hash_xadd: test_torch_hashgrid_o2.py)
    with pytest.raises(ValueError, match="unknown gridtype"):
        thg.HashGridSpec.build(gridtype="dense")
