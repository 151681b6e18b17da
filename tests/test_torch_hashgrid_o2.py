"""Port parity of the ``-O2`` encoder modes and ``hash_xadd``: palettenerf_torch against
palettenerf_tpu on the same numpy inputs and the same draws.

Tolerances: forwards atol 1e-6 (f32, the JAX rounding order); drawn rows and integer
indices bit-exact; table gradients atol 1e-6 for the f32 backward and 1e-5 for the bf16
one, whose JAX side runs the Pallas tile scatter in interpret mode (both sum the same
bf16-rounded updates in f32, in different orders)."""

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
GRIDTYPES = ["hash", "hash_xadd"]
# small specs whose finer levels hash: 4 levels, 2^10-2^13 rows
SMALL = dict(num_levels=4, desired_resolution=256, log2_hashmap_size=11)


def _specs(**kw):
    return jhg.HashGridSpec.build(**kw), thg.HashGridSpec.build(**kw)


def _inputs(spec, n, seed, lo=-0.03, hi=1.03):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (spec.total_params, spec.level_dim)).astype(np.float32)
    x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    u = rng.uniform(size=(n, spec.num_levels)).astype(np.float32)
    return table, x, u


def test_hash_xadd_spec_golden_and_indices():
    js, ts = _specs(gridtype="hash_xadd", num_levels=4, desired_resolution=512,
                    log2_hashmap_size=13)
    assert ts.offsets == js.offsets and ts.resolutions == js.resolutions
    assert [ts.level_layout(lvl)[2] for lvl in range(4)] == [False, True, True, True]
    table, x, _ = _inputs(js, 400, 0)
    ref = np.asarray(jhg.hashgrid_encode(jnp.asarray(table), jnp.asarray(x), js))
    gold = thg.hashgrid_encode(torch.from_numpy(table), torch.from_numpy(x), ts)
    np.testing.assert_allclose(gold.numpy(), ref, rtol=0, atol=1e-6)
    # the uint32 hash on large coordinates, level by level
    pg = np.random.default_rng(3).integers(0, 2 ** 31, (1000, 3)).astype(np.int64)
    for lvl in range(4):
        want = np.asarray(jhg._corner_index(js, lvl, jnp.asarray(pg.astype(np.uint32))))
        got = thg.corner_index(ts, lvl, torch.from_numpy(pg)).numpy()
        np.testing.assert_array_equal(got, want)
    # the pair forward's residuals: base rows bit-exact, y/z weights, x fractions
    xin = np.clip(x, 0, 1)
    _, idx_j, w_j, fx_j, _ = jfast._encode_T(jnp.asarray(table), js, jnp.asarray(xin), None,
                                            False)
    idx, w = tfast.corner_indices(ts, torch.from_numpy(xin))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0, atol=1e-7)
    _, (_, _, fx, _, _) = tfast._encode(torch.from_numpy(table), ts, torch.from_numpy(xin),
                                        None, False)
    np.testing.assert_array_equal(fx.numpy(), np.asarray(fx_j))


@pytest.mark.parametrize("gridtype", GRIDTYPES + ["tiled"])
def test_exact_forward_matches(gridtype):
    js, ts = _specs(gridtype=gridtype, **SMALL)
    table, x, _ = _inputs(js, 300, 1)
    ref = np.asarray(jfast.hashgrid_encode_fast(jnp.asarray(table), jnp.asarray(x), None, js))
    got = tfast.hashgrid_encode_fast(torch.from_numpy(table), torch.from_numpy(x), ts)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    gold = thg.hashgrid_encode(torch.from_numpy(table), torch.from_numpy(x), ts)
    np.testing.assert_allclose(gold.numpy(), ref, rtol=0, atol=1e-6)


def test_pair_table_matches():
    js, ts = _specs(gridtype="hash_xadd", **SMALL)
    table, _, _ = _inputs(js, 1, 2)
    ref = np.asarray(jfast.pair_table(jnp.asarray(table), js))
    got = tfast.pair_table(torch.from_numpy(table), ts)
    np.testing.assert_array_equal(got.numpy(), ref)
    # row q's second half is row q + 1 of its level, the last row of a level wraps
    for lvl in range(ts.num_levels):
        lo, hi = ts.offsets[lvl], ts.offsets[lvl + 1]
        np.testing.assert_array_equal(got[hi - 1, 2:].numpy(), table[lo])


@pytest.mark.parametrize("gridtype", GRIDTYPES)
def test_stochastic_forward_matches(gridtype):
    js, ts = _specs(gridtype=gridtype, **SMALL)
    table, x, u = _inputs(js, 500, 3)
    out_j, idx_j, _, fxu_j, _ = jfast._encode_T(jnp.asarray(table), js, jnp.asarray(x),
                                                jnp.asarray(u), True)
    out, (idx, _, fx, rem, _) = tfast._encode(torch.from_numpy(table), ts,
                                              torch.from_numpy(x), torch.from_numpy(u), True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))          # the same picks
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=0, atol=1e-6)
    if gridtype == "hash_xadd":
        L = ts.num_levels
        np.testing.assert_array_equal(fx.numpy(), np.asarray(fxu_j)[:, :L])
        np.testing.assert_allclose(rem.numpy(), np.asarray(fxu_j)[:, L:], rtol=0, atol=1e-6)
    # the public entry point with rand gives the same output
    got = tfast.hashgrid_encode_fast(torch.from_numpy(table), torch.from_numpy(x), ts,
                                     stochastic=True, rand=tfast.EncodeRand(
                                         u=torch.from_numpy(u)))
    torch.testing.assert_close(got, out, rtol=0, atol=0)


def _jax_position_hash_u(spec, x):
    """The JAX encoder's fallback uniforms (hashgrid_fast.py:287-296), [M, L]."""
    L, D = spec.num_levels, spec.input_dim
    _, frac = jfast._geom_T(spec, jfast._level_constants(spec), jnp.asarray(x).T)
    coef = jnp.asarray([12.9898, 78.233, 37.719][:D], jnp.float32)
    base = sum(frac[d][L - 1] * coef[d] for d in range(D))
    s = jnp.sin(base[None, :] + jnp.arange(L, dtype=jnp.float32)[:, None] * 1.6180339887)
    s = s * 43758.5453
    return np.asarray(s - jnp.floor(s)).T


@pytest.mark.parametrize("gridtype", GRIDTYPES)
def test_position_hash_draw_matches(gridtype):
    """Without ``rand`` the draw comes from a hash of the position: sin(.) x 43758.5453,
    fractional part. The sines of the two libraries differ in their last bit for some
    inputs, which moves those uniforms anywhere in [0, 1); picks agree wherever the two
    uniforms agree to 1e-6 and u is not within 1e-5 of a corner's cumulative weight."""
    js, ts = _specs(gridtype=gridtype, **SMALL)
    table, x, _ = _inputs(js, 2000, 4, 0.0, 1.0)
    _, idx_j, _, _, _ = jfast._encode_T(jnp.asarray(table), js, jnp.asarray(x), None, True)
    _, (idx, _, _, _, _) = tfast._encode(torch.from_numpy(table), ts, torch.from_numpy(x),
                                         None, True)
    _, frac = tfast._geometry(ts, tfast._level_constants(ts, torch.device("cpu")),
                              torch.from_numpy(x))
    u = tfast._position_hash_u(frac).numpy()
    same_u = np.abs(u - _jax_position_hash_u(js, x)) < 1e-6
    assert same_u.mean() > 0.9 and 0.0 <= u.min() and u.max() < 1.0
    w = tfast.corner_indices(ts, torch.from_numpy(x))[1].numpy().reshape(2000, 4, -1)
    csum = np.concatenate([np.zeros_like(w[..., :1]), np.cumsum(w, -1)[..., :-1]], -1)
    near = (np.abs(u[..., None] - csum) < 1e-5).any(-1)
    differ = idx.numpy() != np.asarray(idx_j)
    assert not (differ & same_u & ~near).any()


def test_make_encode_rand():
    ts = thg.HashGridSpec.build(**SMALL)
    gen = torch.Generator().manual_seed(0)
    r = tfast.make_encode_rand(gen, 1000, ts, grad_levels=3)
    assert r.u.shape == (1000, 4) and r.u.dtype == torch.float32
    assert 0.0 <= float(r.u.min()) and float(r.u.max()) < 1.0
    assert r.lvls.shape == (3,) and len(set(r.lvls.tolist())) == 3
    assert set(r.lvls.tolist()) <= set(range(4))
    assert tfast.make_encode_rand(gen, 5, ts, grad_levels=4).lvls is None  # K = L: all
    assert tfast.make_encode_rand(gen, 5, ts).lvls is None


# the backward's mode matrix: (nearest_corner_grad, stochastic, grad_levels)
MODES = {"exact": (False, False, 0), "nearest": (True, False, 0),
         "stochastic": (False, True, 0), "exact_levels": (False, False, 2),
         "nearest_levels": (True, False, 2), "stochastic_levels": (True, True, 2)}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("gridtype", GRIDTYPES)
@pytest.mark.parametrize("mode", list(MODES))
def test_backward_modes_match(mode, gridtype, bf16):
    nearest, stochastic, grad_levels = MODES[mode]
    js, ts = _specs(gridtype=gridtype, num_levels=4, desired_resolution=128,
                    log2_hashmap_size=10)
    # as many points as give every mode's stream U = 5,120 rows (8 per point and level
    # for the exact modes of both gridtypes, 1 for the others): the JAX side's bf16
    # scatter then compiles once for the whole matrix
    n = 5120 // ((grad_levels or 4) * (1 if nearest or stochastic else 8))
    table, x, u = _inputs(js, n, 5)
    co = np.random.default_rng(6).normal(size=(n, js.output_dim)).astype(np.float32)
    lvls = np.array([2, 0])
    jrand = jfast.EncodeRand(u=jnp.asarray(u), lvls=jnp.asarray(lvls))
    sd_j = jnp.bfloat16 if bf16 else None
    ref = jax.grad(lambda t: (jfast.hashgrid_encode_fast(
        t, jnp.asarray(x), jrand, js, sd_j, nearest, stochastic, grad_levels)
        * jnp.asarray(co)).sum())(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    out = tfast.hashgrid_encode_fast(
        t, torch.from_numpy(x), ts, torch.bfloat16 if bf16 else None, nearest, stochastic,
        tfast.EncodeRand(u=torch.from_numpy(u), lvls=torch.from_numpy(lvls)), grad_levels)
    (out * torch.from_numpy(co)).sum().backward()
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0, atol=1e-5 if bf16 else 1e-6)
    if grad_levels:  # the levels outside lvls get no gradient
        for lvl in (1, 3):
            assert not t.grad[ts.offsets[lvl]:ts.offsets[lvl + 1]].any()


def test_backward_stream_periods():
    """The scatter's columns per point on each stream: Leff rows per point for the
    one-row modes, Leff x K for the exact ones (each half of the pair stream)."""
    for gridtype, K in (("hash", 8), ("hash_xadd", 4)):
        ts = thg.HashGridSpec.build(gridtype=gridtype, **SMALL)
        table, x, u = _inputs(ts, 64, 7, 0.0, 1.0)
        lvls = torch.tensor([3, 1])
        for mode, (nearest, stochastic, gl) in MODES.items():
            _, res = tfast._encode(torch.from_numpy(table), ts, torch.from_numpy(x),
                                   torch.from_numpy(u), stochastic)
            g = torch.ones((64, ts.output_dim))
            rows, upd, period = tfast._backward_stream(ts, res, lvls, g, nearest, stochastic, gl)
            leff = gl or 4
            one_row = nearest or stochastic
            assert period == (leff if one_row else leff * K), (gridtype, mode)
            halves = 2 if (gridtype == "hash_xadd" and not one_row) else 1
            assert rows.shape == (64 * period * halves,) and rows.dtype == torch.int32
            assert upd.shape == (rows.shape[0], 2)
