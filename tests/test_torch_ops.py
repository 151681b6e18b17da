"""Port parity of the leaf ops: palettenerf_torch.ops against palettenerf_tpu.ops on the
same numpy inputs (and the same jitter, drawn once with jax.random and passed to both).
Tolerances are stated per test; f32 elementwise math agrees to ~1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.ops import activation as jact
from palettenerf_tpu.ops import composite as jcomp
from palettenerf_tpu.ops import march as jmarch
from palettenerf_tpu.ops import occupancy as jocc
from palettenerf_tpu.ops import rays as jrays
from palettenerf_tpu.ops import sh as jsh
from palettenerf_torch.ops import activation as tact
from palettenerf_torch.ops import composite as tcomp
from palettenerf_torch.ops import march as tmarch
from palettenerf_torch.ops import occupancy as tocc
from palettenerf_torch.ops import rays as trays
from palettenerf_torch.ops import sh as tsh
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
def T(a):
    return torch.from_numpy(np.array(a))


def _rays(n, seed, bound=1.0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.5 * bound).astype(np.float32)
    d = -o + rng.normal(scale=0.4 * bound, size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def test_trunc_exp_forward_and_clamped_grad():
    x = np.array([-30.0, -15.5, -3.0, 0.0, 2.5, 15.0, 16.0, 40.0], np.float32)
    ref = np.asarray(jact.trunc_exp(jnp.asarray(x)))
    ref_g = np.asarray(jax.grad(lambda v: jact.trunc_exp(v).sum())(jnp.asarray(x)))
    t = T(x).requires_grad_(True)
    out = tact.trunc_exp(t)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), ref_g, rtol=1e-6)
    assert t.grad[-1] == pytest.approx(np.exp(15.0), rel=1e-6)  # |x| > 15 is clamped


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode(degree):
    d = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(tsh.sh_encode(T(d), degree).numpy(),
                               np.asarray(jsh.sh_encode(jnp.asarray(d), degree)),
                               rtol=0, atol=1e-6)


def test_near_far_from_aabb():
    o, d = _rays(256, 1)
    d[:4] = [[1, 0, 0], [0, 1, 0], [0, 0, -1], [0.6, 0.8, 0]]  # axis-parallel / misses
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    jn, jf = jrays.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.2)
    tn, tf = trays.near_far_from_aabb(T(o), T(d), T(aabb), 0.2)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)


def test_composite_rays_and_grads():
    rng = np.random.default_rng(2)
    N, S = 32, 24
    sig = rng.uniform(0, 30, (N, S)).astype(np.float32)
    rgb = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
    dts = rng.uniform(0.005, 0.05, (N, S)).astype(np.float32)
    tcum = np.cumsum(dts, -1).astype(np.float32)
    mask = rng.uniform(size=(N, S)) < 0.8
    ref = jcomp.composite_rays(jnp.asarray(sig), jnp.asarray(rgb), jnp.asarray(dts),
                               jnp.asarray(tcum), jnp.asarray(mask), 1e-4)
    ts = T(sig).requires_grad_(True)
    got = tcomp.composite_rays(ts, T(rgb), T(dts), T(tcum), T(mask), 1e-4)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    ref_g = jax.grad(lambda s: jcomp.composite_rays(
        s, jnp.asarray(rgb), jnp.asarray(dts), jnp.asarray(tcum), jnp.asarray(mask),
        1e-4)[2].sum())(jnp.asarray(sig))
    got[2].sum().backward()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(ref_g), rtol=1e-4, atol=1e-6)


def test_packbits_and_occ_lookup():
    occ = np.random.default_rng(3).uniform(size=2 * 16 ** 3) < 0.3
    bits_j = np.asarray(jocc.packbits(jnp.asarray(occ)))
    bits_t = tocc.packbits(T(occ))
    np.testing.assert_array_equal(bits_t.numpy(), bits_j)
    cells = np.random.default_rng(4).integers(0, occ.size, 4000)
    np.testing.assert_array_equal(tocc.occ_lookup(bits_t, T(cells)).numpy(), occ[cells])


@pytest.mark.parametrize("dt_gamma", [0.0, 1 / 128])
def test_candidate_ts_and_mip_level(dt_gamma):
    t0 = np.random.default_rng(5).uniform(0.05, 3.0, 64).astype(np.float32)
    dt_min, dt_max = 2 * 1.7320508075688772 / 256, 2 * 1.7320508075688772 * 4 / 64
    ref = jmarch.candidate_ts(jnp.asarray(t0), 300, dt_min, dt_max, dt_gamma)
    got = tmarch.candidate_ts(T(t0), 300, dt_min, dt_max, dt_gamma)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6, atol=1e-6)
    xyz = np.random.default_rng(6).uniform(-4, 4, (500, 3)).astype(np.float32)
    dt = np.random.default_rng(7).uniform(1e-3, 0.3, 500).astype(np.float32)
    np.testing.assert_array_equal(
        tmarch.mip_level(T(xyz), T(dt), 64, 3).numpy(),
        np.asarray(jmarch.mip_level(jnp.asarray(xyz), jnp.asarray(dt), 64, 3)))


@pytest.mark.parametrize("bound,cascade,dt_gamma", [(1.0, 1, 0.0), (2.0, 2, 1 / 128)])
def test_march_rays_same_noise(bound, cascade, dt_gamma):
    H = 16
    o, d = _rays(200, 8, bound)
    occ = np.random.default_rng(9).uniform(size=cascade * H ** 3) < 0.35
    bits = np.asarray(jocc.packbits(jnp.asarray(occ)))
    aabb = np.array([-bound] * 3 + [bound] * 3, np.float32)
    near, far = [np.asarray(v) for v in jrays.near_far_from_aabb(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb), 0.05)]
    noise = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (200,)))
    args = (bound, cascade, H, dt_gamma, 256, 48)
    ref = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(near),
                            jnp.asarray(far), jnp.asarray(bits), *args, jnp.asarray(noise))
    got = tmarch.march_rays(T(o), T(d), T(near), T(far), T(bits), *args, T(noise))
    assert got.mask.sum() > 200  # the test exercises real samples
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    for name in ("xyzs", "dts", "ts", "t_cum"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-6, err_msg=name)


def _density(x):
    return 40.0 * np.exp(-8.0 * (x ** 2).sum(-1))


@pytest.mark.parametrize("partial", [1, 4])
def test_update_density_grid_same_jitter(partial):
    H, cascade, bound = 16, 2, 2.0
    old = np.random.default_rng(10).uniform(-1, 30, (cascade, H ** 3)).astype(np.float32)
    old[:, ::7] = -1.0  # untrained cells stay untouched
    jstate = jocc.GridState(jnp.asarray(old), jnp.zeros((cascade * H ** 3 // 8,), jnp.uint8),
                            jnp.zeros(()), jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(3)
    kw = dict(bound=bound, density_thresh=10.0, grid_size=H, partial_fraction=partial,
              slab_index=5 if partial > 1 else None)
    ref = jocc.update_density_grid(jstate, lambda p: jnp.asarray(_density(np.asarray(p))),
                                   key, **kw)
    n_cells = H ** 3 // partial
    noise = np.asarray(jax.random.uniform(key, (cascade, n_cells, 3), minval=-1.0, maxval=1.0))
    tstate = tocc.GridState(T(old), torch.zeros(cascade * H ** 3 // 8, dtype=torch.uint8),
                            torch.zeros(()), torch.zeros((), dtype=torch.int32))
    kw["slab_index"] = kw["slab_index"] or 0
    got = tocc.update_density_grid(tstate, lambda p: T(_density(p.numpy())), noise=T(noise),
                                   **kw)
    np.testing.assert_allclose(got.density_grid.numpy(), np.asarray(ref.density_grid),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.bitfield.numpy(), np.asarray(ref.bitfield))
    assert float(got.mean_density) == pytest.approx(float(ref.mean_density), rel=1e-5)
    assert int(got.iter_density) == 1


def test_mark_untrained_grid():
    H, cascade, bound = 16, 2, 2.0
    rng = np.random.default_rng(11)
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(3, 3)) * 0.5 + [0, 0, -3]
    intr = (20.0, 20.0, 16.0, 16.0)
    grid = rng.uniform(0, 5, (cascade, H ** 3)).astype(np.float32)
    jstate = jocc.init_grid_state(cascade, H)._replace(density_grid=jnp.asarray(grid))
    ref = jocc.mark_untrained_grid(jstate, jnp.asarray(poses), intr, bound, 0.2, True, H)
    tstate = tocc.init_grid_state(cascade, H)._replace(density_grid=T(grid))
    got = tocc.mark_untrained_grid(tstate, T(poses), intr, bound, 0.2, True, H)
    np.testing.assert_array_equal(got.density_grid.numpy(), np.asarray(ref.density_grid))
    assert (got.density_grid.numpy() == -1).any() and (got.density_grid.numpy() >= 0).any()
