"""Port parity of the hierarchical march (``--march_groups``): ``build_super_bitfield``,
``super_bitfield_ok`` and ``_march_rays_hier`` through ``march_rays``' gate, against
palettenerf_tpu on the same NumPy bitfields, rays and jitter.

Tolerances. The supercell mips are compared byte for byte, the gates value for value and
the marches' masks element for element. At ``dt_gamma == 0`` so are ``ts``, ``dts``,
``t_cum`` and ``xyzs``: both packages compute them with the same f32 operations in the
same order. With ``dt_gamma > 0`` a candidate's ``t`` goes through ``exp``, whose last bit
differs between XLA's and PyTorch's CPU versions: rtol 1e-6 (a few ulp) there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.ops import march as jmarch
from palettenerf_tpu.ops import occupancy as jocc
from palettenerf_tpu.ops import rays as jrays
from palettenerf_torch.ops import march as tmarch
from palettenerf_torch.ops import occupancy as tocc
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
FIELDS = ("mask", "ts", "dts", "t_cum", "xyzs")


def T(a):
    return torch.from_numpy(np.array(a))


def _equal(got, ref, what="", exact=True):
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask), err_msg=what)
    for f in FIELDS[1:]:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=f"{what} {f}")


def _occupancy(G: int, cascade: int, seed: int = 0) -> np.ndarray:
    """A ball and a far blob in every cascade's frame, plus scattered cells: [CAS*G^3]."""
    rng = np.random.default_rng(seed)
    r = 2 * (np.arange(G) + 0.5) / G - 1
    X, Y, Z = np.meshgrid(r, r, r, indexing="ij")
    occ = np.zeros((cascade, G, G, G), bool)
    for c in range(cascade):
        e = 2.0 ** c
        occ[c] |= ((X * e - 0.2) ** 2 + (Y * e) ** 2 + (Z * e) ** 2) < 0.3
        occ[c] |= ((X * e - 1.5) ** 2 + (Y * e) ** 2 + (Z * e - 0.5) ** 2) < 0.2
        occ[c] |= rng.uniform(size=X.shape) < 0.003
    return occ.reshape(-1)


def _scene(n: int, G: int, cascade: int, seed: int = 0):
    bound = float(2 ** (cascade - 1))
    bits = np.asarray(jocc.packbits(jnp.asarray(_occupancy(G, cascade, seed))))
    rng = np.random.default_rng(seed + 10)
    z = rng.normal(size=(n, 3)) * 0.3 + np.asarray([0.2, 0.0, 1.0])
    d = (z / np.linalg.norm(z, axis=-1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(np.asarray([0.0, 0.0, -1.3 * bound], np.float32), (n, 3)).copy()
    aabb = np.asarray([-bound] * 3 + [bound] * 3, np.float32)
    nears, fars = jrays.near_far_from_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb),
                                           0.05)
    noise = rng.uniform(size=(n,)).astype(np.float32)
    return bits, o, d, np.asarray(nears), np.asarray(fars), noise, bound


def _both(bits, o, d, nears, fars, noise, bound, cascade, G, dt_gamma, K, S, groups,
          fine=None, F=0):
    """(torch, JAX) marches of the same inputs; ``groups`` 0 takes the flat march."""
    jsup = jmarch.build_super_bitfield(jnp.asarray(bits), G, cascade) if groups else None
    tsup = tmarch.build_super_bitfield(T(bits), G, cascade) if groups else None
    jb = jnp.asarray(bits) if fine is None else (jnp.asarray(bits), jnp.asarray(fine))
    tb = T(bits) if fine is None else (T(bits), T(fine))
    ref = jmarch.march_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(nears),
                            jnp.asarray(fars), jb, bound, cascade, G, dt_gamma, K, S,
                            jnp.asarray(noise), sup_bitfield=jsup, max_groups=groups,
                            fine_grid_size=F)
    got = tmarch.march_rays(T(o), T(d), T(nears), T(fars), tb, bound, cascade, G, dt_gamma,
                            K, S, T(noise), sup_bitfield=tsup, max_groups=groups,
                            fine_grid_size=F)
    return got, ref


@pytest.mark.parametrize("G,cascade", [(32, 1), (32, 2), (16, 3), (8, 2)])
def test_build_super_bitfield_bit_exact(G, cascade):
    bits = np.asarray(jocc.packbits(jnp.asarray(_occupancy(G, cascade, seed=G + cascade))))
    ref = jmarch.build_super_bitfield(jnp.asarray(bits), G, cascade)
    got = tmarch.build_super_bitfield(T(bits), G, cascade)
    if ref is None:  # a cascade's grid smaller than one supercell (G=8, cascade 2)
        assert got is None
        return
    assert got.dtype == torch.uint8 and got.shape == tuple(ref.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # conservative: every occupied cell of cascade 0 sets its supercell
    occ = np.unpackbits(bits, bitorder="little").reshape(cascade, G, G, G)[cascade - 1]
    sup = np.unpackbits(got.numpy(), bitorder="little").reshape((G // 4,) * 3)
    xs, ys, zs = np.nonzero(occ)
    assert sup[xs // 4, ys // 4, zs // 4].all()


def test_super_bitfield_ok_matches():
    for bound in (0.5, 1.0, 1.5, 2.0, 4.0, 8.0):
        for G in (4, 8, 16, 128):
            for cascade in (1, 2, 3, 4):
                assert tmarch.super_bitfield_ok(bound, G, cascade) == \
                    jmarch.super_bitfield_ok(bound, G, cascade), (bound, G, cascade)
    assert not tmarch.super_bitfield_ok(1.5, 128, 2) and tmarch.super_bitfield_ok(2.0, 128, 2)


def test_packbits_u8_matches():
    occ = np.random.default_rng(0).uniform(size=(4096,)) < 0.3
    np.testing.assert_array_equal(tmarch.packbits_u8(T(occ.astype(np.uint8))).numpy(),
                                  np.asarray(jmarch.packbits_u8(jnp.asarray(occ))))


@pytest.mark.parametrize("dt_gamma", [0.0, 1.0 / 128], ids=["uniform", "adaptive"])
@pytest.mark.parametrize("groups", [4, 12])
def test_hier_march_matches_jax(dt_gamma, groups):
    """The group budget truncates (4 and 12 of 64 groups): the hierarchical march's own
    output, not the flat one's, is held to JAX's."""
    G, cascade, K, S = 32, 1, 512, 48
    bits, o, d, nears, fars, noise, bound = _scene(96, G, cascade, seed=1)
    got, ref = _both(bits, o, d, nears, fars, noise, bound, cascade, G, dt_gamma, K, S,
                     groups)
    _equal(got, ref, f"groups={groups}", exact=dt_gamma == 0)
    assert 0 < got.mask.sum() < got.mask.numel()


def test_hier_march_multicascade_matches_jax():
    """bound 2, two cascades, dt_gamma 1/128 (the default step rule): per-group
    ``safe`` bits, member candidates at their own mip level."""
    G, cascade, K, S = 32, 2, 512, 64
    bits, o, d, nears, fars, noise, bound = _scene(96, G, cascade, seed=2)
    got, ref = _both(bits, o, d, nears, fars, noise, bound, cascade, G, 1.0 / 128, K, S, 16)
    _equal(got, ref, exact=False)
    assert got.mask.sum() > 0


@pytest.mark.parametrize("dt_gamma", [0.0, 1.0 / 128], ids=["uniform", "adaptive"])
def test_hier_equals_flat_when_groups_suffice(dt_gamma):
    """With K/8 group slots no group can be cut off: the hierarchical march equals the
    flat one (in both packages, and the port's equals JAX's)."""
    G, cascade, K, S = 32, 1, 256, 64
    bits, o, d, nears, fars, noise, bound = _scene(64, G, cascade, seed=3)
    hier, jhier = _both(bits, o, d, nears, fars, noise, bound, cascade, G, dt_gamma, K, S,
                        K // 8)
    flat, jflat = _both(bits, o, d, nears, fars, noise, bound, cascade, G, dt_gamma, K, S, 0)
    _equal(hier, jhier, "hier", exact=dt_gamma == 0)
    _equal(flat, jflat, "flat", exact=dt_gamma == 0)
    for f in FIELDS:
        assert torch.equal(getattr(hier, f), getattr(flat, f)), f


def test_hier_pads_when_group_slots_hold_fewer_than_S():
    """``Sg * g < S`` (5 groups of 8 for 64 slots): the sample slots past 40 are padding
    in both packages."""
    G, cascade, K, S = 32, 1, 256, 64
    bits, o, d, nears, fars, noise, bound = _scene(64, G, cascade, seed=4)
    got, ref = _both(bits, o, d, nears, fars, noise, bound, cascade, G, 0.0, K, S, 5)
    _equal(got, ref)
    assert got.mask.shape == (64, S) and not got.mask[:, 40:].any()
    assert got.mask[:, :40].sum() > 64


def test_gate_falls_back_to_flat():
    """Where ``march_rays``' gate refuses (a bound that is not 2^(cascade-1); K not a
    multiple of 8; a group span past the dilation at dt_gamma 0) both march flat."""
    G = 32
    bits, o, d, nears, fars, noise, _ = _scene(48, G, 2, seed=5)
    sup = tmarch.build_super_bitfield(T(bits), G, 2)
    for bound, K, dt_gamma in ((1.5, 256, 0.0), (2.0, 260, 0.0), (2.0, 24, 0.0)):
        got = tmarch.march_rays(T(o), T(d), T(nears), T(fars), T(bits), bound, 2, G, dt_gamma,
                                K, 16, T(noise), sup_bitfield=sup, max_groups=4)
        flat = tmarch.march_rays(T(o), T(d), T(nears), T(fars), T(bits), bound, 2, G,
                                 dt_gamma, K, 16, T(noise))
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(flat, f)), (bound, K, f)


@pytest.mark.parametrize("groups", [0, 6], ids=["flat", "hier"])
def test_fine_grid_march_matches_jax(groups):
    """The (train, fine) bitfield pair: the fine test where dt <= the fine cell edge (here
    everywhere at K = 512 and F = 64), on the flat and the hierarchical march."""
    G, F, cascade, K, S = 32, 64, 1, 512, 48
    bits, o, d, nears, fars, noise, bound = _scene(96, G, cascade, seed=6)
    fine = np.asarray(jocc.packbits(jnp.asarray(_occupancy(F, cascade, seed=7))))
    got, ref = _both(bits, o, d, nears, fars, noise, bound, cascade, G, 0.0, K, S, groups,
                     fine=fine, F=F)
    _equal(got, ref)
    coarse, _ = _both(bits, o, d, nears, fars, noise, bound, cascade, G, 0.0, K, S, groups)
    assert got.mask.sum() < coarse.mask.sum()


def test_fine_grid_index_math_at_512():
    """The fine grid's flat index ``lvl * F^3 + x F^2 + y F + z`` at F = 512 and two
    cascades (int64 in the port): the last cell of cascade 1 finds the last bit, its
    neighbour and the same cell of cascade 0 find clear bits."""
    F, cascade = 512, 2
    fine = torch.zeros((cascade * F ** 3 // 8,), dtype=torch.uint8)
    fine[-1] = 0x80                                   # the last cell of cascade 1

    def test(x, lvl):
        xyz = torch.tensor([[x]])
        return bool(tmarch._fine_occ_and(
            torch.ones((1, 1), dtype=torch.bool), fine, F, xyz, torch.full((1, 1), 1e-3),
            torch.full((1, 1), 2.0 ** lvl), torch.full((1, 1), lvl, dtype=torch.int32),
            cascade))

    assert test([1.999, 1.999, 1.999], 1)
    assert not test([1.999, 1.999, 1.99], 1)
    assert not test([0.9995, 0.9995, 0.9995], 0)
