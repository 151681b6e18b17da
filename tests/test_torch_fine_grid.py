"""Port parity of the fine eval grid (``--eval_fine_grid``): ``bake_fine_bitfield`` against
palettenerf_tpu on the same grid state and density function, the port's march on the
(train, fine) pair (after ``tests/test_fine_bitfield.py``), and the trainers' lazy bake.

Tolerances. The bake is compared byte for byte: the density is an analytic field whose
value is far from the threshold at every cell centre, so both packages threshold the same
cells. Renders on the fine grid against the train grid: ``weights_sum`` and image atol
1e-5, depth 1e-4 (the culled samples have sigma exactly 0; the rest is f32 summation
order), as in the JAX test. Where the step is too coarse for the fine grid, the march is
bit-equal to the train grid's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.ops import occupancy as jocc
from palettenerf_torch.ops import occupancy as tocc
from palettenerf_torch.ops.composite import composite_rays
from palettenerf_torch.ops.march import march_rays
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
BOUND = 1.0
H, F = 32, 64
R2 = 0.25  # hard sphere radius^2


def T(a):
    return torch.from_numpy(np.array(a))


def _jdensity(pts):
    r2 = (pts ** 2).sum(-1)
    return jnp.where(r2 < R2, 30.0, 0.0) + jnp.where(jnp.abs(pts[..., 2] - 1.5) < 0.3, 30.0, 0.0)


def _tdensity(pts):
    r2 = (pts ** 2).sum(-1)
    return (torch.where(r2 < R2, 30.0, 0.0)
            + torch.where((pts[..., 2] - 1.5).abs() < 0.3, 30.0, 0.0))


def _states(cascade: int = 1, grid: int = H):
    """The same grid state in both packages: a generous box around the sphere in every
    cascade, with the slab at z ~ 1.5 in cascade 1; and the box's cells [CAS, G^3]."""
    xyz, _ = jocc.cell_world_coords(cascade, grid, 2.0 ** (cascade - 1))
    xyz = np.asarray(xyz)
    occ = (np.abs(xyz) < 0.75).all(-1) | (np.abs(xyz[..., 2] - 1.5) < 0.4)
    grid_d = np.where(occ, 30.0, 0.0).astype(np.float32)
    bits = np.asarray(jocc.packbits(jnp.asarray(occ.reshape(-1))))
    mean = np.float32(20.0)  # above the threshold: thresh = density_thresh
    js = jocc.GridState(jnp.asarray(grid_d), jnp.asarray(bits), jnp.asarray(mean),
                        jnp.asarray(0, jnp.int32))
    ts = tocc.GridState(T(grid_d), T(bits), torch.tensor(mean), torch.tensor(0))
    return js, ts, occ


def _bits(bf, n):
    return np.unpackbits(np.asarray(bf), bitorder="little")[:n].astype(bool)


@pytest.mark.parametrize("cascade,chunk", [(1, 1 << 15), (2, 100_000)])
def test_bake_fine_bitfield_bit_exact(cascade, chunk):
    """Same bytes as JAX: threshold at the fine cell centres, 3^3 dilation with zeroed
    borders, AND with the upsampled train grid; chunks that do not divide F^3 included."""
    bound = 2.0 ** (cascade - 1)
    js, ts, _ = _states(cascade)
    ref = jocc.bake_fine_bitfield(js, _jdensity, bound, density_thresh=10.0, fine_size=F,
                                  grid_size=H, chunk=chunk)
    got = tocc.bake_fine_bitfield(ts, _tdensity, bound, density_thresh=10.0, fine_size=F,
                                  grid_size=H, chunk=chunk)
    assert got.dtype == torch.uint8 and got.shape == tuple(ref.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < _bits(got.numpy(), cascade * F ** 3).sum()


def test_bake_uses_mean_density_below_thresh():
    """The threshold is ``min(mean_density, density_thresh)``: a mean below the density
    threshold bakes at the mean, as in JAX."""
    js, ts, _ = _states()
    js = js._replace(mean_density=jnp.asarray(5.0))
    ts = ts._replace(mean_density=torch.tensor(5.0))

    def jd(p):
        return 8.0 * _jdensity(p) / 30.0

    def td(p):
        return 8.0 * _tdensity(p) / 30.0

    ref = jocc.bake_fine_bitfield(js, jd, BOUND, 10.0, fine_size=F, grid_size=H)
    got = tocc.bake_fine_bitfield(ts, td, BOUND, 10.0, fine_size=F, grid_size=H)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert _bits(got.numpy(), F ** 3).any()
    with pytest.raises(ValueError, match="multiple"):
        tocc.bake_fine_bitfield(ts, td, BOUND, 10.0, fine_size=48, grid_size=H)


def test_fine_bitfield_refines_coarse():
    _, ts, occ = _states()
    fine = tocc.bake_fine_bitfield(ts, _tdensity, BOUND, 10.0, fine_size=F, grid_size=H)
    fine_bits = _bits(fine.numpy(), F ** 3).reshape(F, F, F)
    coarse_rep = occ.reshape(H, H, H)
    for ax in range(3):
        coarse_rep = np.repeat(coarse_rep, F // H, axis=ax)
    assert not (fine_bits & ~coarse_rep).any()            # strict refinement
    assert fine_bits.sum() < 0.5 * coarse_rep.sum()       # real culling
    xyz, _ = tocc.cell_world_coords(1, F, BOUND)
    inside = ((xyz[0] ** 2).sum(-1) < 0.8 * R2).numpy()
    assert fine_bits.reshape(-1)[inside].all()            # the interior stays


def _rays(n=64):
    ang = np.linspace(-0.45, 0.45, n)
    o = torch.tensor(np.tile([0.0, 0.0, -1.6], (n, 1)), dtype=torch.float32)
    d = np.stack([np.sin(ang), 0.1 * np.cos(3 * ang), np.cos(ang)], -1)
    d = torch.tensor(d / np.linalg.norm(d, axis=-1, keepdims=True), dtype=torch.float32)
    return o, d, torch.full((n,), 0.05), torch.full((n,), 3.2)


def _render(bitfield, max_steps, num_samples, fine_grid_size=0):
    o, d, nears, fars = _rays()
    m = march_rays(o, d, nears, fars, bitfield, BOUND, 1, H, 0.0, max_steps, num_samples,
                   fine_grid_size=fine_grid_size)
    sig = torch.where(m.mask, _tdensity(m.xyzs), 0.0)
    rgb = torch.tensor([0.8, 0.6, 0.4]).expand(m.xyzs.shape).contiguous()
    ws, depth, image = composite_rays(sig, rgb, m.dts, m.t_cum, m.mask, 1e-4)
    return ws, depth, image, int(m.mask.sum())


def test_fine_bitfield_composite_exact():
    """dt well below the fine cell edge (K = 512, F = 64): the fine test runs everywhere,
    keeps far fewer samples and composites the same (every culled sample has sigma 0)."""
    _, ts, _ = _states()
    fine = tocc.bake_fine_bitfield(ts, _tdensity, BOUND, 10.0, fine_size=F, grid_size=H)
    ws_c, dep_c, img_c, n_c = _render(ts.bitfield, 512, 512)
    ws_f, dep_f, img_f, n_f = _render((ts.bitfield, fine), 512, 512, fine_grid_size=F)
    assert n_f < 0.7 * n_c
    np.testing.assert_allclose(ws_f.numpy(), ws_c.numpy(), atol=1e-5)
    np.testing.assert_allclose(img_f.numpy(), img_c.numpy(), atol=1e-5)
    np.testing.assert_allclose(dep_f.numpy(), dep_c.numpy(), atol=1e-4)


def test_fine_bitfield_coarse_dt_falls_back():
    """dt_min = 2 sqrt(3) / 48 ~ 0.072 is past the fine cell edge 2/64: the fine test is
    off everywhere and the march equals the train grid's bit for bit."""
    _, ts, _ = _states()
    fine = tocc.bake_fine_bitfield(ts, _tdensity, BOUND, 10.0, fine_size=F, grid_size=H)
    ws_c, dep_c, img_c, n_c = _render(ts.bitfield, 48, 48)
    ws_f, dep_f, img_f, n_f = _render((ts.bitfield, fine), 48, 48, fine_grid_size=F)
    assert n_f == n_c
    assert torch.equal(ws_f, ws_c) and torch.equal(img_f, img_c) and torch.equal(dep_f, dep_c)


def test_trainer_bakes_lazily_and_rebakes_after_a_change(tmp_path):
    """``Trainer._eval_bitfield``: the train bitfield without the flag; with it the pair,
    baked from the EMA field at the first call (logged with its occupied cells), kept while
    nothing changes, dropped when the weights are replaced or an epoch trains."""
    from palettenerf_torch.config import Config
    from palettenerf_torch.models.nerf import NeRFSpec
    from palettenerf_torch.train.trainer import Trainer

    spec = NeRFSpec.build(bound=1.0, log2_hashmap_size=12, grid_levels=4, hidden_dim=16,
                          hidden_dim_color=16)
    kw = dict(bound=1.0, grid_size=16, seed=0, log2_hashmap_size=12, grid_levels=4)
    plain = Trainer("ngp", Config(**kw), spec, workspace=str(tmp_path / "a"), mute=True,
                    device="cpu")
    assert plain._eval_bitfield() is plain.grid_state.bitfield
    tr = Trainer("ngp", Config(eval_fine_grid=32, **kw), spec,
                 workspace=str(tmp_path / "b"), mute=True, device="cpu")
    _, ts, _ = _states(grid=16)
    tr.grid_state = ts
    train_bits, fine = tr._eval_bitfield()
    assert train_bits is tr.grid_state.bitfield and fine.shape == (32 ** 3 // 8,)
    want = tocc.bake_fine_bitfield(ts, lambda p: tr._density(tr.eval_params(), p), 1.0,
                                   tr.opt.density_thresh, fine_size=32, grid_size=16)
    assert torch.equal(fine, want)
    assert tr._eval_bitfield()[1] is fine
    assert "baked 32^3 eval bitfield" in open(tr.log_path).read()
    assert tr.fine_bake_stats["occupied"] == int(_bits(fine.numpy(), 32 ** 3).sum())
    tr._set_params(tr.params)
    assert tr._fine_bitfield is None and tr._eval_bitfield()[1] is not fine
