"""Port parity of the serving path: palettenerf_torch against palettenerf_tpu on the same
weights and inputs — the palette model (small and on the committed checkpoint's
full-width weights), the color conversions and edits, the bake and its bitfield mask,
the golden baked renderer, the shear-warp sweep and the serve CLI.

Tolerances: f32 results agree to 1e-4 relative / 1e-5 absolute (sums in another order;
sigma goes through exp). The sweep's intermediate maps (before the bf16 warp) are held
to 2e-5 with f32 shading; with bf16 shading each side rounds at other places, so frames
are held by PSNR (>= 45 dB, the JAX package's own bound between the two shade modes).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_sweep as jsweep_t
import test_sweep_viewdep as jvd_t
from palettenerf_tpu.models import palette as jpal
from palettenerf_tpu.render import baking as jbake
from palettenerf_tpu.render import palette_renderer as jpr
from palettenerf_tpu.render import sweep as jsweep
from palettenerf_tpu.train import checkpoint as jckpt
from palettenerf_tpu.utils import color as jcolor
from palettenerf_torch import main_serve
from palettenerf_torch.data.png import read_png
from palettenerf_torch.models import palette as tpal
from palettenerf_torch.render import baking as tbake
from palettenerf_torch.render import palette_renderer as tpr
from palettenerf_torch.render import sweep as tsweep
from palettenerf_torch.train import checkpoint as tckpt
from palettenerf_torch.utils import color as tcolor
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(REPO, "deploy", "proc_toys", "palette_ep0080.ckpt")
RTOL, ATOL = 1e-4, 1e-5
SMALL = dict(bound=1.0, num_basis=4, grid_levels=4, log2_hashmap_size=13)
BC = np.array([[0.9, 0.2, 0.1], [0.1, 0.8, 0.3], [0.2, 0.3, 0.9], [0.8, 0.8, 0.2]],
              np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=rtol, atol=atol)


def _psnr(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return -10 * np.log10(np.mean((a - np.asarray(b)) ** 2) + 1e-12)


def _jax_tree(tparams):
    """The port's parameter dict -> a JAX parameter tree with the same f32 values."""
    def layer(w):
        if isinstance(w, dict):
            return {k: jnp.asarray(v.numpy()) for k, v in w.items()}
        return {"w": jnp.asarray(w.numpy())}

    return {k: ([layer(w) for w in v] if isinstance(v, list) else jnp.asarray(v.numpy()))
            for k, v in tparams.items()}


@pytest.fixture(scope="module")
def small_model():
    """A 4-level, 2^13-row palette field (JAX init, livelier tables) on both sides."""
    jspec = jpal.PaletteSpec.build(**SMALL)
    tspec = tpal.PaletteSpec.build(**SMALL)
    params = jpal.init_palette(jax.random.PRNGKey(0), jspec)
    params = jpal.initialize_palette(params, jspec, color_list=BC)
    rng = np.random.default_rng(0)
    for name in ("encoder", "encoder_palette"):
        params[name] = jnp.asarray(rng.uniform(-2, 2, params[name].shape).astype(np.float32))
    tparams = tckpt.palette_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return jspec, tspec, params, tparams


@pytest.fixture(scope="module")
def deploy_model():
    """The committed trained checkpoint: the port's f32 parameters and the same f32
    values as a JAX tree (its object-array MLPs unpacked per leaf)."""
    tree = tckpt.load_reference_checkpoint(DEPLOY)
    tparams = tckpt.palette_params_from_jax(tree["params"])
    return tree, tparams, _jax_tree(tparams)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    return x, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


NAMES = ("sigma", "clip_feat", "omega", "offsets_radiance", "view_dep", "diffuse")


def test_palette_forward_matches_jax_small(small_model):
    jspec, tspec, jparams, tparams = small_model
    x, d = _points(2048, 1)
    ref = jpal.palette_forward(jparams, jspec, jnp.asarray(x), jnp.asarray(d))
    got = tpal.palette_forward(tparams, tspec, T(x), T(d))
    for name, g, r in zip(NAMES, got, ref):
        assert g.shape == r.shape, name
        _close(g, r)
    assert float(got[0].std()) > 0.1  # the livelier tables give a varied density


def test_saved_reference_checkpoint_reads_back_in_both_packages(small_model, tmp_path):
    """The port writes a palette checkpoint in the JAX package's layout: the port reads
    it back exactly, and the JAX package's loader + palette_forward agree with the port."""
    jspec, tspec, _, tparams = small_model
    gs = {"density_grid": torch.rand((1, 32 ** 3)),
          "bitfield": torch.randint(0, 256, (32 ** 3 // 8,), dtype=torch.uint8)}
    path = tckpt.save_reference_checkpoint(str(tmp_path / "p_ep0001.ckpt"), tparams,
                                           epoch=1, grid_state=gs)
    back = tckpt.load_reference_checkpoint(path)
    again = tckpt.palette_params_from_jax(back["params"])
    for k, v in tparams.items():
        for a, b in (zip(v, again[k]) if isinstance(v, list) else [(v, again[k])]):
            if isinstance(a, dict):
                assert all(torch.equal(a[n], b[n]) for n in a), k
            else:
                assert torch.equal(a, b), k
    np.testing.assert_array_equal(back["grid_state"]["bitfield"], gs["bitfield"].numpy())
    assert back["grid_state"]["bitfield"].dtype == np.uint8

    jtree = jax.tree_util.tree_map(jnp.asarray, jckpt.load_checkpoint(path)["params"])
    x, d = _points(1024, 4)
    ref = jpal.palette_forward(jtree, jspec, jnp.asarray(x), jnp.asarray(d))
    got = tpal.palette_forward(tparams, tspec, T(x), T(d))
    for name, g, r in zip(NAMES, got, ref):
        _close(g, r)


def test_palette_forward_matches_jax_deploy_checkpoint(deploy_model):
    """4,096 points through the full-width trained weights (tables as f32 on both sides)."""
    _, tparams, jtree = deploy_model
    assert tparams["encoder"].shape == (6_119_864, 2)
    assert [tuple(w["w"].shape) for w in tparams["offsets_radiance_net"]] == [(15, 16)]
    spec_kw = dict(bound=1.0, num_basis=5)
    x, d = _points(4096, 2)
    ref = jpal.palette_forward(jtree, jpal.PaletteSpec.build(**spec_kw), jnp.asarray(x),
                               jnp.asarray(d))
    got = tpal.palette_forward(tparams, tpal.PaletteSpec.build(**spec_kw), T(x), T(d))
    assert float(got[0].max()) > 10.0  # a trained field: real density somewhere
    for name, g, r in zip(NAMES, got, ref):
        _close(g, r, rtol=1e-4, atol=1e-4)


def test_port_f32_tables_vs_jax_bf16_tables_as_stored(deploy_model):
    """The JAX encoder sums each level in the table's dtype, so the JAX package serving
    the bf16 deploy tables rounds every level's features to bf16; the port widens the
    tables to f32. Bound (and state) how far the two sit apart on 4,096 points."""
    _, tparams, jtree = deploy_model
    jtree = dict(jtree)
    for name in ("encoder", "encoder_palette"):
        jtree[name] = jnp.asarray(tparams[name].numpy()).astype(jnp.bfloat16)
    spec_kw = dict(bound=1.0, num_basis=5)
    x, d = _points(4096, 3)
    ref = jpal.palette_forward(jtree, jpal.PaletteSpec.build(**spec_kw), jnp.asarray(x),
                               jnp.asarray(d))
    got = tpal.palette_forward(tparams, tpal.PaletteSpec.build(**spec_kw), T(x), T(d))
    sig_g, sig_r = got[0].numpy(), np.asarray(ref[0], np.float32)
    # measured on these points: |d sigma| / (|sigma| + 1) max 0.024, median 4.3e-5;
    # max |d| of omega 0.011, offsets/radiance 0.012, view_dep 0.0052, diffuse 0.022
    rel = np.abs(sig_g - sig_r) / (np.abs(sig_r) + 1.0)
    assert rel.max() < 0.05 and np.median(rel) < 1e-3
    for name, g, r in list(zip(NAMES, got, ref))[2:]:
        assert np.abs(g.numpy() - np.asarray(r, np.float32)).max() < 0.05, name


@pytest.mark.parametrize("fn", ["rgb_to_hsv", "hsv_to_rgb", "linear_to_srgb",
                                "srgb_to_linear"])
def test_color_conversions_match_jax(fn):
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (512, 3)).astype(np.float32)
    x[:8] = [[0, 0, 0], [1, 1, 1], [1, 0, 0], [0, 1, 0], [0, 0, 1], [0.5, 0.5, 0.5],
             [1, 1, 0], [0, 1, 1]]
    if fn == "hsv_to_rgb":
        x = x * np.array([720.0, 100.0, 100.0], np.float32) - [180.0, 0, 0]
    _close(getattr(tcolor, fn)(T(x)), getattr(jcolor, fn)(jnp.asarray(x)), rtol=1e-5,
           atol=1e-4)


def test_region_edit_delta_hsv_and_apply_match_jax():
    rng = np.random.default_rng(5)
    orig = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    new = orig.copy()
    new[[0, 3]] = rng.uniform(0, 1, (2, 3))
    ref = jpr.region_edit_delta_hsv(jnp.asarray(orig), jnp.asarray(new))
    got = tpr.region_edit_delta_hsv(orig, new)
    _close(got, ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[[1, 2, 4]].numpy(), [[0, 1, 1]] * 3, atol=1e-4)

    rgbs = rng.uniform(0, 1, (256, 5, 3)).astype(np.float32)
    xyz = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    clip = rng.normal(size=(256, 4)).astype(np.float32)
    for kw in (dict(mean_xyz=(0.1, 0.2, -0.3), std_xyz=0.4),
               dict(mean_clip=clip[0], std_clip=3.0), dict(weight_mode=True, mean_xyz=(0, 0, 0))):
        je = jpr.make_region_edit(5, clip_dim=4, **kw)._replace(delta_hsv=ref)
        te = tpr.make_region_edit(5, clip_dim=4, **kw)._replace(delta_hsv=got.numpy())
        _close(tpr.apply_region_edit(te, T(rgbs), T(xyz), T(clip)),
               jpr.apply_region_edit(je, jnp.asarray(rgbs), jnp.asarray(xyz),
                                     jnp.asarray(clip)), rtol=1e-4, atol=1e-4)


def test_bake_palette_matches_jax(small_model, monkeypatch):
    jspec, tspec, jparams, tparams = small_model
    # torch.linspace and jnp.linspace differ in the last f32 bit at some grid points, and
    # the finest hash level (2048 cells per unit) turns one ulp of position into ~1e-4
    # of feature: the bake is compared on the same voxel coordinates
    lin = torch.linspace

    def jax_linspace(start, end, steps, **kw):
        return T(jnp.linspace(start, end, steps, dtype=jnp.float32)).to(kw.get("device"))

    monkeypatch.setattr(torch, "linspace", jax_linspace)
    assert not torch.equal(lin(-1.0, 1.0, 20), torch.linspace(-1.0, 1.0, 20))
    ref = jbake.bake_palette(jparams, jspec, resolution=20, vd_bands=2)
    got = tbake.bake_palette(tparams, tspec, resolution=20, vd_bands=2, chunk=3000)
    for name in ("density", "diffuse", "omega", "offsets", "radiance", "view_sh"):
        g, r = getattr(got, name), getattr(ref, name)
        assert g.shape == r.shape, name
        _close(g, r)
    assert got.clip_feat is None and got.vd_bands == 2


def test_bake_nerf_matches_jax(monkeypatch):
    from palettenerf_tpu.models import nerf as jnerf
    from palettenerf_torch.models import nerf as tnerf

    kw = dict(bound=1.0, log2_hashmap_size=12, grid_levels=4)
    jspec, tspec = jnerf.NeRFSpec.build(**kw), tnerf.NeRFSpec.build(**kw)
    params = jnerf.init_nerf(jax.random.PRNGKey(1), jspec)
    params["encoder"] = jnp.asarray(np.random.default_rng(10).uniform(
        -2, 2, params["encoder"].shape).astype(np.float32))
    tparams = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    monkeypatch.setattr(torch, "linspace", lambda a, b, n, **k: T(
        jnp.linspace(a, b, n, dtype=jnp.float32)))  # same voxel coordinates (see above)
    ref = jbake.bake_nerf(params, jspec, resolution=16, vd_bands=2)
    got = tbake.bake_nerf(tparams, tspec, resolution=16, vd_bands=2, chunk=1000)
    for name in ("density", "diffuse", "view_sh"):
        _close(getattr(got, name), getattr(ref, name))
    assert got.omega is None and got.vd_bands == 2


def test_mask_with_bitfield_matches_jax():
    rng = np.random.default_rng(6)
    R, G = 24, 16
    dens = rng.uniform(0, 5, (R, R, R)).astype(np.float32)
    gs = {"bitfield": rng.integers(0, 256, G ** 3 // 8 + 5).astype(np.uint8) & 0x91,
          "density_grid": np.zeros((1, G ** 3), np.float32)}
    jb = jbake.BakedVolume(R, 1.0, jnp.asarray(dens), None, None, None, None)
    tb = tbake.BakedVolume(R, 1.0, T(dens), None, None, None, None)
    got = tbake.mask_with_bitfield(tb, gs).density.numpy()
    ref = np.asarray(jbake.mask_with_bitfield(jb, gs).density)
    np.testing.assert_array_equal(got, ref)
    assert 0 < (got == 0).mean() < 1


def _both_baked(vd=False, nerf=False, clip_dim=0):
    jb = (jvd_t.make_vd_baked(clip_dim=clip_dim) if vd else
          jsweep_t.make_nerf_baked() if nerf else jsweep_t.make_palette_baked())
    tb = tbake.BakedVolume(*[T(v) if isinstance(v, jax.Array) else v for v in jb])
    return jb, tb


def test_render_baked_matches_jax():
    jb, tb = _both_baked(vd=True)
    rng = np.random.default_rng(7)
    o = rng.normal(size=(256, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.4).astype(np.float32)
    d = -o + rng.normal(scale=0.4, size=o.shape)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ref = jax.jit(lambda o, d: jbake.render_baked(jb, o, d, num_samples=64, basis_color=BC,
                                                  view_dep_weight=0.7))(jnp.asarray(o),
                                                                        jnp.asarray(d))
    got = tbake.render_baked(tb, T(o), T(d), num_samples=64, basis_color=BC,
                             view_dep_weight=0.7)
    for k in ("image", "depth", "weights_sum"):
        _close(got[k], ref[k], atol=2e-5)
    assert 0.05 < float(got["weights_sum"].mean()) < 0.95


def _edit(mod, delta, **kw):
    return mod.make_region_edit(jsweep_t.P, **kw)._replace(
        delta_hsv=np.asarray(delta, np.float32))


EDIT_ALL = [[120.0, 1.0, 1.0], [0.0, 0.5, 1.5], [180.0, 1.0, 0.5], [0.0, 1.0, 1.0]]
EDIT_ONE = [[0.0, 1.0, 1.0], [0.0, 1.0, 1.0], [140.0, 1.2, 0.7], [0.0, 1.0, 1.0]]
SWEEP_CASES = {
    # name: (eye, bf16 shade, edit kwargs + delta, extra)
    "plain_f32": ((0.0, 0.1, -2.6), False, None, {}),
    "plain_f32_flip": ((2.4, 0.8, 0.9), False, None, {}),
    "region_edit_f32": ((0.0, 0.2, -2.6), False,
                        (EDIT_ALL, dict(clip_dim=1, mean_xyz=(0.2, 0.0, -0.1), std_xyz=0.3)),
                        dict(offsets_weight=0.5)),
    "single_basis_cull_f32": ((0.0, 0.2, -2.6), False,
                              (EDIT_ONE, dict(clip_dim=1, mean_xyz=(0.15, 0.1, 0.0),
                                              std_xyz=0.05)), {}),
    "plain_bf16": ((-0.9, 2.5, -0.4), True, None, {}),
    "region_edit_bf16": ((0.0, 0.2, -2.6), True,
                         (EDIT_ALL, dict(clip_dim=1, mean_xyz=(0.2, 0.0, -0.1), std_xyz=0.3)),
                         {}),
    "single_basis_bf16": ((2.4, 0.8, 0.9), True, (EDIT_ONE, dict(clip_dim=1)), {}),
    "view_dep_f32": ((0.3, 0.4, -2.6), False, None, dict(view_dep_weight=0.8)),
    "nerf_f32": ((0.3, -2.5, 0.8), None, None, {}),
    "weight_mode_f32": ((0.0, 0.2, -2.6), False,
                        (EDIT_ALL, dict(clip_dim=1, mean_xyz=(0.2, 0.0, -0.1), std_xyz=0.3,
                                        weight_mode=True)), {}),
}


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_render_sweep_matches_jax(case, monkeypatch):
    eye, bf16, edit, extra = SWEEP_CASES[case]
    jb, tb = _both_baked(vd=case.startswith("view_dep"), nerf=case.startswith("nerf"))
    jsv, tsv = jsweep.build_sweep_volume(jb), tsweep.build_sweep_volume(tb)
    for a in range(3):
        np.testing.assert_array_equal(np.asarray(jsv.occ[a]), tsv.occ[a])
        assert torch.equal(tsv.vols[a], T(np.asarray(jsv.vols[a]).astype(np.float32))
                           .to(torch.bfloat16))
    inter = {}
    for name, mod in (("jax", jsweep), ("torch", tsweep)):
        warp = mod._warp_to_screen

        def record(x, *a, _name=name, _warp=warp, **k):
            inter[_name] = np.asarray(x, np.float32)
            return _warp(x, *a, **k)

        monkeypatch.setattr(mod, "_warp_to_screen", record)
    kw = dict(u_res=160, **extra)
    if not case.startswith("nerf"):
        kw.update(basis_color=BC, shade_bf16=bf16)
    pose = jsweep_t.look_at_pose(eye)
    ref = jsweep.render_sweep(jsv, pose, jsweep_t.INTR, 64, 64,
                              edit=edit and _edit(jpr, edit[0], **edit[1]), **kw)
    got = tsweep.render_sweep(tsv, pose, jsweep_t.INTR, 64, 64,
                              edit=edit and _edit(tpr, edit[0], **edit[1]), **kw)
    gi, ri = inter["torch"], inter["jax"]
    if bf16:
        assert _psnr(gi[..., :3], ri[..., :3]) > 45.0
        assert _psnr(got["image"], ref["image"]) > 45.0
    else:
        # both sides round the interpolation weights to bf16 (as the JAX package does);
        # a weight on a rounding edge (its f32 coordinate differing in the last bit:
        # XLA fuses the multiply-add) moves one bf16 step, so a few samples differ by
        # up to ~1e-3 while 98% of the map agrees to 2e-5 (measured: <= 5.3e-6)
        d = np.abs(gi - ri)
        assert np.quantile(d, 0.98) <= 2e-5 and d.max() <= 2e-3
        # the warp reads the maps in bf16: a map value on a rounding edge may differ by
        # one bf16 step (2^-8 below 1)
        img_g, img_r = got["image"].numpy(), np.asarray(ref["image"])
        assert np.abs(img_g - img_r).max() <= 2 ** -7
        assert np.mean(np.abs(img_g - img_r) > 1e-5) < 0.02
    _close(got["weights_sum"], ref["weights_sum"], rtol=0, atol=2 ** -7)
    assert 0.05 < float(got["weights_sum"].mean()) < 0.95


def test_render_sweep_clip_mask_and_stylizer_match_jax():
    jb, tb = _both_baked(vd=True, clip_dim=4)
    jsv, tsv = jsweep.build_sweep_volume(jb), tsweep.build_sweep_volume(tb)
    mean = np.asarray(jb.clip_feat)[20, 24, 26]
    jm = jsweep.build_clip_masks(jb.clip_feat, mean, 0.2)
    tm = tsweep.build_clip_masks(tb.clip_feat, mean, 0.2)
    for a in range(3):
        assert torch.equal(tm[a], T(np.asarray(jm[a]).astype(np.float32)).to(torch.bfloat16))
    pose = jsweep_t.look_at_pose((0.0, 0.3, -2.6))
    rng = np.random.default_rng(8)
    sty = (rng.normal(scale=0.2, size=(4,)), rng.normal(scale=0.1, size=(1, 4, 3)),
           np.eye(3)[None] + rng.normal(scale=0.1, size=(4, 3, 3)))
    sty = [a.astype(np.float32) for a in sty]
    kw = dict(u_res=160, basis_color=BC, shade_bf16=False)
    ref = jsweep.render_sweep(jsv, pose, jsweep_t.INTR, 64, 64, clip_masks=jm,
                              stylizer=jpr.StylizerParams(*map(jnp.asarray, sty)),
                              edit=_edit(jpr, EDIT_ALL, clip_dim=4, mean_clip=mean,
                                         std_clip=0.2), **kw)
    got = tsweep.render_sweep(tsv, pose, jsweep_t.INTR, 64, 64, clip_masks=tm,
                              stylizer=tpr.StylizerParams(*map(T, sty)),
                              edit=_edit(tpr, EDIT_ALL, clip_dim=4, mean_clip=mean,
                                         std_clip=0.2), **kw)
    assert _psnr(got["image"], ref["image"]) > 60.0


def test_neutral_edit_is_the_plain_render():
    _, tb = _both_baked()
    tsv = tsweep.build_sweep_volume(tb)
    pose = jsweep_t.look_at_pose((0.0, 0.2, -2.6))
    base = tsweep.render_sweep(tsv, pose, jsweep_t.INTR, 64, 64, u_res=160, basis_color=BC)
    out = tsweep.render_sweep(tsv, pose, jsweep_t.INTR, 64, 64, u_res=160, basis_color=BC,
                              edit=tpr.make_region_edit(4, clip_dim=1))
    assert torch.equal(out["image"], base["image"])


def test_main_serve_end_to_end_png(tmp_path):
    """The port's serve CLI on a JAX-package palette checkpoint at tests/test_serve.py's
    size writes a PNG that matches the JAX package's bake + sweep of the same frame."""
    jspec = jpal.PaletteSpec.build(**SMALL)
    params = jpal.init_palette(jax.random.PRNGKey(0), jspec)
    params = jpal.initialize_palette(params, jspec, color_list=np.eye(4, 3) * 0.7 + 0.15)
    params["encoder"] = jnp.asarray(np.random.default_rng(9).uniform(
        -2, 2, params["encoder"].shape).astype(np.float32))
    ws = tmp_path / "ws"
    os.makedirs(ws / "checkpoints")
    jckpt.save_checkpoint(str(ws / "checkpoints"), "palette", 1, 100, params)
    out_png = str(tmp_path / "frame.png")
    argv = [str(ws), "--resolution", "32", "--W", "64", "--H", "64", "--u_res", "96",
            "--n_frames", "3", "--grid_levels", "4", "--log2_hashmap_size", "13",
            "--edit_basis", "1", "--out", out_png]
    res = main_serve.main(argv, device="cpu")
    assert res.fps > 0 and len(res.frames) == 3
    assert res.sv.vols[0].shape[2] == 2 + 4 * 4 + 3 * 4  # P = 4 inferred, vd_bands 2
    png = read_png(out_png)
    assert png.shape == (64, 64, 3)

    # the same frame through the JAX package (its CLI cannot run here: it writes with cv2)
    opt = main_serve.build_parser().parse_args(argv)
    pose_at, intr = main_serve.orbit_camera(opt)
    baked = jbake.bake_palette(params, jspec, resolution=32, vd_bands=2)
    palette = np.clip(np.asarray(params["basis_color"]), 0, 1)
    new = palette.copy()
    new[1] = opt.edit_rgb
    edit = jpr.make_region_edit(4, clip_dim=1, std_xyz=0.3)._replace(
        delta_hsv=jpr.region_edit_delta_hsv(jnp.asarray(palette), jnp.asarray(new)))
    ref = jsweep.render_sweep(jsweep.build_sweep_volume(baked), pose_at(0), intr, 64, 64,
                              u_res=96, basis_color=jnp.asarray(palette), edit=edit)
    ref8 = (np.clip(np.asarray(ref["image"]), 0, 1) * 255).astype(np.uint8)
    assert np.abs(png.astype(int) - ref8.astype(int)).max() <= 2
    assert _psnr(png / 255.0, ref8 / 255.0) > 45.0


def test_main_serve_refuses_video_output(tmp_path):
    with pytest.raises(NotImplementedError, match="cv2"):
        main_serve.main([str(tmp_path), "--out", str(tmp_path / "orbit.mp4")], device="cpu")
