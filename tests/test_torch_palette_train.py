"""Port parity of the palette stage: palettenerf_torch against palettenerf_tpu on the same
weights, rays, bitfield, background and jitter arrays (drawn from a JAX key the way the
JAX functions draw them, then handed to both).

Tolerances. Leaf functions: rtol 1e-6. Renders: atol 2e-5 (f32 sums over up to a few
hundred samples in another order; ``F.softplus`` is the identity above 20, a difference
below 3e-9). One ``-O`` step: loss rtol 1e-5, gradients within 1e-5 of each tensor's
largest entry for the MLPs and basis colors and within 1e-2 for the bf16-scattered table
(an update that differs in its last f32 bit can round to the neighbouring bf16 value),
parameters after Adam's first step atol 1e-6 as in ``tests/test_torch_train.py``. Five
steps: atol 1e-4 on every parameter (Adam divides by sqrt(v): a gradient entry that differs
by a bf16 ulp moves its later updates by ~0.4% of lr = 4e-5); a wrong Adam step count
after the unfreeze would move ``basis_color`` by 3.5e-3. Outside ``basis_color`` one entry
of a tensor, or 1 in 20, may miss those bounds (``_close_params`` says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.config import Config as JConfig
from palettenerf_tpu.models import nerf as jnerf
from palettenerf_tpu.models import palette as jpal
from palettenerf_tpu.ops import composite as jcomp
from palettenerf_tpu.ops import occupancy as jocc
from palettenerf_tpu.render import nerf_renderer as jrender
from palettenerf_tpu.render import palette_renderer as jpr
from palettenerf_tpu.train import checkpoint as jckpt
from palettenerf_tpu.train import metrics as jmetrics
from palettenerf_tpu.train.palette_trainer import PaletteTrainer as JPaletteTrainer
from palettenerf_torch.config import Config as TConfig
from palettenerf_torch.models import mlp as tmlp
from palettenerf_torch.models import nerf as tnerf
from palettenerf_torch.models import palette as tpal
from palettenerf_torch.ops import composite as tcomp
from palettenerf_torch.render import nerf_renderer as trender
from palettenerf_torch.render import palette_renderer as tpr
from palettenerf_torch.train import checkpoint as tckpt
from palettenerf_torch.train import metrics as tmetrics
from palettenerf_torch.train.palette_trainer import PaletteTrainer as TPaletteTrainer
from palettenerf_torch.train.trainer import Trainer as TTrainer
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
ATOL = 2e-5
H = 16
SPEC_KW = dict(bound=1.0, num_basis=4, log2_hashmap_size=12, grid_levels=4, hidden_dim=16,
               hidden_dim_color=16)
CFG_KW = dict(O=True, fp16=True, bound=1.0, grid_size=H, num_rays=128, max_steps=64,
              train_samples_per_ray=16, infer_samples_per_ray=32, iters=100, seed=0,
              log2_hashmap_size=12, grid_levels=4, use_initialization_from_rgbxy=True)
# a palette with entries on both bounds of the clamp, as an extracted palette has
BC = np.array([[1.0, 0.2, 0.1], [0.1, 0.8, 0.0], [0.2, 0.3, 0.9], [0.8, 0.8, 0.2]], np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, atol=ATOL, rtol=0.0, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def _model(pred_clip=False, fp16=False, seed=0):
    """A small palette field on both sides: JAX init, livelier tables, BC as the palette,
    an origin a little off it and a normalized random hist-weight volume."""
    kw = dict(SPEC_KW, pred_clip=pred_clip, clip_dim=6, fp16=fp16)
    jspec, tspec = jpal.PaletteSpec.build(**kw), tpal.PaletteSpec.build(**kw)
    rng = np.random.default_rng(seed)
    hist = rng.uniform(size=(32, 32, 32, 4)).astype(np.float32)
    params = jpal.init_palette(jax.random.PRNGKey(seed), jspec)
    params = jpal.initialize_palette(params, jspec, BC, hist / hist.sum(-1, keepdims=True))
    params["basis_color_origin"] = params["basis_color"] - 0.02
    for name in ("encoder", "encoder_palette", "encoder_clip"):
        params[name] = jnp.asarray(rng.uniform(-2, 2, params[name].shape).astype(np.float32))
    tparams = tckpt.palette_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return jspec, tspec, params, tparams


def _scene(n, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.2).astype(np.float32)
    d = -o + rng.normal(scale=0.5, size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    c = (np.arange(H) + 0.5) / H * 2 - 1
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    occ = (gx ** 2 + gy ** 2 + gz ** 2 < 0.6) & (rng.uniform(size=gx.shape) < 0.9)
    return o, d, np.asarray(jocc.packbits(jnp.asarray(occ.reshape(-1))))


def _settings(mod, **kw):
    base = dict(bound=1.0, cascade=1, grid_size=H, dt_gamma=0.0, max_steps=64,
                num_samples=16, t_thresh=1e-4, min_near=0.05)
    base.update(kw)
    return mod.RenderSettings(**base)


def _draws(key, n, S):
    """The jitter render_palette_train draws from its key: march noise [n], smooth-loss
    jitter [n*S, 3]."""
    k_noise, k_smooth, _ = jax.random.split(key, 3)
    return (np.asarray(jax.random.uniform(k_noise, (n,))),
            np.asarray(jax.random.uniform(k_smooth, (n * S, 3))))


# --------------------------------------------------------------------------- leaves

def test_composite_channels_matches():
    rng = np.random.default_rng(0)
    w = rng.uniform(size=(50, 16)).astype(np.float32)
    v = rng.normal(size=(50, 16, 7)).astype(np.float32)
    _close(tcomp.composite_channels(T(w), T(v)), jcomp.composite_channels(w, v),
           atol=1e-6, rtol=1e-6)


def test_get_palette_weight_with_hist_matches():
    rng = np.random.default_rng(1)
    hist = rng.uniform(size=(32, 32, 32, 5)).astype(np.float32)
    rgb = rng.uniform(-0.1, 1.1, size=(7, 40, 3)).astype(np.float32)
    rgb[0, :4] = [[0, 0, 0], [1, 1, 1], [1, 0, 0.5], [31 / 31, 30 / 31, 1 / 31]]
    got = tpal.get_palette_weight_with_hist(T(rgb), T(hist))
    assert got.shape == (7, 40, 5)
    _close(got, jpal.get_palette_weight_with_hist(jnp.asarray(rgb), jnp.asarray(hist)),
           atol=1e-6, rtol=1e-6)
    # at a bin corner the lookup returns the bin itself
    np.testing.assert_allclose(got[0, 1].numpy(), hist[31, 31, 31], rtol=1e-6)


def test_init_and_initialize_palette_match():
    jspec, tspec, _, _ = _model(pred_clip=True)
    fresh = tpal.init_palette(tspec, torch.Generator().manual_seed(0))
    ref = jpal.init_palette(jax.random.PRNGKey(0), jspec)
    assert set(fresh) == set(ref)
    want = tckpt.palette_params_from_jax(jax.tree_util.tree_map(np.asarray, ref))
    for k in fresh:
        shapes = [[tuple(t.shape) for t in tmlp.param_leaves({k: p[k]})] for p in (fresh, want)]
        assert shapes[0] == shapes[1], k
    # same distributions: table U(-1e-4, 1e-4), Linear's default bound for the MLPs
    assert float(fresh["encoder_palette"].abs().max()) <= 1e-4
    assert float(fresh["basis_net"][0].abs().max()) <= 1 / np.sqrt(8 + 3)
    assert "b" in fresh["offsets_radiance_net"][0] and torch.equal(
        fresh["basis_color"], torch.full((4, 3), 0.5))
    hist = np.random.default_rng(0).uniform(size=(32, 32, 32, 4))
    got = tpal.initialize_palette(fresh, tspec, BC.astype(np.float64), hist)
    want = jpal.initialize_palette(ref, jspec, BC.astype(np.float64), hist)
    for k in ("basis_color", "basis_color_origin", "hist_weights"):
        assert got[k].dtype == torch.float32
        _close(got[k], want[k], atol=0, rtol=1e-6, msg=k)
    assert "hist_weights" not in fresh and got["basis_color"] is not got["basis_color_origin"]
    # the linear colour space constructs and stores the palette in linear space
    kw = dict(SPEC_KW, color_space="linear")
    lin_t, lin_j = tpal.PaletteSpec.build(**kw), jpal.PaletteSpec.build(**kw)
    got = tpal.initialize_palette(fresh, lin_t, BC, None)
    want = jpal.initialize_palette(ref, lin_j, BC, None)
    for k in ("basis_color", "basis_color_origin"):
        _close(got[k], want[k], atol=0, rtol=1e-6, msg=k)
    assert float(got["basis_color"][0, 1]) < 0.2 / 2  # 0.2 in sRGB is ~0.033 linear


@pytest.mark.parametrize("x", [0.0, 1.0, 0.3, -0.2, 1.5])
def test_clip01_has_jax_tie_rule(x):
    """Half of the gradient where the value equals a bound, as ``jnp.clip``."""
    t = torch.tensor([x], requires_grad=True)
    (tpr.clip01(t) * 3.0).sum().backward()
    ref = jax.grad(lambda v: (jnp.clip(v, 0.0, 1.0) * 3.0).sum())(jnp.asarray([x]))
    assert float(tpr.clip01(t).detach()) == float(np.clip(np.float32(x), 0, 1))
    assert float(t.grad) == float(ref[0]) == {0.0: 1.5, 1.0: 1.5, 0.3: 3.0}.get(x, 0.0)


# --------------------------------------------------------------------------- renders

TRAIN_KEYS = ("image", "depth", "weights_sum", "omega_sparsity", "view_dep_norm",
              "offsets_norm", "smooth_norm", "view_dep_rgb", "direct_rgb", "diffuse_rgb",
              "clip_feat", "basis_acc")


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "unfrozen"])
@pytest.mark.parametrize("smooth", [False, True], ids=["plain", "smooth"])
def test_render_palette_train_matches(freeze, smooth):
    jspec, tspec, jparams, tparams = _model(pred_clip=True)
    tspec = tpal.PaletteSpec.build(**dict(SPEC_KW, pred_clip=True, clip_dim=6,
                                          smooth_sigma_clip=0.5 if smooth else 0.0))
    jspec = jpal.PaletteSpec.build(**dict(SPEC_KW, pred_clip=True, clip_dim=6,
                                          smooth_sigma_clip=0.5 if smooth else 0.0))
    n, S = 192, 16
    o, d, bits = _scene(n)
    key = jax.random.PRNGKey(3)
    noise, jit_u = _draws(key, n, S)
    bg = np.random.default_rng(2).uniform(size=(n, 3)).astype(np.float32)
    ref = jpr.render_palette_train(jparams, jspec, jnp.asarray(bits), jnp.asarray(o),
                                   jnp.asarray(d), key, _settings(jrender),
                                   bg_color=jnp.asarray(bg), freeze_basis_color=freeze,
                                   require_smooth_loss=smooth)
    got = tpr.render_palette_train(tparams, tspec, T(bits), T(o), T(d), _settings(trender),
                                   bg_color=T(bg), freeze_basis_color=freeze,
                                   require_smooth_loss=smooth, noise=T(noise), jit_u=T(jit_u))
    assert set(got) == set(TRAIN_KEYS) == set(ref)
    assert float(got["weights_sum"].max()) > 0.5
    assert (float(got["smooth_norm"].max()) > 0) == smooth
    for k in TRAIN_KEYS:
        assert got[k].shape == ref[k].shape, k
        _close(got[k], ref[k], msg=k)


def test_render_palette_train_padded_slots_add_exactly_zero():
    """Rays whose slots are all padding: every aux map is exactly zero and the image is
    the background, as the mask of the JAX composite gives."""
    _, tspec, _, tparams = _model()
    n, S = 64, 16
    o, d, bits = _scene(n)
    bg = torch.rand((n, 3), generator=torch.Generator().manual_seed(0))
    got = tpr.render_palette_train(tparams, tspec, T(np.zeros_like(bits)), T(o), T(d),
                                   _settings(trender), bg_color=bg, require_smooth_loss=True,
                                   noise=torch.zeros(n), jit_u=torch.rand((n * S, 3)))
    for k in TRAIN_KEYS:
        want = bg if k in ("image", "direct_rgb") else torch.zeros_like(got[k])
        assert torch.equal(got[k].detach(), want), k
    with pytest.raises(ValueError, match="jit_u"):
        tpr.render_palette_train(tparams, tspec, T(bits), T(o), T(d), _settings(trender),
                                 require_smooth_loss=True)


def _edits():
    rng = np.random.default_rng(5)
    dh = np.array([[120.0, 1.0, 1.0], [0.0, 0.5, 1.5], [180.0, 1.0, 0.5], [0.0, 1.0, 1.0]],
                  np.float32)
    kw = dict(mean_xyz=(0.2, 0.0, -0.1), std_xyz=0.3, mean_clip=rng.normal(size=6), std_clip=4.0)
    sty = dict(dI=rng.normal(scale=0.1, size=4), dP=rng.normal(scale=0.1, size=(1, 4, 3)),
               ddelta=np.eye(3)[None] + rng.normal(scale=0.1, size=(4, 3, 3)))
    sty = {k: v.astype(np.float32) for k, v in sty.items()}
    return {
        "plain": ({}, {}),
        "edit": (dict(edit=jpr.make_region_edit(4, 6, **kw)._replace(delta_hsv=dh)),
                 dict(edit=tpr.make_region_edit(4, 6, **kw)._replace(delta_hsv=dh))),
        "stylizer": (dict(stylizer=jpr.StylizerParams(**{k: jnp.asarray(v) for k, v in sty.items()})),
                     dict(stylizer=tpr.StylizerParams(**{k: T(v) for k, v in sty.items()}))),
        "dials": (dict(offsets_weight=0.3, view_dep_weight=0.5),) * 2,
        "gui_mode": (dict(gui_mode=True),) * 2,
    }


@pytest.mark.parametrize("case", ["plain", "edit", "stylizer", "dials", "gui_mode"])
def test_render_palette_eval_matches(case):
    jspec, tspec, jparams, tparams = _model(pred_clip=True)
    o, d, bits = _scene(160)
    jkw, tkw = _edits()[case]
    st = dict(num_samples=32, t_thresh=1e-2)
    ref = jpr.render_palette_eval(jparams, jspec, jnp.asarray(bits), jnp.asarray(o),
                                  jnp.asarray(d), _settings(jrender, **st), **jkw)
    got = tpr.render_palette_eval(tparams, tspec, T(bits), T(o), T(d),
                                  _settings(trender, **st), **tkw)
    assert set(got) == set(ref)
    assert ("basis_rgb" in got) == (case != "gui_mode")
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        _close(got[k], ref[k], msg=k)
    if case == "plain":
        np.testing.assert_allclose(got["basis_acc"].sum(-1).numpy(),
                                   got["weights_sum"].numpy(), atol=1e-5)
    # no sample anywhere: the background, and zeros in every map
    empty = tpr.render_palette_eval(tparams, tspec, T(np.zeros_like(bits)), T(o), T(d),
                                    _settings(trender, **st), **tkw)
    assert torch.equal(empty["image"], torch.ones_like(empty["image"]))
    assert float(empty["clip_feat"].abs().max()) == 0.0


def test_stylizer_arap_loss_matches():
    sty = _edits()["stylizer"]
    _close(tpr.stylizer_arap_loss(sty[1]["stylizer"]), jpr.stylizer_arap_loss(sty[0]["stylizer"]),
           atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------- the step

def _jax_loss(jspec, opt, bits, o, d, gt, bg, k_render, lam_w, lam_p, freeze, smooth):
    """The loss of ``PaletteTrainer._train_step`` (palette_trainer.py:147-175)."""
    def loss_fn(p):
        out = jpr.render_palette_train(p, jspec, bits, o, d, k_render, _settings(jrender),
                                       bg_color=bg, freeze_basis_color=freeze,
                                       require_smooth_loss=smooth)
        loss = ((out["image"] - gt) ** 2).mean(-1).mean()
        loss += ((out["direct_rgb"] - gt) ** 2).mean()
        loss += opt.lambda_sparsity * out["omega_sparsity"].mean()
        loss += opt.lambda_offsets * out["offsets_norm"].mean()
        loss += opt.lambda_view_dep * out["view_dep_norm"].mean()
        if smooth:
            loss += opt.lambda_smooth * out["smooth_norm"].mean()
        loss += lam_p * ((p["basis_color"] - p["basis_color_origin"]) ** 2).sum(-1).mean()
        gt_w = jax.lax.stop_gradient(jpal.get_palette_weight_with_hist(gt, p["hist_weights"]))
        return loss + lam_w * ((gt_w - out["basis_acc"]) ** 2).mean()
    return loss_fn


def _trainers(tmp_path, jspec, tspec, jparams, tparams, bits):
    jtr = JPaletteTrainer("palette", JConfig(**CFG_KW), jspec, params=jparams,
                          workspace=str(tmp_path / "jax"), use_checkpoint="scratch", mute=True)
    ttr = TPaletteTrainer("palette", TConfig(**CFG_KW), tspec, params=tparams,
                          workspace=str(tmp_path / "torch"), use_checkpoint="scratch",
                          mute=True, device="cpu")
    ttr.grid_state = ttr.grid_state._replace(bitfield=T(bits))
    return jtr, ttr


def _step_draws(key, n, S):
    """What ``_train_step`` draws from its key: the background, then the render's jitter."""
    k_bg, k_render = jax.random.split(key)
    return (np.asarray(jax.random.uniform(k_bg, (n, 3))),) + _draws(k_render, n, S) + (k_render,)


def _tree_pairs(tparams, jtree):
    """(name, port tensor, JAX leaf as a tensor) over every leaf of the port's dict."""
    ref = tckpt.palette_params_from_jax(jax.tree_util.tree_map(np.asarray, jtree))
    names = [f"{k}[{i}]" for k, v in tparams.items()
             for i in range(len(tmlp.param_leaves({k: v})))]
    return zip(names, tmlp.param_leaves(tparams), tmlp.param_leaves(
        {k: ref[k] for k in tparams}))


def _close_params(name, p, p_ref, atol):
    """Parameters after Adam updates: ``basis_color`` within ``atol`` in every entry (its
    gradient sums over every sample). In any other tensor one entry, or 1 in 20, may
    miss ``atol`` (a wrong count in the lr schedule would move every entry by 2e-4): Adam divides by sqrt(v), so an entry with a small gradient follows that
    gradient's last bits, and those differ between the packages (the order of an f32 sum,
    a bf16 rounding of a table update, from the second step on a ReLU that a 1e-8
    difference in a weight switches for one sample), more so with every step. No entry is
    further off than lr per step."""
    diff = (p.detach() - p_ref).abs()
    allowed = 0 if name.endswith("basis_color[0]") else max(1, p.numel() // 20)
    assert int((diff > atol).sum()) <= allowed, (name, float(diff.max()))
    assert float(diff.max()) <= 0.011 * 5, name


def test_O_palette_step_matches_jax_trainer(tmp_path):
    """One -O step with the smooth loss on, the colors unfrozen and hist weights present:
    loss, every gradient, and the parameters and EMA after the update."""
    jspec, tspec, jparams, tparams = _model(fp16=True)
    assert tspec.scatter_dtype == torch.bfloat16
    n, S = CFG_KW["num_rays"], CFG_KW["train_samples_per_ray"]
    o, d, bits = _scene(n)
    rng = np.random.default_rng(4)
    img = rng.uniform(size=(n, 4)).astype(np.float32)
    img[: n // 3, 3] = 1.0
    jtr, ttr = _trainers(tmp_path, jspec, tspec, jparams, tparams, bits)
    key = jax.random.PRNGKey(5)
    bg, noise, jit_u, k_render = _step_draws(key, n, S)
    lam_w, lam_p = 0.04, 1e-3
    gt = img[:, :3] * img[:, 3:] + bg * (1 - img[:, 3:])
    loss_fn = _jax_loss(jspec, jtr.opt, jnp.asarray(bits), jnp.asarray(o), jnp.asarray(d),
                        jnp.asarray(gt), jnp.asarray(bg), k_render, lam_w, lam_p, False, True)
    jloss, jgrads = jax.value_and_grad(loss_fn)(jtr.params)
    new_j, _, ema_j, loss_j, per_ray_j = jtr._train_step(
        jtr.params, jtr.opt_state, jtr.ema_params, jnp.asarray(bits), key, jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(img), jnp.zeros((n, 16)), jnp.zeros((n,), jnp.int32),
        jnp.float32(lam_w), jnp.float32(lam_p), jnp.int32(32), False, True)
    assert float(jloss) == pytest.approx(float(loss_j), rel=1e-6)

    ttr.freeze_basis_color, ttr.require_smooth_loss = False, True
    ttr.lambda_weight, ttr.lambda_palette = lam_w, lam_p
    loss_t, per_ray_t = ttr.train_step(T(o), T(d), T(img), bg=T(bg), noise=T(noise),
                                       jit_u=T(jit_u))
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    _close(per_ray_t, per_ray_j, atol=1e-6)

    for name, p, g_ref in _tree_pairs(ttr.params, jgrads):
        key_name = name.split("[")[0]
        if key_name in tpal.FROZEN:
            assert p.grad is None, name   # the JAX trainer zeroes these two gradients
            continue
        if key_name in ("encoder", "sigma_net", "encoder_clip"):
            # no gradient reaches these: absent here, exactly zero in the JAX package
            assert p.grad is None and float(g_ref.abs().max()) == 0.0, name
            continue
        tol = 1e-2 if name.startswith("encoder_palette") else 1e-5
        scale = float(g_ref.abs().max())
        assert scale > 0, name
        assert float((p.grad - g_ref).abs().max()) <= tol * scale, name
    for got, ref in ((ttr.params, new_j), (ttr.ema_params, ema_j)):
        for name, p, p_ref in _tree_pairs(got, ref):
            _close_params(name, p, p_ref, 1e-6)
    moved = (ttr.params["encoder_palette"].detach() - tparams["encoder_palette"]).abs().max()
    assert float(moved) == pytest.approx(1e-2, rel=1e-3)


def test_linear_palette_step_matches_jax_trainer(tmp_path):
    """``--color_space linear``: the RGBA gt goes to linear space before it is composited
    on the step's random background (and before the hist-weight lookup), the palette is
    stored linear. Loss, per-ray loss, and the parameters after the update."""
    kw = dict(SPEC_KW, color_space="linear")
    jspec, tspec = jpal.PaletteSpec.build(**kw), tpal.PaletteSpec.build(**kw)
    rng = np.random.default_rng(9)
    hist = rng.uniform(size=(32, 32, 32, 4)).astype(np.float32)
    jparams = jpal.initialize_palette(jpal.init_palette(jax.random.PRNGKey(9), jspec), jspec,
                                      BC, hist / hist.sum(-1, keepdims=True))
    for name in ("encoder", "encoder_palette"):
        jparams[name] = jnp.asarray(rng.uniform(-2, 2, jparams[name].shape).astype(np.float32))
    tparams = tckpt.palette_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    cfg = dict(CFG_KW, fp16=False, O=False, color_space="linear")
    n, S = cfg["num_rays"], cfg["train_samples_per_ray"]
    o, d, bits = _scene(n, seed=9)
    img = rng.uniform(size=(n, 4)).astype(np.float32)
    img[: n // 3, 3] = 1.0
    jtr = JPaletteTrainer("palette", JConfig(**cfg), jspec, params=jparams,
                          workspace=str(tmp_path / "jax"), use_checkpoint="scratch", mute=True)
    ttr = TPaletteTrainer("palette", TConfig(**cfg), tspec, params=tparams,
                          workspace=str(tmp_path / "torch"), use_checkpoint="scratch",
                          mute=True, device="cpu")
    ttr.grid_state = ttr.grid_state._replace(bitfield=T(bits))
    key = jax.random.PRNGKey(13)
    bg, noise, _, _ = _step_draws(key, n, S)
    new_j, _, _, loss_j, per_ray_j = jtr._train_step(
        jtr.params, jtr.opt_state, jtr.ema_params, jnp.asarray(bits), key, jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(img), jnp.zeros((n, 16)), jnp.zeros((n,), jnp.int32),
        jnp.float32(0.05), jnp.float32(0.0), jnp.int32(32), True, False)
    loss_t, per_ray_t = ttr.train_step(T(o), T(d), T(img), bg=T(bg), noise=T(noise))
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    _close(per_ray_t, per_ray_j)
    for name, p, p_ref in _tree_pairs(ttr.params, new_j):
        _close_params(name, p, p_ref, 1e-6)
    # the same step in sRGB is another loss
    srgb = TPaletteTrainer("palette", TConfig(**dict(cfg, color_space="srgb")), tspec,
                           params=tparams, workspace=str(tmp_path / "srgb"),
                           use_checkpoint="scratch", mute=True, device="cpu")
    srgb.grid_state = ttr.grid_state
    assert float(srgb.train_step(T(o), T(d), T(img), bg=T(bg), noise=T(noise))[0]) != float(loss_t)


def test_eval_gt_in_linear_space_matches_jax():
    """The eval / extraction ground truth: RGBA composited on white, then to linear space
    with ``--color_space linear`` (JAX trainer.py:541-547, palette_trainer.py:619-624)."""
    from palettenerf_torch.train.trainer import eval_gt
    from palettenerf_tpu.utils.color import srgb_to_linear

    img = np.random.default_rng(10).uniform(size=(6, 5, 4)).astype(np.float32)
    img[0, :, 3] = 0.0
    on_white = img[..., :3] * img[..., 3:] + 1.0 * (1 - img[..., 3:])
    np.testing.assert_array_equal(eval_gt(TConfig(), img), on_white)
    np.testing.assert_array_equal(eval_gt(TConfig(), img[..., :3]), img[..., :3])
    got = eval_gt(TConfig(color_space="linear"), img)
    _close(got, srgb_to_linear(jnp.asarray(on_white)), atol=1e-6)
    assert got.dtype == np.float32


def test_five_steps_across_the_unfreeze_match_jax_trainer(tmp_path):
    """Two steps with the colors frozen, three after the unfreeze, the same draws in both
    packages: every parameter after each step. ``basis_color`` must take its third
    update with Adam's count at 3, as optax's single count gives it."""
    jspec, tspec, jparams, tparams = _model(fp16=True, seed=1)
    n, S = CFG_KW["num_rays"], CFG_KW["train_samples_per_ray"]
    o, d, bits = _scene(n, seed=2)
    img = np.random.default_rng(6).uniform(size=(n, 4)).astype(np.float32)
    jtr, ttr = _trainers(tmp_path, jspec, tspec, jparams, tparams, bits)
    assert ttr.freeze_basis_color and ttr.lambda_palette == 0.0
    start = ttr.params["basis_color"].detach().clone()
    for step in range(5):
        freeze, lam_p = step < 2, (0.0 if step < 2 else 1e-3)
        key = jax.random.PRNGKey(10 + step)
        bg, noise, jit_u, _ = _step_draws(key, n, S)
        jtr.params, jtr.opt_state, jtr.ema_params, loss_j, _ = jtr._train_step(
            jtr.params, jtr.opt_state, jtr.ema_params, jnp.asarray(bits), key, jnp.asarray(o),
            jnp.asarray(d), jnp.asarray(img), jnp.zeros((n, 16)), jnp.zeros((n,), jnp.int32),
            jnp.float32(0.05), jnp.float32(lam_p), jnp.int32(32), freeze, True)
        ttr.freeze_basis_color, ttr.require_smooth_loss, ttr.lambda_palette = freeze, True, lam_p
        loss_t, _ = ttr.train_step(T(o), T(d), T(img), bg=T(bg), noise=T(noise), jit_u=T(jit_u))
        assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-4), step
        for name, p, p_ref in _tree_pairs(ttr.params, jtr.params):
            _close_params(f"step {step} {name}", p, p_ref, 1e-4)
        if step == 1:
            assert torch.equal(ttr.params["basis_color"].detach(), start)
    assert float((ttr.params["basis_color"].detach() - start).abs().max()) > 5e-3
    assert ttr.opt_step == 5
    state = ttr.optimizer.state[ttr.params["basis_color"]]
    assert int(state["step"]) == 5
    for k in ("encoder", "basis_color_origin", "hist_weights"):
        assert torch.equal(ttr.params[k], tparams[k]) and torch.equal(ttr.ema_params[k], tparams[k])


# --------------------------------------------------------------------------- schedule, warm start

class _NoData:
    images = None


@pytest.mark.parametrize("epoch", [0, 1, 2, 3, 7])
@pytest.mark.parametrize("from_rgbxy", [True, False])
def test_schedule_is_rederived_on_resume(tmp_path, epoch, from_rgbxy):
    """``train`` up to the epoch a run already has: no step, only the flags the schedule
    had left at that epoch, as in the JAX trainer."""
    kw = dict(CFG_KW, use_initialization_from_rgbxy=from_rgbxy, smooth_loss_start_epoch=2,
              max_freeze_palette_epoch=3, lambda_palette=2e-3)
    jspec, tspec, jparams, tparams = _model()
    jtr = JPaletteTrainer("palette", JConfig(**kw), jspec, params=jparams,
                          workspace=str(tmp_path / "j"), use_checkpoint="scratch", mute=True)
    ttr = TPaletteTrainer("palette", TConfig(**kw), tspec, params=tparams,
                          workspace=str(tmp_path / "t"), use_checkpoint="scratch", mute=True,
                          device="cpu")
    jtr.epoch = ttr.epoch = epoch
    jtr.train(_NoData(), None, epoch)
    ttr.train(_NoData(), None, epoch)
    got = (ttr.freeze_basis_color, ttr.require_smooth_loss, ttr.lambda_palette)
    assert got == (jtr.freeze_basis_color, jtr.require_smooth_loss, jtr.lambda_palette)
    assert got == (from_rgbxy and epoch < 3, epoch >= 2,
                   2e-3 if (epoch >= 3 or not from_rgbxy) else 0.0)


def test_initialize_palette_restarts_optimizer_and_schedule_count(tmp_path):
    _, tspec, _, tparams = _model(fp16=True)
    n = CFG_KW["num_rays"]
    o, d, bits = _scene(n)
    ttr = TPaletteTrainer("palette", TConfig(**CFG_KW), tspec, params=tparams,
                          workspace=str(tmp_path), use_checkpoint="scratch", mute=True,
                          device="cpu")
    ttr.grid_state = ttr.grid_state._replace(bitfield=T(bits))
    ttr.train_step(T(o), T(d), torch.rand((n, 4)))
    assert ttr.opt_step == 1 and len(ttr.optimizer.state) > 0
    ttr.initialize_palette(BC[::-1].copy(), None)
    assert ttr.opt_step == 0 and len(ttr.optimizer.state) == 0
    assert torch.equal(ttr.params["basis_color"].detach(), T(BC[::-1]))
    assert torch.equal(ttr.ema_params["basis_color"], T(BC[::-1]))
    assert ttr.params["basis_color"].requires_grad and not ttr.params["hist_weights"].requires_grad
    # patches construct (host-sampled epochs, no LPIPS term in this stage); several
    # devices train in spawned ranks (tests/test_torch_parallel.py), so a trainer for them
    # outside a rank raises
    patched = TPaletteTrainer("palette", TConfig(**dict(CFG_KW, patch_size=2, lambda_lpips=0.1)),
                              tspec, workspace=str(tmp_path), use_checkpoint="scratch", mute=True,
                              device="cpu")
    assert patched.host_sampled() and patched._rlpips_kernels is None
    with pytest.raises(RuntimeError, match="n_devices"):
        TPaletteTrainer("palette", TConfig(**dict(CFG_KW, n_devices=2)), tspec,
                        workspace=str(tmp_path), use_checkpoint="scratch", mute=True, device="cpu")


def test_merge_params_non_strict_matches():
    rng = np.random.default_rng(0)
    target = {"a": T(rng.normal(size=(3, 2)).astype(np.float32)),
              "net": [T(np.zeros((2, 2), np.float32)), {"w": T(np.zeros((2, 1), np.float32)),
                                                        "b": T(np.zeros((1,), np.float32))}],
              "only_target": T(np.ones(2, np.float32))}
    source = {"a": rng.normal(size=(3, 2)).astype(np.float32),
              "net": [rng.normal(size=(2, 2)).astype(np.float32),
                      {"w": rng.normal(size=(5, 1)).astype(np.float32)}],
              "only_source": np.ones(3, np.float32)}
    merged, missing, loaded = tckpt.merge_params_non_strict(target, source)
    as_np = jax.tree_util.tree_map(lambda t: t.numpy(), target)
    merged_j, missing_j, loaded_j = jckpt.merge_params_non_strict(as_np, source)
    assert (sorted(missing), loaded) == (sorted(missing_j), loaded_j)
    assert loaded == ["a", "net/0"] and "net/1/w" in missing and "only_target" in missing
    pairs = [(merged["a"], merged_j["a"]), (merged["net"][0], merged_j["net"][0]),
             (merged["net"][1]["w"], merged_j["net"][1]["w"]),
             (merged["net"][1]["b"], merged_j["net"][1]["b"]),
             (merged["only_target"], merged_j["only_target"])]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), want)
    assert merged["a"].data_ptr() != target["a"].data_ptr()


def _nerf_workspaces(tmp_path):
    """A stage-1 workspace in the port's own format and one as a JAX-package pickle, of
    the same weights and grid."""
    kw = {k: SPEC_KW[k] for k in ("bound", "log2_hashmap_size", "grid_levels", "hidden_dim",
                                  "hidden_dim_color")}
    jparams = jnerf.init_nerf(jax.random.PRNGKey(3), jnerf.NeRFSpec.build(**kw))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(3)
    gs = {"density_grid": rng.uniform(size=(1, H ** 3)).astype(np.float32),
          "bitfield": rng.integers(0, 256, H ** 3 // 8, dtype=np.uint8),
          "mean_density": np.float32(0.5), "iter_density": np.int32(3)}
    jckpt.save_checkpoint(str(tmp_path / "jax_ws" / "checkpoints"), "ngp", 2, 16, tree,
                          {"grid_state": gs})
    cfg = TConfig(**{k: v for k, v in CFG_KW.items() if k != "use_initialization_from_rgbxy"})
    tr = TTrainer("ngp", cfg, tnerf.NeRFSpec.build(fp16=True, **kw),
                  params=tckpt.params_from_jax(tree), workspace=str(tmp_path / "torch_ws"),
                  use_checkpoint="scratch", mute=True, device="cpu")
    from palettenerf_torch.ops.occupancy import GridState
    tr.grid_state = GridState(**{k: T(v) for k, v in gs.items()})
    tr.epoch = 2
    tr.save_checkpoint()
    return tree, gs, str(tmp_path / "jax_ws"), str(tmp_path / "torch_ws")


@pytest.mark.parametrize("source", ["port checkpoint", "jax pickle"])
def test_load_nerf_checkpoint_warm_starts(tmp_path, source):
    tree, gs, jax_ws, torch_ws = _nerf_workspaces(tmp_path)
    jspec, tspec, jparams, tparams = _model()
    ttr = TPaletteTrainer("palette", TConfig(**CFG_KW), tspec, params=tparams,
                          workspace=str(tmp_path / "pal"), use_checkpoint="scratch", mute=True,
                          device="cpu", nerf_path=torch_ws if source == "port checkpoint" else jax_ws)
    want = tckpt.params_from_jax(tree)
    for k in ("encoder", "sigma_net", "color_net"):
        for got, ref, ema in zip(tmlp.param_leaves({k: ttr.params[k]}),
                                 tmlp.param_leaves({k: want[k]}),
                                 tmlp.param_leaves({k: ttr.ema_params[k]})):
            assert torch.equal(got.detach(), ref) and torch.equal(ema, ref), k
    for k in ("encoder_palette", "basis_color", "hist_weights"):
        assert torch.equal(ttr.params[k].detach(), tparams[k]), k   # palette-only: kept
    assert torch.equal(ttr.grid_state.bitfield, T(gs["bitfield"]))
    assert float(ttr.grid_state.mean_density) == 0.5 and ttr.opt_step == 0
    assert not ttr.params["encoder"].requires_grad and ttr.params["color_net"][0].requires_grad
    # the JAX trainer's warm start from the same pickle lands on the same parameters
    jtr = JPaletteTrainer("palette", JConfig(**CFG_KW), jspec, params=jparams,
                          workspace=str(tmp_path / "jpal"), use_checkpoint="scratch",
                          mute=True, nerf_path=jax_ws)
    for name, p, p_ref in _tree_pairs(ttr.params, jtr.params):
        _close(p, p_ref, atol=0, msg=name)


def test_palette_checkpoint_resume_and_both_loaders(tmp_path):
    """The port's palette checkpoint resumes (hist weights adopted), and
    ``load_palette_checkpoint`` reads it and the JAX-layout pickle alike."""
    _, tspec, _, tparams = _model()
    ttr = TPaletteTrainer("palette", TConfig(**CFG_KW), tspec, params=tparams,
                          workspace=str(tmp_path / "ws"), use_checkpoint="scratch", mute=True,
                          device="cpu")
    ttr.epoch, ttr.global_step, ttr.opt_step = 4, 32, 32
    own = ttr.save_checkpoint()
    fresh = TPaletteTrainer("palette", TConfig(**CFG_KW), tspec, workspace=str(tmp_path / "ws"),
                            use_checkpoint="latest", mute=True, device="cpu")
    assert (fresh.epoch, fresh.global_step, fresh.opt_step) == (4, 32, 32)
    assert torch.equal(fresh.params["hist_weights"], tparams["hist_weights"])
    ref = tckpt.save_reference_checkpoint(str(tmp_path / "ref" / "palette_ep0004.ckpt"),
                                          ttr.params, 4, 32, ttr.grid_state._asdict())
    (a, gs_a), (b, gs_b) = (tckpt.load_palette_checkpoint(p) for p in (own, ref))
    assert set(a) == set(b) == set(tparams)
    for x, y in zip(tmlp.param_leaves(a), tmlp.param_leaves({k: b[k] for k in a})):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(gs_a["bitfield"], gs_b["bitfield"])
    assert isinstance(gs_a["density_grid"], np.ndarray)


# --------------------------------------------------------------------------- metrics

def test_metrics_match():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(40, 36, 3))
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1)
    assert tmetrics.ssim(a, b) == pytest.approx(jmetrics.ssim(a, b), rel=1e-12)
    acc = rng.uniform(size=(20, 18, 4))
    ws = rng.uniform(size=(20, 18))
    for name in ("PSNRMeter", "SSIMMeter", "SparsityMeter", "TVMeter"):
        jm, tm = getattr(jmetrics, name)(), getattr(tmetrics, name)()
        args = (acc, ws) if tm.basis_metric else (a[None], b[None])
        for m in (jm, tm):
            m.update(*args)
            m.update(*args)
        assert tm.basis_metric == jm.basis_metric and tm.name == jm.name
        assert tm.measure() == pytest.approx(jm.measure(), rel=1e-12), name
        assert tm.report() == jm.report()
        tm.clear()
        assert tm.measure() == 0.0


def test_palette_entry_points_refuse_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tspec, _, tparams = _model()
    with pytest.raises(RuntimeError, match="CUDA"):
        TPaletteTrainer("palette", TConfig(**CFG_KW), tspec, params=tparams,
                        workspace=str(tmp_path), use_checkpoint="scratch", mute=True)
