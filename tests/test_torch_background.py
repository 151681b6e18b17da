"""Port parity of the background net (``bg_radius > 0``): ``sph_from_ray``, the 2D hash
encoder, both models' background nets, the three stage-1 renders and the two palette
renders with it, one step of each trainer on RGBA images, and the warm start that carries
the net from stage 1 into the palette model. palettenerf_torch against palettenerf_tpu on
the same parameters, rays, bitfield and draws.

Tolerances: ``sph_from_ray`` atol 1e-6; the 2D encoder's features atol 1e-6 and its table
gradient 1e-5 of the gradient's largest entry (f32 sums of up to ~30 updates per row in
another order); the background nets 1e-6; renders ``ATOL = 2e-5`` as the port's other
render tests; one step: the loss rtol 1e-5, the per-ray loss ``ATOL``, the parameters
after Adam's first step atol 1e-6 with at most one entry in 20 of a tensor off (an entry
whose gradient is near zero takes its sign from the gradient's last bits; none is further
off than 2 lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.config import Config as JConfig
from palettenerf_tpu.models import nerf as jnerf
from palettenerf_tpu.models import palette as jpal
from palettenerf_tpu.ops import hashgrid as jhash
from palettenerf_tpu.ops import hashgrid_fast as jfast
from palettenerf_tpu.ops import occupancy as jocc
from palettenerf_tpu.ops import rays as jrays
from palettenerf_tpu.render import nerf_renderer as jrender
from palettenerf_tpu.render import palette_renderer as jpr
from palettenerf_tpu.train import checkpoint as jckpt
from palettenerf_tpu.train.palette_trainer import PaletteTrainer as JPaletteTrainer
from palettenerf_tpu.train.trainer import Trainer as JTrainer
from palettenerf_torch.config import Config as TConfig
from palettenerf_torch.models import mlp as tmlp
from palettenerf_torch.models import nerf as tnerf
from palettenerf_torch.models import palette as tpal
from palettenerf_torch.ops import hashgrid as thash
from palettenerf_torch.ops import hashgrid_fast as tfast
from palettenerf_torch.ops import rays as trays
from palettenerf_torch.render import nerf_renderer as trender
from palettenerf_torch.render import palette_renderer as tpr
from palettenerf_torch.train import checkpoint as tckpt
from palettenerf_torch.train.palette_trainer import PaletteTrainer as TPaletteTrainer
from palettenerf_torch.train.trainer import Trainer as TTrainer
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
ATOL = 2e-5
H = 16
RADIUS = 4.0
NERF_KW = dict(bound=1.0, bg_radius=RADIUS, log2_hashmap_size=12, grid_levels=4,
               hidden_dim=16, hidden_dim_color=16)
PAL_KW = dict(NERF_KW, num_basis=4)
CFG_KW = dict(O=True, fp16=True, bound=1.0, grid_size=H, num_rays=128, max_steps=64,
              train_samples_per_ray=16, infer_samples_per_ray=32, iters=100, seed=0,
              log2_hashmap_size=12, grid_levels=4, bg_radius=RADIUS)
BC = np.array([[1.0, 0.2, 0.1], [0.1, 0.8, 0.0], [0.2, 0.3, 0.9], [0.8, 0.8, 0.2]], np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, atol=ATOL, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol, err_msg=msg)


def _rays(n, seed=1, radius=2.2):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * radius).astype(np.float32)
    d = -o + rng.normal(scale=0.8, size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _bits(seed=1):
    rng = np.random.default_rng(seed)
    c = (np.arange(H) + 0.5) / H * 2 - 1
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    occ = (gx ** 2 + gy ** 2 + gz ** 2 < 0.4) & (rng.uniform(size=gx.shape) < 0.9)
    return np.asarray(jocc.packbits(jnp.asarray(occ.reshape(-1))))


def _lively(params, names, seed):
    """Tables drawn from U(-2, 2) in place of the 1e-4 init, so every part of the field
    (and the background) varies."""
    rng = np.random.default_rng(seed)
    for name in names:
        params[name] = jnp.asarray(rng.uniform(-2, 2, params[name].shape).astype(np.float32))
    return params


@pytest.fixture(scope="module")
def nerf_model():
    jspec, tspec = jnerf.NeRFSpec.build(**NERF_KW), tnerf.NeRFSpec.build(**NERF_KW)
    jparams = _lively(jnerf.init_nerf(jax.random.PRNGKey(0), jspec),
                      ("encoder", "encoder_bg"), 0)
    return jspec, tspec, jparams, tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                               jparams))


@pytest.fixture(scope="module")
def palette_model():
    kw = dict(PAL_KW, color_space="linear")
    jspec, tspec = jpal.PaletteSpec.build(**kw), tpal.PaletteSpec.build(**kw)
    hist = np.random.default_rng(3).uniform(size=(32, 32, 32, 4)).astype(np.float32)
    params = jpal.init_palette(jax.random.PRNGKey(1), jspec)
    params = jpal.initialize_palette(params, jspec, BC, hist / hist.sum(-1, keepdims=True))
    params = _lively(params, ("encoder", "encoder_palette", "encoder_bg"), 1)
    return jspec, tspec, params, tckpt.palette_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))


def _settings(mod, **kw):
    base = dict(bound=1.0, cascade=1, grid_size=H, dt_gamma=0.0, max_steps=64,
                num_samples=16, t_thresh=1e-4, min_near=0.05, bg_radius=RADIUS)
    base.update(kw)
    return mod.RenderSettings(**base)


# --------------------------------------------------------------------------- leaves

def test_sph_from_ray_matches():
    """Rays from inside and outside the sphere, tangent and axis-parallel ones (+-x, +-y
    with theta at 0 and pi, +-z), and a radius the origin lies outside of (a clamped
    discriminant)."""
    o, d = _rays(300, seed=4)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    o = np.concatenate([o, np.zeros((6, 3), np.float32), axes * 1.5,
                        np.array([[0, 0, 5.0], [5.0, 0, 0]], np.float32)])
    d = np.concatenate([d, axes, -axes, np.array([[0, 1.0, 0], [0, 0, 1.0]], np.float32)])
    for radius in (RADIUS, 32.0, 2.0):
        got = trays.sph_from_ray(T(o), T(d), radius)
        ref = jrays.sph_from_ray(jnp.asarray(o), jnp.asarray(d), radius)
        assert got.shape == (len(o), 2) and torch.isfinite(got).all()
        _close(got, ref, atol=1e-6, msg=str(radius))
        assert float(got.abs().max()) <= 1.0 + 1e-6
    # straight up is theta 0 (-1), straight down theta pi (+1); +z is phi pi/2 (0.5)
    got = trays.sph_from_ray(T(np.zeros((3, 3), np.float32)),
                             T(np.array([[0, 1, 0], [0, -1, 0], [0, 0, 1]], np.float32)), 8.0)
    _close(got[:, 0], [-1.0, 1.0, 0.0], atol=1e-6)
    assert float(got[2, 1]) == pytest.approx(0.5, abs=1e-6)


@pytest.mark.parametrize("log2_size", [19, 12], ids=["3dense+1hashed", "1dense+3hashed"])
def test_background_encoder_2d_matches(log2_size):
    """The background grid at D = 2: the same levels, offsets and dense/hashed split as
    JAX; features and the f32 table gradient of ``hashgrid_encode_fast`` at points on
    every part of [0, 1]^2, the edges and corners included."""
    kw = dict(input_dim=2, num_levels=4, desired_resolution=2048, log2_hashmap_size=log2_size)
    tspec, jspec = thash.HashGridSpec.build(**kw), jhash.HashGridSpec.build(**kw)
    assert tspec.resolutions == tuple(jspec.resolutions) == (16, 81, 407, 2048)
    assert tspec.offsets == tuple(jspec.offsets)
    hashed = [tspec.level_layout(lvl)[2] for lvl in range(4)]
    assert hashed == ([False] * 3 + [True] if log2_size == 19 else [False] + [True] * 3)
    rng = np.random.default_rng(5)
    table = rng.uniform(-1, 1, (tspec.total_params, 2)).astype(np.float32)
    x = rng.uniform(size=(2000, 2)).astype(np.float32)
    x[:8] = [[0, 0], [1, 1], [0, 1], [1, 0], [0.5, 0], [1, 0.5], [1e-7, 1 - 1e-7], [0.25, 0.75]]
    cot = rng.normal(size=(2000, 8)).astype(np.float32)

    def jloss(t, xx):
        out = jfast.hashgrid_encode_fast(t, xx, None, jspec)
        return (out * cot).sum(), out

    # eager, as the JAX package's own encoder tests: under jit XLA fuses x * scale + 0.5
    # into one rounding, and at the finest level (scale 2047) a position's last bit is
    # 1.2e-4 of a cell, which moves a feature by up to 6e-5
    jgrad, ref = jax.grad(jloss, has_aux=True)(jnp.asarray(table), jnp.asarray(x))
    tt = T(table).requires_grad_(True)
    got = tfast.hashgrid_encode_fast(tt, T(x), tspec)
    (got * T(cot)).sum().backward()
    _close(got, ref, atol=1e-6)
    scale = float(jnp.abs(jgrad).max())
    _close(tt.grad, jgrad, atol=1e-5 * scale)
    assert int((tt.grad != 0).sum()) > 1000


def test_background_nets_match(nerf_model, palette_model):
    """``nerf_background`` and ``palette_background`` on parameters carried over with
    ``params_from_jax`` / ``palette_params_from_jax``, with the JAX package's shapes."""
    o, d = _rays(500, seed=6)
    sph = np.asarray(jrays.sph_from_ray(jnp.asarray(o), jnp.asarray(d), RADIUS))
    for (jspec, tspec, jparams, tparams), jfn, tfn in (
            (nerf_model, jnerf.nerf_background, tnerf.nerf_background),
            (palette_model, jpal.palette_background, tpal.palette_background)):
        assert tspec.grid_bg == tnerf.background_grid(RADIUS)
        ref = jfn(jparams, jspec, jnp.asarray(sph), jnp.asarray(d))
        got = tfn(tparams, tspec, T(sph), T(d))
        assert got.shape == (500, 3) and float(got.std()) > 0.01
        _close(got, ref, atol=1e-6)
    # a fresh port model has the JAX package's background shapes
    jspec, tspec, jparams, _ = nerf_model
    fresh = tnerf.init_nerf(tspec, torch.Generator().manual_seed(0))
    want = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert list(fresh) == list(want)
    for k in ("encoder_bg", "bg_net"):
        assert ([tuple(t.shape) for t in tmlp.param_leaves({k: fresh[k]})]
                == [tuple(t.shape) for t in tmlp.param_leaves({k: want[k]})]), k
    assert float(fresh["encoder_bg"].abs().max()) <= 1e-4
    _, pspec, _, ptparams = palette_model
    pfresh = tpal.init_palette(pspec, torch.Generator().manual_seed(0))
    assert set(pfresh) == set(ptparams) - {"hist_weights"}


def test_empty_bitfield_is_pure_background(nerf_model):
    """``tests/test_config_coverage.py``'s case: a fully empty grid renders the background
    net's colour, not white, in both packages."""
    jspec, tspec, jparams, tparams = nerf_model
    ro = np.tile(np.array([[0, 0, -1.5]], np.float32), (8, 1))
    rd = np.tile(np.array([[0, 0, 1.0]], np.float32), (8, 1))
    empty = np.zeros(H ** 3 // 8, np.uint8)
    st = dict(max_steps=32, num_samples=8)
    render = jax.jit(jrender.render_nerf_eval, static_argnums=(1, 5))
    ref = render(jparams, jspec, jnp.asarray(empty), jnp.asarray(ro), jnp.asarray(rd),
                 _settings(jrender, **st))
    got = trender.render_nerf_eval(tparams, tspec, T(empty), T(ro), T(rd),
                                   _settings(trender, **st))
    img = got["image"]
    assert torch.isfinite(img).all() and not torch.allclose(img, torch.ones_like(img))
    assert float(got["weights_sum"].abs().max()) == 0.0
    bg = tnerf.nerf_background(tparams, tspec, trays.sph_from_ray(T(ro), T(rd), RADIUS), T(rd))
    _close(img, bg, atol=1e-6)
    _close(img, ref["image"], atol=1e-6)


# --------------------------------------------------------------------------- renders

def test_render_nerf_train_matches_with_background(nerf_model):
    jspec, tspec, jparams, tparams = nerf_model
    o, d = _rays(192)
    bits = _bits()
    n = o.shape[0]
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.uniform(jax.random.split(key)[0], (n,)))
    gt = np.random.default_rng(3).uniform(size=(n, 3)).astype(np.float32)
    render = jax.jit(jrender.render_nerf_train, static_argnums=(1, 6))
    ref = render(jparams, jspec, jnp.asarray(bits), jnp.asarray(o), jnp.asarray(d), key,
                 _settings(jrender), rays_gt=jnp.asarray(gt))
    got = trender.render_nerf_train(tparams, tspec, T(bits), T(o), T(d), _settings(trender),
                                    rays_gt=T(gt), noise=T(noise))
    ws = got["weights_sum"]
    assert float(ws.max()) > 0.5 and float(ws.min()) < 0.1  # hits and misses
    for k in ("image", "depth", "weights_sum", "rgb_norm"):
        _close(got[k], ref[k], msg=k)


@pytest.mark.parametrize("rounds", [(), ((1, 8), (4, 8), (16, 16))], ids=["flat", "rounds"])
def test_render_nerf_eval_matches_with_background(nerf_model, rounds):
    """``render_nerf_eval`` and, with compaction rounds, ``render_nerf_eval_compact``."""
    jspec, tspec, jparams, tparams = nerf_model
    o, d = _rays(256, seed=2)
    bits = _bits(2)
    kw = dict(num_samples=32, t_thresh=1e-2, compaction_rounds=rounds)
    render = jax.jit(jrender.render_nerf_eval, static_argnums=(1, 5))
    ref = render(jparams, jspec, jnp.asarray(bits), jnp.asarray(o), jnp.asarray(d),
                 _settings(jrender, **kw))
    got = trender.render_nerf_eval(tparams, tspec, T(bits), T(o), T(d),
                                   _settings(trender, **kw))
    assert float(got["weights_sum"].min()) < 0.1
    for k in ("image", "depth", "depth_origin", "weights_sum"):
        _close(got[k], ref[k], msg=k)


def test_palette_renders_match_with_background_and_linear(palette_model):
    """``render_palette_train`` (with the smooth loss) and ``render_palette_eval`` of a
    linear-space palette model with the background net."""
    jspec, tspec, jparams, tparams = palette_model
    _close(tparams["basis_color"], tpal.srgb_to_linear(T(BC)), atol=1e-6)
    o, d = _rays(160, seed=3)
    bits = _bits(3)
    n, S = o.shape[0], 16
    key = jax.random.PRNGKey(9)
    k_noise, k_smooth, _ = jax.random.split(key, 3)
    noise = np.asarray(jax.random.uniform(k_noise, (n,)))
    jit_u = np.asarray(jax.random.uniform(k_smooth, (n * S, 3)))
    render = jax.jit(jpr.render_palette_train, static_argnums=(1, 6, 8, 9))
    ref = render(jparams, jspec, jnp.asarray(bits), jnp.asarray(o), jnp.asarray(d), key,
                 _settings(jrender), None, False, True)
    got = tpr.render_palette_train(tparams, tspec, T(bits), T(o), T(d), _settings(trender),
                                   freeze_basis_color=False, require_smooth_loss=True,
                                   noise=T(noise), jit_u=T(jit_u))
    assert float(got["weights_sum"].min()) < 0.1
    for k in ref:
        _close(got[k], ref[k], msg=k)
    st = dict(num_samples=32, t_thresh=1e-2)
    render = jax.jit(jpr.render_palette_eval, static_argnums=(1, 5))
    ref = render(jparams, jspec, jnp.asarray(bits), jnp.asarray(o), jnp.asarray(d),
                 _settings(jrender, **st))
    got = tpr.render_palette_eval(tparams, tspec, T(bits), T(o), T(d), _settings(trender, **st))
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], msg=k)


# --------------------------------------------------------------------------- steps

def _img(n, seed):
    """RGBA pixels: a third opaque, a sixth transparent (RGB kept under alpha 0)."""
    img = np.random.default_rng(seed).uniform(size=(n, 4)).astype(np.float32)
    img[: n // 3, 3] = 1.0
    img[n // 3: n // 2, 3] = 0.0
    return img


def _close_after_update(name, got, ref, lr=1e-2):
    diff = (got.detach() - ref).abs()
    assert int((diff > 1e-6).sum()) <= max(1, got.numel() // 20), (name, float(diff.max()))
    assert float(diff.max()) <= 2 * lr + 1e-6, name


def test_stage1_step_with_background_matches_jax_trainer(nerf_model, tmp_path):
    """RGBA images with the background net: the target is the straight RGB (no random
    background is drawn), the net trains with the rest. Loss, per-ray loss, and every
    parameter and its EMA after the update (bg net included)."""
    jspec, tspec, jparams, tparams = nerf_model
    n = CFG_KW["num_rays"]
    o, d = _rays(n, seed=5)
    bits, img = _bits(5), _img(n, 6)
    jtr = JTrainer("ngp", JConfig(**dict(CFG_KW, fp16=False, O=False)), jspec,
                   params=jax.tree_util.tree_map(jnp.array, jparams),
                   workspace=str(tmp_path / "jax"), use_checkpoint="scratch", mute=True)
    key = jax.random.PRNGKey(5)
    _, k_pt = jax.random.split(key)
    noise = np.asarray(jax.random.uniform(jax.random.split(k_pt)[0], (n,)))
    new_j, _, ema_j, loss_j, per_ray_j = jtr._train_step(
        jtr.params, jtr.opt_state, jtr.ema_params, jnp.asarray(bits), key,
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(img))
    ttr = TTrainer("ngp", TConfig(**dict(CFG_KW, fp16=False, O=False)), tspec, params=tparams,
                   workspace=str(tmp_path / "torch"), use_checkpoint="scratch", mute=True,
                   device="cpu")
    assert ttr.train_settings.bg_radius == ttr.eval_settings.bg_radius == RADIUS
    ttr.grid_state = ttr.grid_state._replace(bitfield=T(bits))
    state = ttr.generator.get_state()
    loss_t, per_ray_t = ttr.train_step(T(o), T(d), T(img), noise=T(noise))
    assert torch.equal(ttr.generator.get_state(), state)  # no background drawn
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    _close(per_ray_t, per_ray_j)
    for got, ref in ((ttr.params, new_j), (ttr.ema_params, ema_j)):
        ref = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, ref))
        for i, (p, p_ref) in enumerate(zip(tnerf.param_list(got), tnerf.param_list(ref))):
            _close_after_update(f"leaf {i}", p, p_ref)
    moved = (ttr.params["encoder_bg"].detach() - tparams["encoder_bg"]).abs().max()
    assert float(moved) == pytest.approx(1e-2, rel=1e-3)


def test_palette_step_with_background_matches_jax_trainer(palette_model, tmp_path):
    """The palette step on RGBA images with the background net in linear space: the
    straight RGB in linear space as the target; the bg net is trained in this stage."""
    jspec, tspec, jparams, tparams = palette_model
    kw = dict(CFG_KW, use_initialization_from_rgbxy=True, color_space="linear")
    n = kw["num_rays"]
    o, d = _rays(n, seed=7)
    bits, img = _bits(7), _img(n, 8)
    jtr = JPaletteTrainer("palette", JConfig(**kw), jspec,
                          params=jax.tree_util.tree_map(jnp.array, jparams),
                          workspace=str(tmp_path / "jax"), use_checkpoint="scratch", mute=True)
    ttr = TPaletteTrainer("palette", TConfig(**kw), tspec, params=tparams,
                          workspace=str(tmp_path / "torch"), use_checkpoint="scratch",
                          mute=True, device="cpu")
    ttr.grid_state = ttr.grid_state._replace(bitfield=T(bits))
    key = jax.random.PRNGKey(11)
    _, k_render = jax.random.split(key)
    noise = np.asarray(jax.random.uniform(jax.random.split(k_render, 3)[0], (n,)))
    new_j, _, _, loss_j, per_ray_j = jtr._train_step(
        jtr.params, jtr.opt_state, jtr.ema_params, jnp.asarray(bits), key, jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(img), jnp.zeros((n, 16)), jnp.zeros((n,), jnp.int32),
        jnp.float32(0.05), jnp.float32(0.0), jnp.int32(32), True, False)
    loss_t, per_ray_t = ttr.train_step(T(o), T(d), T(img), noise=T(noise))
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    _close(per_ray_t, per_ray_j)
    ref = tckpt.palette_params_from_jax(jax.tree_util.tree_map(np.asarray, new_j))
    for k in ("encoder_bg", "bg_net", "diff_net", "encoder_palette", "basis_net"):
        for i, (p, p_ref) in enumerate(zip(tmlp.param_leaves({k: ttr.params[k]}),
                                           tmlp.param_leaves({k: ref[k]}))):
            _close_after_update(f"{k}[{i}]", p, p_ref)
    assert not torch.equal(ttr.params["bg_net"][0].detach(), tparams["bg_net"][0])


# --------------------------------------------------------------------------- warm start

def test_warm_start_carries_the_background_net(nerf_model, palette_model, tmp_path):
    """The non-strict NeRF -> palette load copies ``encoder_bg`` and ``bg_net`` by name,
    from a JAX pickle and from the port's own checkpoint, as the JAX trainer does."""
    _, nspec, jnparams, tnparams = nerf_model
    jspec, tspec, jparams, tparams = palette_model
    gs = {"density_grid": np.zeros((1, H ** 3), np.float32),
          "bitfield": np.asarray(_bits()), "mean_density": np.float32(0.5),
          "iter_density": np.int32(3)}
    jax_ws = tmp_path / "jax_ws"
    jckpt.save_checkpoint(str(jax_ws / "checkpoints"), "ngp", 2, 16,
                          jax.tree_util.tree_map(np.asarray, jnparams), {"grid_state": gs})
    tr = TTrainer("ngp", TConfig(**CFG_KW), nspec, params=tnparams,
                  workspace=str(tmp_path / "torch_ws"), use_checkpoint="scratch", mute=True,
                  device="cpu")
    tr.epoch = 2
    tr.save_checkpoint()
    kw = dict(CFG_KW, use_initialization_from_rgbxy=True, color_space="linear")
    for ws in (str(jax_ws), tr.workspace):
        ttr = TPaletteTrainer("palette", TConfig(**kw), tspec, params=tparams,
                              workspace=str(tmp_path / "pal"), use_checkpoint="scratch",
                              mute=True, device="cpu", nerf_path=ws)
        for k in ("encoder_bg", "bg_net", "encoder", "color_net"):
            for got, ref in zip(tmlp.param_leaves({k: ttr.params[k]}),
                                tmlp.param_leaves({k: tnparams[k]})):
                assert torch.equal(got.detach(), ref), (ws, k)
        assert ttr.params["encoder_bg"].requires_grad  # trained in this stage
    jtr = JPaletteTrainer("palette", JConfig(**kw), jspec, params=jparams,
                          workspace=str(tmp_path / "jpal"), use_checkpoint="scratch",
                          mute=True, nerf_path=str(jax_ws))
    ref = tckpt.palette_params_from_jax(jax.tree_util.tree_map(np.asarray, jtr.params))
    for got, want in zip(tmlp.param_leaves(ttr.params),
                         tmlp.param_leaves({k: ref[k] for k in ttr.params})):
        assert torch.equal(got.detach(), want)

