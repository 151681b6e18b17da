"""Port parity of the shipped training profiles: ``-O2`` (fast_grad, stochastic_trilerp,
grad_levels), ``hash_xadd``, the paired-pixel ``random_size`` sampler with its
patch-smooth term and the ``error_map`` host-sampled epoch, for both trainers.

Draws: what the JAX functions draw from their keys (march jitter, smooth-loss jitter,
background, and ``encode_rand_for``'s corner uniforms and level subset) is derived from
the same keys here and handed to the port.

Tolerances. Renders atol 2e-5 (f32 sums in another order) with the f32 table backward,
table gradients within 1e-5 of their largest entry. One train step (bf16 backward):
loss rtol 1e-5, parameters after Adam's first step atol 1e-6 (``_close_params``, as in
``tests/test_torch_palette_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.config import Config as JConfig
from palettenerf_tpu.data import provider as jprov
from palettenerf_tpu.data import rays as jrays
from palettenerf_tpu.models import nerf as jnerf
from palettenerf_tpu.models import palette as jpal
from palettenerf_tpu.render import nerf_renderer as jrender
from palettenerf_tpu.render import palette_renderer as jpr
from palettenerf_tpu.train.palette_trainer import PaletteTrainer as JPaletteTrainer
from palettenerf_tpu.train.trainer import Trainer as JTrainer
from palettenerf_torch import main_nerf as tmain
from palettenerf_torch import main_palette as tmain_pal
from palettenerf_torch import main_serve as tserve
from palettenerf_torch.config import Config as TConfig
from palettenerf_torch.data import provider as tprov
from palettenerf_torch.data import rays as trays
from palettenerf_torch.models import nerf as tnerf
from palettenerf_torch.models import palette as tpal
from palettenerf_torch.ops.hashgrid_fast import EncodeRand
from palettenerf_torch.render import nerf_renderer as trender
from palettenerf_torch.render import palette_renderer as tpr
from palettenerf_torch.train import checkpoint as tckpt
from palettenerf_torch.train import trainer as ttrainer
from palettenerf_torch.train.palette_trainer import PaletteTrainer as TPaletteTrainer
from palettenerf_torch.train.palette_trainer import patch_smooth_term
from synthetic import make_sphere_dataset
from test_torch_palette_train import (BC, CFG_KW, _close, _close_params, _model, _scene,
                                      _settings, _tree_pairs)
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
O2 = dict(fast_grad=True, stochastic_trilerp=True, grad_levels=2)
NERF_KW = dict(bound=1.0, log2_hashmap_size=12, grid_levels=4, hidden_dim=16,
               hidden_dim_color=16)


def T(a):
    return torch.from_numpy(np.array(a))


def _rand(r):
    """A JAX EncodeRand as the port's."""
    return EncodeRand(u=T(r.u), lvls=None if r.lvls is None else T(r.lvls).long())


def _nerf_model(gridtype="hash", fp16=False):
    kw = dict(NERF_KW, gridtype=gridtype, fp16=fp16, **O2)
    jspec, tspec = jnerf.NeRFSpec.build(**kw), tnerf.NeRFSpec.build(**kw)
    jparams = jnerf.init_nerf(jax.random.PRNGKey(1), jspec)
    jparams["encoder"] = jnp.asarray(np.random.default_rng(1).uniform(
        -1, 1, jparams["encoder"].shape).astype(np.float32))
    tparams = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jspec, tspec, jparams, tparams


# --------------------------------------------------------------------------- renders

@pytest.mark.parametrize("gridtype", ["hash", "hash_xadd"])
def test_render_nerf_train_O2_matches(gridtype):
    jspec, tspec, jparams, tparams = _nerf_model(gridtype)
    n, S = 160, 16
    o, d, bits = _scene(n)
    gt = np.random.default_rng(2).uniform(size=(n, 3)).astype(np.float32)
    co = np.random.default_rng(3).normal(size=(n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    k_noise, k_enc = jax.random.split(key)
    noise = np.asarray(jax.random.uniform(k_noise, (n,)))
    rand = jnerf.encode_rand_for(k_enc, jspec, n * S)
    assert rand.u.shape == (n * S, 4) and rand.lvls.shape == (2,)

    def jloss(p):
        out = jrender.render_nerf_train(p, jspec, jnp.asarray(bits), jnp.asarray(o),
                                        jnp.asarray(d), key, _settings(jrender),
                                        rays_gt=jnp.asarray(gt))
        return (out["image"] * co).sum() + out["rgb_norm"].sum(), out

    (_, ref), jgrad = jax.value_and_grad(jloss, has_aux=True)(jparams)
    for p in tnerf.param_list(tparams):
        p.requires_grad_(True)
    got = trender.render_nerf_train(tparams, tspec, T(bits), T(o), T(d), _settings(trender),
                                    rays_gt=T(gt), noise=T(noise), rand=_rand(rand))
    ((got["image"] * T(co)).sum() + got["rgb_norm"].sum()).backward()
    assert float(got["weights_sum"].detach().max()) > 0.5
    for k in ("image", "depth", "weights_sum", "rgb_norm"):
        _close(got[k], ref[k], msg=k)
    g_ref = np.asarray(jgrad["encoder"])
    scale = np.abs(g_ref).max()
    assert scale > 0
    _close(tparams["encoder"].grad, g_ref, atol=1e-5 * scale, msg="encoder grad")
    # grad_levels: only the drawn levels got a gradient
    idle = sorted(set(range(4)) - set(np.asarray(rand.lvls).tolist()))
    for lvl in idle:
        lo, hi = tspec.grid.offsets[lvl], tspec.grid.offsets[lvl + 1]
        assert not tparams["encoder"].grad[lo:hi].any()


@pytest.mark.parametrize("smooth", [False, True], ids=["plain", "smooth"])
def test_render_palette_train_O2_matches(smooth):
    """Every encoder of the step, the smooth loss's jittered pass included, shares one
    draw: the picks of a second draw would give other (plausible) values here."""
    kw = dict(bound=1.0, num_basis=4, log2_hashmap_size=12, grid_levels=4, hidden_dim=16,
              hidden_dim_color=16, pred_clip=True, clip_dim=6, **O2)
    jspec, tspec = jpal.PaletteSpec.build(**kw), tpal.PaletteSpec.build(**kw)
    _, _, jparams, tparams = _model(pred_clip=True)
    n, S = 160, 16
    o, d, bits = _scene(n)
    key = jax.random.PRNGKey(3)
    k_noise, k_smooth, k_enc = jax.random.split(key, 3)
    noise = np.asarray(jax.random.uniform(k_noise, (n,)))
    jit_u = np.asarray(jax.random.uniform(k_smooth, (n * S, 3)))
    rand = jnerf.encode_rand_for(k_enc, jspec, n * S)
    co = np.random.default_rng(5).normal(size=(n, 3)).astype(np.float32)

    def jloss(p):
        out = jpr.render_palette_train(p, jspec, jnp.asarray(bits), jnp.asarray(o),
                                       jnp.asarray(d), key, _settings(jrender),
                                       freeze_basis_color=False, require_smooth_loss=smooth)
        return (out["image"] * co).sum() + out["smooth_norm"].sum() + out["clip_feat"].sum(), out

    (_, ref), jgrad = jax.value_and_grad(jloss, has_aux=True)(jparams)
    for name in ("encoder_palette", "encoder_clip"):
        tparams[name].requires_grad_(True)
    got = tpr.render_palette_train(tparams, tspec, T(bits), T(o), T(d), _settings(trender),
                                   freeze_basis_color=False, require_smooth_loss=smooth,
                                   noise=T(noise), jit_u=T(jit_u), rand=_rand(rand))
    ((got["image"] * T(co)).sum() + got["smooth_norm"].sum()
     + got["clip_feat"].sum()).backward()
    assert (float(got["smooth_norm"].max()) > 0) == smooth
    for k in ref:
        _close(got[k], ref[k], msg=k)
    for name in ("encoder_palette", "encoder_clip"):
        g_ref = np.asarray(jgrad[name])
        _close(tparams[name].grad, g_ref, atol=1e-5 * np.abs(g_ref).max(), msg=name)


def test_exact_eval_is_unchanged_by_the_O2_flags():
    """Eval, the grid refresh's density and the bake interpolate exactly under -O2."""
    _, tspec, _, tparams = _nerf_model()
    plain = tnerf.NeRFSpec.build(**NERF_KW)
    o, d, bits = _scene(64)
    a = trender.render_nerf_eval(tparams, tspec, T(bits), T(o), T(d), _settings(trender))
    b = trender.render_nerf_eval(tparams, plain, T(bits), T(o), T(d), _settings(trender))
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    x = torch.rand((500, 3)) * 2 - 1
    torch.testing.assert_close(tnerf.nerf_density(tparams, tspec, x)["sigma"],
                               tnerf.nerf_density(tparams, plain, x)["sigma"], rtol=0, atol=0)
    _, _, _, tpparams = _model()
    kw = dict(bound=1.0, num_basis=4, log2_hashmap_size=12, grid_levels=4, hidden_dim=16,
              hidden_dim_color=16)
    pa = tpr.render_palette_eval(tpparams, tpal.PaletteSpec.build(**kw, **O2), T(bits), T(o),
                                 T(d), _settings(trender))
    pb = tpr.render_palette_eval(tpparams, tpal.PaletteSpec.build(**kw), T(bits), T(o), T(d),
                                 _settings(trender))
    for k in pa:
        torch.testing.assert_close(pa[k], pb[k], rtol=0, atol=0)


# --------------------------------------------------------------------------- train steps

def test_O2_train_step_matches_jax_trainer(tmp_path):
    jspec, tspec, jparams, tparams = _nerf_model(fp16=True)
    cfg = dict(O=True, O2=True, fp16=True, bound=1.0, grid_size=16, num_rays=128,
               max_steps=64, train_samples_per_ray=16, iters=100, seed=0,
               log2_hashmap_size=12, grid_levels=4, **O2)
    n, S = cfg["num_rays"], cfg["train_samples_per_ray"]
    o, d, bits = _scene(n)
    img = np.random.default_rng(4).uniform(size=(n, 4)).astype(np.float32)
    img[: n // 3, 3] = 1.0
    jtr = JTrainer("ngp", JConfig(**cfg), jspec, params=jparams,
                   workspace=str(tmp_path / "jax"), use_checkpoint="scratch", mute=True)
    key = jax.random.PRNGKey(5)
    k_bg, k_pt = jax.random.split(key)
    k_noise, k_enc = jax.random.split(k_pt)
    rand = jnerf.encode_rand_for(k_enc, jspec, n * S)
    new_j, _, _, loss_j, per_ray_j = jtr._train_step(
        jtr.params, jtr.opt_state, jtr.ema_params, jnp.asarray(bits), key,
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(img))
    ttr = ttrainer.Trainer("ngp", TConfig(**cfg), tspec, params=tparams,
                           workspace=str(tmp_path / "torch"), use_checkpoint="scratch",
                           mute=True, device="cpu")
    ttr.grid_state = ttr.grid_state._replace(bitfield=T(bits))
    loss_t, per_ray_t = ttr.train_step(
        T(o), T(d), T(img), bg=T(jax.random.uniform(k_bg, (n, 3))),
        noise=T(jax.random.uniform(k_noise, (n,))), enc_u=T(rand.u),
        enc_lvls=T(rand.lvls).long())
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    _close(per_ray_t, per_ray_j, atol=1e-6)
    ref = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, new_j))
    for got, want in zip(tnerf.param_list(ttr.params), tnerf.param_list(ref)):
        _close(got, want.numpy(), atol=1e-6)


def test_O2_palette_step_with_patch_smooth_matches_jax_trainer(tmp_path):
    """One -O2 palette step with the smooth loss on, the colours unfrozen and the
    paired-pixel patch term of a random_size batch, weighted so that the term is a
    large share of the loss: loss and parameters after the step."""
    kw = dict(bound=1.0, num_basis=4, log2_hashmap_size=12, grid_levels=4, hidden_dim=16,
              hidden_dim_color=16, fp16=True, **O2)
    jspec, tspec = jpal.PaletteSpec.build(**kw), tpal.PaletteSpec.build(**kw)
    _, _, jparams, tparams = _model(fp16=True)
    lam = 20.0
    cfg = dict(CFG_KW, O2=True, random_size=8, lambda_patchsmooth=lam, **O2)
    n, S, W = cfg["num_rays"], cfg["train_samples_per_ray"], 32
    inds, _ = trays.sample_ray_indices(np.random.default_rng(8), W, W, n, random_size=8)
    o, d, bits = _scene(n)
    img = np.random.default_rng(4).uniform(size=(n, 4)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    k_bg, k_render = jax.random.split(key)
    k_noise, k_smooth, k_enc = jax.random.split(k_render, 3)
    rand = jnerf.encode_rand_for(k_enc, jspec, n * S)
    jtr = JPaletteTrainer("palette", JConfig(**cfg), jspec, params=jparams,
                          workspace=str(tmp_path / "jax"), use_checkpoint="scratch", mute=True)
    new_j, _, _, loss_j, _ = jtr._train_step(
        jtr.params, jtr.opt_state, jtr.ema_params, jnp.asarray(bits), key, jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(img), jnp.zeros((n, 16)),
        jnp.asarray(inds.astype(np.int32)), jnp.float32(0.04), jnp.float32(1e-3),
        jnp.int32(W), False, True)
    ttr = TPaletteTrainer("palette", TConfig(**cfg), tspec, params=tparams,
                          workspace=str(tmp_path / "torch"), use_checkpoint="scratch",
                          mute=True, device="cpu")
    ttr.grid_state = ttr.grid_state._replace(bitfield=T(bits))
    ttr.freeze_basis_color, ttr.require_smooth_loss = False, True
    ttr.lambda_weight, ttr.lambda_palette = 0.04, 1e-3
    draws = dict(bg=T(jax.random.uniform(k_bg, (n, 3))),
                 noise=T(jax.random.uniform(k_noise, (n,))),
                 jit_u=T(jax.random.uniform(k_smooth, (n * S, 3))), enc_u=T(rand.u),
                 enc_lvls=T(rand.lvls).long())
    with torch.no_grad():  # the patch term on the render of these draws
        out = tpr.render_palette_train(
            ttr.params, tspec, T(bits), T(o), T(d), ttr.train_settings,
            bg_color=draws["bg"], freeze_basis_color=False, require_smooth_loss=True,
            noise=draws["noise"], jit_u=draws["jit_u"],
            rand=EncodeRand(draws["enc_u"], draws["enc_lvls"]))
        term = float(patch_smooth_term(out, T(inds), W, ttr.opt.sigma_color))
    loss_t, _ = ttr.train_step(T(o), T(d), T(img), inds=T(inds), width=W, **draws)
    assert lam * term > 0.1 * float(loss_t)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    for name, p, p_ref in _tree_pairs(ttr.params, new_j):
        _close_params(name, p, p_ref, 1e-6)
    with pytest.raises(ValueError, match="pixel indices"):
        ttr.train_step(T(o), T(d), T(img))


# --------------------------------------------------------------------------- samplers

def test_paired_and_error_map_samplers_match():
    for kw in (dict(random_size=8), dict(error_map=np.random.default_rng(0).uniform(
            size=128 * 128).astype(np.float32))):
        ref = jrays.sample_ray_indices(np.random.default_rng(3), 48, 40, 256, **kw)
        got = trays.sample_ray_indices(np.random.default_rng(3), 48, 40, 256, **kw)
        for a, b in zip(got, ref):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    inds, coarse = got
    assert coarse is not None and len(np.unique(coarse)) == 256
    pairs, _ = trays.sample_ray_indices(np.random.default_rng(4), 48, 40, 256, random_size=8)
    ij = np.stack([pairs // 40, pairs % 40], -1)
    assert np.abs(ij[:128] - ij[128:]).max() <= 8


@pytest.fixture(scope="module")
def sphere_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("recipes_sphere")
    return make_sphere_dataset(str(root), n_train=6, n_val=1, n_test=1, H=32, W=32)


def test_update_error_map_and_host_epoch(sphere_scene, tmp_path):
    """The error-map batch and update against the JAX provider; then one host-sampled
    epoch of the port's trainer moves the map."""
    kw = dict(path=sphere_scene, O=True, fp16=True, bound=1.0, scale=0.5, dt_gamma=0.0,
              min_near=0.05, num_rays=256, iters=12, max_steps=64, grid_size=16,
              train_samples_per_ray=16, infer_samples_per_ray=32, log2_hashmap_size=10,
              grid_levels=4, error_map=True, seed=0)
    tds = tprov.NeRFDataset(TConfig(**kw), type="train")
    jds = jprov.NeRFDataset(JConfig(**kw), type="train")
    tds.rng, jds.rng = np.random.default_rng(5), np.random.default_rng(5)
    tb, jb = tds.collate(2), jds.collate(2)
    for k in ("inds", "inds_coarse", "rays_o", "rays_d", "images"):
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    err = np.random.default_rng(6).uniform(size=len(tb["inds_coarse"])).astype(np.float32)
    tds.update_error_map(2, tb["inds_coarse"], err)
    jds.update_error_map(2, jb["inds_coarse"], err)
    np.testing.assert_array_equal(tds.error_map, np.asarray(jds.error_map))

    spec = tnerf.NeRFSpec.build(bound=1.0, fp16=True, log2_hashmap_size=10, grid_levels=4,
                                **O2)
    tr = ttrainer.Trainer("ngp", TConfig(**kw), spec, workspace=str(tmp_path / "ws"),
                          use_checkpoint="scratch", mute=True, device="cpu")
    assert tr.host_sampled()
    before = tds.error_map.copy()
    tr.train(tds, None, 2)
    assert tr.global_step == 12 and np.isfinite(tr.stats["loss"]).all()
    changed = (tds.error_map != before).any(-1)
    assert changed.all(), changed


# --------------------------------------------------------------------------- CLIs

def test_check_ported_keeps_raising_for_the_rest():
    """Only ``rand_pose`` still raises; the background net, the patch loss, the linear
    colour space and several devices pass, alone and with every other ported option."""
    base = TConfig()
    ttrainer.check_ported(base.replace(O2=True, fast_grad=True, stochastic_trilerp=True,
                                       grad_levels=8, gridtype="hash_xadd", random_size=8,
                                       error_map=True, march_groups=2, eval_fine_grid=256,
                                       eval_compact_frac=0.3, train_compact_frac=0.3,
                                       bg_radius=1.0, patch_size=2, lambda_lpips=0.1,
                                       color_space="linear", n_devices=2))
    for kw in (dict(bg_radius=1.0), dict(patch_size=2, lambda_lpips=0.1),
               dict(color_space="linear"), dict(n_devices=2)):
        ttrainer.check_ported(base.replace(**kw))
    with pytest.raises(NotImplementedError, match="rand_pose"):
        ttrainer.check_ported(base.replace(rand_pose=0))


@pytest.mark.parametrize("march_groups", [-1, 0, 3])
def test_render_options_reach_the_settings_as_in_jax(tmp_path, march_groups):
    """``--march_groups`` (-1 resolves to 0), ``--train_compact_frac``,
    ``--eval_compact_frac`` and ``--eval_fine_grid`` reach ``train_settings`` /
    ``eval_settings`` as in the JAX Trainer (trainer.py:111-136)."""
    kw = dict(bound=1.0, grid_size=16, seed=0, log2_hashmap_size=10, grid_levels=4,
              max_steps=64, train_samples_per_ray=16, infer_samples_per_ray=32,
              march_groups=march_groups, train_compact_frac=0.25, eval_compact_frac=0.125,
              eval_fine_grid=32)
    spec = dict(bound=1.0, log2_hashmap_size=10, grid_levels=4, hidden_dim=16,
                hidden_dim_color=16)
    jtr = JTrainer("ngp", JConfig(**kw), jnerf.NeRFSpec.build(**spec),
                   workspace=str(tmp_path / "jax"), use_checkpoint="scratch", mute=True)
    ttr = ttrainer.Trainer("ngp", TConfig(**kw), tnerf.NeRFSpec.build(**spec),
                           workspace=str(tmp_path / "torch"), use_checkpoint="scratch",
                           mute=True, device="cpu")
    for kind in ("train_settings", "eval_settings"):
        j, t = getattr(jtr, kind), getattr(ttr, kind)
        for f in ("march_groups", "compact_frac", "fine_grid_size", "compaction_rounds",
                  "num_samples"):
            assert getattr(t, f) == getattr(j, f), (kind, f)
    assert ttr.train_settings.march_groups == max(0, march_groups)
    assert (ttr.train_settings.compact_frac, ttr.eval_settings.compact_frac) == (0.25, 0.125)
    assert (ttr.train_settings.fine_grid_size, ttr.eval_settings.fine_grid_size) == (0, 32)


def _nerf_argv(scene, *extra):
    return [scene, "--bound", "1", "--scale", "0.5", "--dt_gamma", "0", "--min_near", "0.05",
            "--num_rays", "256", "--iters", "12", "--max_steps", "64",
            "--train_samples_per_ray", "16", "--infer_samples_per_ray", "32",
            "--log2_hashmap_size", "10", "--grid_levels", "4", "--eval_interval", "1",
            *extra]


def test_main_nerf_O2_cli_and_test_reload(sphere_scene, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = _nerf_argv(sphere_scene, "-O2", "--workspace", "o2")
    tr = tmain.main(argv, device="cpu", mesh_resolution=16)
    spec = tr.spec
    assert (spec.fp16, spec.fast_grad, spec.stochastic_trilerp, spec.grad_levels) == (
        True, True, True, 8)
    assert tr.global_step == 12 and tr.stats["loss"][-1] < tr.stats["loss"][0]
    val = tprov.NeRFDataset(tr.opt, type="val")
    psnr = tr.evaluate_one_epoch(val, save_images=False)
    again = tmain.main(argv + ["--test", "--version_id", "1"], device="cpu",
                       mesh_resolution=16)
    assert again.global_step == 12 and again.spec == spec
    assert again.evaluate_one_epoch(val, save_images=False) == pytest.approx(psnr, abs=1e-4)


def test_hash_xadd_error_map_nerf_to_palette_to_serve_clis(sphere_scene, tmp_path, monkeypatch):
    """main_nerf --gridtype hash_xadd --error_map (host-sampled epochs), then main_palette
    -O2 --random_size 8 --lambda_patchsmooth on it (patch term from epoch 1), its --test
    reload, and main_serve baking the hash_xadd checkpoint through the exact pair forward."""
    monkeypatch.chdir(tmp_path)
    nerf = tmain.main(_nerf_argv(sphere_scene, "-O", "--gridtype", "hash_xadd",
                                 "--error_map", "--workspace", "xadd"),
                      device="cpu", mesh_resolution=16)
    assert nerf.spec.grid.gridtype == "hash_xadd" and nerf.host_sampled()
    pal_argv = [sphere_scene, "results/xadd", "-O2", "--gridtype", "hash_xadd", "--bound", "1",
                "--scale", "0.5", "--dt_gamma", "0", "--min_near", "0.05", "--num_rays", "256",
                "--iters", "12", "--max_steps", "64", "--train_samples_per_ray", "16",
                "--infer_samples_per_ray", "32", "--log2_hashmap_size", "10",
                "--grid_levels", "4", "--eval_interval", "2", "--random_size", "8",
                "--lambda_patchsmooth", "1e-3", "--smooth_loss_start_epoch", "0"]
    pal = tmain_pal.main(pal_argv, device="cpu")
    assert pal.host_sampled() and pal.require_smooth_loss and pal.global_step == 12
    assert pal.palette_spec.stochastic_trilerp and np.isfinite(pal.stats["loss"]).all()
    cfg, test_tr = tmain_pal.load_test_trainer(pal_argv + ["--test"], device="cpu")
    assert test_tr.global_step == 12 and test_tr.palette_spec.grid.gridtype == "hash_xadd"
    torch.testing.assert_close(test_tr.params["encoder_palette"],
                               pal.params["encoder_palette"].detach())
    res = tserve.main([pal.workspace, "--resolution", "24", "--W", "32", "--H", "32",
                       "--u_res", "48", "--n_frames", "2", "--grid_levels", "4",
                       "--log2_hashmap_size", "10", "--gridtype", "hash_xadd", "--bench"],
                      device="cpu")
    assert res.fps > 0 and res.sv is not None
