"""Port parity of sample compaction (``--train_compact_frac`` / ``--eval_compact_frac``):
``forward_compact``, ``_compact_budget`` and ``compact_overflow``, and the renders that use
them, against palettenerf_tpu on the same NumPy inputs (after
``tests/test_sample_compaction.py``).

Draws: the march jitter, the smooth-loss jitter (over all N*S slots) and the ``-O2``
encode draws (over the compact budget's rows) are drawn from JAX keys as the JAX renders
draw them, and handed to the port. The JAX eval renders run under ``jax.jit``, as the
JAX trainers run them; the train renders and their gradients run op by op (under
``jit`` XLA fuses the sample positions' arithmetic, whose last bits then differ from
the op-by-op values that the port computes, and the lively tables of these tests turn
that into gradient differences of ~1%).

Tolerances. ``forward_compact`` against JAX: exact (gathers only). Overflow counts:
exact. Renders atol 2e-5, and the compacted render against the port's own uncompacted
one atol 2e-5 (f32 sums in another order). Gradients: the MLPs within 1e-5 of each
tensor's largest entry, an f32 table within 1e-5 of its largest entry, a bf16-scattered
table (``-O``) within 1e-2 of it (an update that differs in its last f32 bit rounds to
the neighbouring bf16 value), as in ``tests/test_torch_palette_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.models import nerf as jnerf
from palettenerf_tpu.models import palette as jpal
from palettenerf_tpu.render import nerf_renderer as jrender
from palettenerf_tpu.render import palette_renderer as jpr
from palettenerf_torch.models import nerf as tnerf
from palettenerf_torch.models import palette as tpal
from palettenerf_torch.ops.hashgrid_fast import EncodeRand
from palettenerf_torch.render import nerf_renderer as trender
from palettenerf_torch.render import palette_renderer as tpr
from palettenerf_torch.train import checkpoint as tckpt
from test_torch_palette_train import SPEC_KW, _close, _model, _scene, _settings
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
O2 = dict(fast_grad=True, stochastic_trilerp=True, grad_levels=2)
NERF_KW = dict(bound=1.0, log2_hashmap_size=12, grid_levels=4, hidden_dim=16,
               hidden_dim_color=16)


def T(a):
    return torch.from_numpy(np.array(a))


def _nerf(profile: str):
    """A small NeRF on both sides with a lively table: ``plain`` (f32 backward), ``O``
    (bf16 scatter) or ``O2``."""
    kw = dict(NERF_KW, **({"O": dict(fp16=True), "O2": dict(fp16=True, **O2)}.get(profile, {})))
    jspec, tspec = jnerf.NeRFSpec.build(**kw), tnerf.NeRFSpec.build(**kw)
    jparams = jnerf.init_nerf(jax.random.PRNGKey(1), jspec)
    jparams["encoder"] = jnp.asarray(np.random.default_rng(1).uniform(
        -1, 1, jparams["encoder"].shape).astype(np.float32))
    tparams = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return jspec, tspec, jparams, tparams


# --------------------------------------------------------------------------- leaves

def test_forward_compact_expand_parity():
    rng = np.random.default_rng(2)
    M = 1024
    xyz = rng.normal(size=(M, 3)).astype(np.float32)
    valid = rng.uniform(size=(M,)) < 0.3
    fn_j = lambda x: (x.sum(-1), x * 2.0)  # noqa: E731
    fn_t = lambda x: (x.sum(-1), x * 2.0)  # noqa: E731
    ref = jrender.forward_compact(fn_j, jnp.asarray(valid), 512, jnp.asarray(xyz))
    got = trender.forward_compact(fn_t, T(valid), 512, T(xyz))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got[1].numpy(), np.where(valid[:, None], 2 * xyz, 0))


def test_forward_compact_budget_drop_and_gradients():
    """Past the budget the valid samples are dropped (zeros out, no gradient); the kept
    ones get the gradient of the plain function."""
    M = 256
    valid = np.ones((M,), bool)
    valid[::3] = False
    xyz = np.arange(3 * M, dtype=np.float32).reshape(M, 3) / M
    ref = jrender.forward_compact(lambda x: (x.sum(-1),), jnp.asarray(valid), 128,
                                  jnp.asarray(xyz))[0]
    x = T(xyz).requires_grad_(True)
    (got,) = trender.forward_compact(lambda x: ((x ** 2).sum(-1),), T(valid), 128, x)
    kept = np.cumsum(valid) <= 128
    assert kept.sum() > 128 and (valid & kept).sum() == 128
    np.testing.assert_array_equal((got != 0).numpy(), valid & kept)
    np.testing.assert_array_equal((np.asarray(ref) != 0), valid & kept)
    got.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.where((valid & kept)[:, None], 2 * xyz, 0))


@pytest.mark.parametrize("frac,n_slots", [(0.25, 4096), (0.01, 4096), (0.3, 100),
                                          (1.0, 1000), (0.5, 129)])
def test_compact_budget_and_overflow_match(frac, n_slots):
    j = jrender._compact_budget(jrender.RenderSettings(compact_frac=frac), n_slots)
    t = trender._compact_budget(trender.RenderSettings(compact_frac=frac), n_slots)
    assert t == j and t % 128 == 0 or t == n_slots
    valid = np.random.default_rng(n_slots).uniform(size=(n_slots,)) < 0.4
    got = trender.compact_overflow(T(valid), t)
    assert got.dtype == torch.int32 and got.shape == (1,)
    assert int(got[0]) == int(np.asarray(jrender.compact_overflow(jnp.asarray(valid), j))[0])


# --------------------------------------------------------------------------- nerf renders

def _eval_pair(settings_kw, n=160):
    jspec, tspec, jparams, tparams = _nerf("plain")
    o, d, bits = _scene(n)
    ref = jax.jit(lambda p, b, o, d: jrender.render_nerf_eval(
        p, jspec, b, o, d, _settings(jrender, **settings_kw)))(
            jparams, jnp.asarray(bits), jnp.asarray(o), jnp.asarray(d))
    got = trender.render_nerf_eval(tparams, tspec, T(bits), T(o), T(d),
                                   _settings(trender, **settings_kw))
    plain_kw = {k: v for k, v in settings_kw.items() if k != "compact_frac"}
    plain = trender.render_nerf_eval(tparams, tspec, T(bits), T(o), T(d),
                                     _settings(trender, **plain_kw))
    return got, ref, plain


@pytest.mark.parametrize("rounds,frac", [((), 0.5), (((1, 8), (4, 8), (16, 16)), 1.0)],
                         ids=["flat", "rounds"])
def test_eval_compact_matches_plain_and_jax(rounds, frac):
    """A budget that holds every valid sample (39% of the slots are valid; in round 0 of
    the rounds most are): the render equals the uncompacted one, and JAX's."""
    got, ref, plain = _eval_pair(dict(num_samples=32, compact_frac=frac,
                                      compaction_rounds=rounds))
    assert set(got) == set(ref) == set(plain) | {"compact_overflow"}
    assert int(got["compact_overflow"][0]) == 0 == int(np.asarray(ref["compact_overflow"])[0])
    for k in plain:
        _close(got[k], ref[k], msg=k)
        _close(got[k], plain[k], msg=k)
    assert float(got["weights_sum"].max()) > 0.5


@pytest.mark.parametrize("rounds", [(), ((1, 8), (4, 8), (16, 16))], ids=["flat", "rounds"])
def test_eval_overflow_counts_match_jax(rounds):
    """An undersized budget: the same samples are dropped (same render) and counted (summed
    over the rounds)."""
    got, ref, plain = _eval_pair(dict(num_samples=32, compact_frac=0.02,
                                      compaction_rounds=rounds))
    n_over = int(got["compact_overflow"][0])
    assert n_over > 0 and n_over == int(np.asarray(ref["compact_overflow"])[0])
    for k in plain:
        _close(got[k], ref[k], msg=k)
    assert float((got["image"] - plain["image"]).abs().max()) > 1e-3


@pytest.mark.parametrize("profile,frac", [("plain", 0.25), ("O", 0.75), ("O2", 0.25)])
def test_train_compact_matches_jax(profile, frac):
    """render_nerf_train with compaction: outputs, overflow and table / MLP gradients; the
    ``-O2`` draw covers the budget's rows. 61% of the slots hold a sample: at frac 0.25
    samples are dropped."""
    jspec, tspec, jparams, tparams = _nerf(profile)
    n, S = 160, 16
    o, d, bits = _scene(n)
    gt = np.random.default_rng(2).uniform(size=(n, 3)).astype(np.float32)
    co = np.random.default_rng(3).normal(size=(n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    k_noise, k_enc = jax.random.split(key)
    noise = np.asarray(jax.random.uniform(k_noise, (n,)))
    st_t = _settings(trender, compact_frac=frac)
    budget = trender.train_rows(st_t, n)
    assert budget == jrender._compact_budget(_settings(jrender, compact_frac=frac), n * S)
    jr = jnerf.encode_rand_for(k_enc, jspec, budget)
    rand = None if jr is None else EncodeRand(u=T(jr.u), lvls=T(jr.lvls).long())

    def jloss(p):
        out = jrender.render_nerf_train(p, jspec, jnp.asarray(bits), jnp.asarray(o),
                                        jnp.asarray(d), key, _settings(jrender,
                                                                       compact_frac=frac),
                                        rays_gt=jnp.asarray(gt))
        return (out["image"] * co).sum() + out["rgb_norm"].sum(), out

    (_, ref), jgrad = jax.value_and_grad(jloss, has_aux=True)(jparams)
    for p in tnerf.param_list(tparams):
        p.requires_grad_(True)
    got = trender.render_nerf_train(tparams, tspec, T(bits), T(o), T(d), st_t,
                                    rays_gt=T(gt), noise=T(noise), rand=rand)
    ((got["image"] * T(co)).sum() + got["rgb_norm"].sum()).backward()
    assert set(got) == set(ref)
    over = int(got["compact_overflow"][0])
    assert over == int(np.asarray(ref["compact_overflow"])[0]) and (over > 0) == (frac < 0.5)
    for k in ("image", "depth", "weights_sum", "rgb_norm"):
        _close(got[k], ref[k], msg=k)
    g_ref = np.asarray(jgrad["encoder"])
    _close(tparams["encoder"].grad, g_ref, msg="encoder grad",
           atol=(1e-2 if profile == "O" else 1e-5) * np.abs(g_ref).max())
    jnet = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jgrad))
    for name in ("sigma_net", "color_net"):
        for i, (layer, ref_layer) in enumerate(zip(tparams[name], jnet[name])):
            scale = float(ref_layer.abs().max())
            _close(layer.grad, ref_layer, atol=1e-5 * scale, msg=f"{name}[{i}]")


def test_train_compact_full_budget_equals_plain_render():
    """compact_frac 1.0 keeps every valid sample: the port's compacted render and its
    gradients equal the uncompacted ones."""
    _, tspec, _, tparams = _nerf("plain")
    n = 96
    o, d, bits = _scene(n)
    noise = torch.rand(n, generator=torch.Generator().manual_seed(0))
    outs, grads = [], []
    for frac in (0.0, 1.0):
        p = {k: ([{kk: vv.clone().requires_grad_(True) for kk, vv in layer.items()}
                  if isinstance(layer, dict) else layer.clone().requires_grad_(True)
                  for layer in v] if isinstance(v, list) else v.clone().requires_grad_(True))
             for k, v in tparams.items()}
        out = trender.render_nerf_train(p, tspec, T(bits), T(o), T(d),
                                        _settings(trender, compact_frac=frac), noise=noise)
        out["image"].sum().backward()
        outs.append(out)
        grads.append(p["encoder"].grad)
    _close(outs[1]["image"], outs[0]["image"].detach(), msg="image")
    _close(grads[1], grads[0], atol=1e-6, msg="encoder grad")
    assert "compact_overflow" not in outs[0] and int(outs[1]["compact_overflow"][0]) == 0


# --------------------------------------------------------------------------- palette renders

@pytest.mark.parametrize("smooth", [False, True], ids=["plain", "smooth"])
def test_render_palette_train_compact_matches_jax(smooth):
    """Every per-sample computation in the compact domain, ``jit_u`` (drawn over the N*S
    slots) compacted with the samples; the palette and clip tables' gradients."""
    kw = dict(SPEC_KW, pred_clip=True, clip_dim=6, smooth_sigma_clip=0.5 if smooth else 0.0)
    jspec, tspec = jpal.PaletteSpec.build(**kw), tpal.PaletteSpec.build(**kw)
    _, _, jparams, tparams = _model(pred_clip=True)
    n, S, frac = 160, 16, 0.25
    o, d, bits = _scene(n)
    key = jax.random.PRNGKey(3)
    k_noise, k_smooth, _ = jax.random.split(key, 3)
    noise = np.asarray(jax.random.uniform(k_noise, (n,)))
    jit_u = np.asarray(jax.random.uniform(k_smooth, (n * S, 3)))
    co = np.random.default_rng(5).normal(size=(n, 3)).astype(np.float32)

    def jloss(p):
        out = jpr.render_palette_train(p, jspec, jnp.asarray(bits), jnp.asarray(o),
                                       jnp.asarray(d), key,
                                       _settings(jrender, compact_frac=frac),
                                       freeze_basis_color=False, require_smooth_loss=smooth)
        return (out["image"] * co).sum() + out["smooth_norm"].sum() + out["clip_feat"].sum(), out

    (_, ref), jgrad = jax.value_and_grad(jloss, has_aux=True)(jparams)
    for name in ("encoder_palette", "encoder_clip"):
        tparams[name].requires_grad_(True)
    got = tpr.render_palette_train(tparams, tspec, T(bits), T(o), T(d),
                                   _settings(trender, compact_frac=frac),
                                   freeze_basis_color=False, require_smooth_loss=smooth,
                                   noise=T(noise), jit_u=T(jit_u))
    ((got["image"] * T(co)).sum() + got["smooth_norm"].sum()
     + got["clip_feat"].sum()).backward()
    assert set(got) == set(ref)
    assert int(got["compact_overflow"][0]) == int(np.asarray(ref["compact_overflow"])[0])
    assert (float(got["smooth_norm"].max()) > 0) == smooth
    for k in ref:
        _close(got[k], ref[k], msg=k)
    for name in ("encoder_palette", "encoder_clip"):
        g_ref = np.asarray(jgrad[name])
        _close(tparams[name].grad, g_ref, atol=1e-5 * np.abs(g_ref).max(), msg=name)


@pytest.mark.parametrize("frac", [0.5, 0.05])
def test_render_palette_eval_compact_matches_jax(frac):
    jspec, tspec, jparams, tparams = _model(pred_clip=True)
    o, d, bits = _scene(160)
    st = dict(num_samples=32, t_thresh=1e-2, compact_frac=frac)
    ref = jax.jit(lambda p, b, o, d: jpr.render_palette_eval(
        p, jspec, b, o, d, _settings(jrender, **st)))(
            jparams, jnp.asarray(bits), jnp.asarray(o), jnp.asarray(d))
    got = tpr.render_palette_eval(tparams, tspec, T(bits), T(o), T(d), _settings(trender, **st))
    assert set(got) == set(ref)
    over = int(got["compact_overflow"][0])
    assert over == int(np.asarray(ref["compact_overflow"])[0]) and (over > 0) == (frac < 0.1)
    for k in ref:
        _close(got[k], ref[k], msg=k)
    if frac == 0.5:  # no overflow: the uncompacted render
        plain = tpr.render_palette_eval(tparams, tspec, T(bits), T(o), T(d),
                                        _settings(trender, num_samples=32, t_thresh=1e-2))
        for k in plain:
            _close(got[k], plain[k], msg=k)
