"""Port parity of the random-feature LPIPS (rLPIPS): ``rlpips_distance`` with the JAX
package's conv stack handed over, the meters, the stage-1 patch loss (``--patch_size 4
--lambda_lpips 0.1``) in one train step, and the meter lists of both CLIs.

The port draws its own stack (``make_rlpips_kernels``, a seeded ``torch.Generator``): the
JAX package draws from ``jax.random``, so the two packages' scores agree only when both
run the same kernels, which is what these tests hand them.

Tolerances: the distance rtol 1e-5 (f32 convolutions summed in another order), its input
gradient 1e-5 of the gradient's largest entry; the train step's loss rtol 1e-5, the
per-ray loss ``ATOL = 2e-5``, every gradient 3e-4 of its tensor's largest entry: the
jitted JAX gradients of this step differ from JAX's own eager ones by up to 1.2e-4 of
that (``sigma_net``, with or without the patch term), the port's from the eager ones by
less than 1e-5.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.config import Config as JConfig
from palettenerf_tpu.models import nerf as jnerf
from palettenerf_tpu.ops import occupancy as jocc
from palettenerf_tpu.render import nerf_renderer as jrender
from palettenerf_tpu.train import metrics as jmetrics
from palettenerf_tpu.train import palette_trainer as jpt
from palettenerf_tpu.train import trainer as jtrainer
from palettenerf_torch import main_nerf as tmain_nerf
from palettenerf_torch import main_palette as tmain_palette
from palettenerf_torch.config import Config as TConfig
from palettenerf_torch.models import nerf as tnerf
from palettenerf_torch.train import metrics as tmetrics
from palettenerf_torch.train import palette_trainer as tpt
from palettenerf_torch.train import trainer as ttrainer
from palettenerf_torch.train.checkpoint import params_from_jax
from synthetic import make_sphere_dataset
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
ATOL = 2e-5
H = 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_kernels():
    jk = jmetrics.make_rlpips_kernels(0)
    return jk, [(T(w), T(b)) for w, b in jk]


# --------------------------------------------------------------------------- the distance

@pytest.mark.parametrize("shape", [(4, 16, 16), (2, 17, 23), (1, 40, 33)],
                         ids=["16x16", "17x23", "40x33"])
def test_rlpips_distance_matches_with_jax_kernels(jax_kernels, shape):
    """Value and input gradient. Every size takes XLA's asymmetric "SAME" padding
    somewhere in the stack (16 at k = 11, s = 4: 3 before, 4 after; 17 x 23 from the
    fourth stage on); the odd sizes also take uneven strides."""
    jk, tk = jax_kernels
    rng = np.random.default_rng(sum(shape))
    p = rng.uniform(size=shape + (3,)).astype(np.float32)
    g = np.clip(p + rng.normal(scale=0.2, size=p.shape), 0, 1).astype(np.float32)
    ref, jgrad = jax.jit(jax.value_and_grad(
        lambda x, y: jmetrics.rlpips_distance(jk, x, y)))(jnp.asarray(p), jnp.asarray(g))
    pt = T(p).requires_grad_(True)
    got = tmetrics.rlpips_distance(tk, pt, T(g))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(ref), rel=1e-5)
    scale = float(jnp.abs(jgrad).max())
    assert scale > 0
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-5 * scale)


def test_same_padding_matches_xla():
    """``_same_pad`` + a VALID conv gives XLA's SAME output size and alignment for every
    kernel and stride of the stack, at even and odd sizes."""
    rng = np.random.default_rng(0)
    for c_out, k, s in tmetrics._RLPIPS_TOPOLOGY[:2]:
        w = rng.normal(size=(4, 3, k, k)).astype(np.float32)
        for hw in ((16, 16), (17, 23), (11, 5), (3, 2)):
            x = rng.normal(size=(1, 3) + hw).astype(np.float32)
            ref = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (s, s), "SAME")
            got = torch.nn.functional.conv2d(tmetrics._same_pad(T(x), k, s), T(w), stride=s)
            assert tuple(got.shape) == tuple(ref.shape), (k, s, hw)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_make_rlpips_kernels_shapes_and_draw(jax_kernels):
    jk, _ = jax_kernels
    a, b = tmetrics.make_rlpips_kernels(0), tmetrics.make_rlpips_kernels(0)
    c = tmetrics.make_rlpips_kernels(1)
    assert [tuple(w.shape) for w, _ in a] == [tuple(np.shape(w)) for w, _ in jk]
    assert [tuple(bb.shape) for _, bb in a] == [tuple(np.shape(bb)) for _, bb in jk]
    for (w0, b0), (w1, b1), (w2, _) in zip(a, b, c):
        assert torch.equal(w0, w1) and torch.equal(b0, b1) and not torch.equal(w0, w2)
        fan_in = w0.shape[1] * w0.shape[2] * w0.shape[3]
        assert float(w0.std()) == pytest.approx((2.0 / fan_in) ** 0.5, rel=0.1)
        assert float(b0.std()) == pytest.approx(0.2, rel=0.5)


# --------------------------------------------------------------------------- meters

def test_meters():
    """rLPIPS: zero on identity, growing with the distortion, the same across instances,
    the JAX meter's name and report; LPIPS: NaN without the ``lpips`` package, as JAX."""
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(1, 24, 20, 3)).astype(np.float32)
    noise = rng.normal(size=img.shape).astype(np.float32)
    scores = []
    for s in (0.0, 0.02, 0.05, 0.1, 0.2):
        m = tmetrics.RLPIPSMeter()
        m.update(img, np.clip(img + s * noise, 0, 1))
        scores.append(m.measure())
    assert scores[0] == 0.0 and all(b > a for a, b in zip(scores, scores[1:])), scores
    m1, m2 = tmetrics.RLPIPSMeter(), tmetrics.RLPIPSMeter()
    for m in (m1, m2):
        m.update(img[0], img[0] * 0.7)  # an [H, W, 3] frame
        m.update(img, img[:, ::-1].copy())
    assert m1.measure() == m2.measure() > 0 and m1.N == 2
    jm = jmetrics.RLPIPSMeter()
    assert m1.name == jm.name and m1.report().startswith("rLPIPS = ")
    lp, jlp = tmetrics.LPIPSMeter(), jmetrics.LPIPSMeter()
    lp.update(img, img)
    jlp.update(img, img)
    assert lp.name == jlp.name == "LPIPS (alex)"
    assert np.isnan(lp.measure()) and np.isnan(jlp.measure())
    assert lp.report() == jlp.report()


# --------------------------------------------------------------------------- the patch loss

SPEC_KW = dict(bound=1.0, log2_hashmap_size=12, grid_levels=4, hidden_dim=16,
               hidden_dim_color=16)
CFG_KW = dict(bound=1.0, grid_size=H, num_rays=128, max_steps=64, train_samples_per_ray=16,
              infer_samples_per_ray=32, iters=100, seed=0, log2_hashmap_size=12,
              grid_levels=4, patch_size=4, lambda_lpips=0.1)


def _patch_batch(n, ps, seed=2):
    """Rays through ``n // ps^2`` patches of ps x ps neighbouring pixels of one camera,
    in ``data/rays.py``'s order, and RGBA pixels."""
    rng = np.random.default_rng(seed)
    o = np.array([0.3, 0.2, 2.4], np.float32)
    n_patch = n // ps ** 2
    corner = rng.integers(0, 24, (n_patch, 2))
    ij = (corner[:, None, :] + np.stack(np.meshgrid(np.arange(ps), np.arange(ps),
                                                    indexing="ij"), -1).reshape(1, -1, 2))
    ij = ij.reshape(-1, 2).astype(np.float32)
    d = np.stack([(ij[:, 1] - 16) / 20, (ij[:, 0] - 16) / 20, -np.ones(n)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    img = rng.uniform(size=(n, 4)).astype(np.float32)
    img[: n // 2, 3] = 1.0
    return np.tile(o, (n, 1)), d, img


def test_stage1_patch_loss_step_matches_jax_trainer(tmp_path, jax_kernels):
    """One stage-1 step with the patch loss: loss, per-ray loss and every gradient against
    ``jax.value_and_grad`` of the JAX trainer's loss (trainer.py:186-205) on the same
    draws, the port trainer holding the JAX stack."""
    jk, tk = jax_kernels
    jspec, tspec = jnerf.NeRFSpec.build(**SPEC_KW), tnerf.NeRFSpec.build(**SPEC_KW)
    jparams = jnerf.init_nerf(jax.random.PRNGKey(2), jspec)
    jparams["encoder"] = jnp.asarray(np.random.default_rng(2).uniform(
        -2, 2, jparams["encoder"].shape).astype(np.float32))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    n, ps = CFG_KW["num_rays"], CFG_KW["patch_size"]
    o, d, img = _patch_batch(n, ps)
    c = (np.arange(H) + 0.5) / H * 2 - 1
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    bits = np.asarray(jocc.packbits(jnp.asarray((gx ** 2 + gy ** 2 + gz ** 2 < 0.5).reshape(-1))))

    jtr = jtrainer.Trainer("ngp", JConfig(**CFG_KW), jspec, params=jparams,
                           workspace=str(tmp_path / "jax"), use_checkpoint="scratch", mute=True)
    assert len(jtr._rlpips_kernels) == 5
    key = jax.random.PRNGKey(8)
    k_bg, k_pt = jax.random.split(key)
    bg = np.asarray(jax.random.uniform(k_bg, (n, 3)))
    noise = np.asarray(jax.random.uniform(jax.random.split(k_pt)[0], (n,)))
    gt = img[:, :3] * img[:, 3:] + bg * (1 - img[:, 3:])
    settings = jtr.train_settings

    def loss_fn(p):
        out = jrender.render_nerf_train(p, jspec, jnp.asarray(bits), jnp.asarray(o),
                                        jnp.asarray(d), k_pt, settings, bg_color=jnp.asarray(bg),
                                        rays_gt=jnp.asarray(gt))
        per_ray = ((out["image"] - gt) ** 2).mean(-1) + out["rgb_norm"] * jtr.opt.lambda_sparse
        lp = jmetrics.rlpips_distance(jk, out["image"].reshape(-1, ps, ps, 3),
                                      jnp.asarray(gt).reshape(-1, ps, ps, 3))
        return per_ray.mean() + 0.1 * lp, (per_ray, lp)

    (loss_j, (per_ray_j, lp_j)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jparams)
    assert float(lp_j) > 0.1  # the patch term is a real part of the loss
    loss_step = jtr._train_step(jtr.params, jtr.opt_state, jtr.ema_params, jnp.asarray(bits),
                                key, jnp.asarray(o), jnp.asarray(d), jnp.asarray(img))[3]
    assert float(loss_step) == pytest.approx(float(loss_j), rel=1e-6)

    ttr = ttrainer.Trainer("ngp", TConfig(**CFG_KW), tspec, params=params_from_jax(tree),
                           workspace=str(tmp_path / "torch"), use_checkpoint="scratch",
                           mute=True, device="cpu")
    assert ttr.host_sampled() and len(ttr._rlpips_kernels) == 5
    ttr._rlpips_kernels = tk
    ttr.grid_state = ttr.grid_state._replace(bitfield=T(bits))
    loss_t, per_ray_t = ttr.train_step(T(o), T(d), T(img), bg=T(bg), noise=T(noise))
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    np.testing.assert_allclose(per_ray_t.numpy(), np.asarray(per_ray_j), rtol=0, atol=ATOL)
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    for i, (p, g_ref) in enumerate(zip(tnerf.param_list(ttr.params), tnerf.param_list(ref))):
        scale = float(g_ref.abs().max())
        assert scale > 0, i
        assert float((p.grad - g_ref).abs().max()) <= 3e-4 * scale, i


# --------------------------------------------------------------------------- the CLIs' meters

class _Captured(Exception):
    pass


def _capture(monkeypatch, module, name, store):
    """Replace ``module.name`` (a trainer class) by one that records the meters it is
    given and stops the CLI there."""
    def fake(*args, metrics=None, **kw):
        store.append([m.name for m in metrics])
        raise _Captured()
    monkeypatch.setattr(module, name, fake)


def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_meter_lists_match_jax(tmp_path, monkeypatch):
    """Both branches of both CLIs hand their trainer the JAX CLIs' meters, by name:
    train [PSNR, LPIPS, rLPIPS]; ``main_nerf --test`` + SSIM; ``main_palette --test`` +
    SSIM, TV, Sparsity."""
    monkeypatch.chdir(tmp_path)
    scene = make_sphere_dataset(str(tmp_path / "scene"), n_train=2, n_val=1, n_test=1, H=8, W=8)
    import palettenerf_tpu.utils.jax_setup as jax_setup

    monkeypatch.setattr(jax_setup, "setup_jax", lambda *a, **k: None)  # no process-wide cache
    got, want = [], []
    _capture(monkeypatch, jtrainer, "Trainer", want)
    _capture(monkeypatch, jpt, "PaletteTrainer", want)
    _capture(monkeypatch, ttrainer, "Trainer", got)
    _capture(monkeypatch, tpt, "PaletteTrainer", got)
    jnerf_cli, jpal_cli = _jax_cli("main_nerf"), _jax_cli("main_palette")
    common = ["--bound", "1", "--scale", "0.5"]
    for extra in ([], ["--test"]):
        for run in (lambda a: jnerf_cli.main(a), lambda a: tmain_nerf.main(a, device="cpu")):
            with pytest.raises(_Captured):
                run([scene] + common + extra)
        for run in (lambda a: jpal_cli.main(a), lambda a: tmain_palette.main(a, device="cpu")):
            with pytest.raises(_Captured):
                run([scene, "results/workspace"] + common + extra)
    assert got == want == [
        ["PSNR", "LPIPS (alex)", "rLPIPS"], ["PSNR", "LPIPS (alex)", "rLPIPS"],
        ["PSNR", "SSIM", "LPIPS (alex)", "rLPIPS"],
        ["PSNR", "SSIM", "LPIPS (alex)", "rLPIPS", "TV", "Sparsity"]]
