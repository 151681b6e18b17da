"""Port parity of the stage-1 model and renderers: palettenerf_torch against
palettenerf_tpu on weights carried across with ``params_from_jax``, the same rays,
bitfield, march jitter and background. atol 1e-5 on renders (f32 sums over up to
a few hundred samples in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.models import nerf as jnerf
from palettenerf_tpu.ops import occupancy as jocc
from palettenerf_tpu.render import nerf_renderer as jrender
from palettenerf_torch.models import nerf as tnerf
from palettenerf_torch.render import nerf_renderer as trender
from palettenerf_torch.train.checkpoint import params_from_jax
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
ATOL = 1e-5
SPEC_KW = dict(bound=1.0, log2_hashmap_size=12, grid_levels=4, hidden_dim=16,
               hidden_dim_color=16)
H = 16


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model():
    jspec = jnerf.NeRFSpec.build(**SPEC_KW)
    tspec = tnerf.NeRFSpec.build(**SPEC_KW)
    jparams = jnerf.init_nerf(jax.random.PRNGKey(0), jspec)
    # a livelier table than the 1e-4 init, so densities span a wide range
    jparams["encoder"] = jnp.asarray(np.random.default_rng(0).uniform(
        -2, 2, jparams["encoder"].shape).astype(np.float32))
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jspec, tspec, jparams, params_from_jax(np_tree)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(1)
    n = 256
    o = rng.normal(size=(n, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.2).astype(np.float32)
    d = -o + rng.normal(scale=0.5, size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    c = (np.arange(H) + 0.5) / H * 2 - 1
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    occ = (gx ** 2 + gy ** 2 + gz ** 2 < 0.6) & (rng.uniform(size=gx.shape) < 0.9)
    bits = np.asarray(jocc.packbits(jnp.asarray(occ.reshape(-1))))
    return o, d, bits


def _settings(mod, **kw):
    base = dict(bound=1.0, cascade=1, grid_size=H, dt_gamma=0.0, max_steps=128,
                num_samples=32, t_thresh=1e-4, min_near=0.05)
    base.update(kw)
    return mod.RenderSettings(**base)


def test_nerf_forward_matches(model):
    jspec, tspec, jparams, tparams = model
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    d = rng.normal(size=(400, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    js, jc = jnerf.nerf_forward(jparams, jspec, jnp.asarray(x), jnp.asarray(d))
    ts, tc = tnerf.nerf_forward(tparams, tspec, T(x), T(d))
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), rtol=0, atol=ATOL)


def test_render_train_matches(model, scene):
    jspec, tspec, jparams, tparams = model
    o, d, bits = scene
    n = o.shape[0]
    key = jax.random.PRNGKey(7)
    k_noise, _ = jax.random.split(key)   # render_nerf_train's own split of its key
    noise = np.asarray(jax.random.uniform(k_noise, (n,)))
    rng = np.random.default_rng(3)
    bg = rng.uniform(size=(n, 3)).astype(np.float32)
    gt = rng.uniform(size=(n, 3)).astype(np.float32)
    render = jax.jit(jrender.render_nerf_train, static_argnums=(1, 6))
    ref = render(jparams, jspec, jnp.asarray(bits), jnp.asarray(o), jnp.asarray(d), key,
                 _settings(jrender), bg_color=jnp.asarray(bg), rays_gt=jnp.asarray(gt))
    got = trender.render_nerf_train(tparams, tspec, T(bits), T(o), T(d), _settings(trender),
                                    bg_color=T(bg), rays_gt=T(gt), noise=T(noise))
    assert float(got["weights_sum"].max()) > 0.5  # rays really hit density
    for k in ("image", "depth", "weights_sum", "rgb_norm"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("samples,rounds", [
    (32, ()),
    (32, ((1, 8), (4, 8), (16, 16))),
    (64, ((1, 16), (4, 16), (16, 32))),
], ids=["plain", "compact32", "compact64"])
def test_render_eval_matches(model, scene, samples, rounds):
    """render_nerf_eval, which dispatches to render_nerf_eval_compact when the
    settings carry compaction rounds."""
    jspec, tspec, jparams, tparams = model
    o, d, bits = scene
    kw = dict(num_samples=samples, t_thresh=1e-2, compaction_rounds=rounds)
    render = jax.jit(jrender.render_nerf_eval, static_argnums=(1, 5))
    ref = render(jparams, jspec, jnp.asarray(bits), jnp.asarray(o), jnp.asarray(d),
                 _settings(jrender, **kw))
    got = trender.render_nerf_eval(tparams, tspec, T(bits), T(o), T(d),
                                   _settings(trender, **kw))
    assert float(got["weights_sum"].max()) > 0.3
    for k in ("image", "depth", "depth_origin", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=ATOL,
                                   err_msg=k)
