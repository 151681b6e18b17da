"""Port parity of the leaf ops no product path calls: ``freq_encode``, ``get_encoder``
(all five names), the MAPE / Huber / distortion losses with their gradients, the Morton
code, ``sample_pdf`` and the grid-free ``render_nerf_uniform``.

Tolerances: encodings and losses atol 1e-6 (values of order 1; f32); loss gradients 1e-6
of the gradient's largest entry; Morton codes exact over samples of [0, 1024)^3;
``sample_pdf`` ``ATOL = 2e-5`` on z values of order 1-5: XLA's cumsum adds in another
order (the cdfs differ by up to 2.4e-7), and the inverse transform divides that by the
cdf step of the bin; ``render_nerf_uniform`` ``ATOL`` without upsampling and 1e-4 with
it, where those z differences move samples through a field that varies fast. The
stochastic paths take the JAX draws as arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.models import nerf as jnerf
from palettenerf_tpu.ops import encoding as jenc
from palettenerf_tpu.ops import freq as jfreq
from palettenerf_tpu.ops import losses as jloss
from palettenerf_tpu.ops import morton as jmorton
from palettenerf_tpu.ops import sampling as jsampling
from palettenerf_tpu.render import nerf_renderer as jrender
from palettenerf_torch.models import nerf as tnerf
from palettenerf_torch.ops import encoding as tenc
from palettenerf_torch.ops import freq as tfreq
from palettenerf_torch.ops import losses as tloss
from palettenerf_torch.ops import morton as tmorton
from palettenerf_torch.ops import sampling as tsampling
from palettenerf_torch.render import nerf_renderer as trender
from palettenerf_torch.train.checkpoint import params_from_jax
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
ATOL = 2e-5


def T(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, atol=1e-6, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol, err_msg=msg)


@pytest.mark.parametrize("degree", [1, 4, 6])
def test_freq_encode_matches(degree):
    x = np.random.default_rng(degree).uniform(-1, 1, (50, 3)).astype(np.float32)
    got = tfreq.freq_encode(T(x), degree)
    assert got.shape == (50, tfreq.freq_output_dim(3, degree))
    assert tfreq.freq_output_dim(3, degree) == jfreq.freq_output_dim(3, degree)
    _close(got, jfreq.freq_encode(jnp.asarray(x), degree))


@pytest.mark.parametrize("name", [None, "frequency", "sphere_harmonics", "hashgrid",
                                  "tiledgrid"])
def test_get_encoder_matches(name):
    """Every name: the output size, the init's shape, and the encoding of the same
    parameters (the JAX init's, for the grids)."""
    kw = dict(input_dim=3, multires=4, degree=3, num_levels=4, log2_hashmap_size=10,
              desired_resolution=256)
    t_fn, t_dim, t_init = tenc.get_encoder(name, **kw)
    j_fn, j_dim, j_init = jenc.get_encoder(name, **kw)
    assert t_dim == j_dim
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    if name == "sphere_harmonics":
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    jparams = j_init(jax.random.PRNGKey(0))
    tparams = t_init(torch.Generator().manual_seed(0))
    if name in ("hashgrid", "tiledgrid"):
        assert tuple(tparams.shape) == tuple(jparams.shape)
        assert t_fn.spec.gridtype == j_fn.spec.gridtype and t_fn.spec.offsets == tuple(
            j_fn.spec.offsets)
        assert float(tparams.abs().max()) <= 1e-4
        jparams = jnp.asarray(rng.uniform(-1, 1, jparams.shape).astype(np.float32))
        tparams = T(jparams)
    else:
        assert tparams is None and jparams is None
    got = t_fn(tparams, T(x))
    assert got.shape == (64, t_dim)
    _close(got, j_fn(jparams, jnp.asarray(x)))
    with pytest.raises(NotImplementedError):
        tenc.get_encoder("ash")


def _loss_pair(fn_t, fn_j, args, **kw):
    """Value and gradient in the first argument of a loss, in both packages."""
    ts = [T(a).requires_grad_(i == 0) for i, a in enumerate(args)]
    got = fn_t(*ts, **kw)
    ref = fn_j(*[jnp.asarray(a) for a in args], **kw)
    jgrad = jax.grad(lambda a, *r: fn_j(a, *r, **kw).sum())(*[jnp.asarray(a) for a in args])
    got.sum().backward()
    return got, ref, ts[0].grad, jgrad


def test_losses_match():
    rng = np.random.default_rng(1)
    pred = rng.normal(size=(40, 3)).astype(np.float32)
    target = rng.normal(size=(40, 3)).astype(np.float32)
    target[0, 0] = 0.0
    pred[1] = target[1] + 0.05  # below Huber's delta
    cases = [(tloss.mape_loss, jloss.mape_loss, (pred, target), {}),
             (tloss.mape_loss, jloss.mape_loss, (pred, target), dict(reduction="none")),
             (tloss.huber_loss, jloss.huber_loss, (pred, target), {}),
             (tloss.huber_loss, jloss.huber_loss, (pred, target),
              dict(delta=0.5, reduction="none"))]
    w = rng.uniform(size=(30, 24)).astype(np.float32)
    m = np.sort(rng.uniform(size=(30, 24)), -1).astype(np.float32)
    interval = rng.uniform(0.01, 0.05, (30, 24)).astype(np.float32)
    cases += [(tloss.eff_dist_loss, jloss.eff_dist_loss, (w, m, np.float32(0.03)), {}),
              (tloss.eff_dist_loss, jloss.eff_dist_loss, (w, m, interval), {}),
              (tloss.eff_dist_loss, jloss.eff_dist_loss, (w[0], m[0], np.float32(0.03)), {})]
    for i, (ft, fj, args, kw) in enumerate(cases):
        got, ref, g, jg = _loss_pair(ft, fj, args, **kw)
        assert tuple(got.shape) == tuple(np.shape(ref)), i
        _close(got, ref, atol=1e-6 * max(1.0, float(np.abs(ref).max())), msg=str(i))
        _close(g, jg, atol=1e-6 * float(jnp.abs(jg).max()), msg=str(i))


def test_morton_codes_are_bit_exact():
    rng = np.random.default_rng(2)
    coords = rng.integers(0, 1024, (200_000, 3)).astype(np.int32)
    coords[:8] = [[0, 0, 0], [1023, 1023, 1023], [1023, 0, 0], [0, 1023, 0], [0, 0, 1023],
                  [1, 2, 4], [512, 511, 256], [1000, 3, 777]]
    got = tmorton.morton3d(T(coords))
    ref = np.asarray(jmorton.morton3d(jnp.asarray(coords)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    assert int(got.max()) == 2 ** 30 - 1 and int(got.min()) == 0
    back = tmorton.morton3d_invert(got)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), coords)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jmorton.morton3d_invert(jnp.asarray(ref))))
    # every code of a full 16^3 block, and uint32 inputs above 2^31
    full = np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"), -1).reshape(-1, 3)
    codes = tmorton.morton3d(T(full)).numpy()
    assert sorted(codes.tolist()) == list(range(16 ** 3))
    high = np.array([0xFFFFFFFF, 0x80000001, 0xC0000000], np.uint32)
    np.testing.assert_array_equal(
        tmorton.morton3d_invert(T(high.astype(np.int64))).numpy(),
        np.asarray(jmorton.morton3d_invert(jnp.asarray(high))))


@pytest.mark.parametrize("det", [True, False], ids=["det", "given_u"])
def test_sample_pdf_matches(det):
    rng = np.random.default_rng(3)
    bins = np.sort(rng.uniform(1, 5, (50, 33)), -1).astype(np.float32)
    weights = rng.uniform(size=(50, 32)).astype(np.float32)
    weights[:5, 10:] = 0.0  # mass on a few bins; flat cdf stretches
    weights[5] = 0.0
    key = jax.random.PRNGKey(4)
    ref = jsampling.sample_pdf(key, jnp.asarray(bins), jnp.asarray(weights), 24, det=det)
    u = None if det else T(jax.random.uniform(key, (50, 24)))
    got = tsampling.sample_pdf(T(bins), T(weights), 24, u=u, det=det)
    assert got.shape == (50, 24)
    _close(got, ref, atol=ATOL)
    assert bool(((got >= T(bins[:, :1])) & (got <= T(bins[:, -1:]))).all())
    with pytest.raises(ValueError):
        tsampling.sample_pdf(T(bins), T(weights), 24)


@pytest.fixture(scope="module")
def model():
    kw = dict(bound=1.0, log2_hashmap_size=12, grid_levels=4, hidden_dim=16,
              hidden_dim_color=16)
    jspec, tspec = jnerf.NeRFSpec.build(**kw), tnerf.NeRFSpec.build(**kw)
    jparams = jnerf.init_nerf(jax.random.PRNGKey(0), jspec)
    jparams["encoder"] = jnp.asarray(np.random.default_rng(0).uniform(
        -2, 2, jparams["encoder"].shape).astype(np.float32))
    return jspec, tspec, jparams, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


@pytest.mark.parametrize("up,perturb", [(0, False), (16, False), (16, True)],
                         ids=["uniform", "upsampled", "perturbed"])
def test_render_nerf_uniform_matches(model, up, perturb):
    """Uniform samples, then ``sample_pdf`` upsampling; perturbed: the stratified jitter
    and the upsampler's uniforms are the JAX function's draws from its key."""
    jspec, tspec, jparams, tparams = model
    rng = np.random.default_rng(5)
    n, steps = 96, 24
    o = rng.normal(size=(n, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.2).astype(np.float32)
    d = -o + rng.normal(scale=0.4, size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    st = dict(bound=1.0, min_near=0.05)
    key = jax.random.PRNGKey(6)
    render = jax.jit(jrender.render_nerf_uniform, static_argnums=(1, 5, 6, 7, 9))
    ref = render(jparams, jspec, jnp.asarray(o), jnp.asarray(d), key,
                 jrender.RenderSettings(**st), steps, up, None, perturb)
    draws = {}
    if perturb:
        k1, rest = jax.random.split(key)
        k2, _ = jax.random.split(rest)
        draws = dict(jitter=T(jax.random.uniform(k1, (n, steps))),
                     pdf_u=T(jax.random.uniform(k2, (n, up))))
    got = trender.render_nerf_uniform(tparams, tspec, T(o), T(d), trender.RenderSettings(**st),
                                      steps, up, **draws)
    atol = 1e-4 if up else ATOL
    assert float(got["weights_sum"].max()) > 0.5
    for k in ("image", "depth", "weights_sum"):
        _close(got[k], ref[k], atol=atol, msg=k)
