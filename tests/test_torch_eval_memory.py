"""The eval encode's buffers against the JAX encoder's (ROADMAP C17).

On the card a palette eval chunk (16,384 rays x 256 slots, every slot holding a sample on
the early mip360 field) peaked at 19.3 GiB: the port's encoder built every corner's rows,
indices and weights for all 4,194,304 points at once (``ops/hashgrid_fast.py:_encode``,
[M, 16, 8, 2] f32 and [M, 16, 8] twice). The JAX encoder maps over chunks of
``_ENCODE_CHUNK`` points, and its primal (no gradient) keeps no residuals, so the only
encoder buffer that spans all M points is the output [M, L*C]. The port now encodes
without a gradient in passes of ``NO_GRAD_CHUNK`` points and keeps no residuals: these
tests hold that bound, on a render whose M exceeds the chunk on both sides, and the
chunked render to the JAX render (atol 2e-5, the render tolerance of
``tests/test_torch_palette_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from palettenerf_tpu.models import palette as jpal
from palettenerf_tpu.ops import hashgrid_fast as jhf
from palettenerf_tpu.ops import occupancy as jocc
from palettenerf_tpu.render import nerf_renderer as jrender
from palettenerf_tpu.render import palette_renderer as jpr
from palettenerf_torch.models import palette as tpal
from palettenerf_torch.ops import hashgrid_fast as thf
from palettenerf_torch.render import nerf_renderer as trender
from palettenerf_torch.render import palette_renderer as tpr
from palettenerf_torch.train import checkpoint as tckpt
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
CHUNK = 512          # points per pass on both sides (the packages' constants, made small)
G, N, S = 16, 96, 32  # grid, rays, slots: up to 3,072 held samples, 6 passes
ATOL = 2e-5
KW = dict(bound=1.0, num_basis=4, log2_hashmap_size=12, grid_levels=4, hidden_dim=16,
          hidden_dim_color=16)
BC = np.array([[0.9, 0.2, 0.1], [0.1, 0.8, 0.3], [0.2, 0.3, 0.9], [0.8, 0.8, 0.2]],
              np.float32)


class _Sizes(TorchDispatchMode):
    """The shapes of every tensor an op makes while active."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.fixture(scope="module")
def case():
    jspec, tspec = jpal.PaletteSpec.build(**KW), tpal.PaletteSpec.build(**KW)
    rng = np.random.default_rng(0)
    params = jpal.initialize_palette(jpal.init_palette(jax.random.PRNGKey(0), jspec), jspec,
                                     BC)
    for name in ("encoder", "encoder_palette"):
        params[name] = jnp.asarray(rng.uniform(-2, 2, params[name].shape).astype(np.float32))
    tparams = tckpt.palette_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    o = rng.normal(size=(N, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.2).astype(np.float32)
    d = -o + rng.normal(scale=0.3, size=(N, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    bits = np.array(jocc.packbits(jnp.ones((G ** 3,), bool)))  # every cell occupied
    return jspec, tspec, params, tparams, o, d, bits


def _settings(mod):
    return mod.RenderSettings(bound=1.0, cascade=1, grid_size=G, dt_gamma=0.0, max_steps=64,
                              num_samples=S, t_thresh=1e-4, min_near=0.05)


def test_eval_encode_buffers_are_per_pass(case, monkeypatch):
    """Every encode of the eval render runs in passes of at most CHUNK points, and the
    largest buffer of a pass is its gathered corner rows [n, L, K, C]: what spans all M
    points is the output [M, L*C] alone, as in JAX's primal encode."""
    _, tspec, _, tparams, o, d, bits = case
    monkeypatch.setattr(thf, "NO_GRAD_CHUNK", CHUNK)
    calls, encode = [], thf._encode

    def recorded(table, spec, x, u, stochastic):
        with _Sizes() as sizes:
            out = encode(table, spec, x, u, stochastic)
        calls.append((x.shape[0], spec, sizes.shapes))
        return out

    monkeypatch.setattr(thf, "_encode", recorded)
    got = tpr.render_palette_eval(tparams, tspec, torch.from_numpy(bits), torch.from_numpy(o),
                                  torch.from_numpy(d), _settings(trender))
    assert float(got["weights_sum"].mean()) > 0.5
    assert calls and all(n <= CHUNK for n, _, _ in calls)
    M = int(sum(n for n, _, _ in calls)) // 2  # two encoders (density, palette) per sample
    assert M > 4 * CHUNK
    for n, spec, shapes in calls:
        L, K, C = spec.num_levels, 2 ** spec.input_dim, spec.level_dim
        # the largest: the gathered corner rows of the pass, [n, L, K, C]
        assert max(int(np.prod(s)) for s in shapes) == n * L * K * C


def test_chunked_eval_render_matches_jax(case, monkeypatch):
    """The render with both encoders in passes of CHUNK points (the port's NO_GRAD_CHUNK,
    JAX's _ENCODE_CHUNK) agrees with JAX's."""
    jspec, tspec, params, tparams, o, d, bits = case
    monkeypatch.setattr(thf, "NO_GRAD_CHUNK", CHUNK)
    monkeypatch.setattr(jhf, "_ENCODE_CHUNK", CHUNK)
    ref = jpr.render_palette_eval(params, jspec, jnp.asarray(bits), jnp.asarray(o),
                                  jnp.asarray(d), _settings(jrender))
    got = tpr.render_palette_eval(tparams, tspec, torch.from_numpy(bits), torch.from_numpy(o),
                                  torch.from_numpy(d), _settings(trender))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0.0, atol=ATOL,
                                   err_msg=k)


def test_train_encode_keeps_its_residuals():
    """With a gradient to follow the encode is one pass that saves the backward's
    residuals, as before: the table gradient is that of the whole batch."""
    spec = tpal.PaletteSpec.build(**KW).grid
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.total_params, spec.level_dim))
                             .astype(np.float32)).requires_grad_(True)
    x = torch.from_numpy(rng.uniform(0, 1, (3 * CHUNK, 3)).astype(np.float32))
    out = thf.hashgrid_encode_fast(table, x, spec)
    out.sum().backward()
    ref = thf.hashgrid_encode_fast(table.detach(), x, spec)  # no gradient: passes
    assert torch.equal(out.detach(), ref)
    idx, w = thf.corner_indices(spec, x)
    want = torch.zeros_like(table).index_add_(0, idx.reshape(-1).long(),
                                              w.reshape(-1, 1).expand(-1, spec.level_dim))
    torch.testing.assert_close(table.grad, want, rtol=1e-5, atol=1e-5)
