"""The forward-facing LLFF recipe (``scripts/run_llff.sh`` with ``configs_llff/fern.sh``)
against the JAX package, on the committed fixture ``data_proc/proc_toys_ff`` (written by
``scripts/make_ff_fixture.py``: 20 JPEG views at 504x378, ``llff2nerf.py --datatype llff``).

- The providers: for the train, val, test and video splits, the port's ``NeRFDataset`` and
  ``PaletteDataset`` equal JAX's with fern's flags (``--scale 0.25 --offset 0 0 1.5 --bound 2
  --min_near 0.02``) and with ``--offset 0 0 0`` (the recipe's extract block passes no
  offset): images bit for bit, poses and intrinsics exactly, every frame's rays and near/far
  within 1e-6.
- The first step of each stage at small width, both packages on the CPU, held as
  ``tests/test_torch_real_scene.py`` holds the mip360 recipe's: stage 1's ``-O`` step with
  fern's flags (the mark of untrained cells, the full refresh, the march, the step) and the
  palette stage's ``-O`` step with ``--datatype llff --random_size 0
  --use_initialization_from_rgbxy`` (the colours unfrozen, the smooth loss on). Each: the
  loss to rtol 1e-5, the per-ray losses to 1e-6, and every gradient through the parameters
  and EMA after Adam's first step, which moves each entry by about +-lr in the direction of
  its gradient: within 1e-6 but one entry in 20 of a tensor, none past 2 lr (an entry whose
  gradient is near zero takes its sign from the gradient's last bits).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.config import Config as JConfig
from palettenerf_tpu.data.palette_provider import PaletteDataset as JPaletteDataset
from palettenerf_tpu.data.provider import NeRFDataset as JDataset
from palettenerf_tpu.data.rays import gen_rays as jgen_rays
from palettenerf_tpu.models import nerf as jnerf
from palettenerf_tpu.models import palette as jpal
from palettenerf_tpu.ops import rays as jrays
from palettenerf_tpu.train.palette_trainer import PaletteTrainer as JPaletteTrainer
from palettenerf_tpu.train.trainer import Trainer as JTrainer
from palettenerf_torch.config import Config as TConfig
from palettenerf_torch.data.palette_provider import PaletteDataset as TPaletteDataset
from palettenerf_torch.data.provider import NeRFDataset as TDataset
from palettenerf_torch.data.rays import gen_rays
from palettenerf_torch.models import mlp as tmlp
from palettenerf_torch.models import nerf as tnerf
from palettenerf_torch.models import palette as tpal
from palettenerf_torch.ops.occupancy import mark_untrained_grid, update_density_grid
from palettenerf_torch.ops.rays import near_far_from_aabb
from palettenerf_torch.render.nerf_renderer import _aabb, _march
from palettenerf_torch.train import checkpoint as tckpt
from palettenerf_torch.train.palette_trainer import PaletteTrainer as TPaletteTrainer
from palettenerf_torch.train.trainer import Trainer as TTrainer
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "data_proc", "proc_toys_ff")
# configs_llff/fern.sh with run_llff.sh's nerf flags (-O, --no_bg)
RECIPE = dict(bound=2.0, scale=0.25, offset=(0.0, 0.0, 1.5), bg_radius=0.0, density_thresh=10.0,
              lambda_sparse=0.05, min_near=0.02, no_bg=True)
OFFSETS = {"offset": (0.0, 0.0, 1.5), "no_offset": (0.0, 0.0, 0.0)}
RAY_ATOL = 1e-6


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("offset", list(OFFSETS))
@pytest.mark.parametrize("split", ["train", "val", "test", "video"])
@pytest.mark.parametrize("kind", ["nerf", "palette"])
def test_provider_matches_jax_on_ff_fixture(kind, split, offset):
    """JPEG decode at 504x378 (no resize) and ``llff2nerf``'s forward-facing poses through
    ``nerf_matrix_to_ngp`` with fern's scale and offset (or none): the port's provider
    equals the JAX package's, and so do the rays of every frame and their near/far in the
    ``--bound 2`` box at ``--min_near 0.02``."""
    kw = dict(RECIPE, path=FIXTURE, num_rays=64, offset=OFFSETS[offset])
    jcls, tcls = (JDataset, TDataset) if kind == "nerf" else (JPaletteDataset, TPaletteDataset)
    j, t = jcls(JConfig(**kw), type=split), tcls(TConfig(**kw), type=split)
    assert (t.H, t.W) == (j.H, j.W) == (378, 504)
    n_views = {"train": 17, "val": 1, "test": 3, "video": 120}[split]
    assert t.poses.shape == j.poses.shape == (n_views, 4, 4)
    np.testing.assert_array_equal(t.poses, j.poses)
    np.testing.assert_array_equal(t.intrinsics, j.intrinsics)
    if split == "video":
        assert t.images is None and j.images is None
    else:
        assert t.images.shape == j.images.shape == (n_views, 378, 504, 3)
        np.testing.assert_array_equal(t.images, j.images)
    # every camera inside the box with the offset (make_ff_fixture.py's placement)
    if offset == "offset" and split != "video":
        assert np.abs(t.poses[:, :3, 3]).max() < RECIPE["bound"]
    rays = {}
    for b in range(0, n_views, max(1, n_views // 6)):  # six video frames suffice
        o, d = rays[b] = gen_rays(t.poses[b], t.intrinsics, t.H, t.W, None)
        jo, jd = jgen_rays(j.poses[b], j.intrinsics, j.H, j.W, None)
        np.testing.assert_allclose(o, jo, rtol=0, atol=RAY_ATOL)
        np.testing.assert_allclose(d, jd, rtol=0, atol=RAY_ATOL)
        aabb = np.array([-2.0] * 3 + [2.0] * 3, np.float32)
        jn, jf = jrays.near_far_from_aabb(jnp.asarray(jo), jnp.asarray(jd), jnp.asarray(aabb),
                                          RECIPE["min_near"])
        tn, tf = near_far_from_aabb(T(o), T(d), T(aabb), RECIPE["min_near"])
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=RAY_ATOL)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=RAY_ATOL)
        if offset == "offset" and split != "video":
            # the cameras sit inside the box: every ray starts at min_near
            np.testing.assert_array_equal(tn.numpy(), np.float32(RECIPE["min_near"]))
    if split in ("val", "test"):
        # the eval collate's rays are these
        data = t.collate(0)
        np.testing.assert_array_equal(data["rays_o"].reshape(-1, 3), rays[0][0])
        np.testing.assert_array_equal(data["rays_d"].reshape(-1, 3), rays[0][1])


SPEC_KW = dict(bound=2.0, log2_hashmap_size=12, grid_levels=4, hidden_dim=16,
               hidden_dim_color=16)
STEP_CFG = dict(O=True, fp16=True, grid_size=16, num_rays=192, max_steps=128,
                train_samples_per_ray=64, infer_samples_per_ray=64, iters=100, seed=0,
                log2_hashmap_size=12, grid_levels=4, path=FIXTURE, **RECIPE)


def _batch(tds, view, n, seed):
    inds = np.random.default_rng(seed).choice(tds.H * tds.W, n, replace=False)
    o, d = gen_rays(tds.poses[view], tds.intrinsics, tds.H, tds.W, inds)
    return o, d, tds.images[view].reshape(-1, 3)[inds]


def _close_after_step(got_list, ref_list, lr, scale):
    """Parameters after Adam's first step, each moved by about +-lr:
    ``test_torch_train.py``'s rule for a step whose bf16 hash gradient has entries near
    zero (at most one entry in 20 of a tensor off by more than 1e-6, none by more than 2 lr;
    such an entry takes its sign from the gradient's last bits)."""
    for got, ref in zip(got_list, ref_list):
        diff = (got.detach() - ref).abs()
        assert int((diff > 1e-6).sum()) <= max(1, got.numel() // 20), float(diff.max())
        assert float(diff.max()) <= 2 * lr * scale + 1e-6


def test_llff_recipe_first_step_matches_jax(tmp_path):
    """Stage 1 of fern's recipe at small width: the mark of the cells no training camera
    sees, the full refresh, the march of 192 pixels of view 0 from min_near 0.02 with JAX's
    jitter, and the ``-O`` step with ``--lambda_sparse 0.05``."""
    jspec, tspec = (m.NeRFSpec.build(fp16=True, **SPEC_KW) for m in (jnerf, tnerf))
    jparams = jnerf.init_nerf(jax.random.PRNGKey(2), jspec)
    jparams["encoder"] = jnp.asarray(np.random.default_rng(2).uniform(
        -0.5, 0.5, jparams["encoder"].shape).astype(np.float32))
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = STEP_CFG
    jds, tds = JDataset(JConfig(**cfg), type="train"), TDataset(TConfig(**cfg), type="train")
    jtr = JTrainer("ngp", JConfig(**cfg), jspec, params=jparams,
                   workspace=str(tmp_path / "jax"), use_checkpoint="scratch", mute=True)
    ttr = TTrainer("ngp", TConfig(**cfg), tspec, params=tckpt.params_from_jax(np_tree),
                   workspace=str(tmp_path / "torch"), use_checkpoint="scratch", mute=True,
                   device="cpu")
    cascade, G = 2, cfg["grid_size"]
    assert tuple(ttr.grid_state.density_grid.shape) == (cascade, G ** 3)

    jstate = jtr._mark_untrained(jtr.grid_state, jnp.asarray(jds.poses),
                                 tuple(float(v) for v in jds.intrinsics))
    ttr.grid_state = mark_untrained_grid(ttr.grid_state, T(tds.poses), tds.intrinsics, 2.0,
                                         0.02, False, G)
    marked = ttr.grid_state.density_grid.numpy()
    np.testing.assert_array_equal(marked, np.asarray(jstate.density_grid))
    # forward-facing: most of the box is behind or beside the cameras
    assert (marked == -1).any() and (marked >= 0).any()

    key = jax.random.PRNGKey(7)
    jstate = jtr._update_grid(jtr.params, jstate, key)
    noise = np.asarray(jax.random.uniform(key, (cascade, G ** 3, 3), minval=-1.0, maxval=1.0))
    ttr.grid_state = update_density_grid(
        ttr.grid_state, lambda p: ttr._density(ttr.params, p), bound=2.0, density_thresh=10.0,
        grid_size=G, noise=T(noise))
    np.testing.assert_allclose(ttr.grid_state.density_grid.numpy(),
                               np.asarray(jstate.density_grid), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ttr.grid_state.bitfield.numpy(), np.asarray(jstate.bitfield))

    n = cfg["num_rays"]
    o, d, img = _batch(tds, 0, n, 3)
    k_pt = jax.random.split(jax.random.PRNGKey(11))[1]
    jitter = np.asarray(jax.random.uniform(jax.random.split(k_pt)[0], (n,)))
    st = ttr.train_settings
    nears, fars = near_far_from_aabb(T(o), T(d), _aabb(st, "cpu"), st.min_near)
    assert float(nears.max()) == pytest.approx(0.02)  # the cameras are inside the box
    m = _march(T(o), T(d), nears, fars, ttr.grid_state.bitfield, st, st.num_samples, T(jitter))
    assert bool(m.mask.any())
    new_j, _, ema_j, loss_j, per_ray_j = jtr._train_step(
        jtr.params, jtr.opt_state, jtr.ema_params, jstate.bitfield, jax.random.PRNGKey(11),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(img))
    loss_t, per_ray_t = ttr.train_step(T(o), T(d), T(img), noise=T(jitter))
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    np.testing.assert_allclose(per_ray_t.numpy(), np.asarray(per_ray_j), rtol=0, atol=1e-6)
    lr = cfg.get("lr", 1e-2)
    for got, ref, scale in (
            (ttr.params, new_j, 1.0), (ttr.ema_params, ema_j, 1.0 - 0.95)):
        ref = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, ref))
        _close_after_step(tnerf.param_list(got), tnerf.param_list(ref), lr, scale)


PALETTE_BC = np.array([[0.85, 0.15, 0.12], [0.12, 0.35, 0.85], [0.9, 0.8, 0.15],
                       [0.2, 0.55, 0.55]], np.float32)


def _toy_bitfield(G):
    """Both cascades' bitfield [2 * G^3 / 8]: the cells within 0.6 of the fixture's target,
    (0, 0, 1.5) in the provider's frame with fern's offset."""
    c = (np.arange(G) + 0.5) / G * 2 - 1
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    occ = [(s * gx) ** 2 + (s * gy) ** 2 + (s * gz - 1.5) ** 2 < 0.6 ** 2 for s in (1.0, 2.0)]
    return np.packbits(np.concatenate([o.reshape(-1) for o in occ]), bitorder="little")


def test_llff_palette_first_step_matches_jax(tmp_path):
    """The palette stage of fern's recipe (``--datatype llff --random_size 0
    --use_initialization_from_rgbxy``) at small width on view 0 of the fixture: one ``-O``
    step with the colours unfrozen and the smooth loss on (JAX's draws): the loss, the
    per-ray losses, the parameters and EMA after the step; the density half and the frozen
    leaves stay as they were, every palette tensor moves."""
    cfg = dict(STEP_CFG, datatype="llff", random_size=0, use_initialization_from_rgbxy=True,
               use_normalized_palette=True, train_samples_per_ray=32)
    kw = dict(SPEC_KW, num_basis=len(PALETTE_BC), fp16=True)
    jspec, tspec = jpal.PaletteSpec.build(**kw), tpal.PaletteSpec.build(**kw)
    rng = np.random.default_rng(5)
    hist = rng.uniform(size=(32, 32, 32, len(PALETTE_BC))).astype(np.float32)
    jparams = jpal.initialize_palette(jpal.init_palette(jax.random.PRNGKey(4), jspec), jspec,
                                      PALETTE_BC, hist / hist.sum(-1, keepdims=True))
    jparams["basis_color_origin"] = jparams["basis_color"] - 0.02
    for name in ("encoder", "encoder_palette"):
        jparams[name] = jnp.asarray(rng.uniform(-1, 1, jparams[name].shape).astype(np.float32))
    tparams = tckpt.palette_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    jds = JPaletteDataset(JConfig(**cfg), type="train")
    tds = TPaletteDataset(TConfig(**cfg), type="train")
    np.testing.assert_array_equal(tds.images, jds.images)
    jtr = JPaletteTrainer("palette", JConfig(**cfg), jspec, params=jparams,
                          workspace=str(tmp_path / "jax"), use_checkpoint="scratch", mute=True)
    ttr = TPaletteTrainer("palette", TConfig(**cfg), tspec, params=tparams,
                          workspace=str(tmp_path / "torch"), use_checkpoint="scratch",
                          mute=True, device="cpu")
    assert jtr.supports_fast_path(jds) and not ttr.host_sampled()
    bits = _toy_bitfield(cfg["grid_size"])
    ttr.grid_state = ttr.grid_state._replace(bitfield=T(bits))

    n, S = cfg["num_rays"], cfg["train_samples_per_ray"]
    o, d, img = _batch(tds, 0, n, 6)
    key = jax.random.PRNGKey(5)
    k_render = jax.random.split(key)[1]
    k_noise, k_smooth, _ = jax.random.split(k_render, 3)
    noise = np.asarray(jax.random.uniform(k_noise, (n,)))
    jit_u = np.asarray(jax.random.uniform(k_smooth, (n * S, 3)))
    lam_w, lam_p = 0.04, 1e-3
    new_j, _, ema_j, loss_j, per_ray_j = jtr._train_step(
        jtr.params, jtr.opt_state, jtr.ema_params, jnp.asarray(bits), key, jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(img), jnp.zeros((n, 16)), jnp.zeros((n,), jnp.int32),
        jnp.float32(lam_w), jnp.float32(lam_p), jnp.int32(tds.W), False, True)

    ttr.freeze_basis_color, ttr.require_smooth_loss = False, True
    ttr.lambda_weight, ttr.lambda_palette = lam_w, lam_p
    loss_t, per_ray_t = ttr.train_step(T(o), T(d), T(img), noise=T(noise), jit_u=T(jit_u))
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    np.testing.assert_allclose(per_ray_t.detach().numpy(), np.asarray(per_ray_j), rtol=0,
                               atol=1e-6)
    for got, jref, scale in ((ttr.params, new_j, 1.0), (ttr.ema_params, ema_j, 0.05)):
        ref = tckpt.palette_params_from_jax(jax.tree_util.tree_map(np.asarray, jref))
        for k in got:
            _close_after_step(tmlp.param_leaves({k: got[k]}), tmlp.param_leaves({k: ref[k]}),
                              1e-2, scale)
    for k, v in ttr.params.items():
        moved = max(float((a.detach() - b).abs().max()) for a, b in zip(
            tmlp.param_leaves({k: v}), tmlp.param_leaves({k: tparams[k]})))
        if k in tpal.FROZEN or k in ("encoder", "sigma_net", "encoder_clip"):
            assert moved == 0.0, k  # frozen, or no gradient reaches it
        else:
            assert moved == pytest.approx(1e-2, rel=1e-3), k  # Adam's first step: lr
