"""The real-scene input path against the JAX package: the providers on the committed
LLFF-layout JPEG fixture (``data_proc/proc_toys_llff``, written by
``scripts/make_llff_fixture.py``) and on ``--extract_downscale 3`` of proc_toys, and the
first train step of the Mip-NeRF 360 recipe (``scripts/run_mip360.sh``: ``--bound 2``, two
occupancy cascades, ``--no_bg``, ``--filter_close_point``) at small width on views of the
fixture: the mark of untrained cells, the grid refresh, the march and the step."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.config import Config as JConfig
from palettenerf_tpu.data.palette_provider import PaletteDataset as JPaletteDataset
from palettenerf_tpu.data.provider import NeRFDataset as JDataset
from palettenerf_tpu.models import nerf as jnerf
from palettenerf_tpu.train.trainer import Trainer as JTrainer
from palettenerf_torch.config import Config as TConfig
from palettenerf_torch.data.palette_provider import PaletteDataset as TPaletteDataset
from palettenerf_torch.data.provider import NeRFDataset as TDataset
from palettenerf_torch.data.rays import gen_rays
from palettenerf_torch.models import nerf as tnerf
from palettenerf_torch.ops.occupancy import mark_untrained_grid, update_density_grid
from palettenerf_torch.render.nerf_renderer import _aabb, _march
from palettenerf_torch.ops.rays import near_far_from_aabb
from palettenerf_torch.train.checkpoint import params_from_jax
from palettenerf_torch.train.trainer import Trainer as TTrainer
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "data_proc", "proc_toys_llff")
PROC_TOYS = os.path.join(REPO, "data_proc", "proc_toys")
# configs_mip360/bonsai.sh with run_mip360.sh's nerf flags
RECIPE = dict(bound=2.0, scale=0.16, offset=(0.0, 0.0, 0.0), bg_radius=0.0, density_thresh=10.0,
              lambda_sparse=0.0, min_near=0.2, no_bg=True, filter_close_point=True)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_provider_matches_jax_on_llff_fixture(split):
    """JPEG decode + INTER_AREA 1000x750 -> 333x250 + llff2nerf poses: the port's
    provider equals the JAX package's (images bit for bit after / 255)."""
    kw = dict(path=FIXTURE, num_rays=64, **RECIPE)
    j = JDataset(JConfig(**kw), type=split)
    t = TDataset(TConfig(**kw), type=split)
    assert (t.H, t.W) == (j.H, j.W) == (250, 333)
    assert t.images.shape == j.images.shape and t.images.shape[-1] == 3
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.poses, j.poses)
    np.testing.assert_array_equal(t.intrinsics, j.intrinsics)


def test_extract_downscale_3_matches_jax():
    """``main_palette --extract_downscale 3`` on proc_toys: the traintest split at
    800 -> 266 (a fractional factor), RGBA, equal to the JAX provider's."""
    kw = dict(path=PROC_TOYS, bound=1.0, scale=0.8, num_rays=64)
    j = JPaletteDataset(JConfig(**kw), type="traintest", downscale=3)
    t = TPaletteDataset(TConfig(**kw), type="traintest", downscale=3)
    assert (t.H, t.W) == (j.H, j.W) == (266, 266)
    assert t.images.shape == j.images.shape == (100, 266, 266, 4)
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.poses, j.poses)
    np.testing.assert_allclose(t.intrinsics, j.intrinsics, rtol=0, atol=0)


SPEC_KW = dict(bound=2.0, log2_hashmap_size=12, grid_levels=4, hidden_dim=16,
               hidden_dim_color=16)
# 64 sample slots per ray, the CLI's default: enough for the march to pass |x| = 1
STEP_CFG = dict(O=True, fp16=True, grid_size=16, num_rays=192, max_steps=128,
                train_samples_per_ray=64, infer_samples_per_ray=64, iters=100, seed=0,
                log2_hashmap_size=12, grid_levels=4, **RECIPE)


@pytest.fixture(scope="module")
def fixture_views(tmp_path_factory):
    """Three training views of the fixture (frames 0, 9 and 18 of its train split)."""
    root = tmp_path_factory.mktemp("llff_views")
    with open(os.path.join(FIXTURE, "transforms_train.json")) as f:
        meta = json.load(f)
    meta["frames"] = [dict(fr, file_path=os.path.join(FIXTURE, fr["file_path"]))
                      for fr in meta["frames"][::9][:3]]
    for split in ("train", "val", "test"):
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump(meta, f)
    return str(root)


def test_mip360_recipe_first_step_matches_jax(fixture_views, tmp_path):
    jspec, tspec = jnerf.NeRFSpec.build(fp16=True, **SPEC_KW), tnerf.NeRFSpec.build(
        fp16=True, **SPEC_KW)
    jparams = jnerf.init_nerf(jax.random.PRNGKey(2), jspec)
    jparams["encoder"] = jnp.asarray(np.random.default_rng(2).uniform(
        -0.5, 0.5, jparams["encoder"].shape).astype(np.float32))
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = dict(STEP_CFG, path=fixture_views)
    jds = JDataset(JConfig(**cfg), type="train")
    tds = TDataset(TConfig(**cfg), type="train")
    np.testing.assert_array_equal(tds.images, jds.images)
    jtr = JTrainer("ngp", JConfig(**cfg), jspec, params=jparams,
                   workspace=str(tmp_path / "jax"), use_checkpoint="scratch", mute=True)
    ttr = TTrainer("ngp", TConfig(**cfg), tspec, params=params_from_jax(np_tree),
                   workspace=str(tmp_path / "torch"), use_checkpoint="scratch", mute=True,
                   device="cpu")
    cascade, G = 2, cfg["grid_size"]
    assert tuple(ttr.grid_state.density_grid.shape) == (cascade, G ** 3)

    # mark: cells no training camera sees, or sees closer than min_near (filter_close_point)
    jstate = jtr._mark_untrained(jtr.grid_state, jnp.asarray(jds.poses),
                                 tuple(float(v) for v in jds.intrinsics))
    ttr.grid_state = mark_untrained_grid(ttr.grid_state, T(tds.poses), tds.intrinsics, 2.0,
                                         0.2, True, G)
    marked = ttr.grid_state.density_grid.numpy()
    np.testing.assert_array_equal(marked, np.asarray(jstate.density_grid))
    assert ((marked == -1).any(1) & (marked >= 0).any(1)).all()  # both cascades partly seen

    # refresh: the JAX trainer's full refresh and the port's with its draws; the network's
    # density within test_torch_checkpoint.py's nerf_density tolerance (f32 sums in
    # another order)
    key = jax.random.PRNGKey(7)
    jstate = jtr._update_grid(jtr.params, jstate, key)
    noise = np.asarray(jax.random.uniform(key, (cascade, G ** 3, 3), minval=-1.0, maxval=1.0))
    ttr.grid_state = update_density_grid(
        ttr.grid_state, lambda p: ttr._density(ttr.params, p), bound=2.0, density_thresh=10.0,
        grid_size=G, noise=T(noise))
    np.testing.assert_allclose(ttr.grid_state.density_grid.numpy(),
                               np.asarray(jstate.density_grid), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ttr.grid_state.bitfield.numpy(), np.asarray(jstate.bitfield))
    occ = np.unpackbits(ttr.grid_state.bitfield.numpy(), bitorder="little").reshape(cascade, -1)
    assert occ.any(1).all() and not occ.all(1).any()

    # the march and the step on 192 pixels of the first view, with JAX's jitter
    n = cfg["num_rays"]
    inds = np.random.default_rng(3).choice(tds.H * tds.W, n, replace=False)
    o, d = gen_rays(tds.poses[0], tds.intrinsics, tds.H, tds.W, inds)
    img = tds.images[0].reshape(-1, 3)[inds]
    k_pt = jax.random.split(jax.random.PRNGKey(11))[1]
    jitter = np.asarray(jax.random.uniform(jax.random.split(k_pt)[0], (n,)))
    st = ttr.train_settings
    nears, fars = near_far_from_aabb(T(o), T(d), _aabb(st, "cpu"), st.min_near)
    m = _march(T(o), T(d), nears, fars, ttr.grid_state.bitfield, st, st.num_samples, T(jitter))
    reach = m.xyzs[m.mask].abs().amax(-1)
    assert bool((reach > 1.0).any()) and bool((reach < 1.0).any())  # samples in both cascades
    new_j, _, ema_j, loss_j, per_ray_j = jtr._train_step(
        jtr.params, jtr.opt_state, jtr.ema_params, jstate.bitfield, jax.random.PRNGKey(11),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(img))
    loss_t, per_ray_t = ttr.train_step(T(o), T(d), T(img), noise=T(jitter))
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    np.testing.assert_allclose(per_ray_t.numpy(), np.asarray(per_ray_j), rtol=0, atol=1e-6)
    new_j = params_from_jax(jax.tree_util.tree_map(np.asarray, new_j))
    ema_j = params_from_jax(jax.tree_util.tree_map(np.asarray, ema_j))
    # the parameters after Adam's first step, each moved by about +-lr: test_torch_train.py's
    # rule for a step whose bf16 hash gradient has entries near zero (at most one entry in
    # 20 of a tensor off by more than 1e-6, none by more than 2 lr; such an entry takes its
    # sign from the gradient's last bits)
    lr = cfg.get("lr", 1e-2)
    for got_list, ref_list, scale in [
            (tnerf.param_list(ttr.params), tnerf.param_list(new_j), 1.0),
            (tnerf.param_list(ttr.ema_params), tnerf.param_list(ema_j), 1.0 - 0.95)]:
        for got, ref in zip(got_list, ref_list):
            diff = (got.detach() - ref).abs()
            assert int((diff > 1e-6).sum()) <= max(1, got.numel() // 20), float(diff.max())
            assert float(diff.max()) <= 2 * lr * scale + 1e-6
