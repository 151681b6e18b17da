"""Port parity of the interactive editing path: ``palettenerf_torch.gui`` (OrbitCamera,
EditingSession, fit_stylizer, the DearPyGui layer), the trainers' GUI hooks (train_gui,
test_gui, set_render_option, save_view, save_mesh) and ``utils/mcubes.py``, against the
JAX package on the same weights, rays and draws.

The palette field is that of ``tests/test_gui_headless.py`` (16x16 sphere scene, 4 levels,
2^13 rows, P = 4, 24x24 frames, density scale 30, every grid cell open), with lively
tables and two palette GUI steps taken in both packages, so that the EMA weights differ
from the raw ones. Tolerances: renders atol 2e-5 and one train step loss rtol 1e-5, as
``tests/test_torch_palette_train.py`` justifies them; two maps of a frame are not bounded
by 1: xyz, the pick buffer, is a depth times a direction (atol 1e-4), and
``unscaled_basis_rgb`` adds the unclamped offsets to the palette (up to 1.4 on these
tables; atol 5e-5, three f32 MLP layers in another order). The parameters after the two palette steps within 1e-4 with
one entry in 20 allowed beyond (that file's ``_close_params``; ``basis_color`` in every
entry), after one stage-1 step atol 1e-6 (``tests/test_torch_train.py``), where an entry
whose gradient sums to about zero (the bf16 table's, or an MLP's on this batch) may step
the other way: 2 lr off, one entry in 20 allowed, as ``_close_params`` allows. The stylizer solve
(20 Adam steps): each leaf within 1e-4 of its largest entry, the loss rtol 1e-4. Camera
poses atol 1e-6. Marching tetrahedra: byte-identical files.
"""

import dataclasses
import importlib
import os
import sys
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.config import Config as JConfig
from palettenerf_tpu.data.palette_provider import PaletteDataset as JPaletteDataset
from palettenerf_tpu.data.provider import NeRFDataset as JNeRFDataset
from palettenerf_tpu.gui import camera as jcamera
from palettenerf_tpu.gui import headless as jheadless
from palettenerf_tpu.models import nerf as jnerf
from palettenerf_tpu.models import palette as jpal
from palettenerf_tpu.ops import composite as jcomp
from palettenerf_tpu.ops.march import march_rays as jmarch_rays
from palettenerf_tpu.ops.rays import near_far_from_aabb as jnear_far
from palettenerf_tpu.render import palette_renderer as jpr
from palettenerf_tpu.train.palette_trainer import PaletteTrainer as JPaletteTrainer
from palettenerf_tpu.train.trainer import Trainer as JTrainer
from palettenerf_tpu.utils import mcubes as jmcubes
from palettenerf_torch import main_nerf as tmain_nerf
from palettenerf_torch import main_palette as tmain_palette
from palettenerf_torch.config import Config as TConfig
from palettenerf_torch.data.palette_provider import PaletteDataset as TPaletteDataset
from palettenerf_torch.data.provider import NeRFDataset as TNeRFDataset
from palettenerf_torch.gui import camera as tcamera
from palettenerf_torch.gui import headless as theadless
from palettenerf_torch.models import nerf as tnerf
from palettenerf_torch.models import palette as tpal
from palettenerf_torch.models.mlp import param_leaves
from palettenerf_torch.render import palette_renderer as tpr
from palettenerf_torch.train import checkpoint as tckpt
from palettenerf_torch.train.palette_trainer import PaletteTrainer as TPaletteTrainer
from palettenerf_torch.train.trainer import Trainer as TTrainer
from palettenerf_torch.utils import mcubes as tmcubes
from palettenerf_torch.utils.mcubes import read_ply
from synthetic import make_sphere_dataset
from tests_stub_support import make_stub_dpg
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
ATOL = 2e-5
FRAME_ATOL = {"xyz": 1e-4, "unscaled_basis_rgb": 5e-5}
CFG_KW = dict(O=True, fp16=True, bound=1.0, scale=0.5, dt_gamma=0.0, min_near=0.05,
              num_rays=64, iters=4, max_steps=32, grid_size=64, train_samples_per_ray=8,
              infer_samples_per_ray=16, num_basis=4, seed=0, update_extra_interval=2,
              grid_levels=4, log2_hashmap_size=13, W=24, H=24, radius=2.2, fovy=50.0)
SPEC_KW = dict(bound=1.0, num_basis=4, grid_levels=4, log2_hashmap_size=13, fp16=True)
BC = np.array([[1.0, 0.2, 0.1], [0.1, 0.8, 0.0], [0.2, 0.3, 0.9], [0.8, 0.8, 0.2]], np.float32)
W = H = 24
RADIUS = 2.2


def T(a):
    return torch.from_numpy(np.array(a))


def _step_draws(key, n, S):
    """What the JAX palette ``_train_step`` draws from its key: the background, the march
    jitter, the smooth-loss jitter."""
    k_bg, k_render = jax.random.split(key)
    k_noise, k_smooth, _ = jax.random.split(k_render, 3)
    return dict(bg=T(jax.random.uniform(k_bg, (n, 3))), noise=T(jax.random.uniform(k_noise, (n,))),
                jit_u=T(jax.random.uniform(k_smooth, (n * S, 3))))


def _assert_palette_params_close(tparams, jtree, atol):
    """Every leaf of the port's dict against the JAX tree; ``basis_color`` in every entry,
    other tensors with one entry in 20 allowed beyond ``atol``
    (``tests/test_torch_palette_train.py:_close_params`` says why)."""
    ref = tckpt.palette_params_from_jax(jax.tree_util.tree_map(np.asarray, jtree))
    for k in tparams:
        for i, (p, r) in enumerate(zip(param_leaves({k: tparams[k]}), param_leaves({k: ref[k]}))):
            diff = (p.detach() - r).abs()
            allowed = 0 if k == "basis_color" else max(1, p.numel() // 20)
            assert int((diff > atol).sum()) <= allowed, (k, i, float(diff.max()))


def _port_tree(tree):
    return tckpt.palette_params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _adopt_jax_state(ttr, jtr):
    """The port takes the JAX trainer's parameters, EMA and Adam state (moments, count)
    as they are, so that its next step starts where the JAX one does."""
    ttr._set_params(_port_tree(jtr.params), _port_tree(jtr.ema_params))
    adam = next(s for s in jtr.opt_state if hasattr(s, "mu"))
    count = int(adam.count)
    for p, m, v in zip(ttr._trainable(ttr.params), ttr._trainable(_port_tree(adam.mu)),
                       ttr._trainable(_port_tree(adam.nu))):
        ttr.optimizer.state[p] = {"step": torch.tensor(float(count)), "exp_avg": m,
                                  "exp_avg_sq": v}
    ttr.opt_step = count


# --------------------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_gui")
    return make_sphere_dataset(str(root / "scene"), n_train=3, n_val=1, n_test=1, H=16, W=16)


@pytest.fixture(scope="module")
def pair(scene, tmp_path_factory):
    """The small palette field in both packages. Two palette GUI steps (smooth loss on,
    colors unfrozen, hist weights present) are taken in both on the same batches and
    draws; their losses are kept for ``test_palette_gui_step_matches``, then the port
    adopts the JAX weights and EMA exactly."""
    tmp = tmp_path_factory.mktemp("torch_gui_ws")
    jcfg, tcfg = JConfig(path=scene, **CFG_KW), TConfig(path=scene, **CFG_KW)
    jspec, tspec = jpal.PaletteSpec.build(**SPEC_KW), tpal.PaletteSpec.build(**SPEC_KW)
    rng = np.random.default_rng(0)
    params = jpal.init_palette(jax.random.PRNGKey(0), jspec)
    for name in ("encoder", "encoder_palette"):
        params[name] = jnp.asarray(rng.uniform(-2, 2, params[name].shape).astype(np.float32))
    jtr = JPaletteTrainer("palette", jcfg, jspec, params=params, workspace=str(tmp / "jax"),
                          use_checkpoint="scratch", nerf_path=None, mute=True)
    hist = rng.uniform(size=(32, 32, 32, 4)).astype(np.float32)
    jtr.initialize_palette(BC, hist / hist.sum(-1, keepdims=True))
    jtr.eval_settings = dataclasses.replace(jtr.eval_settings, density_scale=30.0)
    jtr.grid_state = jtr.grid_state._replace(bitfield=jnp.full_like(jtr.grid_state.bitfield, 255))
    jtr._build_jit_fns()

    ttr = TPaletteTrainer("palette", tcfg, tspec, workspace=str(tmp / "torch"),
                          params=tckpt.palette_params_from_jax(
                              jax.tree_util.tree_map(np.asarray, jtr.params)),
                          use_checkpoint="scratch", mute=True, device="cpu")
    ttr.eval_settings = dataclasses.replace(ttr.eval_settings, density_scale=30.0)
    ttr.grid_state = ttr.grid_state._replace(bitfield=torch.full_like(ttr.grid_state.bitfield, 255))

    ds = JPaletteDataset(jcfg, type="train")
    # the JAX dataset seeds its sampler with the salted str hash of its type, which differs
    # from process to process; seed it as the port's dataset seeds itself
    ds.rng = np.random.default_rng(jcfg.seed + zlib.crc32(b"train") % 2 ** 16)
    steps = []
    for tr in (jtr, ttr):
        tr.freeze_basis_color, tr.require_smooth_loss = False, True
        tr.lambda_weight, tr.lambda_palette = 0.05, 1e-3
    for i in range(2):
        if i:  # each step from the same state: the second one from JAX's after the first
            _adopt_jax_state(ttr, jtr)
        data = ds.collate(i)
        key = jax.random.PRNGKey(10 + i)
        loss_j = jtr._gui_train_step(data, key)
        loss_t = ttr._gui_train_step(data, **_step_draws(key, len(data["rays_o"]),
                                                         CFG_KW["train_samples_per_ray"]))
        steps.append((loss_j, float(loss_t)))
    steps.append(ttr.params)
    steps.append(jtr.params)
    ttr._set_params(*(_port_tree(t) for t in (jtr.params, jtr.ema_params)))
    for tr in (jtr, ttr):
        tr.require_smooth_loss = False
    return jtr, ttr, steps


def _sessions(pair):
    jtr, ttr, _ = pair
    return (jheadless.EditingSession(jtr, W=W, H=H, radius=RADIUS),
            theadless.EditingSession(ttr, W=W, H=H, radius=RADIUS))


def _close_frames(got, ref, keys=None):
    keys = keys or ref.keys()
    assert set(got) == set(ref)
    for k in keys:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=0,
                                   atol=FRAME_ATOL.get(k, ATOL), err_msg=k)


# --------------------------------------------------------------------------- camera

@pytest.mark.parametrize("op", ["pose", "orbit", "scale", "pan", "set_pose", "fovy"])
def test_orbit_camera_matches(op, scene):
    """The port's copy moves exactly as the JAX class: pose and intrinsics after ``op``."""
    pose0 = TNeRFDataset(TConfig(path=scene, bound=1.0, scale=0.5), type="train").poses[0]
    cams = []
    for mod in (jcamera, tcamera):
        cam = mod.OrbitCamera(W, 20, r=RADIUS, fovy=50.0 if op == "fovy" else 60.0)
        if op in ("orbit", "pan", "set_pose"):
            cam.orbit(5.0, -3.0)
        if op == "scale":
            cam.scale(1.5)
        if op == "pan":
            cam.pan(30.0, -12.0, 4.0)
        if op == "set_pose":
            cam.set_pose(pose0)
            cam.orbit(1.0, 2.0)
        cams.append(cam)
    j, t = cams
    np.testing.assert_allclose(t.pose, j.pose, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.intrinsics, j.intrinsics, rtol=0, atol=1e-6)
    assert t.pose.dtype == j.pose.dtype == np.float32


# --------------------------------------------------------------------------- session

def test_palette_gui_step_matches(pair):
    """Two palette ``_gui_train_step``s: the loss of each, then every parameter."""
    jtr, _, steps = pair
    for loss_j, loss_t in steps[:2]:
        assert loss_t == pytest.approx(loss_j, rel=1e-5)
    _assert_palette_params_close(steps[2], steps[3], 1e-4)
    assert jtr.global_step == 0   # the steps themselves do not count (train_gui does)


def test_session_render_and_pick_match(pair):
    js, ts = _sessions(pair)
    # the raw trained colors, not the EMA copy
    np.testing.assert_array_equal(ts.palette, np.asarray(pair[0].params["basis_color"]))
    assert not np.array_equal(ts.palette, np.asarray(pair[0].ema_params["basis_color"]))
    fj, ft = js.render(), ts.render()
    _close_frames(ft, fj)
    assert ft["image"].shape == (H, W, 3) and float(ft["weights_sum"].max()) > 0.5
    for x, y in ((12, 12), (3, 20)):
        pj, pt = js.pick(x, y), ts.pick(x, y)
        for k in ("xyz", "clip_feat", "rgb"):
            np.testing.assert_allclose(pt[k], pj[k], rtol=0, atol=1e-4, err_msg=k)


def test_region_recolor_matches_and_stays_in_region(pair):
    """A tight spatial region: pixels whose rays pass nowhere near the picked point keep
    their bits (the region weight underflows to exactly 0 there); the frame moves at the
    pick; both packages agree."""
    js, ts = _sessions(pair)
    ts.render()
    xyz = ts.pick(12, 12)["xyz"]
    std = 2e-3
    frames = []
    for s in (js, ts):
        s.set_region(mean_xyz=xyz, std_xyz=std)
        before = s.render()
        s.recolor(1, [0.9, 0.1, 0.1])
        s.recolor(3, [0.1, 0.2, 0.9])
        frames.append((before, s.render()))
    (jb, ja), (tb, ta) = frames
    _close_frames(ta, ja)
    _close_frames(tb, jb)
    from palettenerf_torch.data.rays import gen_rays

    ro, rd = gen_rays(ts.cam.pose, ts.cam.intrinsics, H, W)
    line_dist = np.linalg.norm(np.cross(xyz - ro, rd), axis=-1).reshape(H, W)
    far = line_dist ** 2 / std > 110.0  # exp(-110) is below the smallest f32
    moved = np.abs(ta["image"] - tb["image"]).max(-1)
    assert far.sum() > 100 and moved[12, 12] > 1e-3
    np.testing.assert_array_equal(ta["image"][far], tb["image"][far])


def test_weight_mode_matches_and_is_gray(pair):
    js, ts = _sessions(pair)
    out = []
    for s in (js, ts):
        s.set_weights(view_dep_weight=0.0)
        s.set_region(mean_xyz=(0, 0, 0), std_xyz=0.5, weight_mode=True)
        out.append(s.render())
    _close_frames(out[1], out[0])
    img = out[1]["image"]
    np.testing.assert_allclose(img[..., 0], img[..., 1], atol=1e-5)
    np.testing.assert_allclose(img[..., 0], img[..., 2], atol=1e-5)


@pytest.mark.parametrize("dials", [(0.0, 1.0), (1.0, 0.0), (0.5, 0.3)])
def test_dials_match(pair, dials):
    js, ts = _sessions(pair)
    plain = ts.render()["image"]
    out = []
    for s in (js, ts):
        s.set_weights(*dials)
        out.append(s.render())
    _close_frames(out[1], out[0])
    assert np.abs(out[1]["image"] - plain).max() > 1e-4


def test_reset_colors_gives_back_the_first_frame(pair):
    js, ts = _sessions(pair)
    first = ts.render()["image"]
    out = []
    for s in (js, ts):
        s.recolor(0, [0.2, 0.9, 0.2])
        s.recolor(2, [0.9, 0.9, 0.1])
        edited = s.render()["image"]
        s.reset_colors()
        out.append((np.asarray(edited), s.render()))
    _close_frames(out[1][1], out[0][1])
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=0, atol=ATOL)
    assert np.abs(out[1][0] - first).max() > 1e-3
    np.testing.assert_array_equal(out[1][1]["image"], first)
    np.testing.assert_array_equal(ts.edited_palette, ts.palette)


def test_jump_to_pose_matches(pair, scene):
    js, ts = _sessions(pair)
    poses = JNeRFDataset(JConfig(path=scene, bound=1.0, scale=0.5), type="train").poses
    pj, pt = js.jump_to_pose(poses, 1), ts.jump_to_pose(poses, 1)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_allclose(ts.cam.pose, js.cam.pose, rtol=0, atol=1e-6)
    _close_frames(ts.render(), js.render())


@pytest.mark.parametrize("downscale", [0.5, 0.37])
def test_test_gui_downscale_matches(pair, downscale):
    """``int()`` truncation of the frame size, intrinsics scaled, every output map."""
    jtr, ttr, _ = pair
    for tr in (jtr, ttr):
        tr.set_edit()
    cam = tcamera.OrbitCamera(W, H, r=RADIUS)
    cam.orbit(3.0, 1.0)
    got = ttr.test_gui(cam.pose, cam.intrinsics, W, H, downscale=downscale)
    ref = jtr.test_gui(cam.pose, cam.intrinsics, W, H, downscale=downscale)
    side = int(W * downscale)
    assert got["image"].shape == (side, side, 3)
    _close_frames(got, ref)


def test_render_dynamic_accumulation_matches(pair):
    """At a fixed pose and downscale 1 (a budget no frame misses): the running mean, spp
    and downscale of three frames, then the restart when the camera moves."""
    js, ts = _sessions(pair)
    for i in range(3):
        oj, ot = js.render_dynamic(target_ms=1e9), ts.render_dynamic(target_ms=1e9)
        assert ot["spp"] == oj["spp"] == i + 1 and ot["downscale"] == oj["downscale"] == 1.0
        np.testing.assert_allclose(ot["image"], oj["image"], rtol=0, atol=ATOL)
        assert ot["image"].dtype == np.float32
    for s in (js, ts):
        s.cam.orbit(5, 0)
    oj, ot = js.render_dynamic(target_ms=1e9), ts.render_dynamic(target_ms=1e9)
    assert ot["spp"] == oj["spp"] == 1
    np.testing.assert_allclose(ot["image"], oj["image"], rtol=0, atol=ATOL)
    # a budget every frame misses: the downscale falls by the 0.7 floor per frame to 1/4
    downs = [ts.render_dynamic(target_ms=1e-6)["downscale"] for _ in range(5)]
    np.testing.assert_allclose(downs, [0.7, 0.49, 0.343, 0.25, 0.25], rtol=1e-12)


def _jax_stylizer_loss(jtr, ro, rd, tgt, sty, arap_weight=1e-2):
    """The loss ``palettenerf_tpu.gui.headless.fit_stylizer`` minimizes, at ``sty``."""
    spec, st = jtr.palette_spec, jtr.eval_settings
    params = jtr.eval_params()
    n, P, S, b = ro.shape[0], spec.num_basis, st.num_samples, st.bound
    aabb = jnp.asarray([-b, -b, -b, b, b, b], jnp.float32)
    nears, fars = jnear_far(jnp.asarray(ro), jnp.asarray(rd), aabb, st.min_near)
    m = jmarch_rays(jnp.asarray(ro), jnp.asarray(rd), nears, fars, jtr.grid_state.bitfield, b,
                    st.cascade, st.grid_size, st.dt_gamma, st.max_steps, S, None)
    xyzs = m.xyzs.reshape(-1, 3)
    dirs = jnp.broadcast_to(jnp.asarray(rd)[:, None, :], m.xyzs.shape).reshape(-1, 3)
    sigma, _, omega, off_rad, view_dep, _ = jpal.palette_forward(params, spec, xyzs, dirs)
    M = xyzs.shape[0]
    w, ws, _ = jcomp.composite_weights((sigma * st.density_scale).reshape(n, S), m.dts, m.mask,
                                       st.t_thresh)
    rgbs = jpr.apply_stylizer(sty, off_rad[..., -1:].reshape(M, 1, 1), omega.reshape(M, P, 1),
                              jnp.clip(params["basis_color"], 0, 1)[None],
                              off_rad[..., :-1].reshape(M, P, 3), view_dep)
    img = jcomp.composite_channels(w, rgbs.reshape(n, S, 3)) + (1 - ws)[:, None]
    return float(((img - tgt) ** 2).mean() + arap_weight * jpr.stylizer_arap_loss(sty))


def test_fit_stylizer_matches(pair):
    """20 Adam steps on 8 recorded correspondences: every leaf and the final loss; then
    the stylized frames through the session, with the style on and off."""
    js, ts = _sessions(pair)
    frame = ts.render()
    js.render()
    rng = np.random.default_rng(3)
    ys, xs = np.nonzero(frame["weights_sum"] > 0.5)
    pick = rng.choice(len(xs), 8, replace=False)
    for i in pick:
        tgt = rng.uniform(size=3)
        for s in (js, ts):
            s.add_correspondence(int(xs[i]), int(ys[i]), tgt)
    ro, rd, tgt = (np.stack(c) for c in zip(*ts._corr))
    sty_j = jheadless.fit_stylizer(pair[0], ro, rd, tgt, iters=20)
    sty_t = theadless.fit_stylizer(pair[1], ro, rd, tgt, iters=20)
    start = tpr.init_stylizer(4)
    for name, got, ref, init in zip(sty_t._fields, sty_t, sty_j, start):
        ref = np.asarray(ref)
        assert float(np.abs(got.numpy() - init.numpy()).max()) > 1e-3, name
        assert float(np.abs(got.numpy() - ref).max()) <= 1e-4 * float(np.abs(ref).max()), name
    loss_t = float(theadless.stylizer_problem(pair[1], ro, rd, tgt)(sty_t))
    loss_j = _jax_stylizer_loss(pair[0], ro, rd, tgt, sty_j)
    assert loss_t == pytest.approx(loss_j, rel=1e-4)
    assert loss_t < float(theadless.stylizer_problem(pair[1], ro, rd, tgt)(start))
    # the JAX fit through both sessions: on, then off
    js.set_stylizer(sty_j)
    ts.set_stylizer(tpr.StylizerParams(*(T(leaf) for leaf in sty_j)))
    on = [js.render(), ts.render()]
    _close_frames(on[1], on[0])
    for s in (js, ts):
        s.use_style(False)
    off = [js.render(), ts.render()]
    _close_frames(off[1], off[0])
    assert np.abs(on[1]["image"] - off[1]["image"]).max() > 1e-4
    np.testing.assert_array_equal(off[1]["image"], frame["image"])


# --------------------------------------------------------------------------- trainers

STAGE1_KW = dict(O=True, fp16=True, bound=1.0, scale=0.5, grid_size=16, num_rays=192,
                 max_steps=128, train_samples_per_ray=32, infer_samples_per_ray=64, iters=100,
                 seed=0, log2_hashmap_size=12, grid_levels=4, update_extra_interval=2,
                 min_near=0.05, dt_gamma=0.0)


def _stage1(scene, tmp_path, seed=1):
    jspec = jnerf.NeRFSpec.build(fp16=True, bound=1.0, log2_hashmap_size=12, grid_levels=4)
    tspec = tnerf.NeRFSpec.build(fp16=True, bound=1.0, log2_hashmap_size=12, grid_levels=4)
    jparams = jnerf.init_nerf(jax.random.PRNGKey(seed), jspec)
    jparams["encoder"] = jnp.asarray(np.random.default_rng(seed).uniform(
        -1, 1, jparams["encoder"].shape).astype(np.float32))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    ttr = TTrainer("ngp", TConfig(path=scene, **STAGE1_KW), tspec,
                   params=tckpt.params_from_jax(tree), workspace=str(tmp_path / "torch"),
                   use_checkpoint="scratch", mute=True, device="cpu")
    return jspec, jparams, ttr


def test_stage1_gui_step_matches(scene, tmp_path):
    """One stage-1 ``_gui_train_step`` on a collated batch, the JAX key's draws handed to
    the port: loss, then every parameter and its EMA."""
    jspec, jparams, ttr = _stage1(scene, tmp_path)
    jtr = JTrainer("ngp", JConfig(path=scene, **STAGE1_KW), jspec, params=jparams,
                   workspace=str(tmp_path / "jax"), use_checkpoint="scratch", mute=True)
    jtr.grid_state = jtr.grid_state._replace(bitfield=jnp.full_like(jtr.grid_state.bitfield, 255))
    ttr.grid_state = ttr.grid_state._replace(bitfield=torch.full_like(ttr.grid_state.bitfield, 255))
    data = JNeRFDataset(jtr.opt, type="train").collate(1)
    n = len(data["rays_o"])
    key = jax.random.PRNGKey(7)
    k_bg, k_pt = jax.random.split(key)
    draws = dict(bg=T(jax.random.uniform(k_bg, (n, 3))),
                 noise=T(jax.random.uniform(jax.random.split(k_pt)[0], (n,))))
    loss_j = jtr._gui_train_step(data, key)
    loss_t = ttr._gui_train_step(data, **draws)
    assert float(loss_t) == pytest.approx(loss_j, rel=1e-5)
    for got, ref in ((ttr.params, jtr.params), (ttr.ema_params, jtr.ema_params)):
        ref = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, ref))
        for i, (a, b) in enumerate(zip(tnerf.param_list(got), tnerf.param_list(ref))):
            # an entry whose gradient sums to about 0 may take the other sign: 2 lr off
            diff = (a.detach() - b).abs()
            assert int((diff > 1e-6).sum()) <= max(1, diff.numel() // 20), i
            assert float(diff.max()) <= 2 * 1e-2 + 1e-6, i


def test_train_burst_steps_and_refresh_cadence(scene, tmp_path):
    """``train_gui``: a burst of 3 steps advances ``global_step`` by 3, refreshes the
    stage-1 grid every ``update_extra_interval`` steps and returns the lr of the JAX
    formula; the palette trainer's grid stays frozen."""
    _, _, ttr = _stage1(scene, tmp_path)
    ds = TNeRFDataset(ttr.opt, type="train")
    iters = []
    for _ in range(2):
        stats = ttr.train_gui(ds, step=3)
        iters.append(int(ttr.grid_state.iter_density))
        assert np.isfinite(stats["loss"]) and stats["time"] > 0
        assert stats["lr"] == pytest.approx(1e-2 * 0.1 ** (ttr.global_step / 100), rel=1e-12)
    assert ttr.global_step == ttr.opt_step == 6
    assert iters == [2, 3]   # refreshes before steps 0, 2 | 4

    tspec = tpal.PaletteSpec.build(**SPEC_KW)
    ptr = TPaletteTrainer("palette", TConfig(path=scene, **CFG_KW), tspec,
                          workspace=str(tmp_path / "pal"), use_checkpoint="scratch", mute=True,
                          device="cpu")
    ptr.grid_state = ptr.grid_state._replace(bitfield=torch.full_like(ptr.grid_state.bitfield, 7))
    before = ptr.grid_state
    stats = ptr.train_gui(TPaletteDataset(ptr.opt, type="train"), step=3)
    assert ptr.global_step == 3 and np.isfinite(stats["loss"])
    assert ptr.grid_state is before


@pytest.mark.parametrize("samples", [64, 32, 30, 12])
def test_set_render_option_rederives_compaction(scene, tmp_path, samples):
    jspec, jparams, ttr = _stage1(scene, tmp_path)
    jtr = JTrainer("ngp", JConfig(path=scene, **STAGE1_KW), jspec, params=jparams,
                   workspace=str(tmp_path / "jax"), use_checkpoint="scratch", mute=True)
    for tr in (jtr, ttr):
        tr.set_render_option(num_samples=samples, dt_gamma=0.004)
    assert ttr.eval_settings.compaction_rounds == jtr.eval_settings.compaction_rounds \
        == jtr._compaction_rounds(samples)
    assert (samples % 4 == 0 and samples >= 16) == bool(ttr.eval_settings.compaction_rounds)
    for kind in ("train_settings", "eval_settings"):
        st = getattr(ttr, kind)
        assert (st.num_samples, st.dt_gamma) == (samples, 0.004), kind
    assert ttr.train_settings.compaction_rounds == ()
    # the hierarchical march's group slots: set on both settings, and re-provisioned from
    # the trainer's option when only the sample count moves (trainer.py:684-700)
    for tr in (jtr, ttr):
        tr.set_render_option(march_groups=4)
    for kind in ("train_settings", "eval_settings"):
        assert getattr(ttr, kind).march_groups == getattr(jtr, kind).march_groups == 4, kind
    for tr in (jtr, ttr):
        tr.set_render_option(num_samples=samples)
    for kind in ("train_settings", "eval_settings"):
        assert getattr(ttr, kind).march_groups == getattr(jtr, kind).march_groups \
            == ttr._march_groups() == 0, kind


def test_save_view_writes_the_test_gui_frame(pair):
    from palettenerf_torch.data.png import read_png

    _, ttr, _ = pair
    cam = tcamera.OrbitCamera(W, H, r=RADIUS)
    path = ttr.save_view(cam.pose, cam.intrinsics, W, H, name="view")
    img = read_png(path)
    want = (np.clip(ttr.test_gui(cam.pose, cam.intrinsics, W, H)["image"], 0, 1) * 255)
    np.testing.assert_array_equal(img[..., :3], want.astype(np.uint8))


# --------------------------------------------------------------------------- mesh

def _field(kind):
    rng = np.random.default_rng(4)
    c = np.linspace(-1, 1, 21, dtype=np.float32)
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    if kind == "noise":
        return rng.uniform(0, 20, size=(13, 17, 11)).astype(np.float32)
    f = 20.0 * np.exp(-4 * (gx ** 2 + 1.5 * gy ** 2 + gz ** 2)) + rng.normal(scale=0.3, size=gx.shape)
    return f.astype(np.float32)


@pytest.mark.parametrize("kind, threshold", [("blob", 10.0), ("noise", 10.0), ("blob", 1e3)],
                         ids=["blob", "noise", "empty"])
def test_marching_tetrahedra_writes_the_same_bytes(tmp_path, kind, threshold):
    field = _field(kind)
    out = []
    for i, mod in enumerate((jmcubes, tmcubes)):
        v, f = mod.marching_tetrahedra(field, threshold)
        mod.write_ply(str(tmp_path / f"{i}.ply"), v, f)
        mod.write_obj(str(tmp_path / f"{i}.obj"), v, f)
        out.append((v, f))
    for ext in ("ply", "obj"):
        assert (tmp_path / f"0.{ext}").read_bytes() == (tmp_path / f"1.{ext}").read_bytes()
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert (len(out[1][1]) > 0) == (threshold < 100)


@pytest.mark.parametrize("model", ["nerf", "palette"])
def test_density_lattice_matches(pair, scene, tmp_path, model):
    """The field ``save_mesh`` meshes: ``sigma`` of the EMA weights on the lattice, the
    JAX package's loop (``nerf_density`` / ``palette_density``) on the same points."""
    R = 20
    if model == "palette":
        jtr, ttr, _ = pair
        density = jpal.palette_density
    else:
        jspec, jparams, ttr = _stage1(scene, tmp_path)
        jtr = types.SimpleNamespace(spec=jspec, eval_params=lambda: jparams)
        density = jnerf.nerf_density
    got = ttr.density_lattice(R)
    lin = np.linspace(-1.0, 1.0, R, dtype=np.float32)
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    ref = np.asarray(density(jtr.eval_params(), jtr.spec, jnp.asarray(grid))["sigma"])
    assert got.shape == (R, R, R) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref.reshape(R, R, R), rtol=1e-5, atol=ATOL)


def test_save_mesh_meshes_the_lattice(pair):
    _, ttr, _ = pair
    R = 18
    field = ttr.density_lattice(R)
    thr = float(np.median(field))
    path = ttr.save_mesh(resolution=R, threshold=thr)
    assert path == os.path.join(ttr.workspace, "meshes", "palette_0.ply")
    v, f = read_ply(path)
    want_v, want_f = tmcubes.marching_tetrahedra(field, thr)
    assert len(f) > 0 and ttr.mesh_stats["faces"] == len(f)
    np.testing.assert_array_equal(f, want_f)
    np.testing.assert_array_equal(v, (want_v / (R - 1) * 2.0 - 1.0).astype(np.float32))


# --------------------------------------------------------------------------- DearPyGui layer

@pytest.fixture()
def dpg_module():
    """Reload the port's gui.dpg_gui with the recording stub installed; restore after."""
    stub = make_stub_dpg(max_frames=2)
    pkg = types.ModuleType("dearpygui")
    pkg.dearpygui = stub
    saved = {k: sys.modules.get(k) for k in ("dearpygui", "dearpygui.dearpygui")}
    sys.modules["dearpygui"] = pkg
    sys.modules["dearpygui.dearpygui"] = stub
    import palettenerf_torch.gui.dpg_gui as mod

    mod = importlib.reload(mod)
    assert mod.HAS_DPG and mod.dpg is stub
    yield mod, stub
    for k, v in saved.items():
        if v is None:
            sys.modules.pop(k, None)
        else:
            sys.modules[k] = v
    importlib.reload(mod)


def test_without_dearpygui_the_error_names_the_headless_session(pair, monkeypatch):
    import palettenerf_torch.gui.dpg_gui as mod

    monkeypatch.setitem(sys.modules, "dearpygui", None)
    monkeypatch.setitem(sys.modules, "dearpygui.dearpygui", None)
    mod = importlib.reload(mod)
    try:
        assert not mod.HAS_DPG
        for cls in (mod.NeRFGUI, mod.PaletteGUI):
            with pytest.raises(ImportError, match=r"palettenerf_torch\.gui\.EditingSession"):
                cls(pair[1].opt, pair[1])
    finally:
        monkeypatch.undo()
        importlib.reload(mod)


def test_nerf_gui_loop_and_widgets(pair, dpg_module):
    _, ttr, _ = pair
    mod, stub = dpg_module
    gui = mod.NeRFGUI(ttr.opt, ttr)
    gui.render()   # two loop frames against the stub, then exits
    assert stub.frames_rendered == 2
    assert gui.render_buffer.shape == (H, W, 3) and np.isfinite(gui.render_buffer).all()
    settings = ttr.eval_settings, ttr.train_settings
    try:
        stub.fire("dt_gamma", 0.005)
        stub.fire("max samples", 32)
        assert ttr.eval_settings.num_samples == 32 and ttr.eval_settings.dt_gamma == 0.005
        assert ttr.eval_settings.compaction_rounds == ((1, 8), (4, 8), (16, 16))
        stub.fire_handler("mouse_drag_left", (0, 5.0, 3.0))
        stub.fire_handler("mouse_wheel", 1.0)
        pose1 = gui.cam.pose.copy()
        gui.render_frame()
        assert np.isfinite(gui.render_buffer).all()
        stub.fire_handler("mouse_drag_middle", (0, 2.0, -1.0))
        assert not np.allclose(gui.cam.pose, pose1)
        # the button meshes at the CLI's 256^3 / density 10; 16^3 at the median here
        calls, save_mesh = [], ttr.save_mesh
        thr = float(np.median(ttr.density_lattice(16)))
        ttr.save_mesh = lambda **kw: calls.append(kw) or save_mesh(resolution=16, threshold=thr)
        stub.fire("save mesh", None)
        assert calls == [{}]
        assert read_ply(os.path.join(ttr.workspace, "meshes", "palette_0.ply"))[1].size > 0
    finally:
        ttr.eval_settings, ttr.train_settings = settings
        ttr.__dict__.pop("save_mesh", None)


def test_palette_gui_edit_flow(pair, dpg_module, scene):
    jtr, ttr, _ = pair
    mod, stub = dpg_module
    poses = TNeRFDataset(ttr.opt, type="train").poses
    gui = mod.PaletteGUI(ttr.opt, ttr, test_poses=poses,
                         video_loader=TNeRFDataset(ttr.opt, type="test"))
    try:
        gui.render()
        assert stub.frames_rendered == 2
        base = gui.render_buffer.copy()
        stub.fire("basis 1", [0.9, 0.1, 0.1, 1.0])   # recolor through its color edit
        gui.render_frame()
        assert np.abs(gui.render_buffer - base).max() > 1e-5
        stub.set_mouse_pos(12, 12)
        stub.fire_handler("mouse_click_right", None)  # pick -> region center
        assert bool(gui.session._edit.use_xyz)
        np.testing.assert_array_equal(gui.session._edit.mean_xyz,
                                      gui.session._last_frame["xyz"][12, 12])
        stub.fire("std_xyz", 0.4)
        stub.fire("weight mode", True)
        assert gui.session._edit.weight_mode
        stub.fire("weight mode", False)
        stub.fire("offsets w", 0.5)
        stub.fire("view-dep w", 0.0)
        assert gui.session._weights == (1.0, 0.0)   # each dial sets the other back to 1
        gui.render_frame()
        assert np.isfinite(gui.render_buffer).all()
        # style panel: pick mode, a target color, a correspondence, the fit, style off
        stub.set_value("_style_mode", True)
        stub.fire("target color", [1.0, 0.0, 0.0, 1.0])
        stub.fire_handler("mouse_click_right", None)
        assert stub.get_value("_log_style").startswith("1 ")
        stub.fire("optimize style", None)
        assert ttr.stylizer is gui.session._stylizer is not None
        stub.fire("use style", False)
        assert ttr.stylizer is None
        gui.render_frame()
        stub.fire("clear corr", None)
        assert gui.session._corr == []
        stub.fire("test pose", 2)
        np.testing.assert_allclose(gui.cam.pose, poses[2], atol=1e-5)
        stub.fire("reset colors", None)
        gui.render_frame()
        assert np.isfinite(gui.render_buffer).all()
        # output panel: render view (a png), render video (the test split's pngs)
        stub.fire("render view", None)
        stub.fire("render video", None)
        names = os.listdir(os.path.join(ttr.workspace, "results"))
        assert any("_view_" in n for n in names) and any(n.endswith("0000_rgb.png") for n in names)
    finally:
        ttr.set_edit()


def test_clis_reach_the_guis(scene, tmp_path, monkeypatch, dpg_module):
    """``main_nerf --gui`` (both branches) and ``main_palette --test --gui`` open the
    port's NeRFGUI / PaletteGUI; with the stub they run two loop frames."""
    mod, stub = dpg_module
    monkeypatch.chdir(tmp_path)
    common = ["-O", "--bound", "1", "--scale", "0.5", "--dt_gamma", "0", "--min_near", "0.05",
              "--log2_hashmap_size", "10", "--grid_levels", "4", "--max_steps", "32",
              "--infer_samples_per_ray", "16", "--W", "20", "--H", "16", "--gui"]
    seen = []
    monkeypatch.setattr(mod.NeRFGUI, "_loop_body",
                        lambda self, f=mod.NeRFGUI._loop_body: (seen.append(type(self).__name__),
                                                                f(self))[1])
    for extra in ([], ["--test"]):
        stub.reset(max_frames=2)
        tr = tmain_nerf.main([scene] + common + extra, device="cpu")
        assert tr.global_step == 0 and stub.frames_rendered == 2
    stub.reset(max_frames=2)
    tr = tmain_palette.main([scene, "results/workspace"] + common + ["--test"], device="cpu")
    assert isinstance(tr, TPaletteTrainer) and stub.frames_rendered == 2
    assert seen == ["NeRFGUI"] * 4 + ["PaletteGUI"] * 2
    assert not os.path.isdir("results/workspace/version_1/meshes")
