"""Port parity of ``palettenerf_torch.serve_vs_gt`` (the serve path against ground truth)
against the JAX pipeline of ``scripts/serve_vs_gt.py``: ``bake_palette`` ->
``mask_with_bitfield`` -> ``build_sweep_volume`` -> ``render_sweep`` at every test pose,
and ``render_palette_eval(gui_mode=True)`` with the script's ``RenderSettings`` on the
first two, on a small palette checkpoint in the JAX package's layout (R 32, the test views
of ``tests/synthetic.py``'s sphere scene). The exact path runs in chunks of one whole
32x32 view, so that neither side pads a chunk (``tests/test_torch_eval_chunk.py`` holds
the padded last chunk of the script's 16,384-ray chunks).

Tolerances: the sweep frames by PSNR >= 45 dB against JAX's (bf16 shading on both sides
rounds at other places: the bound of ``tests/test_torch_serve.py``); the exact frames to
2e-5 absolute (f32 sums in another order, the ``ATOL`` of
``tests/test_torch_palette_train.py``); every PSNR the module reports to 0.05 dB of the
one computed from JAX's frames.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.config import Config as JConfig
from palettenerf_tpu.data.provider import NeRFDataset as JDataset
from palettenerf_tpu.models import palette as jpal
from palettenerf_tpu.render import baking as jbake
from palettenerf_tpu.render import nerf_renderer as jrender
from palettenerf_tpu.render import palette_renderer as jpr
from palettenerf_tpu.render import sweep as jsweep
from palettenerf_torch import serve_vs_gt as svg
from palettenerf_torch.train import checkpoint as tckpt
from synthetic import make_sphere_dataset
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
SMALL = dict(bound=1.0, num_basis=4, grid_levels=4, log2_hashmap_size=13)
BC = np.array([[0.9, 0.2, 0.1], [0.1, 0.8, 0.3], [0.2, 0.3, 0.9], [0.8, 0.8, 0.2]],
              np.float32)
R, G, HW, N_TEST = 32, 32, 32, 3
SWEEP_PSNR = 45.0   # sweep frame, port vs JAX (tests/test_torch_serve.py)
EXACT_ATOL = 2e-5   # exact frame, port vs JAX
PSNR_TOL = 0.05     # dB


def _psnr(a, b):
    return svg.psnr(a, b)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A sphere scene with N_TEST test views, a small palette field with lively tables and
    a random occupancy bitfield, written as a JAX-layout pickle into a workspace."""
    root = tmp_path_factory.mktemp("svg")
    scene = make_sphere_dataset(str(root / "scene"), n_train=2, n_val=1, n_test=N_TEST,
                                H=HW, W=HW)
    spec = jpal.PaletteSpec.build(**SMALL)
    params = jpal.initialize_palette(jpal.init_palette(jax.random.PRNGKey(0), spec), spec,
                                     color_list=BC)
    rng = np.random.default_rng(0)
    for name in ("encoder", "encoder_palette"):
        params[name] = jnp.asarray(rng.uniform(-2, 2, params[name].shape).astype(np.float32))
    params = jax.tree_util.tree_map(np.asarray, params)
    occ = rng.random(G ** 3) < 0.6
    gs = {"density_grid": np.where(occ, 20.0, 0.0).astype(np.float32)[None],
          "bitfield": np.packbits(occ, bitorder="little")}
    ws = str(root / "ws")
    tckpt.save_reference_checkpoint(
        os.path.join(ws, "checkpoints", "palette_ep0001.ckpt"),
        tckpt.palette_params_from_jax(params), grid_state={k: torch.from_numpy(v)
                                                           for k, v in gs.items()})
    got = svg.serve_vs_gt(ws, scene, device="cpu", resolution=R, grid_levels=4,
                          log2_hashmap_size=13, verbose=False, chunk=HW * HW)
    return scene, spec, params, gs, got, ws


def _jax_reference(scene, spec, params, gs):
    """scripts/serve_vs_gt.py's pipeline at R with the same settings: sweep frames,
    exact frames, ground truths."""
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    baked = jbake.mask_with_bitfield(jbake.bake_palette(jp, spec, resolution=R, vd_bands=3),
                                     gs)
    sv = jsweep.build_sweep_volume(baked, sigma_thresh=1e-3)
    bc = jnp.asarray(np.clip(params["basis_color"], 0, 1), jnp.float32)
    ds = JDataset(JConfig(path=scene, bound=1.0, scale=0.8, dt_gamma=0.0, min_near=0.05,
                          bg_radius=0, fp16=True), type="test")
    eset = jrender.RenderSettings(bound=1.0, cascade=1, grid_size=G, dt_gamma=0.0,
                                  max_steps=512, num_samples=192, t_thresh=1e-2,
                                  min_near=0.05, march_groups=48, compact_frac=0.375)
    bitfield = jnp.asarray(gs["bitfield"][: G ** 3 // 8])
    sweeps, exacts, gts = [], [], []
    for i, data in enumerate(ds.iter_epoch()):
        H, W, idx = data["H"], data["W"], data["index"]
        gt = np.asarray(ds.images[idx], np.float32).reshape(H, W, -1)
        gts.append(gt[..., :3] * gt[..., 3:] + 1.0 * (1 - gt[..., 3:]))
        out = jsweep.render_sweep(sv, np.asarray(ds.poses[idx]).reshape(4, 4),
                                  ds.intrinsics, H, W, u_res=448, basis_color=bc,
                                  min_near=0.05)
        sweeps.append(np.asarray(out["image"]))
        if i < 2:
            ex = jpr.render_palette_eval(jp, spec, bitfield,
                                         jnp.asarray(data["rays_o"].reshape(-1, 3)),
                                         jnp.asarray(data["rays_d"].reshape(-1, 3)), eset,
                                         bg_color=jnp.ones(3), gui_mode=True)
            exacts.append(np.asarray(ex["image"]).reshape(H, W, 3))
    return sweeps, exacts, gts


def test_serve_vs_gt_matches_jax_pipeline(case):
    scene, spec, params, gs, got, _ = case
    sweeps, exacts, gts = _jax_reference(scene, spec, params, gs)
    assert len(got.sweep_frames) == len(sweeps) == N_TEST
    assert len(got.exact_frames) == len(exacts) == 2
    for g, r in zip(got.sweep_frames, sweeps):
        assert g.shape == r.shape == (HW, HW, 3)
        assert _psnr(g, r) > SWEEP_PSNR
    for g, r in zip(got.exact_frames, exacts):
        np.testing.assert_allclose(g, r, rtol=0.0, atol=EXACT_ATOL)
    ref_sweep = [_psnr(s, gt) for s, gt in zip(sweeps, gts)]
    ref_exact = [_psnr(e, gt) for e, gt in zip(exacts, gts)]
    ref_cross = [_psnr(s, e) for s, e in zip(sweeps, exacts)]
    np.testing.assert_allclose(got.sweep_vs_gt, ref_sweep, atol=PSNR_TOL)
    np.testing.assert_allclose(got.exact_vs_gt, ref_exact, atol=PSNR_TOL)
    np.testing.assert_allclose(got.sweep_vs_exact, ref_cross, atol=PSNR_TOL)
    means = got.means()
    assert means["sweep_vs_gt"] == pytest.approx(np.mean(got.sweep_vs_gt))
    # the field is not the sphere's, but it is a real render: not blank, not the GT
    assert all(5.0 < p < 40.0 for p in got.sweep_vs_gt + got.exact_vs_gt)


def test_serve_vs_gt_reads_the_port_checkpoint(case, tmp_path):
    """The CLI on the same weights as the port's own checkpoint (``torch.save``) gives
    the same frames as the function on the JAX-layout pickle, both in the script's
    16,384-ray chunks."""
    scene, _, params, gs, got, pickle_ws = case
    ws = str(tmp_path / "ws")
    tckpt.save_checkpoint(os.path.join(ws, "checkpoints"), "palette", 1,
                          {"params": tckpt.palette_params_from_jax(params),
                           "grid_state": {k: torch.from_numpy(v) for k, v in gs.items()}}, 2)
    again = svg.main([ws, "--data", scene, "--resolution", str(R), "--n_exact", "1",
                      "--grid_levels", "4", "--log2_hashmap_size", "13"], device="cpu")
    assert len(again.exact_frames) == 1
    for a, b in zip(again.sweep_frames, got.sweep_frames):
        np.testing.assert_array_equal(a, b)
    ref = svg.serve_vs_gt(pickle_ws, scene, device="cpu", resolution=R, n_exact=1,
                          grid_levels=4, log2_hashmap_size=13, verbose=False)
    np.testing.assert_array_equal(again.exact_frames[0], ref.exact_frames[0])
