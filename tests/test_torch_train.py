"""Port parity of one ``-O`` train step, and short CPU training runs of the port.

The step test feeds the same weights, rays, pixels, bitfield, background and march
jitter to the JAX ``Trainer._train_step`` (bf16 hash-grid backward through the Pallas
tile scatter in interpret mode) and to ``palettenerf_torch``'s ``Trainer.train_step``
(its plain scatter on the CPU), then compares the loss and the updated parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.config import Config as JConfig
from palettenerf_tpu.models import nerf as jnerf
from palettenerf_tpu.ops import occupancy as jocc
from palettenerf_tpu.train.trainer import Trainer as JTrainer
from palettenerf_torch import main_nerf as tmain
from palettenerf_torch.config import Config as TConfig
from palettenerf_torch.data.provider import NeRFDataset
from palettenerf_torch.models import nerf as tnerf
from palettenerf_torch.train.checkpoint import params_from_jax
from palettenerf_torch.train.trainer import Trainer as TTrainer
from palettenerf_torch.utils.mcubes import read_ply
from synthetic import make_sphere_dataset
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
SPEC_KW = dict(bound=1.0, log2_hashmap_size=12, grid_levels=4, hidden_dim=16,
               hidden_dim_color=16)
CFG_KW = dict(O=True, fp16=True, bound=1.0, grid_size=16, num_rays=192, max_steps=128,
              train_samples_per_ray=32, infer_samples_per_ray=64, iters=100, seed=0,
              log2_hashmap_size=12, grid_levels=4)
H = 16


def T(a):
    return torch.from_numpy(np.array(a))


def _step_inputs(n):
    rng = np.random.default_rng(0)
    o = rng.normal(size=(n, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0).astype(np.float32)
    d = -o + rng.normal(scale=0.5, size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    img = rng.uniform(size=(n, 4)).astype(np.float32)
    img[: n // 3, 3] = 1.0
    img[n // 3: n // 2, 3] = 0.0
    c = (np.arange(H) + 0.5) / H * 2 - 1
    gx, gy, gz = np.meshgrid(c, c, c, indexing="ij")
    bits = np.asarray(jocc.packbits(jnp.asarray((gx ** 2 + gy ** 2 + gz ** 2 < 0.5).reshape(-1))))
    return o, d, img, bits


def test_O_train_step_matches_jax_trainer(tmp_path):
    jspec = jnerf.NeRFSpec.build(fp16=True, **SPEC_KW)
    tspec = tnerf.NeRFSpec.build(fp16=True, **SPEC_KW)
    assert tspec.scatter_dtype == torch.bfloat16
    jparams = jnerf.init_nerf(jax.random.PRNGKey(1), jspec)
    jparams["encoder"] = jnp.asarray(np.random.default_rng(1).uniform(
        -1, 1, jparams["encoder"].shape).astype(np.float32))
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    n = CFG_KW["num_rays"]
    o, d, img, bits = _step_inputs(n)

    jtr = JTrainer("ngp", JConfig(**CFG_KW), jspec, params=jparams,
                   workspace=str(tmp_path / "jax"), use_checkpoint="scratch", mute=True)
    key = jax.random.PRNGKey(5)
    # the draws _train_step makes from its key: background, then render_nerf_train's jitter
    k_bg, k_pt = jax.random.split(key)
    bg = np.asarray(jax.random.uniform(k_bg, (n, 3)))
    noise = np.asarray(jax.random.uniform(jax.random.split(k_pt)[0], (n,)))
    new_j, _, ema_j, loss_j, per_ray_j = jtr._train_step(
        jtr.params, jtr.opt_state, jtr.ema_params, jnp.asarray(bits), key,
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(img))

    ttr = TTrainer("ngp", TConfig(**CFG_KW), tspec, params=params_from_jax(np_tree),
                   workspace=str(tmp_path / "torch"), use_checkpoint="scratch", mute=True,
                   device="cpu")
    ttr.grid_state = ttr.grid_state._replace(bitfield=T(bits))
    loss_t, per_ray_t = ttr.train_step(T(o), T(d), T(img), bg=T(bg), noise=T(noise))

    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    np.testing.assert_allclose(per_ray_t.numpy(), np.asarray(per_ray_j), rtol=0, atol=1e-6)
    new_j = params_from_jax(jax.tree_util.tree_map(np.asarray, new_j))
    ema_j = params_from_jax(jax.tree_util.tree_map(np.asarray, ema_j))
    # Adam's first step moves each weight by lr * g/(|g| + 1e-15), i.e. by about +-lr
    # wherever g != 0, so this also checks that every gradient has the JAX sign
    pairs = [(tnerf.param_list(ttr.params), tnerf.param_list(new_j)),
             (tnerf.param_list(ttr.ema_params), tnerf.param_list(ema_j))]
    for got_list, ref_list in pairs:
        for got, ref in zip(got_list, ref_list):
            np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), rtol=0, atol=1e-6)
    moved = (tnerf.param_list(ttr.params)[0].detach() - T(np_tree["encoder"])).abs().max()
    assert float(moved) == pytest.approx(CFG_KW.get("lr", 1e-2), rel=1e-3)


def test_linear_train_step_matches_jax_trainer(tmp_path):
    """``--color_space linear``: the gt's rgb goes to linear space before the RGBA
    composite on the step's random background. Loss, per-ray loss (atol 2e-5, the port's
    render tolerance) and the parameters after the update (atol 1e-6; at most one entry
    in 20 of a tensor off, none by more than 2 lr: an entry whose gradient is near zero
    takes its sign from the gradient's last bits)."""
    jspec, tspec = jnerf.NeRFSpec.build(**SPEC_KW), tnerf.NeRFSpec.build(**SPEC_KW)
    jparams = jnerf.init_nerf(jax.random.PRNGKey(4), jspec)
    jparams["encoder"] = jnp.asarray(np.random.default_rng(4).uniform(
        -1, 1, jparams["encoder"].shape).astype(np.float32))
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = dict(CFG_KW, O=False, fp16=False, color_space="linear")
    n = cfg["num_rays"]
    o, d, img, bits = _step_inputs(n)
    jtr = JTrainer("ngp", JConfig(**cfg), jspec, params=jparams,
                   workspace=str(tmp_path / "jax"), use_checkpoint="scratch", mute=True)
    key = jax.random.PRNGKey(6)
    k_bg, k_pt = jax.random.split(key)
    bg = np.asarray(jax.random.uniform(k_bg, (n, 3)))
    noise = np.asarray(jax.random.uniform(jax.random.split(k_pt)[0], (n,)))
    new_j, _, _, loss_j, per_ray_j = jtr._train_step(
        jtr.params, jtr.opt_state, jtr.ema_params, jnp.asarray(bits), key,
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(img))
    ttr = TTrainer("ngp", TConfig(**cfg), tspec, params=params_from_jax(np_tree),
                   workspace=str(tmp_path / "torch"), use_checkpoint="scratch", mute=True,
                   device="cpu")
    ttr.grid_state = ttr.grid_state._replace(bitfield=T(bits))
    loss_t, per_ray_t = ttr.train_step(T(o), T(d), T(img), bg=T(bg), noise=T(noise))
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    np.testing.assert_allclose(per_ray_t.numpy(), np.asarray(per_ray_j), rtol=0, atol=2e-5)
    new_j = params_from_jax(jax.tree_util.tree_map(np.asarray, new_j))
    for got, ref in zip(tnerf.param_list(ttr.params), tnerf.param_list(new_j)):
        diff = (got.detach() - ref).abs()
        assert int((diff > 1e-6).sum()) <= max(1, got.numel() // 20), float(diff.max())
        assert float(diff.max()) <= 2e-2 + 1e-6


@pytest.fixture(scope="module")
def sphere_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_sphere")
    return make_sphere_dataset(str(root), n_train=8, n_val=1, n_test=1, H=32, W=32)


def _sphere_cfg(scene, **kw):
    base = dict(path=scene, O=True, fp16=True, bound=1.0, scale=0.5, dt_gamma=0.0,
                min_near=0.05, num_rays=512, iters=64, max_steps=96, grid_size=16,
                train_samples_per_ray=32, infer_samples_per_ray=64, lambda_sparse=0.0,
                log2_hashmap_size=12, grid_levels=6, grid_update_warmup=32, seed=0)
    base.update(kw)
    return TConfig(**base)


def test_short_run_loss_falls_and_checkpoint_roundtrips(sphere_scene, tmp_path):
    cfg = _sphere_cfg(sphere_scene)
    spec = tnerf.NeRFSpec.build(bound=1.0, fp16=True, log2_hashmap_size=12, grid_levels=6)
    train_ds = NeRFDataset(cfg, type="train")
    val_ds = NeRFDataset(cfg, type="val")
    tr = TTrainer("ngp", cfg, spec, workspace=str(tmp_path / "ws"), use_checkpoint="scratch",
                  mute=True, device="cpu", eval_interval=10_000)
    # 48 steps: 8 views, fewer than update_extra_interval (16), so one refresh at the start
    # of each epoch (JAX train_one_epoch_fast): full below step 32, then 1/4 slabs
    tr.train(train_ds, None, 6)
    losses = tr.stats["loss"]
    assert losses[-1] < 0.6 * losses[0], losses
    assert int(tr.grid_state.iter_density) == 6
    psnr = tr.evaluate_one_epoch(val_ds, save_images=False)
    assert psnr > 13.0, psnr

    tr2 = TTrainer("ngp", cfg, spec, workspace=tr.workspace, use_checkpoint="latest",
                   mute=True, device="cpu", eval_interval=10_000)
    assert (tr2.global_step, tr2.opt_step, tr2.epoch) == (48, 48, 6)
    torch.testing.assert_close(tr2.grid_state.bitfield, tr.grid_state.bitfield)
    assert tr2.evaluate_one_epoch(val_ds, save_images=False) == pytest.approx(psnr, abs=1e-4)


def test_main_nerf_cli_on_cpu(sphere_scene, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = [sphere_scene, "-O", "--bound", "1", "--scale", "0.5", "--dt_gamma", "0",
            "--min_near", "0.05", "--num_rays", "256", "--iters", "16", "--max_steps", "64",
            "--train_samples_per_ray", "16", "--infer_samples_per_ray", "32",
            "--log2_hashmap_size", "10", "--grid_levels", "4", "--eval_interval", "1"]
    tr = tmain.main(argv, device="cpu", mesh_resolution=24)
    assert tr.global_step == 16 and tr.spec.fp16
    assert (tmp_path / "results" / "workspace" / "version_1" / "results").is_dir()
    # the CLI ends with the mesh export: a PLY that parses, vertices inside the box
    verts, faces = read_ply(tmp_path / "results" / "workspace" / "version_1" / "meshes" /
                            f"ngp_{tr.epoch}.ply")
    assert np.abs(verts).max(initial=0.0) <= 1.0 and faces.max(initial=-1) < len(verts)
    # several devices run in spawned ranks (tests/test_torch_parallel.py); a batch that
    # does not split into them raises before any starts (JAX's num_rays % n_devices)
    with pytest.raises(ValueError, match="n_devices"):
        tmain.main(argv + ["--n_devices", "3"], device="cpu")
    # the option whose path is not ported still raises (-O2: test_torch_recipes.py)
    with pytest.raises(NotImplementedError, match="rand_pose"):
        tmain.main(argv + ["--rand_pose", "0"], device="cpu")
    # the options this CLI runs since the background net, the patch loss and the linear
    # colour space were ported construct their trainer (runs: test_torch_background.py)
    cfg = _sphere_cfg(sphere_scene, bg_radius=4.0, patch_size=4, lambda_lpips=0.1,
                      color_space="linear")
    tr = TTrainer("ngp", cfg, tnerf.NeRFSpec.build(bound=1.0, bg_radius=4.0),
                  workspace=str(tmp_path / "ported"), use_checkpoint="scratch", mute=True,
                  device="cpu")
    assert tr.host_sampled() and tr._rlpips_kernels is not None and "bg_net" in tr.params


def test_main_nerf_cli_with_hierarchical_march_and_eval_compaction(sphere_scene, tmp_path,
                                                                    monkeypatch):
    """The opt-in render flags reach the trainer: it trains and evaluates with the
    hierarchical march and the compacted eval renders."""
    monkeypatch.chdir(tmp_path)
    argv = [sphere_scene, "--bound", "1", "--scale", "0.5", "--dt_gamma", "0",
            "--min_near", "0.05", "--num_rays", "256", "--iters", "16", "--max_steps", "64",
            "--train_samples_per_ray", "16", "--infer_samples_per_ray", "32",
            "--log2_hashmap_size", "10", "--grid_levels", "4", "--eval_interval", "1",
            "--march_groups", "2", "--eval_compact_frac", "0.5"]
    tr = tmain.main(argv, device="cpu", mesh_resolution=16)
    assert tr.global_step == 16 and np.isfinite(tr.stats["loss"]).all()
    assert tr.train_settings.march_groups == tr.eval_settings.march_groups == 2
    assert tr.eval_settings.compact_frac == 0.5 and tr.train_settings.compact_frac == 0.0
    assert len(tr.stats["results"]) >= tr.epoch and tr.last_compact_overflow is not None
    # a frame whose budget dropped samples says so in the log, once per frame
    warned = "compact budget overflow" in open(tr.log_path).read()
    assert warned == (tr.last_compact_overflow > 0)


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = TConfig(**CFG_KW)
    with pytest.raises(RuntimeError, match="CUDA"):
        TTrainer("ngp", cfg, tnerf.NeRFSpec.build(**SPEC_KW), workspace="unused",
                 use_checkpoint="scratch", mute=True)
