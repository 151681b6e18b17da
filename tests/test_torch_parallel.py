"""Ray data-parallel training of the port (``palettenerf_torch.parallel``, ``--n_devices``)
in two spawned ranks on the CPU (gloo), against the JAX package's device mesh and the
port's own single-process runs.

The rank bodies are in ``tests/torch_dp_workers.py`` (JAX-free: spawned ranks import
them). Tolerances: the sharded gradients against JAX's 8-device mesh rtol 1e-4, atol
1e-6 (``tests/test_parallel.py``'s own); the trainers' loss trajectories rtol 2e-3,
atol 2e-5 (``tests/test_trainer_dp_resume.py``'s: the same rays, the sums in another
order); the first step's loss rel 1e-5; the palette step's parameters as
``tests/test_torch_palette_train.py``'s ``_close_params`` (1e-4, one entry in twenty
allowed beyond it). The ranks' parameters, EMA and bitfields are compared bit for bit.
Every spawn has a deadline; the ranks are killed and the test fails when it passes.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.models.nerf import NeRFSpec as JNeRFSpec
from palettenerf_tpu.models.nerf import init_nerf as jinit_nerf
from palettenerf_tpu.ops.occupancy import packbits as jpackbits
from palettenerf_tpu.parallel.mesh import make_mesh, replicated, shard_batch
from palettenerf_tpu.render.nerf_renderer import RenderSettings as JRenderSettings
from palettenerf_tpu.render.nerf_renderer import render_nerf_train as jrender_nerf_train
from palettenerf_torch import main_nerf as tmain
from palettenerf_torch import main_palette as tmain_palette
from palettenerf_torch import parallel
from palettenerf_torch.models.mlp import param_leaves
from palettenerf_torch.train.checkpoint import params_from_jax
from synthetic import make_sphere_dataset
from torch_support import CPU_THREADS
import torch_dp_workers as workers

torch.set_num_threads(CPU_THREADS)
SPAWN_TIMEOUT_S = 120.0   # a whole two-rank run; far above what one takes here
WORLD = 2
TRAIN_KW = dict(bound=1.0, scale=0.5, dt_gamma=0.0, min_near=0.05, density_thresh=10.0,
                num_rays=256, iters=64, max_steps=64, grid_size=32, update_extra_interval=4,
                train_samples_per_ray=16, infer_samples_per_ray=32, lambda_sparse=0.0,
                seed=0, O=True, fp16=True, log2_hashmap_size=12, grid_levels=4)


def _spawn(fn, args, timeout_s=SPAWN_TIMEOUT_S):
    parallel.spawn(fn, WORLD, args=args, device="cpu", timeout_s=timeout_s,
                   collective_timeout_s=60.0)


def _results(out_dir):
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_scene")
    return make_sphere_dataset(str(root), n_train=4, n_val=1, n_test=1, H=32, W=32)


def test_sharded_grads_match_jax_mesh(tmp_path):
    """tests/test_parallel.py's setup: JAX's gradient on its 8-device mesh against the
    port's on two ranks, each with half the rays, summed by ``reduce_grads``."""
    spec = JNeRFSpec.build(bound=1.0, grid_levels=4, log2_hashmap_size=13)
    params = jinit_nerf(jax.random.PRNGKey(0), spec)
    bitfield = jpackbits(jnp.ones((64 ** 3,), jnp.uint8))
    settings = JRenderSettings(bound=1.0, cascade=1, grid_size=64, max_steps=64,
                               num_samples=16, min_near=0.05)
    n = 64 * 8
    rng = np.random.default_rng(0)
    ro = np.tile(np.array([[0, 0, -1.5]], np.float32), (n, 1))
    rd = rng.normal(size=(n, 3)) * 0.1 + [0, 0, 1]
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    gt = rng.uniform(0, 1, (n, 3)).astype(np.float32)

    def loss(p, ro, rd, gt):
        out = jrender_nerf_train(p, spec, bitfield, ro, rd, jax.random.PRNGKey(1), settings,
                                 bg_color=jnp.ones((3,), jnp.float32), rays_gt=gt,
                                 perturb=False)
        return ((out["image"] - gt) ** 2).mean()

    mesh = make_mesh(8)
    rep, shard = replicated(mesh), shard_batch(mesh)
    with mesh:
        step = jax.jit(jax.value_and_grad(loss), in_shardings=(rep, shard, shard, shard),
                       out_shardings=(rep, rep))
        l_ref, g_ref = step(jax.device_put(params, rep), *(
            jax.device_put(jnp.asarray(a), shard) for a in (ro, rd, gt)))
    g_ref = params_from_jax(jax.tree_util.tree_map(np.asarray, g_ref))

    inputs = str(tmp_path / "inputs.pt")
    torch.save({"params": params_from_jax(jax.tree_util.tree_map(np.asarray, params)),
                "ro": torch.from_numpy(ro), "rd": torch.from_numpy(rd),
                "gt": torch.from_numpy(gt)}, inputs)
    _spawn(workers.sharded_grads, (inputs, str(tmp_path)))
    r0, r1 = _results(str(tmp_path))
    assert r0["loss"] == pytest.approx(float(l_ref), rel=1e-5)
    assert r0["loss_bytes"] == 4   # its own storage, not a view of the gradients' buffer
    ref = param_leaves(g_ref)
    assert len(r0["grads"]) == len(ref)
    for a, b, r in zip(r0["grads"], r1["grads"], ref):
        assert torch.equal(a, b)   # the same sum on both ranks
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-4, atol=1e-6)


PALETTE_KW = dict(bound=1.0, scale=0.5, dt_gamma=0.0, min_near=0.05, num_rays=64, iters=4,
                  max_steps=32, grid_size=64, train_samples_per_ray=8,
                  infer_samples_per_ray=16, num_basis=4, seed=0, O=True, fp16=True,
                  grid_levels=4, log2_hashmap_size=13, random_size=4, lambda_patchsmooth=0.5)


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """The trainer runs of the tests below, each in one process and in one set of two
    ranks (started once): {name: (single-process result, [rank 0's, rank 1's])}."""
    root = tmp_path_factory.mktemp("dp_runs")
    plan = {"train": ("train_sphere", (dict(TRAIN_KW), 2)),
            "compact": ("train_sphere", (dict(TRAIN_KW, train_compact_frac=1.0,
                                              eval_compact_frac=0.05), 1)),
            "palette": ("palette_step", (PALETTE_KW,))}
    dp_runs = []
    for name, (body, args) in plan.items():
        for where in ("one", "dp"):
            os.makedirs(root / name / where)
        getattr(workers, body)(scene, str(root / name / "ws1"), str(root / name / "one"), *args)
        dp_runs.append((body, (scene, str(root / name / "ws"), str(root / name / "dp"), *args)))
    _spawn(workers.run_all, (dp_runs,))
    return {name: (torch.load(root / name / "one" / "rank0.pt"), _results(root / name / "dp"))
            for name in plan}


def test_two_rank_trainer_matches_one(runs):
    """Two epochs of the stage-1 trainer (4 steps each, a grid refresh every 4 steps):
    the ranks' loss trajectory is the single process's, and the ranks end with equal
    parameters, EMA and bitfields."""
    one, (r0, r1) = runs["train"]
    assert r0["global_step"] == r1["global_step"] == one["global_step"] == 8
    assert r0["steps"][0] == pytest.approx(one["steps"][0], rel=1e-5)
    for r in (r0, r1):
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=2e-3, atol=2e-5)
        np.testing.assert_allclose(r["steps"], one["steps"], rtol=2e-3, atol=2e-5)
    for k in ("params", "ema", "bitfield"):
        assert r0[k] == r1[k], k
    assert torch.equal(r0["table"], r1["table"])
    assert not torch.equal(r0["table"], torch.zeros_like(r0["table"]))


def test_two_rank_compacted_trainer_matches_one_without_overflow(runs):
    """``--train_compact_frac`` with a budget that holds every valid sample (no
    overflow): each rank packs its own rays into its half of the budget, and the run is
    the single process's (with overflow the two drop other samples: ROADMAP C15)."""
    one, (r0, r1) = runs["compact"]
    assert one["compact_overflow"] == r0["compact_overflow"] == r1["compact_overflow"] == [0]
    np.testing.assert_allclose(r0["steps"], one["steps"], rtol=2e-3, atol=2e-5)
    assert r0["params"] == r1["params"]


@pytest.mark.parametrize("run", ["train", "compact"])
def test_two_rank_eval_frame_is_the_single_process_frame(runs, run):
    """An eval frame rendered a whole chunk per rank and summed over the ranks equals,
    bit for bit, the frame the rank renders alone, in three chunks and in one (rank 1
    then renders none of its own); with ``--eval_compact_frac`` the dropped samples of
    the frame are counted as alone (the compact run's budget drops some)."""
    _, (r0, r1) = runs[run]
    assert r0["frames"].keys() == r1["frames"].keys() and len(r0["frames"]) == 2
    for chunk, (equal, (dropped, alone), frame) in r0["frames"].items():
        assert equal, chunk
        assert dropped == alone and r1["frames"][chunk][1] == (dropped, alone)
        assert bool(dropped) == (run == "compact"), (chunk, dropped)   # None: no budget
        assert r1["frames"][chunk][0] and r1["frames"][chunk][2] == frame


def test_two_rank_palette_step_matches_one(runs):
    """Two palette steps on ``--random_size`` batches with the patch-smooth term (pairs
    i, i + N/2 held on one rank), ``lambda_palette`` counted once: losses and parameters
    as the single process's; the ranks' parameters and EMA equal."""
    one, (r0, r1) = runs["palette"]
    assert r0["digest"] == r1["digest"]
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-5)
    for k, ref in one["params"].items():
        for got, want in zip(r0["params"][k], ref):
            diff = (got - want).abs()
            allowed = 0 if k == "basis_color" else max(1, got.numel() // 20)
            assert int((diff > 1e-4).sum()) <= allowed, (k, float(diff.max()))


def test_two_rank_palette_steps_stay_eager_and_count(runs):
    """A rank's palette steps run eagerly (on the card too: a rank's step is never
    captured) and count as the single process's: no replay, each rank its share of the
    rays, the ranks' march samples summing to the single process's."""
    one, (r0, r1) = runs["palette"]
    n = PALETTE_KW["num_rays"]
    assert one["counters"]["train.ray_count"] == 2 * n
    for r in (one, r0, r1):
        assert r["counters"]["train.graph.replays"] == 0
        assert "train.graph.captures" not in r["counters"]
    assert r0["counters"]["train.ray_count"] == r1["counters"]["train.ray_count"] == n
    assert (r0["counters"]["train.valid_samples"] + r1["counters"]["train.valid_samples"]
            == one["counters"]["train.valid_samples"] > 0)


def test_main_nerf_trains_on_two_ranks(scene, tmp_path, monkeypatch):
    """``main_nerf --n_devices 2`` spawns its ranks, trains, evaluates, tests and meshes;
    rank 0 alone writes the workspace (one log, one set of checkpoints and images)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the ranks' intra-op threads
    argv = [scene, "-O", "--bound", "1", "--scale", "0.5", "--dt_gamma", "0",
            "--min_near", "0.05", "--num_rays", "128", "--iters", "8", "--max_steps", "32",
            "--train_samples_per_ray", "16", "--infer_samples_per_ray", "16",
            "--log2_hashmap_size", "10", "--grid_levels", "4", "--eval_interval", "1",
            "--n_devices", "2"]
    assert tmain.main(argv, device="cpu", mesh_resolution=16) is None
    ws = tmp_path / "results" / "workspace" / "version_1"
    assert not (tmp_path / "results" / "workspace" / "version_2").exists()
    log = (ws / "log_ngp.txt").read_text()
    assert log.count("[epoch 2]") == 1 and "loss=" in log
    assert sorted(os.listdir(ws / "checkpoints")) == ["ngp.ckpt", "ngp_ep0001.ckpt",
                                                      "ngp_ep0002.ckpt"]
    assert len(os.listdir(ws / "validation")) == 2 and (ws / "meshes" / "ngp_2.ply").exists()
    # a batch that would not split: raised in the parent, before any rank starts (both CLIs)
    with pytest.raises(ValueError, match="num_rays"):
        tmain.main(argv[:-1] + ["3"], device="cpu")
    with pytest.raises(ValueError, match="num_rays"):
        tmain_palette.main([scene, "results/workspace"] + argv[1:-1] + ["3"], device="cpu")


def test_spawn_kills_ranks_on_failure_and_on_deadline():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank1"):
        _spawn(workers.fail_on_rank1, ())
    with pytest.raises(TimeoutError):
        _spawn(workers.hang, (), timeout_s=3.0)
    assert time.monotonic() - t0 < 60.0
    import multiprocessing as mp

    assert not [p for p in mp.active_children() if p.name.startswith("rank")]


def test_shards_split_batches_as_the_step_needs():
    """Contiguous blocks of whole patches; a paired batch's two halves alike; batches
    that would split a patch or a pair, or leave ranks unequal, raise."""
    groups = [parallel.RayGroup(r, 2, torch.device("cpu"), "gloo") for r in range(2)]
    a = np.arange(16)
    s0, s1 = (g.shard(16) for g in groups)
    assert list(s0.take(a)) == list(range(8)) and list(s1.take(a)) == list(range(8, 16))
    p0, p1 = (g.shard(16, paired=True) for g in groups)
    assert list(p1.take(a)) == [4, 5, 6, 7, 12, 13, 14, 15]
    t = torch.arange(32.0).reshape(16, 2)
    assert torch.equal(p1.take(t.reshape(-1)), t[[4, 5, 6, 7, 12, 13, 14, 15]].reshape(-1))
    assert torch.equal(p0.place(p0.take(t)) + p1.place(p1.take(t)), t)
    with pytest.raises(ValueError):
        groups[0].shard(16, patch=16)      # one patch of 16 rays for two ranks
    with pytest.raises(ValueError):
        groups[0].shard(18, paired=True)   # 9 pairs
    with pytest.raises(ValueError):
        parallel.check_batch(4096, 3)
    parallel.check_batch(4096, 2, patch_size=16)
    with pytest.raises(ValueError):
        parallel.check_batch(256, 2, patch_size=16)   # one patch
    with pytest.raises(RuntimeError, match="spawn"):
        parallel.group_for(2)   # not a rank
    assert parallel.group_for(1) is None
