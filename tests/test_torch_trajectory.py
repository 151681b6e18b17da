"""Both packages' trainers over whole epochs: the same scene, the same initial weights and
the same random draws through the JAX package's ``Trainer.train`` (``train_one_epoch_fast``
and its scanned steps, ``_scan_steps`` / ``_scan_steps_palette``) and through the port's
``Trainer.train`` (``train_one_epoch`` and its device-sampled epoch).

Draws. The JAX trainer draws from its key chain: per scanned run of
``update_extra_interval`` steps one key for the grid refresh and one for the scan, per step
``split(key, 4)`` into the pixel indices, the background and the render's key (march
jitter, the palette's smooth jitter, the ``-O2`` encode draws); the epoch's order comes from
NumPy's global generator (seeded here). The test records the keys the JAX trainer hands to
its jitted functions (wrappers on the instance's attributes; nothing of the JAX package is
edited), derives every draw from them as the JAX functions do, and replays them to the port
through its draw source (``Trainer.train(..., draws=...)``).

Exact checks: the steps at which the grid is refreshed, full or which 1/4 slab; the optax
update count of every step and its lr; the palette stage's ``freeze_basis_color``,
``require_smooth_loss``, ``lambda_weight`` and ``lambda_palette`` at every step.

Numeric checks, and why the single-step tolerances grow over an epoch. One step agrees to
a loss rtol of 1e-5 and parameters within 1e-6, one entry in 20 of a tensor excepted
(``tests/test_torch_train.py``): Adam moves every entry by about +-lr, so an entry whose
gradient is near zero takes its sign from the gradient's last bits, which differ between
the packages (the order of an f32 sum, a bf16 rounding of a table update). From the second
step on those entries feed back into every later step, the network's, the renders' and the
grid's, so the packages move apart as the steps add up, and no bound short of lr per step
holds for every entry. The file holds:

- the loss of each step of the first run (``EARLY`` steps, one refresh) to rtol 1e-4, ten
  times the single step's, and every step's loss to rtol 1e-3 (``LOSS_RTOL``; the largest
  seen at this size is 5e-5), with ``-O2`` to 5e-2 (``LOSS_RTOL_O2``): its stochastic
  trilerp picks one corner per sample by a uniform draw against the trilinear weight, and a
  weight that differs in its last bits flips a pick (1.4e-2 seen once in 40 steps);
- every parameter tensor and its EMA: the median |difference| of its entries within
  ``PARAM_MEDIAN`` (0.05 lr), the mean within ``PARAM_MEAN`` (0.1 lr) (the largest seen:
  1.3e-4 and 2.2e-4, ``-O2``), and no entry off by more than lr per step taken;
- the density grid's cells above 1e-2 within rtol ``GRID_RTOL`` (2e-2; 5.5e-3 seen),
  ``mean_density`` to the same, and the bitfield equal except at cells whose density, in
  either package, lies within ``THRESH_BAND`` (5%) of the threshold ``min(mean_density,
  density_thresh)`` (one such cell seen, ``-O2``).

A departure of the loop (a refresh at another step, another slab, another image order,
another schedule flag or lr) fails the exact checks first.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.config import Config as JConfig
from palettenerf_tpu.data.provider import NeRFDataset as JDataset
from palettenerf_tpu.models import nerf as jnerf
from palettenerf_tpu.models import palette as jpal
from palettenerf_tpu.train.palette_trainer import PaletteTrainer as JPaletteTrainer
from palettenerf_tpu.train.trainer import Trainer as JTrainer
from palettenerf_torch.config import Config as TConfig
from palettenerf_torch.data.provider import NeRFDataset as TDataset
from palettenerf_torch.models import mlp as tmlp
from palettenerf_torch.models import nerf as tnerf
from palettenerf_torch.models import palette as tpal
from palettenerf_torch.ops.hashgrid_fast import EncodeRand
from palettenerf_torch.train import checkpoint as tckpt
from palettenerf_torch.train import trainer as ttrainer
from palettenerf_torch.train.palette_trainer import PaletteTrainer as TPaletteTrainer
from synthetic import make_sphere_dataset
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "data_proc", "proc_toys_llff")
FF_FIXTURE = os.path.join(REPO, "data_proc", "proc_toys_ff")

LR = 1e-2
EARLY = 4
LOSS_RTOL_EARLY = 1e-4
LOSS_RTOL = 1e-3
LOSS_RTOL_O2 = 5e-2
PARAM_MEDIAN = 0.05 * LR
PARAM_MEAN = 0.1 * LR
GRID_RTOL = 2e-2
THRESH_BAND = 0.05

# B = 10 training views and runs of 4 steps: 4 + 4 + 2 per epoch, so the refreshes restart
# at each epoch's first step; full refreshes below step 8, 1/4 slabs after. Steps 8 and 10
# (the last run of epoch 1, the first of epoch 2) both take slab 10 // 4 = 2, as steps 96
# and 100 do on proc_toys' 100 views with runs of 16
SPHERE = dict(O=True, fp16=True, bound=1.0, scale=0.5, dt_gamma=0.0, min_near=0.05,
              num_rays=192, iters=30, max_steps=96, grid_size=16, train_samples_per_ray=32,
              infer_samples_per_ray=64, lambda_sparse=0.0, log2_hashmap_size=12,
              grid_levels=6, update_extra_interval=4, grid_update_warmup=8, seed=0, lr=LR)
SPEC = dict(bound=1.0, fp16=True, log2_hashmap_size=12, grid_levels=6)
STAGE1 = {
    "O": ({}, {}),
    "O_fast_grad": ({"fast_grad": True}, {"fast_grad": True}),
    # -O2 on 6 levels: half of them take the gradient, as --grad_levels 8 of 16 does
    "O2": (dict(O2=True, fast_grad=True, stochastic_trilerp=True, grad_levels=3),
           dict(fast_grad=True, stochastic_trilerp=True, grad_levels=3)),
}
EPOCHS = 3
# the mip360 recipe (scripts/run_mip360.sh; tests/test_torch_real_scene.py) on five views
# of the LLFF fixture: bound 2, two cascades, --no_bg, --filter_close_point; runs of 2
# steps (2 + 2 + 1), slabs from step 4
MIP360 = dict(O=True, fp16=True, bound=2.0, scale=0.16, offset=(0.0, 0.0, 0.0), bg_radius=0.0,
              density_thresh=10.0, lambda_sparse=0.0, min_near=0.2, no_bg=True,
              filter_close_point=True, grid_size=16, num_rays=192, max_steps=128,
              train_samples_per_ray=64, infer_samples_per_ray=64, iters=15, seed=0,
              log2_hashmap_size=12, grid_levels=4, update_extra_interval=2,
              grid_update_warmup=4, lr=LR)
MIP360_SPEC = dict(bound=2.0, fp16=True, log2_hashmap_size=12, grid_levels=4)
MIP360_EPOCHS = 3
# the LLFF recipe (scripts/run_llff.sh with configs_llff/fern.sh) on five views of the
# forward-facing fixture: bound 2, two cascades, --offset 0 0 1.5 (the cameras inside the
# box), --min_near 0.02, --lambda_sparse 0.05, --no_bg; runs of 2 steps as mip360's
LLFF = dict(MIP360, scale=0.25, offset=(0.0, 0.0, 1.5), lambda_sparse=0.05, min_near=0.02,
            filter_close_point=False)
# the palette stage at -O --fast_grad, warm-started from the O_fast_grad case's JAX
# stage-1 checkpoint: the colours frozen in epoch 1, unfrozen from epoch 2, the smooth loss
# from epoch 3; lambda_weight decays to 0 by epoch 4
PALETTE = dict(SPHERE, use_initialization_from_rgbxy=True, max_freeze_palette_epoch=1,
               smooth_loss_start_epoch=2, lweight_decay_epoch=4, update_extra_interval=5,
               iters=30)
PALETTE_EPOCHS = 3
BC = np.array([[0.9, 0.5, 0.1], [0.2, 0.8, 0.3], [0.2, 0.3, 0.9], [0.8, 0.8, 0.8]], np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------- JAX's draws

def step_draws_fn(n, hw, spec, samples, palette):
    """key -> (the next step's key, that step's draws), jitted: the scan body's split of its
    carry into the pixel indices, the background and the render's key, and the render's
    split of that into the march jitter, [the palette's smooth jitter], the encode draws."""
    def draw(key):
        key, k_pix, k_bg, k_render = jax.random.split(key, 4)
        out = {"inds": jax.random.randint(k_pix, (n,), 0, hw),
               "bg": jax.random.uniform(k_bg, (n, 3))}
        if palette:
            k_noise, k_smooth, k_enc = jax.random.split(k_render, 3)
            out["jit_u"] = jax.random.uniform(k_smooth, (n * samples, 3))
        else:
            k_noise, k_enc = jax.random.split(k_render)
        out["noise"] = jax.random.uniform(k_noise, (n,))
        rand = jnerf.encode_rand_for(k_enc, spec, n * samples)
        if rand is not None:
            out["enc_u"] = rand.u
            if rand.lvls is not None:
                out["enc_lvls"] = rand.lvls
        return key, out

    return jax.jit(draw)


class StepDraws:
    """One step's draws (``step_draws_fn``'s) as the port's tensors."""

    def __init__(self, out):
        self.inds = T(out["inds"]).long()
        self.bg, self.noise = T(out["bg"]), T(out["noise"])
        self.jit_u = T(out["jit_u"]) if "jit_u" in out else None
        self.rand = None
        if "enc_u" in out:
            self.rand = EncodeRand(u=T(out["enc_u"]), lvls=(
                T(out["enc_lvls"]).long() if "enc_lvls" in out else None))


class ReplayDraws:
    """The port's draw source for a replay of the JAX trainer's draws, in the order the
    port asks for them. A refresh or an epoch order the JAX trainer did not make is noted
    in ``departures`` and served from a fixed NumPy generator, so that the run ends and the
    schedule checks say what departed."""

    def __init__(self, orders, refreshes, steps):
        self.orders, self.refreshes, self.steps = list(orders), list(refreshes), list(steps)
        self.departures = []
        self.cur = None
        self._rng = np.random.default_rng(0)

    def order(self, n):
        if not self.orders:
            self.departures.append(("order", n))
            return self._rng.permutation(n).tolist()
        return self.orders.pop(0)

    def refresh_noise(self, shape):
        if self.refreshes and tuple(self.refreshes[0].shape) == tuple(shape):
            return self.refreshes.pop(0)
        self.departures.append(("refresh", tuple(shape)))
        if self.refreshes:
            self.refreshes.pop(0)
        return T(self._rng.uniform(-1, 1, shape).astype(np.float32))

    def pixels(self, n, high):
        self.cur = self.steps.pop(0)
        assert self.cur.inds.shape[0] == n and int(self.cur.inds.max()) < high
        return self.cur.inds

    def background(self, n):
        return self.cur.bg

    def jitter(self, n):
        return self.cur.noise

    def smooth_jitter(self, rows):
        return self.cur.jit_u

    def encode(self, spec, rows):
        return self.cur.rand


# --------------------------------------------------------------------------- recording

def _opt_count(opt_state):
    """optax's update count (the schedule's step) in an ``optax.adam`` state."""
    return int(jax.tree_util.tree_leaves(opt_state)[0])


def record_jax(jtr, palette=False):
    """Wrap the JAX trainer instance's refresh and scan attributes; returns the record:
    ``refresh`` [(global_step, "full" | slab)], ``refresh_keys`` [(key, shape)], ``scans``
    [(key, img_idx, first update count, palette flags or None, epoch)], ``losses``."""
    rec = {"refresh": [], "refresh_keys": [], "scans": [], "losses": []}
    cells = jtr.opt.grid_size ** 3
    cascade = int(jtr.grid_state.density_grid.shape[0])
    if not palette:
        full, part = jtr._update_grid, jtr._update_grid_partial

        def update_grid(params, gs, key):
            rec["refresh"].append((jtr.global_step, "full"))
            rec["refresh_keys"].append((key, (cascade, cells, 3)))
            return full(params, gs, key)

        def update_grid_partial(params, gs, key, slab):
            rec["refresh"].append((jtr.global_step, int(slab) % 4))
            rec["refresh_keys"].append((key, (cascade, cells // 4, 3)))
            return part(params, gs, key, slab)

        jtr._update_grid, jtr._update_grid_partial = update_grid, update_grid_partial
    name = "_scan_steps_palette" if palette else "_scan_steps"
    scan = getattr(jtr, name)

    def scan_steps(*a):
        idx = np.asarray(a[8] if palette else a[7]).tolist()
        flags = None
        if palette:
            flags = (bool(a[14]), bool(a[15]), float(a[9]), float(a[10]))
        rec["scans"].append((a[4], idx, _opt_count(a[1]), flags, jtr.epoch))
        out = scan(*a)
        rec["losses"].extend(np.asarray(out[3]).tolist())
        return out

    setattr(jtr, name, scan_steps)
    return rec


def jax_lrs(opt, counts):
    """The lr optax's schedule (JAX trainer.py:139) gives the updates of these counts."""
    return [float(opt.lr * (0.1 ** jnp.minimum(jnp.float32(c) / opt.iters, 1.0)))
            for c in counts]


def replay_for(rec, n, hw, spec, samples, B, palette=False):
    """The port's ReplayDraws of a JAX record."""
    orders, cur = [], []
    for _, idx, _, _, _ in rec["scans"]:
        cur.extend(idx)
        if len(cur) == B:
            orders.append(cur)
            cur = []
    assert not cur
    refreshes = [T(jax.random.uniform(k, shape, minval=-1.0, maxval=1.0))
                 for k, shape in rec["refresh_keys"]]
    draw, steps = step_draws_fn(n, hw, spec, samples, palette), []
    for key, idx, _, _, _ in rec["scans"]:
        for _ in idx:
            key, out = draw(key)
            steps.append(StepDraws(out))
    return ReplayDraws(orders, refreshes, steps)


def record_port(ttr, monkeypatch):
    """Record the port trainer's refreshes (from its calls of ``update_density_grid``),
    step losses, lr and palette flags of every update."""
    rec = {"refresh": [], "losses": [], "lrs": [], "flags": []}
    update = ttrainer.update_density_grid

    def update_density_grid(state, fn, partial_fraction=1, slab_index=0, **kw):
        rec["refresh"].append((ttr.global_step, "full" if partial_fraction <= 1
                               else slab_index % partial_fraction))
        return update(state, fn, partial_fraction=partial_fraction, slab_index=slab_index,
                      **kw)

    monkeypatch.setattr(ttrainer, "update_density_grid", update_density_grid)
    step = ttr.train_step

    def train_step(*a, **kw):
        if hasattr(ttr, "freeze_basis_color"):
            rec["flags"].append((ttr.freeze_basis_color, ttr.require_smooth_loss,
                                 ttr.lambda_weight, ttr.lambda_palette))
        out = step(*a, **kw)
        rec["losses"].append(float(out[0]))
        return out

    ttr.train_step = train_step
    ttr.optimizer.register_step_pre_hook(
        lambda o, args, kwargs: rec["lrs"].append(o.param_groups[0]["lr"]))
    return rec


# --------------------------------------------------------------------------- the runs

def _datasets(cfg):
    jds, tds = JDataset(JConfig(**cfg), type="train"), TDataset(TConfig(**cfg), type="train")
    np.testing.assert_array_equal(tds.images, jds.images)
    np.testing.assert_array_equal(tds.poses, jds.poses)
    return jds, tds


def _stage1_run(tmp, cfg, spec_kw, epochs, monkeypatch):
    jspec, tspec = jnerf.NeRFSpec.build(**spec_kw), tnerf.NeRFSpec.build(**spec_kw)
    jds, tds = _datasets(cfg)
    jparams = jnerf.init_nerf(jax.random.PRNGKey(1), jspec)
    tparams = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    jtr = JTrainer("ngp", JConfig(**cfg), jspec, params=jparams, workspace=str(tmp / "jax"),
                   use_checkpoint="scratch", mute=True)
    assert jtr.supports_fast_path(jds)
    jrec = record_jax(jtr)
    np.random.seed(0)  # the JAX epoch's order: np.random.permutation
    jtr.train(jds, None, epochs)

    ttr = ttrainer.Trainer("ngp", TConfig(**cfg), tspec, params=tparams,
                           workspace=str(tmp / "torch"), use_checkpoint="scratch", mute=True,
                           device="cpu")
    assert not ttr.host_sampled()
    trec = record_port(ttr, monkeypatch)
    draws = replay_for(jrec, cfg["num_rays"], tds.H * tds.W, jspec,
                       cfg["train_samples_per_ray"], len(tds.poses))
    ttr.train(tds, None, epochs, draws=draws)
    trec["departures"] = draws.departures
    return jtr, ttr, jrec, trec


def _five_views(tmp_path_factory, fixture=FIXTURE, step=5):
    """Five training views of a JPEG fixture (frames 0, step, ..., 4 step of its train
    split) as a scene of their own."""
    root = tmp_path_factory.mktemp("trajectory_" + os.path.basename(fixture))
    with open(os.path.join(fixture, "transforms_train.json")) as f:
        meta = json.load(f)
    meta["frames"] = [dict(fr, file_path=os.path.join(fixture, fr["file_path"]))
                      for fr in meta["frames"][::step][:5]]
    for split in ("train", "val", "test"):
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump(meta, f)
    return str(root)


class Runs:
    """Each case's run, (cfg, JAX trainer, port trainer, JAX record, port record), made at
    its first use and kept for the module's tests."""

    def __init__(self, tmp_path_factory):
        self.tmp = tmp_path_factory
        self.done = {}
        self._scene = None

    def sphere(self):
        if self._scene is None:
            self._scene = make_sphere_dataset(str(self.tmp.mktemp("trajectory_sphere")),
                                              n_train=10, n_val=1, n_test=1, H=32, W=32)
        return self._scene

    def __getitem__(self, case):
        if case not in self.done:
            self.done[case] = self._palette() if case == "palette" else self._stage1(case)
        return self.done[case]

    def _stage1(self, case):
        if case == "mip360":
            cfg = dict(MIP360, path=_five_views(self.tmp))
            spec_kw, epochs = MIP360_SPEC, MIP360_EPOCHS
        elif case == "llff":
            cfg = dict(LLFF, path=_five_views(self.tmp, FF_FIXTURE, 4))
            spec_kw, epochs = MIP360_SPEC, MIP360_EPOCHS
        else:
            cfg_kw, spec_extra = STAGE1[case]
            cfg = dict(SPHERE, path=self.sphere(), **cfg_kw)
            spec_kw, epochs = dict(SPEC, **spec_extra), EPOCHS
        with pytest.MonkeyPatch.context() as mp:
            return (cfg,) + _stage1_run(self.tmp.mktemp(f"trajectory_{case}"), cfg, spec_kw,
                                        epochs, mp)

    def _palette(self):
        """Warm-started in both packages from the O_fast_grad case's JAX stage-1
        checkpoint."""
        nerf_ws = self["O_fast_grad"][1].workspace
        cfg = dict(PALETTE, path=self.sphere(), fast_grad=True)
        kw = dict(SPEC, fast_grad=True, num_basis=len(BC))
        jspec, tspec = jpal.PaletteSpec.build(**kw), tpal.PaletteSpec.build(**kw)
        jds, tds = _datasets(cfg)
        hist = np.random.default_rng(2).uniform(size=(32, 32, 32, len(BC))).astype(np.float32)
        hist /= hist.sum(-1, keepdims=True)
        jparams = jpal.init_palette(jax.random.PRNGKey(3), jspec)
        tparams = tckpt.palette_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
        tmp = self.tmp.mktemp("trajectory_palette")
        jtr = JPaletteTrainer("palette", JConfig(**cfg), jspec, params=jparams,
                              workspace=str(tmp / "jax"), use_checkpoint="scratch", mute=True,
                              nerf_path=nerf_ws)
        jtr.initialize_palette(BC, hist)
        assert jtr.supports_fast_path(jds)
        jrec = record_jax(jtr, palette=True)
        np.random.seed(1)
        jtr.train(jds, None, PALETTE_EPOCHS)
        with pytest.MonkeyPatch.context() as mp:
            ttr = TPaletteTrainer("palette", TConfig(**cfg), tspec, params=tparams,
                                  workspace=str(tmp / "torch"), use_checkpoint="scratch",
                                  mute=True, device="cpu", nerf_path=nerf_ws)
            ttr.initialize_palette(BC, hist)
            assert not ttr.host_sampled()
            trec = record_port(ttr, mp)
            draws = replay_for(jrec, cfg["num_rays"], tds.H * tds.W, jspec,
                               cfg["train_samples_per_ray"], len(tds.poses), palette=True)
            ttr.train(tds, None, PALETTE_EPOCHS, draws=draws)
        trec["departures"] = draws.departures
        return cfg, jtr, ttr, jrec, trec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return Runs(tmp_path_factory)


CASES = ["O", "O_fast_grad", "O2", "palette", "mip360", "llff"]


# --------------------------------------------------------------------------- exact checks

@pytest.mark.parametrize("case", [c for c in CASES if c != "palette"])
def test_refresh_schedule_matches(case, runs):
    """The steps at which the grid is refreshed, full or which slab, element for element:
    both kinds occur, the refreshes restart at every epoch's first step, and a slab repeats
    across an epoch boundary."""
    cfg, jtr, ttr, jrec, trec = runs[case]
    assert trec["refresh"] == jrec["refresh"]
    assert trec["departures"] == []
    kinds = [k for _, k in jrec["refresh"]]
    assert "full" in kinds and set(kinds) & {0, 1, 2, 3}
    B, interval = len(ttr._dev_poses), cfg["update_extra_interval"]
    assert B % interval != 0
    assert len(kinds) == -(-B // interval) * ttr.epoch
    assert {s for s, _ in jrec["refresh"]} >= {e * B for e in range(ttr.epoch)}
    assert any(a == b != "full" for a, b in zip(kinds, kinds[1:]))


@pytest.mark.parametrize("case", CASES)
def test_lr_and_count_of_every_update_match(case, runs):
    """Every update's place in the lr schedule: the port's lr equals what optax's
    schedule gives the JAX trainer's update count (f32 rounding of one pow apart)."""
    cfg, jtr, ttr, jrec, trec = runs[case]
    counts = [c + j for _, idx, c, _, _ in jrec["scans"] for j in range(len(idx))]
    assert counts == list(range(len(counts))) and len(trec["lrs"]) == len(counts)
    assert ttr.opt_step == len(counts) and ttr.global_step == jtr.global_step
    np.testing.assert_allclose(trec["lrs"], jax_lrs(jtr.opt, counts), rtol=1e-6, atol=0)


def test_palette_schedule_flags_match(runs):
    """``freeze_basis_color``, ``require_smooth_loss``, ``lambda_weight`` and
    ``lambda_palette`` at every step, across the unfreeze and the smooth-loss start."""
    cfg, jtr, ttr, jrec, trec = runs["palette"]
    want = [flags for _, idx, _, flags, _ in jrec["scans"] for _ in idx]
    got = [(f, s, np.float32(lw), np.float32(lp)) for f, s, lw, lp in trec["flags"]]
    assert got == [(f, s, np.float32(lw), np.float32(lp)) for f, s, lw, lp in want]
    assert {(f, s) for f, s, _, _ in want} == {(True, False), (False, False), (False, True)}
    assert trec["departures"] == []


# --------------------------------------------------------------------------- numeric checks

@pytest.mark.parametrize("case", CASES)
def test_step_losses_match(case, runs):
    cfg, jtr, ttr, jrec, trec = runs[case]
    got, want = np.asarray(trec["losses"]), np.asarray(jrec["losses"])
    assert got.shape == want.shape == (ttr.global_step,)
    rtol = LOSS_RTOL_O2 if case == "O2" else LOSS_RTOL
    np.testing.assert_allclose(got[:EARLY], want[:EARLY], rtol=LOSS_RTOL_EARLY)
    np.testing.assert_allclose(got, want, rtol=rtol)
    np.testing.assert_allclose(ttr.stats["loss"], jtr.stats["loss"], rtol=rtol)


def _param_pairs(case, got, tree):
    """(name, port tensor, JAX leaf as a tensor) over every leaf of the port's dict."""
    ref = (tckpt.palette_params_from_jax if case == "palette" else tckpt.params_from_jax)(
        jax.tree_util.tree_map(np.asarray, tree))
    names = [f"{k}[{i}]" for k, v in got.items() for i in range(len(tmlp.param_leaves({k: v})))]
    return zip(names, tmlp.param_leaves(got), tmlp.param_leaves({k: ref[k] for k in got}))


@pytest.mark.parametrize("case", CASES)
def test_params_and_ema_match(case, runs):
    cfg, jtr, ttr, jrec, trec = runs[case]
    steps = ttr.global_step
    for kind, tparams, jparams in (("params", ttr.params, jtr.params),
                                   ("ema", ttr.ema_params, jtr.ema_params)):
        for name, p, p_ref in _param_pairs(case, tparams, jparams):
            diff = (p.detach().float() - p_ref.float()).abs().flatten()
            msg = f"{kind} {name}: median {float(diff.median())}, mean {float(diff.mean())}"
            assert float(diff.median()) <= PARAM_MEDIAN, msg
            assert float(diff.mean()) <= PARAM_MEAN, msg
            assert float(diff.max()) <= LR * steps + 1e-6, msg


@pytest.mark.parametrize("case", [c for c in CASES if c != "palette"])
def test_density_grid_and_bitfield_match(case, runs):
    cfg, jtr, ttr, jrec, trec = runs[case]
    got = ttr.grid_state.density_grid.numpy()
    want = np.asarray(jtr.grid_state.density_grid)
    np.testing.assert_array_equal(got < 0, want < 0)  # the marked cells
    live = (want > 1e-2) | (got > 1e-2)
    np.testing.assert_allclose(got[live], want[live], rtol=GRID_RTOL)
    md_t, md_j = float(ttr.grid_state.mean_density), float(jtr.grid_state.mean_density)
    assert md_t == pytest.approx(md_j, rel=GRID_RTOL)
    assert int(ttr.grid_state.iter_density) == int(jtr.grid_state.iter_density)
    thresh_t, thresh_j = (min(md, cfg.get("density_thresh", 10.0)) for md in (md_t, md_j))
    bits_t = np.unpackbits(ttr.grid_state.bitfield.numpy(), bitorder="little")
    bits_j = np.unpackbits(np.asarray(jtr.grid_state.bitfield), bitorder="little")
    near = ((np.abs(got.reshape(-1) - thresh_t) <= THRESH_BAND * thresh_t)
            | (np.abs(want.reshape(-1) - thresh_j) <= THRESH_BAND * thresh_j))
    assert bits_j.any() and not bits_j.all()
    np.testing.assert_array_equal(bits_t[~near], bits_j[~near])


def test_palette_keeps_the_stage1_grid_and_density_half(runs):
    """The palette stage refreshes nothing, and its density half stays stage 1's."""
    cfg, jtr, ttr, jrec, trec = runs["palette"]
    assert trec["refresh"] == [] and jrec["refresh"] == []
    np.testing.assert_array_equal(ttr.grid_state.bitfield.numpy(),
                                  np.asarray(jtr.grid_state.bitfield))
    ref = tckpt.palette_params_from_jax(jax.tree_util.tree_map(np.asarray, jtr.params))
    torch.testing.assert_close(ttr.params["encoder"], ref["encoder"], rtol=0, atol=0)


def test_host_epoch_refresh_schedule_matches(runs, tmp_path_factory, monkeypatch):
    """The host-sampled epoch (``--error_map``) keeps the JAX host epoch's rule: a refresh
    before every step whose ``global_step`` is a multiple of ``update_extra_interval``
    (JAX trainer.py:466), across the epoch boundaries. The schedule does not depend on the
    draws or the precision, so both packages run f32 here."""
    cfg = dict(SPHERE, path=runs.sphere(), fp16=False, error_map=True,
               num_rays=64, train_samples_per_ray=16)
    spec_kw = dict(SPEC, fp16=False)
    jspec, tspec = jnerf.NeRFSpec.build(**spec_kw), tnerf.NeRFSpec.build(**spec_kw)
    jds, tds = _datasets(cfg)
    jparams = jnerf.init_nerf(jax.random.PRNGKey(1), jspec)
    tparams = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    tmp = tmp_path_factory.mktemp("trajectory_host")
    jtr = JTrainer("ngp", JConfig(**cfg), jspec, params=jparams, workspace=str(tmp / "jax"),
                   use_checkpoint="scratch", mute=True)
    assert not jtr.supports_fast_path(jds)
    jrec = record_jax(jtr)
    jtr.train(jds, None, EPOCHS)
    ttr = ttrainer.Trainer("ngp", TConfig(**cfg), tspec, params=tparams,
                           workspace=str(tmp / "torch"), use_checkpoint="scratch", mute=True,
                           device="cpu")
    assert ttr.host_sampled()
    trec = record_port(ttr, monkeypatch)
    ttr.train(tds, None, EPOCHS)
    interval = cfg["update_extra_interval"]
    assert trec["refresh"] == jrec["refresh"]
    assert [s for s, _ in trec["refresh"]] == list(range(0, ttr.global_step, interval))


def _grid_numbers(grid_state, bitfield) -> tuple:
    """(occupied cells of the bitfield, mean density) of a trainer's grid."""
    bits = np.unpackbits(np.asarray(bitfield), bitorder="little")
    return int(bits.sum()), float(grid_state.mean_density)


def main(argv=None):
    """The ``-O --fast_grad`` stage-1 case for more epochs than the tests take, on the CPU:
    ``PYTHONPATH=. python tests/test_torch_trajectory.py --epochs 30`` (300 steps, ~1 min)
    prints the step losses' drift by epoch, each tensor's drift, both packages' occupied cells and mean
    density every ``--every`` epochs (10: every 100 steps), and both packages' val PSNR
    (the EMA weights, the sphere's val view), and the port's render of JAX's final state
    against JAX's frame."""
    import argparse
    import pathlib
    import sys
    import tempfile

    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--every", type=int, default=10)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    root = pathlib.Path(tempfile.mkdtemp(prefix="trajectory_"))

    class Factory:
        def mktemp(self, name):
            return pathlib.Path(tempfile.mkdtemp(prefix=name, dir=root))

    cfg = dict(SPHERE, path=Runs(Factory()).sphere(), fast_grad=True,
               iters=10 * args.epochs)
    spec_kw = dict(SPEC, fast_grad=True)
    # _stage1_run's two runs, each in stretches of --every epochs to read the grids
    jspec, tspec = jnerf.NeRFSpec.build(**spec_kw), tnerf.NeRFSpec.build(**spec_kw)
    jds, tds = _datasets(cfg)
    jparams = jnerf.init_nerf(jax.random.PRNGKey(1), jspec)
    tparams = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    jtr = JTrainer("ngp", JConfig(**cfg), jspec, params=jparams, workspace=str(root / "jax"),
                   use_checkpoint="scratch", mute=True)
    jrec = record_jax(jtr)
    np.random.seed(0)
    marks = list(range(args.every, args.epochs, args.every)) + [args.epochs]
    t0, grids = time.perf_counter(), {}
    for e in marks:
        jtr.train(jds, None, e)
        grids[e] = [_grid_numbers(jtr.grid_state, jtr.grid_state.bitfield)]
    t_jax = time.perf_counter() - t0
    with pytest.MonkeyPatch.context() as mp:
        ttr = ttrainer.Trainer("ngp", TConfig(**cfg), tspec, params=tparams,
                               workspace=str(root / "torch"), use_checkpoint="scratch",
                               mute=True, device="cpu")
        trec = record_port(ttr, mp)
        draws = replay_for(jrec, cfg["num_rays"], tds.H * tds.W, jspec,
                           cfg["train_samples_per_ray"], len(tds.poses))
        t0 = time.perf_counter()
        for e in marks:
            ttr.train(tds, None, e, draws=draws)
            grids[e].append(_grid_numbers(ttr.grid_state, ttr.grid_state.bitfield.numpy()))
    t_port = time.perf_counter() - t0
    print(f"{10 * args.epochs} steps: JAX {t_jax:.0f} s, port {t_port:.0f} s")
    print("refresh schedule equal:", trec["refresh"] == jrec["refresh"], "departures:",
          draws.departures)
    for e in marks:
        (cj, dj), (ct, dt) = grids[e]
        print(f"step {10 * e}: occupied cells JAX {cj} port {ct}; mean density JAX {dj:.6f} "
              f"port {dt:.6f} (rel {abs(dt - dj) / max(abs(dj), 1e-12):.2e})")
    lj, lt = np.asarray(jrec["losses"]), np.asarray(trec["losses"])
    for e in range(0, args.epochs, args.every):
        s = slice(10 * e, 10 * (e + args.every))
        rel = (np.abs(lt[s] - lj[s]) / lj[s]).max()
        print(f"epochs {e + 1}-{e + args.every}: loss JAX {lj[s].mean():.6f} port "
              f"{lt[s].mean():.6f}, largest step rel diff {rel:.2e}")
    for name, p, p_ref in _param_pairs("O", ttr.params, jtr.params):
        d = (p.detach().float() - p_ref.float()).abs().flatten()
        print(f"{name}: |diff| median {float(d.median()):.2e} mean {float(d.mean()):.2e} "
              f"max {float(d.max()):.2e}")
    bits = [np.unpackbits(np.asarray(b), bitorder="little").astype(bool)
            for b in (ttr.grid_state.bitfield.numpy(), jtr.grid_state.bitfield)]
    print(f"bitfields differ in {(bits[0] != bits[1]).sum()} cells")
    print("val PSNR JAX", jtr.evaluate_one_epoch(JDataset(JConfig(**cfg), type="val"),
                                                 save_images=False),
          "port", ttr.evaluate_one_epoch(TDataset(TConfig(**cfg), type="val"),
                                         save_images=False))
    # the eval frame of JAX's own state through the port's render_image (one short chunk,
    # counted as JAX's padded 16,384-ray chunk; ROADMAP C21), against JAX's frame
    data = next(iter(TDataset(TConfig(**cfg), type="val").iter_epoch()))
    ref = jtr.eval_step_full(next(iter(JDataset(JConfig(**cfg), type="val").iter_epoch())))
    ttr.ema_params = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jtr.ema_params))
    ttr.grid_state = ttr.grid_state._replace(bitfield=T(jtr.grid_state.bitfield))
    t0 = time.perf_counter()
    img = ttr.render_image(data["rays_o"], data["rays_d"])["image"].reshape(ref["image"].shape)
    secs = time.perf_counter() - t0
    mse = float(((img - ref["image"]) ** 2).mean())
    print(f"port eval of JAX's state: {10 * np.log10(1 / max(mse, 1e-30)):.2f} dB from JAX's "
          f"frame, {secs:.2f} s")


if __name__ == "__main__":
    main()
