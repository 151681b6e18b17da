"""The palette step captured into one CUDA graph and replayed (``train/step_graph.py``,
``PaletteTrainer.train_step``), and what it counts.

This file imports neither JAX nor the JAX package, so its card tests (marker ``cuda``) run
on a machine that has only PyTorch + CUDA:

    python -m pytest --noconftest -m cuda tests/test_torch_step_graph.py

On the CPU: the recorder's accounting of a capture, the graph cache's warm-up and keys,
and where a trainer's steps stay eager. On the card: replayed steps against eager ones
from the same weights and draws, across an epoch boundary, and an epoch of replays.
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

from palettenerf_torch.config import Config
from palettenerf_torch.models.mlp import init_mlp
from palettenerf_torch.models.palette import PaletteSpec, init_palette
from palettenerf_torch.ops import hashgrid_fast, scatter
from palettenerf_torch.train.palette_trainer import PaletteTrainer
from palettenerf_torch.train.step_graph import DeviceScalars, StepGraphs
from palettenerf_torch.utils import profiling
from portbench import compare
from torch_support import CPU_THREADS, cuda_device  # noqa: F401  (fixture)

torch.set_num_threads(CPU_THREADS)

PAL_KW = dict(bound=1.0, log2_hashmap_size=14, grid_levels=8)


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


class Views:
    """What a device-sampled epoch reads of a dataset: ``n`` RGBA views of ``size``^2
    pixels around the origin."""

    def __init__(self, n: int, size: int = 32):
        rng = np.random.default_rng(4)
        self.images = rng.uniform(0, 1, (n, size, size, 4)).astype(np.float32)
        poses = []
        for k in range(n):
            a = 2 * math.pi * k / n
            eye = np.array([2.0 * math.sin(a), 0.4, 2.0 * math.cos(a)])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, [0.0, 1.0, 0.0])
            right /= np.linalg.norm(right)
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = (
                right, np.cross(fwd, right), fwd, eye)
            poses.append(pose)
        self.poses = np.stack(poses)
        self.H = self.W = size
        self.intrinsics = np.array([size, size, size / 2, size / 2], np.float32)

    def __len__(self):
        return len(self.poses)


def _trainer(dev, workspace, num_rays=512, **cfg_kw):
    """A palette trainer at the palette stage's smooth epochs (from epoch 31: smooth loss
    on, colours frozen, ``lambda_weight`` falling every epoch) on a lively seeded field
    with hist weights, every grid cell occupied."""
    cfg = Config(O=True, fp16=True, grid_size=32, num_rays=num_rays, max_steps=256,
                 train_samples_per_ray=32, iters=100, use_initialization_from_rgbxy=True,
                 seed=3, **PAL_KW, **cfg_kw)
    spec = PaletteSpec.build(num_basis=4, fp16=True, **PAL_KW)
    gen = torch.Generator().manual_seed(2)
    params = init_palette(spec, gen)
    for name in ("encoder", "encoder_palette"):
        params[name].uniform_(-4, 4, generator=gen)
    params["sigma_net"][-1][:, 0] *= 8.0
    params["omega_net"] = init_mlp([spec.geo_feat_dim, 4], gen)
    params["omega_net"][0] *= 8.0
    params["basis_color"] = torch.tensor([[1.0, 0.2, 0.1], [0.1, 0.8, 0.3], [0.2, 0.3, 0.9],
                                          [0.8, 0.8, 0.2]])
    params["basis_color_origin"] = params["basis_color"] - 0.01
    hist = torch.rand((32, 32, 32, 4), generator=gen)
    params["hist_weights"] = hist / hist.sum(-1, keepdim=True)
    tr = PaletteTrainer("t", cfg, spec, params=params, workspace=str(workspace),
                        use_checkpoint="scratch", mute=True, device=dev)
    tr.grid_state = tr.grid_state._replace(bitfield=torch.full_like(tr.grid_state.bitfield, 255))
    tr.epoch = 30
    tr.save_checkpoint = lambda best=False: None
    return tr


def _kept_steps(tr) -> list:
    """Each step's (loss, per_ray), as ``train_step`` returns them, kept as they come."""
    kept, step = [], tr.train_step

    def keep(*a, **kw):
        out = step(*a, **kw)
        kept.append(out)
        return out

    tr.train_step = keep
    return kept


# ------------------------------------------------------------------ on the CPU

def test_capture_counts_at_each_replay():
    """Inside a capture nothing reaches the recorder, and spans record nothing; each
    ``replayed()`` counts what the block counted once more, while the recorder is on."""
    x = torch.ones(5, dtype=torch.bool)
    profiling.enable()
    with profiling.capture() as counted:
        with profiling.span("inside"):
            profiling.count("c", 3)
            profiling.count_device("d", x)
        with pytest.raises(RuntimeError):
            with profiling.capture():
                pass
    s = profiling.snapshot()
    assert s["spans"] == {} and s["counters"] == {}
    for _ in range(2):
        counted.replayed()
    assert profiling.snapshot()["counters"] == {"c": 6, "d": 10}
    profiling.enable(False)  # the recorder off: a replay counts nothing
    counted.replayed()
    profiling.enable()
    assert profiling.snapshot()["counters"] == {"c": 6, "d": 10}


def test_kernel_launches_count_device_kernels_alone():
    """Host operations in the window are no kernels: on the CPU every count stays 0, and
    the recorder is on inside the window (the profiler's), off after it."""
    with profiling.kernel_launches(["add", "ones"]) as counts:
        assert profiling.counting()
        torch.ones(3).add_(1.0)
    assert counts == {"add": 0, "ones": 0} and not profiling.counting()


def test_step_graphs_warm_up_each_key_and_drop_on_replaced_reads():
    """Each key's first step is eager; ``clear`` (new parameters or optimizer: what the
    graphs read is replaced) drops every graph, and each key warms up again."""
    graphs = StepGraphs()
    body = lambda inputs: ()  # noqa: E731
    assert graphs.get("k", body) is None       # the key's eager warm-up
    g = graphs.get("k", body)
    assert g is not None and graphs.get("k", body) is g
    assert graphs.get("other", body) is None
    graphs.clear()
    assert graphs.get("k", body) is None
    assert graphs.get("k", body) is not g
    g.load({"x": torch.arange(3.0), "y": None})
    g.load({"x": torch.arange(3.0) + 1, "y": None})
    assert torch.equal(g.inputs["x"], torch.arange(3.0) + 1) and g.inputs["y"] is None


def test_device_scalars_fill_what_changed():
    s = DeviceScalars("cpu", ("a", "b"))
    before = s["a"]
    s.set(a=0.1, b=2.0)
    assert float(s["a"]) == np.float32(0.1) and float(s["b"]) == 2.0
    s["a"].add_(1.0)   # a stale value is not refilled while the host's value holds
    s.set(a=0.1)
    assert float(s["a"]) == np.float32(1.1) and s["a"] is before
    s.set(a=0.5)
    assert float(s["a"]) == 0.5


def test_steps_stay_eager_where_they_cannot_be_captured(tmp_path):
    """Captured only on the card, in one process, without ``--train_compact_frac``; the
    decision reads nothing but the trainer's device, rank and render settings."""
    tr = _trainer("cpu", tmp_path, num_rays=64)
    assert not tr._captures() and tr._scalars is None
    assert isinstance(tr.optimizer.param_groups[0]["lr"], float)
    tr.device = torch.device("cuda")   # the decision alone: nothing runs on it here
    assert tr._captures()
    tr.dp = object()                   # a rank of a --n_devices run
    assert not tr._captures()
    tr.dp = None
    tr.train_settings = dataclasses.replace(tr.train_settings, compact_frac=0.25)
    assert not tr._captures()


def test_optimizer_state_from_a_capturable_optimizer_loads_on_the_cpu(tmp_path):
    """A checkpoint's Adam state written on the card (lr a device scalar, ``capturable``,
    step counts beside the parameters) loads into a CPU trainer's optimizer, which keeps its
    own lr and setting and takes the moments and step counts as they are."""
    views = Views(2, 12)
    tr = _trainer("cpu", tmp_path / "a", num_rays=64)
    tr.train(views, None, tr.epoch + 1)
    state = tr.optimizer.state_dict()
    for group in state["param_groups"]:
        group["lr"], group["capturable"] = torch.tensor(0.5), True
    for st in state["state"].values():
        st["step"] = st["step"].double()
    other = _trainer("cpu", tmp_path / "b", num_rays=64)
    other._load_optimizer(state)
    group = other.optimizer.param_groups[0]
    assert group["lr"] == other.opt.lr and group["capturable"] is False
    for p, q in zip(tr._trainable(tr.params), other._trainable(other.params)):
        mine, theirs = tr.optimizer.state[p], other.optimizer.state[q]
        assert torch.equal(mine["exp_avg"], theirs["exp_avg"])
        assert theirs["step"].device.type == "cpu" and theirs["step"].dtype == torch.float32
        assert float(theirs["step"]) == 2.0
    other.train(views, None, other.epoch + 1)   # a non-capturable step on the loaded state
    assert math.isfinite(other.stats["loss"][-1])


def test_cpu_palette_steps_count_as_eager_steps(tmp_path):
    tr = _trainer("cpu", tmp_path, num_rays=64)
    profiling.enable()
    tr.train(Views(3, 12), None, tr.epoch + 1)
    c = profiling.snapshot()["counters"]
    assert c["train.graph.replays"] == 0 and "train.graph.captures" not in c
    assert c["train.ray_count"] == 3 * 64 and c["train.valid_samples"] > 0


# ------------------------------------------------------------------ on the card

def _named(tree):
    for k, v in tree.items():
        if not isinstance(v, list):
            yield k, v
            continue
        for i, layer in enumerate(v):
            items = layer.items() if isinstance(layer, dict) else [("", layer)]
            for kk, t in items:
                yield f"{k}.{i}{'.' + kk if kk else ''}", t


def _state(tr) -> tuple:
    """(the leaves the optimizer moves: name -> (parameter, EMA, Adam's first moment,
    second moment), the leaves it does not move: name -> parameter), on the CPU."""
    moved = {id(p) for p in tr._trainable(tr.params)}
    ema = dict(_named(tr.ema_params))
    train, fixed = {}, {}
    for name, p in _named(tr.params):
        if id(p) in moved:
            st = tr.optimizer.state[p]
            train[name] = tuple(t.detach().cpu().clone() for t in (
                p, ema[name], st["exp_avg"], st["exp_avg_sq"]))
        else:
            fixed[name] = p.detach().cpu().clone()
    return train, fixed


LIMITS = {"loss_gap": 1e-5, "grad_gap": 4e-5, "change_gap": 1e-6}  # smooth-epochs.json


def _run(dev, workspace, epochs: int, views, eager: bool):
    """Train ``epochs`` epochs, replayed under a kernel-counting profiler window. Returns
    (the trainer, each step's outputs, the recorder's counters, the kernels B1 and E1 that
    ran on the card in a replayed run, the host's calls of their launch). An eager step's
    calls are its launches."""
    tr = _trainer(dev, workspace)
    if eager:
        tr._captures = lambda: False
    kept = _kept_steps(tr)
    calls = scatter.scatter_add.launches, hashgrid_fast.encode_kernel.launches
    profiling.enable()
    window = contextlib.nullcontext({}) if eager else profiling.kernel_launches(
        ["scatter_add", "hashgrid_encode"])
    with window as ran:
        tr.train(views, None, tr.epoch + epochs)
        counters = profiling.snapshot()["counters"]
    profiling.enable(False)
    profiling.reset()
    called = (scatter.scatter_add.launches - calls[0],
              hashgrid_fast.encode_kernel.launches - calls[1])
    return tr, kept, counters, (ran.get("scatter_add"), ran.get("hashgrid_encode")), called


@pytest.mark.cuda
def test_replayed_steps_match_eager_steps_across_an_epoch(cuda_device, tmp_path):
    """Six steps, three an epoch: the lr changes every step and ``lambda_weight`` at the
    epoch boundary, between replays. Step 0 runs eagerly in both runs, steps 1-5 replay in
    one of them. Every count is the eager run's; the losses, ``per_ray``, the parameters,
    the EMA and Adam's moments are within the ``palette-train`` cell's limits of the eager
    run's (the scatter kernel's f32 atomics add in no fixed order, so two eager runs differ
    in the last bits too)."""
    views = Views(3)
    runs = {name: _run(cuda_device, tmp_path / name, 2, views, name == "eager")
            for name in ("eager", "graph")}
    (tr_e, kept_e, c_e, n_e, h_e), (tr_g, kept_g, c_g, n_g, h_g) = runs["eager"], runs["graph"]
    assert c_g["train.graph.captures"] == 1 and c_g["train.graph.replays"] == 5
    assert c_e["train.graph.replays"] == 0 and "train.graph.captures" not in c_e
    for name in ("train.ray_count", "train.valid_samples", "encode.fused"):
        assert c_g[name] == c_e[name], name
    assert n_g == h_e == (12, 24)   # two B1 and four E1 kernels a step: replayed, eager
    assert h_g == (4, 8)            # the replayed run's host calls: the warm-up, the capture
    assert tr_g.opt_step == tr_e.opt_step == 6
    assert tr_g.lambda_weight == tr_e.lambda_weight == pytest.approx(0.05 * (1 - 32 / 100))
    losses_e = [float(loss) for loss, _ in kept_e]
    losses_g = [float(loss) for loss, _ in kept_g]
    assert len(set(losses_g)) == 6   # copies, not views of one buffer
    for (_, a), (_, b) in zip(kept_g, kept_e):
        assert float((a - b).abs().max()) <= LIMITS["loss_gap"] * float(b.abs().max())
    train_e, fixed_e = _state(tr_e)
    train_g, fixed_g = _state(tr_g)
    init = dict(_named(_trainer("cpu", tmp_path / "init").params))
    for name, p in fixed_g.items():   # what the stage never moves, bit for bit
        assert torch.equal(p, fixed_e[name]) and torch.equal(p, init[name]), name

    def norms(train: dict, which: int) -> dict:
        """Per leaf: the norm of the parameter's or the EMA's change, or of a moment."""
        return compare.norms({k: v[which] - init[k] if which < 2 else v[which]
                              for k, v in train.items()})

    first_g, first_e = norms(train_g, 2), norms(train_e, 2)
    for what, which in (("parameters", 0), ("EMA", 1), ("second moment", 3)):
        gaps = compare.training_gaps(losses_g, losses_e, first_g, first_e,
                                     norms(train_g, which), norms(train_e, which))
        for name, limit in LIMITS.items():
            assert gaps[name] <= limit, (what, name, gaps[name])


@pytest.mark.cuda
def test_an_epoch_of_replays_keeps_every_step_loss(cuda_device, tmp_path):
    """100 steps of one epoch: one capture, 99 replays; the epoch's mean loss is the mean of
    the 100 step losses, which are copies of the graph's output (not one buffer), and the
    eager epoch's to the cell's loss limit."""
    views = Views(100, 16)
    (tr_g, kept_g, c_g, n_g, h_g), (tr_e, kept_e, c_e, n_e, h_e) = (
        _run(cuda_device, tmp_path / name, 1, views, name == "eager")
        for name in ("graph", "eager"))
    assert c_g["train.graph.captures"] == 1 and c_g["train.graph.replays"] == 99
    assert n_g == h_e == (200, 400) and h_g == (4, 8)
    losses = torch.stack([loss for loss, _ in kept_g]).double()
    assert len(set(losses.tolist())) == 100
    assert tr_g.stats["loss"][-1] == pytest.approx(float(losses.mean()), rel=1e-6)
    assert tr_g.stats["loss"][-1] == pytest.approx(tr_e.stats["loss"][-1], rel=1e-5)
    scatter.check_refused()
