"""The port's recorder (``palettenerf_torch/utils/profiling.py``: ``span``, ``count``,
``count_device``) and what reads it: off it records nothing and enters no
``record_function``; on, its spans nest with parents, self times and unit ids on the
profiler's clock; a tiny CPU epoch of each trainer, exact frame and sweep frame give the
spans and counts the program's structure says; off against on, the aten calls of a unit
differ by the device counters' stated operations alone; ``portbench/trace.py`` labels an
idle gap with the program's span; and the benchmark's readers of the recorder
(``portbench/metrics/``) read numbers from a traced run and nothing from an untraced one."""

import collections
import math
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from palettenerf_torch.config import Config
from palettenerf_torch.models.nerf import NeRFSpec
from palettenerf_torch.models.palette import PaletteSpec
from palettenerf_torch.render import nerf_renderer, palette_renderer, sweep
from palettenerf_torch.train.palette_trainer import PaletteTrainer
from palettenerf_torch.train.trainer import Trainer
from palettenerf_torch.utils import profiling
from portbench import harness
from portbench.tests import support
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)

CFG = dict(bound=1.0, scale=0.8, grid_size=16, max_steps=64, num_rays=64,
           train_samples_per_ray=16, infer_samples_per_ray=64, log2_hashmap_size=12,
           grid_levels=4, dt_gamma=0.0, min_near=0.05, update_extra_interval=2, seed=0)
H = W = 12
VIEWS = 3


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


class FakeViews:
    """What a device-sampled epoch reads of a dataset: RGBA images, poses, intrinsics."""

    def __init__(self, n: int = VIEWS):
        rng = np.random.default_rng(3)
        self.images = rng.uniform(0, 1, (n, H, W, 4)).astype(np.float32)
        poses = []
        for k in range(n):
            a = 2 * math.pi * k / n
            eye = np.array([2.0 * math.sin(a), 0.3, 2.0 * math.cos(a)])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, [0.0, 1.0, 0.0])
            right /= np.linalg.norm(right)
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = (
                right, np.cross(fwd, right), fwd, eye)
            poses.append(pose)
        self.poses = np.stack(poses)
        self.H, self.W = H, W
        self.intrinsics = np.array([10.0, 10.0, W / 2, H / 2], np.float32)

    def __len__(self):
        return len(self.poses)


def _trainer(kind: str, tmp_path):
    """``kind``: "ngp", "palette", or "palette-compact" (``--train_compact_frac 0.5``)."""
    opt = Config(**CFG, train_compact_frac=0.5 if kind == "palette-compact" else 0.0)
    if kind == "ngp":
        spec = NeRFSpec.build(bound=1.0, log2_hashmap_size=12, grid_levels=4)
        tr = Trainer("ngp", opt, spec, workspace=str(tmp_path), use_checkpoint="scratch",
                     mute=True, device="cpu")
    else:
        spec = PaletteSpec.build(bound=1.0, num_basis=3, log2_hashmap_size=12, grid_levels=4)
        tr = PaletteTrainer("palette", opt, spec, workspace=str(tmp_path),
                            use_checkpoint="scratch", mute=True, device="cpu")
    bits = tr.grid_state.bitfield
    tr.grid_state = tr.grid_state._replace(bitfield=torch.full_like(bits, 255))
    return tr


def _tree(snap_records):
    """name -> list of (parent's name or None, unit)."""
    out = collections.defaultdict(list)
    for name, _, _, parent, unit in snap_records:
        out[name].append((snap_records[parent][0] if parent >= 0 else None, unit))
    return out


# ------------------------------------------------------------------ the recorder itself

def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or torch.autograd.profiler
                        .record_function(name))
    x = torch.ones(5, dtype=torch.bool)
    a, b = profiling.span("a"), profiling.span("b", unit=3)
    assert a is b  # the shared no-op context
    with a:
        profiling.count("c", 4)
        profiling.count_device("d", x)
    profiling.flush()
    s = profiling.snapshot()
    assert entered == [] and s == {"spans": {}, "counters": {}, "records": 0, "dropped": 0}
    assert profiling.RECORDER.pending == {}
    profiling.enable()
    with profiling.span("a"):
        profiling.count("c", 4)
        profiling.count_device("d", x)
    assert entered == ["a"]
    assert profiling.snapshot()["counters"] == {"c": 4, "d": 5}


def test_nesting_parents_self_time_and_units(monkeypatch):
    profiling.enable()
    for _ in range(2):
        with profiling.span("outer"):
            time.sleep(0.004)
            with profiling.span("inner"):
                time.sleep(0.006)
                with profiling.span("leaf", unit=9):
                    time.sleep(0.002)
            with profiling.span("inner", unit=5):
                pass
    rec = profiling.RECORDER
    tree = _tree(rec.records)
    assert tree["outer"] == [(None, 0), (None, 1)]  # a root's unit: its occurrence
    assert tree["inner"] == [("outer", 0), ("outer", 5), ("outer", 1), ("outer", 5)]
    assert tree["leaf"] == [("inner", 9), ("inner", 9)]
    spans = profiling.snapshot()["spans"]
    dur = collections.defaultdict(int)
    child = collections.defaultdict(int)
    for name, start, end, parent, _ in rec.records:
        assert end >= start
        dur[name] += end - start
        if parent >= 0:
            child[rec.records[parent][0]] += end - start
    for name in ("outer", "inner", "leaf"):
        assert spans[name]["total_ns"] == dur[name]
        assert spans[name]["self_ns"] == dur[name] - child[name]
    assert spans["outer"]["count"] == 2 and spans["inner"]["count"] == 4
    assert spans["outer"]["self_ns"] >= 2 * 4e6 and spans["leaf"]["self_ns"] >= 2 * 2e6
    # past the limit records are dropped and counted; the aggregates stay whole
    monkeypatch.setattr(profiling.Recorder, "LIMIT", len(rec.records) + 1)
    for _ in range(3):
        with profiling.span("late"):
            pass
    s = profiling.snapshot()
    assert s["records"] == profiling.Recorder.LIMIT and s["dropped"] == 2
    assert s["spans"]["late"]["count"] == 3


def test_span_start_is_its_record_function_event_start():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with profiling.span("probe.span"):
                time.sleep(0.002)
    mine = [r[1] for r in profiling.RECORDER.records if r[0] == "probe.span"]
    theirs = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "probe.span")
    assert len(mine) == len(theirs) == 3
    for a, b in zip(mine, theirs):
        assert abs(a - b) < 1e6


def test_trace_writes_the_spans_beside_the_chrome_trace(tmp_path):
    import json
    import os

    with profiling.trace(str(tmp_path)):
        with profiling.span("probe.outer"):
            profiling.count("probe.n", 2)
    files = sorted(os.listdir(tmp_path))
    assert [f.split("_")[0] for f in files] == ["spans", "trace"]
    with open(tmp_path / files[0]) as f:
        got = json.load(f)
    assert got["spans"]["probe.outer"]["count"] == 1 and got["counters"] == {"probe.n": 2}
    assert [r[0] for r in got["span_records"]] == ["probe.outer"]


# ------------------------------------------------------------------ the program's spans

@pytest.mark.parametrize("kind", ["ngp", "palette", "palette-compact"])
def test_epoch_span_tree_and_valid_samples(kind, tmp_path, monkeypatch):
    tr = _trainer(kind, tmp_path)
    views = FakeViews()
    module = nerf_renderer if kind == "ngp" else palette_renderer
    march, sums = module._march, []

    def counted(*a, **kw):  # the march masks' sums, taken beside the program's counter
        m = march(*a, **kw)
        sums.append(int(m.mask.sum()))
        return m

    monkeypatch.setattr(module, "_march", counted)
    profiling.enable()
    tr.epoch += 1
    tr.train_one_epoch(views)
    s = profiling.snapshot()
    tree = _tree(profiling.RECORDER.records)
    steps = len(views)
    assert tree["train.epoch"] == [(None, 1)] and tree["train.read"] == [("train.epoch", 1)]
    assert tree["train.step"] == [("train.epoch", k) for k in range(steps)]
    for name in ("train.rays", "train.forward", "train.backward", "train.optim"):
        assert tree[name] == [("train.step", k) for k in range(steps)], name
    refreshes = -(-steps // CFG["update_extra_interval"]) if kind == "ngp" else 0
    assert tree.get("train.refresh", []) == [("train.step", k) for k in range(0, steps, 2)
                                              ][:refreshes]
    assert s["counters"]["train.ray_count"] == steps * CFG["num_rays"]
    assert len(sums) == steps and sum(sums) > 0
    assert s["counters"]["train.valid_samples"] == sum(sums)
    # the CPU's palette steps run eagerly, and count that they replayed nothing
    assert s["counters"].get("train.graph.replays") == (None if kind == "ngp" else 0)
    assert "train.graph.captures" not in s["counters"]


def test_exact_frame_counts_its_rounds(tmp_path):
    tr = _trainer("ngp", tmp_path)
    rounds = tr.eval_settings.compaction_rounds
    assert len(rounds) == 3
    views = FakeViews()
    from palettenerf_torch.data.rays import gen_rays

    ro, rd = gen_rays(views.poses[0], views.intrinsics, H, W, None)
    chunk = 64
    chunks = -(-H * W // chunk)
    profiling.enable()
    tr.render_image(ro, rd, chunk=chunk)
    s = profiling.snapshot()
    tree = _tree(profiling.RECORDER.records)
    assert s["counters"]["eval.chunks"] == chunks
    assert s["counters"]["eval.rounds"] == chunks * len(rounds)
    assert tree["eval.frame"] == [(None, 0)] and tree["eval.gather"] == [("eval.frame", 0)]
    assert tree["eval.chunk"] == [("eval.frame", 0)] * chunks
    assert tree["eval.round"] == [("eval.chunk", 0)] * (chunks * len(rounds))
    assert {f"eval.valid_samples.r{k}" for k in range(3)} <= set(s["counters"])
    assert s["counters"]["eval.valid_samples.r0"] > 0


def _sweep_volume(Z: int = 24):
    """A random palette sweep volume whose slices 8-15 of every axis hold no density."""
    P, vd = 2, 1
    C = 2 + 4 * P + 3 * vd * vd
    gen = torch.Generator().manual_seed(5)
    vols = tuple(torch.rand((Z, Z, C, Z), generator=gen).to(torch.bfloat16)
                 for _ in range(3))
    occ = np.ones(Z, bool)
    occ[8:16] = False
    return sweep.SweepVolume(Z, 1.0, P, vols, (occ, occ, occ), vd_bands=vd)


@pytest.mark.parametrize("edit", [False, True])
def test_sweep_frame_counts_its_blocks(edit):
    sv = _sweep_volume()
    pose = FakeViews().poses[1]
    region = None
    if edit:
        region = palette_renderer.make_region_edit(2, clip_dim=1, mean_xyz=[0.0, 0.0, 0.9],
                                                   std_xyz=0.02)
        region = region._replace(delta_hsv=np.array([[90.0, 1, 1], [0, 1, 1]], np.float32))
    intr = (20.0, 20.0, 8.0, 8.0)
    profiling.enable()
    sweep.render_sweep(sv, pose, intr, 16, 16, u_res=12, basis_color=torch.rand(2, 3),
                       edit=region)
    s = profiling.snapshot()
    plan = sweep.plan_sweep(pose, intr, 16, 16, sv.bound, 12)
    blocks = sweep._blocks(sv.occ[plan.axis], plan.flip)
    c = s["counters"]
    assert c["sweep.blocks_run"] == len(blocks) == 2
    assert c["sweep.blocks_skipped"] == 1
    assert c["sweep.blocks_edit_culled"] + c["sweep.blocks_edit_partial"] <= len(blocks)
    if not edit:
        assert c["sweep.blocks_edit_culled"] == c["sweep.blocks_edit_partial"] == 0
    else:
        assert c["sweep.blocks_edit_culled"] >= 1
    tree = _tree(profiling.RECORDER.records)
    assert tree["sweep.frame"] == [(None, 0)]
    for name in ("sweep.plan", "sweep.composite", "sweep.warp"):
        assert tree[name] == [("sweep.frame", 0)], name


# ------------------------------------------------------------------ what off costs

class AtenCalls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name == "profiler._record_function_enter_new.default":
            name = f"record_function {args[0]}"  # PyTorch's own too (``Optimizer.step#``)
        self.calls[name] += 1
        return func(*args, **(kwargs or {}))


def _unit_calls(kind: str, on: bool, tmp_path) -> collections.Counter:
    """The dispatched calls of one unit (a train step and its epoch's read, or a frame)
    of a fresh program, the recorder off or on."""
    profiling.reset()
    profiling.enable(on)
    views = FakeViews(1)
    if kind == "sweep":
        sv, pose = _sweep_volume(), views.poses[0]
        run = lambda: sweep.render_sweep(sv, pose, (20.0, 20.0, 8.0, 8.0), 16, 16,  # noqa: E731
                                         u_res=12, basis_color=torch.ones(2, 3) * 0.5)
    elif kind == "exact":
        tr = _trainer("ngp", tmp_path)
        from palettenerf_torch.data.rays import gen_rays

        ro, rd = gen_rays(views.poses[0], views.intrinsics, H, W, None)
        run = lambda: tr.render_image(ro, rd, chunk=72)  # noqa: E731
    else:
        tr = _trainer(kind, tmp_path)
        run = lambda: tr.train_one_epoch(views)  # noqa: E731
    with AtenCalls() as mode:
        run()
    profiling.enable(False)
    return mode.calls


@pytest.mark.parametrize("kind,added", [
    ("ngp", {"aten.sum.default": 1, "aten.add.Tensor": 1, "aten.stack.default": 1}),
    ("palette", {"aten.sum.default": 1, "aten.add.Tensor": 1, "aten.stack.default": 1}),
    # two chunks of three rounds
    ("exact", {"aten.sum.default": 6, "aten.add.Tensor": 6, "aten.stack.default": 1}),
    ("sweep", {}),
])
def test_off_adds_no_call_on_adds_the_counters(kind, added, tmp_path):
    off = _unit_calls(kind, False, tmp_path / "off")
    on = _unit_calls(kind, True, tmp_path / "on")
    program = ("record_function train.", "record_function eval.", "record_function sweep.",
               "record_function data.")
    assert not any(k.startswith(program) for k in off)
    assert off - on == collections.Counter()
    extra = on - off
    # each span's record_function, entered and left
    entered = sum(v for k, v in extra.items() if k.startswith("record_function "))
    assert entered > 0 and all(k.startswith(program) for k in extra
                               if k.startswith("record_function "))
    assert extra["profiler._record_function_exit._RecordFunction"] == entered
    assert {k: v for k, v in extra.items() if not k.startswith(("record_function ",
                                                                "profiler."))} == added


# ------------------------------------------------------------------ what the benchmark reads

def test_idle_gap_is_labelled_with_the_program_span(tmp_path):
    cell = harness.load_cell(support.ROOT, "ngp-train")
    ctx = harness.RunContext(cell=cell, seed=1, seconds=0.0, trace=True,
                             device=torch.device("cpu"), t0=0.0, workdir=str(tmp_path))

    def unit():
        with profiling.span("train.step"):
            time.sleep(0.05)
        return 1

    window, summary = harness.run_window(ctx, unit)
    assert window.units == 1
    assert summary.idle_gaps[0][0] == "train.step"


NEW = {"ngp-train": ("refresh_ms_per_step", "forward_host_ms_per_step",
                     "backward_host_ms_per_step", "valid_samples_per_ray"),
       "palette-train": ("forward_host_ms_per_step.palette",
                         "backward_host_ms_per_step.palette", "valid_samples_per_ray.palette",
                         "graph_replay_share.palette"),
       "ngp-exact-eval": ("collate_ms_per_frame.exact", "late_round_samples.exact"),
       "palette-sweep-edit": ("plan_ms_per_frame.sweep", "composite_host_ms_per_frame.sweep",
                              "warp_host_ms_per_frame.sweep", "blocks_run_per_frame.sweep")}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return support.small_scene(str(tmp_path_factory.mktemp("scene")))


@pytest.mark.parametrize("cell", sorted(NEW))
def test_metric_readers(cell, scene):
    c = support.small_cell(cell, scene, warm_epochs=1) if "train" in cell else \
        support.small_cell(cell, scene)
    assert set(NEW[cell]) <= {m["name"] for m in c.per_layer}
    readers = {name: harness.load_module("metrics", name).read for name in NEW[cell]}
    traced = support.run_cpu(c, trace=True)
    for name in NEW[cell]:
        v = traced["metrics"][name]["value"]
        assert math.isfinite(v), (name, v)
    if cell == "ngp-exact-eval":
        assert 0 <= traced["metrics"]["late_round_samples.exact"]["value"] <= 100
    profiling.reset()
    untraced = support.run_cpu(c, trace=False)
    assert profiling.snapshot()["spans"] == {} and profiling.snapshot()["counters"] == {}
    assert not set(NEW[cell]) & set(untraced["metrics"])
    window = harness.Window(units=untraced["attempted"], calls=1, seconds=1.0)
    for name, read in readers.items():
        assert read(harness.Reading(cell=c, window=window, spans={}, trace=None)) is None
        assert read(harness.Reading(cell=c, window=window, spans={}, trace=object())) is None


def test_graph_replay_share_reads_the_replay_counter():
    """``graph_replay_share.palette``: replayed steps per step of the window in %, from the
    recorder's counter; nothing without a trace or from a program that counts no replays."""
    cell = harness.load_cell(support.ROOT, "palette-train")
    read = harness.load_module("metrics", "graph_replay_share.palette").read
    window = harness.Window(units=200, calls=2, seconds=1.0)
    traced = harness.Reading(cell=cell, window=window, spans={}, trace=object())
    profiling.enable()
    profiling.count("train.graph.replays", 199)
    profiling.count("train.ray_count", 200 * 64)
    assert read(traced) == pytest.approx(99.5)
    assert read(harness.Reading(cell=cell, window=window, spans={}, trace=None)) is None
    profiling.reset()
    profiling.count("train.ray_count", 200 * 64)
    assert read(traced) is None
