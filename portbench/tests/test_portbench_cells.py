"""Every cell on the CPU at a small size: a whole run (set-up, window, check) comes out
correct, and comes out not correct with its timed path broken underneath (each fault of
its driver)."""

from __future__ import annotations

import pytest
import torch

from portbench import harness, inputs
from portbench.tests import support

CELLS = ("ngp-train", "palette-train", "palette-sweep-edit", "ngp-exact-eval")
FAULTS = [(cell, fault) for cell in CELLS for fault in sorted(harness.load_module(
    "drivers", harness.load_cell(support.ROOT, cell).traffic["driver"]).FAULTS)]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return support.small_scene(str(tmp_path_factory.mktemp("scene")))


@pytest.mark.parametrize("cell", CELLS)
def test_run_is_correct(cell, scene):
    c = support.small_cell(cell, scene)
    r = support.run_cpu(c, trace=True)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and set(r["checks"]) == set(c.traffic["limits"])
    assert r["device"]["window_s"] > 0
    assert set(r["metrics"]) == {m["name"] for m in c.per_layer
                                 if m["source"] != "device_trace"
                                 or m["name"].startswith(("device_idle", "launches"))}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_path_is_not_correct(cell, fault, scene):
    c = support.small_cell(cell, scene)
    driver = harness.load_module("drivers", c.traffic["driver"])
    r = support.run_cpu(c, plant=driver.FAULTS[fault])
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ("ngp-train", "palette-train"))
def test_control_inputs_are_the_runs(cell, scene):
    """The training control's inputs are the ones a run of the same seed hands both
    sides."""
    from portbench.reference.scene import Scene

    c = support.small_cell(cell, scene)
    ctx = harness.RunContext(cell=c, seed=77, seconds=0.0, trace=False,
                             device=torch.device("cpu"), t0=0.0)
    driver = harness.load_module("drivers", "train")
    state = driver.setup(ctx)
    params, _, record = driver.train_inputs(c, Scene(scene, "train", c.config["scale"]), 77,
                                            "cpu")
    for k, v in inputs.leaves(state.init).items():
        assert torch.equal(v, inputs.leaves(params)[k]), k
    assert [k for k, _ in record] == [k for k, _ in state.draws.record]
    for (_, a), (_, b) in zip(record, state.draws.record):
        assert a == b if isinstance(a, list) else torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 9_000_000_000])
def test_large_seeds_make_the_same_inputs(seed):
    cfg = dict(harness.load_cell(support.ROOT, "ngp-train").config, **support.TINY)
    a = inputs.ngp_params(cfg, inputs.generator(seed, "cpu"), "cpu")
    b = inputs.ngp_params(cfg, inputs.generator(seed, "cpu"), "cpu")
    assert torch.equal(a["encoder"], b["encoder"])
    c = inputs.ngp_params(cfg, inputs.generator(seed + 1, "cpu"), "cpu")
    assert not torch.equal(a["encoder"], c["encoder"])


def test_seeded_scene_fills_its_share():
    cfg = dict(harness.load_cell(support.ROOT, "palette-train").config, **support.TINY)
    _, occupied = inputs.seeded_field(cfg, inputs.generator(5, "cpu"), "cpu")
    share = float(occupied.float().mean())
    assert abs(share - cfg["scene"]["occupied_share"]) < 1e-4
