"""The port's profiling utilities (``palettenerf_torch/utils/profiling.py``) against the
JAX package's: the same ``PhaseTimer`` report under one fake clock patched into both
modules, ``device_sync`` on CPU trees, and a trace file from ``trace``."""

import json
import os

import numpy as np
import pytest
import torch

from palettenerf_tpu.utils import profiling as jprof
from palettenerf_torch.utils import profiling as tprof
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)


class _FakeClock:
    """``time.perf_counter`` stand-in: each read advances by the next step."""

    def __init__(self, steps):
        self.steps, self.now = list(steps), 100.0

    def perf_counter(self):
        self.now += self.steps.pop(0)
        return self.now


def _run(mod, monkeypatch):
    # phase reads the clock twice per call: (start, end); durations from the steps' pairs
    steps = [0.0, 0.0123, 0.5, 0.25, 0.0, 0.0031, 1.0, 0.75, 0.0, 0.0004]
    clock = _FakeClock(steps)
    monkeypatch.setattr(mod.time, "perf_counter", clock.perf_counter)
    timer = mod.PhaseTimer()
    for name in ("render", "bake", "render", "host", "d2h"):
        with timer.phase(name):
            pass
    monkeypatch.undo()
    return timer


def test_phase_timer_report_matches_jax(monkeypatch):
    got, ref = _run(tprof, monkeypatch), _run(jprof, monkeypatch)
    assert got.totals == ref.totals and got.counts == ref.counts
    assert got.report() == ref.report()
    assert got.report().splitlines()[0].startswith("host ")   # the largest total first
    assert tprof.PhaseTimer().report() == jprof.PhaseTimer().report() == ""


def test_phase_timer_counts_a_phase_that_raises():
    timer = tprof.PhaseTimer()
    with pytest.raises(ValueError):
        with timer.phase("fails"):
            raise ValueError("boom")
    assert timer.counts == {"fails": 1} and timer.totals["fails"] >= 0.0


@pytest.mark.parametrize("tree", [
    torch.ones(3),
    [np.zeros(2), torch.ones(2)],
    {"a": 1, "b": (torch.zeros(1), torch.ones(1))},
    {"none": None},
    [],
], ids=["tensor", "list", "dict", "no-tensor", "empty"])
def test_device_sync_accepts_cpu_trees(tree):
    timer = tprof.PhaseTimer()
    with timer.phase("sync", sync_on=tree):
        pass
    tprof.device_sync(tree)
    assert timer.counts == {"sync": 1}


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tprof.trace(log_dir) as prof:
        (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    files = [f for f in os.listdir(log_dir) if f.startswith("trace_")]
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
    with tprof.trace(log_dir):   # a second trace in the same directory: a second file
        torch.ones(4).sum()
    assert len([f for f in os.listdir(log_dir) if f.startswith("trace_")]) == 2
