"""On the card (``-m cuda``; each test skips without one): every cell's control, at the
cell's own size, fails one of the cell's limits, and a short run of every cell at its
own size comes out correct.

    python -m pytest -m cuda portbench/tests/test_portbench_cuda.py
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness
from portbench.tests.support import ROOT

CELLS = ("ngp-train", "palette-train", "palette-sweep-edit", "ngp-exact-eval")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell, card):
    c = harness.load_cell(ROOT, cell)
    got = harness.load_module("drivers", c.traffic["driver"]).control(c, 31337, card)
    assert any(got[k] > limit for k, limit in c.traffic["limits"].items()), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(cell, card):
    ctx = harness.RunContext(cell=harness.load_cell(ROOT, cell), seed=2 ** 31 + 11,
                             seconds=1.0, trace=False, device=card, t0=time.perf_counter())
    r = harness.measure(ctx)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
