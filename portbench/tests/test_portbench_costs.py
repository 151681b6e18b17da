"""``costs.py`` against counts made by hand from the configurations' widths."""

from __future__ import annotations

import json
import os

import pytest

from portbench import costs
from portbench.tests.support import ROOT


def config(name: str) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_table_rows_of_the_recipe():
    # levels 0-4 dense: 17^3, 24^3, 32^3, 44^3, 60^3 (rounded up to 8s), then 2^19 rows
    c = config("ngp-nerf")
    rows = costs.level_rows(c)
    assert rows[:5] == [4920, 13824, 32768, 85184, 216000] and rows[5:] == [2 ** 19] * 11
    assert costs.grid_rows(c) == 6_119_864


def test_ngp_step_flops_by_hand():
    c = config("ngp-nerf")
    enc = 16 * 8 * (2 * 2 + 4)                      # 1,024
    sigma = 2 * (32 * 64 + 64 * 16)                 # 6,144
    color = 2 * (31 * 64 + 64 * 64 + 64 * 3)        # 12,544
    assert costs.ngp_sample_flops(c) == enc + sigma + color == 19_712
    step = costs.train_step_flops(c)
    assert step == 3 * 19_712 * 4096 * 64
    assert step == pytest.approx(15.5e9, rel=1e-3)   # the -O step: 15.5 GFLOP


def test_palette_step_flops_by_hand():
    c = config("palettenerf")
    enc = 1024
    density = enc + 2 * (32 * 64 + 64 * 16)
    heads = (2 * (31 * 64 + 64 * 64 + 64 * 3)       # view-dependent colour
             + 2 * (15 * 64 + 64 * 64 + 64 * 3)     # diffuse
             + enc + 2 * (35 * 64 + 64 * 15)        # palette encoder, basis net
             + 2 * 15 * 19 + 2 * 15 * 6)            # offsets + radiance, omega
    f = costs.palette_sample_flops(c)
    assert f == {"density": density, "heads": heads}
    assert costs.train_step_flops(c) == 2 * (density + 3 * heads) * 4096 * 64


def test_scatter_bytes_and_bound():
    c = config("ngp-nerf")
    U = 4096 * 64 * 16 * 8
    assert costs.scatter_updates(c) == U == 33_554_432
    assert costs.scatter_bytes(c) == U * 8 == 268_435_456
    # with the table's zero-fill, the wrapper's bound of PERF.md's table: 317.4 MB, 0.0947 ms
    total = costs.scatter_bytes(c) + costs.grid_rows(c) * 2 * 4
    assert total / costs.PEAK_HBM_BYTES * 1e3 == pytest.approx(0.0947, abs=1e-4)
    assert costs.scatter_bound_s(c) * 1e3 == pytest.approx(0.0801, abs=1e-4)
