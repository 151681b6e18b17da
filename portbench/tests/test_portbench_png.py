"""The reference's PNG reader against the program's over the benchmark's scene, and over
rows of every filter type."""

from __future__ import annotations

import os

import numpy as np

from portbench.reference.png import read_png
from portbench.tests.support import ROOT, write_png


def test_reads_the_scene_as_the_program_does():
    from palettenerf_torch.data.png import read_png as program_read

    for i in (0, 42, 99):
        path = os.path.join(ROOT, "data_proc", "proc_toys", "train", f"r_{i}.png")
        np.testing.assert_array_equal(read_png(path), program_read(path))


def test_every_filter_type(tmp_path):
    img = np.random.default_rng(7).integers(0, 256, (23, 17, 4), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    np.testing.assert_array_equal(read_png(path), img)
