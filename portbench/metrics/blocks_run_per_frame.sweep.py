"""Blocks of 8 slices the sweep ran (counter ``sweep.blocks_run``) per frame."""

from portbench.program_spans import per_unit


def read(r):
    return per_unit(r, "sweep.blocks_run")
