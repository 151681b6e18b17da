"""Host milliseconds of the warp to the screen (span ``sweep.warp``, self time) per
frame."""

from portbench.program_spans import self_ms_per_unit


def read(r):
    return self_ms_per_unit(r, "sweep.warp")
