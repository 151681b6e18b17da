"""Host milliseconds of the grid refresh (span ``train.refresh``, self time) per step."""

from portbench.program_spans import self_ms_per_unit


def read(r):
    return self_ms_per_unit(r, "train.refresh")
