"""Host milliseconds of the block loop (span ``sweep.composite``, self time: the
dispatch of every block's interpolation, shade and composite) per frame."""

from portbench.program_spans import self_ms_per_unit


def read(r):
    return self_ms_per_unit(r, "sweep.composite")
