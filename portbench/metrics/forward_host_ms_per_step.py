"""Host milliseconds of the step's forward, its draws, render and loss terms (span
``train.forward``, self time) per step: the host's dispatch of the forward."""

from portbench.program_spans import self_ms_per_unit


def read(r):
    return self_ms_per_unit(r, "train.forward")
