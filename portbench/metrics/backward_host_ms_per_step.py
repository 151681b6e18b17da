"""Host milliseconds of ``total.backward()`` (span ``train.backward``, self time: the
autograd engine's dispatch, B1's launch inside it) per step."""

from portbench.program_spans import self_ms_per_unit


def read(r):
    return self_ms_per_unit(r, "train.backward")
