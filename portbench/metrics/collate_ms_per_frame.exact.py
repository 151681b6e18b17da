"""Host milliseconds of the view's collate (span ``data.collate``, self time: the
frame's rays made on the host) per exact frame."""

from portbench.program_spans import self_ms_per_unit


def read(r):
    return self_ms_per_unit(r, "data.collate")
