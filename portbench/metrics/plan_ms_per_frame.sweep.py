"""Host milliseconds of the sweep frame's plan (span ``sweep.plan``, self time: the
camera's factorization, the edit's host checks, the uniforms and uploads) per frame."""

from portbench.program_spans import self_ms_per_unit


def read(r):
    return self_ms_per_unit(r, "sweep.plan")
