"""Share of the window's palette steps that replayed the step's CUDA graph (counter
``train.graph.replays``, one per replayed step, per step of the window), in %. Nothing
from a program that does not count replays."""

from portbench.program_spans import per_unit


def read(r):
    replays = per_unit(r, "train.graph.replays")
    return None if replays is None else 100.0 * replays
