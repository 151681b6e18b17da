"""Share of the traced window of stage-1 epochs in which no device operation ran, in %."""

from portbench.trace import idle_percent


def read(r):
    return None if r.trace is None else idle_percent(r.trace)
