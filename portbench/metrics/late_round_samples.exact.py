"""Share of the exact frames' valid samples that the rounds after the first march
(device counters ``eval.valid_samples.r<k>``, k >= 1, over all k), in %."""

from portbench.program_spans import snapshot

PREFIX = "eval.valid_samples.r"


def read(r):
    s = snapshot(r)
    rounds = {} if s is None else {int(k[len(PREFIX):]): v for k, v in s["counters"].items()
                                   if k.startswith(PREFIX)}
    total = sum(rounds.values())
    if not total:
        return None
    return 100.0 * (total - rounds.get(0, 0)) / total
