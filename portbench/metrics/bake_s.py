"""Seconds from ``bake_palette`` to a built ``SweepVolume`` (the bitfield mask
included), in set-up."""


def read(r):
    return r.spans.get("bake_s")
