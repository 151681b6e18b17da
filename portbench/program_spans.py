"""What the program records of itself in the traced window: the spans and counters of
``palettenerf_torch.utils.profiling`` (on while the window's profiler records, and only
then), per unit of the window. Set-up and the check are not traced, so the recorder holds
the window alone; a run is one process.

Every reader returns None where there is nothing to read: an untraced run, a program
without the recorder, a span or counter the program does not have."""

from __future__ import annotations

from typing import Optional


def snapshot(r) -> Optional[dict]:
    """The program's recorder after the traced window ``r`` (a ``harness.Reading``), or
    None."""
    if r.trace is None or r.window.units == 0:
        return None
    try:
        from palettenerf_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "snapshot"):
        return None
    s = profiling.snapshot()
    return s if s["spans"] or s["counters"] else None


def self_ms_per_unit(r, span: str) -> Optional[float]:
    """Host milliseconds of span ``span`` less its child spans', per unit of the window."""
    s = snapshot(r)
    if s is None or span not in s["spans"]:
        return None
    return s["spans"][span]["self_ns"] / 1e6 / r.window.units


def counter(r, name: str) -> Optional[int]:
    s = snapshot(r)
    return None if s is None else s["counters"].get(name)


def per_unit(r, name: str) -> Optional[float]:
    """Counter ``name`` per unit of the window."""
    n = counter(r, name)
    return None if n is None else n / r.window.units


def ratio(r, num: str, den: str) -> Optional[float]:
    """Counter ``num`` over counter ``den`` (None when either is missing or ``den`` is 0)."""
    a, b = counter(r, num), counter(r, den)
    return None if a is None or not b else a / b
