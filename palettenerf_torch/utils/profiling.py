"""Phase timing and trace capture.

The port's counterpart of ``palettenerf_tpu/utils/profiling.py``:

- ``device_sync(x)`` waits for the CUDA work that produces ``x`` (a tensor, or a list,
  tuple or dict of them: the first tensor found decides the device); CPU tensors need no
  wait.
- ``PhaseTimer`` sums wall seconds per named phase, with the JAX class's API and the
  same ``report()`` text for the same totals.
- ``trace(log_dir)`` records a ``torch.profiler`` trace (CPU activity, and CUDA
  activity when a card is present) and writes it as a Chrome trace into ``log_dir``,
  with the recorder's spans and counters beside it.

The recorder (``span``, ``count``, ``count_device``, ``snapshot``): the port's spans at
its layer boundaries and its counters. It is on only while a ``torch.profiler`` records
(or after ``enable()``); off, ``span`` returns a shared no-op context and the counters
return at once, after one probe of the profiler's state (well under a microsecond). On, a
span enters ``torch.profiler.record_function`` (so it lies on the profiler's timeline with
the device's operations) and records its name, its start and end on ``time.time_ns()``
(the clock of the profiler's events), its parent and its unit id (the global step, the
frame's index). A device counter adds a tensor's sum into a device accumulator (two aten calls, a
reduction and an add; four device operations on a card, the bool tensor's cast and the
reduction's memset included), read by ``flush()`` at a host read the caller already makes.

Inside ``capture()`` (a CUDA graph's capture, which records device work without running
it) spans record nothing, and what the block counts goes into a ``Captured``: its
``replayed()`` counts it again at each replay of the graph, the device counters from the
tensors the graph writes. The kernel wrappers' ``launches`` count the host's calls of a
kernel's launch, so a kernel in a CUDA graph once, at its capture: ``kernel_launches``
counts the kernels that ran on the device, from a profiler window's kernel events.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import torch

_profiling = torch._C._autograd._profiler_enabled  # whether a torch.profiler records


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def device_sync(x) -> None:
    """Wait for the device work that produces ``x``; nothing to wait for on the CPU."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class PhaseTimer:
    """Accumulates wall-clock per named phase; ``report()`` gives ms + share."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        """Time the block as phase ``name``; also the recorder's span ``extract.<name>``."""
        with span(f"extract.{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync_on is not None:
                    device_sync(sync_on)
                dt = time.perf_counter() - t0
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = []
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:24s} {t*1000:9.1f} ms  ({t/total*100:5.1f}%)  x{n}  "
                f"{t/n*1000:8.2f} ms/call"
            )
        return "\n".join(lines)


class Recorder:
    """Spans and counters of one process. ``records`` holds each span as [name, start_ns,
    end_ns, parent's index in ``records`` (-1: none), unit], at most ``LIMIT`` of them
    (``dropped`` counts the rest); ``totals`` per name [count, total ns, self ns], the self
    time being the total less what the span's children cover; ``counters`` integers by
    name."""

    LIMIT = 200_000

    def __init__(self):
        self.forced = False
        self.capture: Optional["Captured"] = None  # the capture under way, if any
        self.reset()

    def reset(self) -> None:
        self.records: List[list] = []
        self.dropped = 0
        self.totals: Dict[str, List[int]] = {}
        self.counters: Dict[str, int] = {}
        self.pending: Dict[str, torch.Tensor] = {}  # device counters not read yet
        self.stack: List["_Span"] = []
        self.roots: Dict[str, int] = {}  # a root span's occurrences: its unit by default

    def flush(self) -> None:
        """Read the device counters into ``counters``: one host read of them all."""
        if not self.pending:
            return
        names = list(self.pending)
        values = torch.stack([self.pending[n] for n in names]).tolist()
        for n, v in zip(names, values):
            self.counters[n] = self.counters.get(n, 0) + int(v)
        self.pending.clear()

    def snapshot(self) -> dict:
        """The aggregates and counters (device counters read first)."""
        self.flush()
        return {"spans": {n: {"count": c, "total_ns": t, "self_ns": s}
                          for n, (c, t, s) in self.totals.items()},
                "counters": dict(self.counters), "records": len(self.records),
                "dropped": self.dropped}


class _Span:
    __slots__ = ("rec", "name", "unit", "start", "child", "index", "rf")

    def __init__(self, rec: Recorder, name: str, unit):
        self.rec, self.name, self.unit = rec, name, unit

    def __enter__(self):
        rec = self.rec
        parent = rec.stack[-1] if rec.stack else None
        if self.unit is None:
            if parent is not None:
                self.unit = parent.unit
            else:
                self.unit = rec.roots.get(self.name, 0)
                rec.roots[self.name] = self.unit + 1
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.child = 0
        self.start = time.time_ns()
        if len(rec.records) < rec.LIMIT:
            self.index = len(rec.records)
            rec.records.append([self.name, self.start, None,
                                -1 if parent is None else parent.index, self.unit])
        else:
            self.index = -1
            rec.dropped += 1
        rec.stack.append(self)
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = self.rec
        rec.stack.pop()
        self.rf.__exit__(*exc)
        dur = end - self.start
        agg = rec.totals.setdefault(self.name, [0, 0, 0])
        agg[0] += 1
        agg[1] += dur
        agg[2] += dur - self.child
        if self.index >= 0:
            rec.records[self.index][2] = end
        if rec.stack:
            rec.stack[-1].child += dur
        return False


class Captured:
    """What a block captured into a CUDA graph counted (``capture``): the recorder's host
    counts and its device counters, whose sums are tensors that each replay of the graph
    writes anew."""

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.device: Dict[str, torch.Tensor] = {}

    def replayed(self) -> None:
        """Count one replay of the graph (call it after the replay's launch)."""
        for name, n in self.counts.items():
            count(name, n)
        if self.device and counting():
            for name, t in self.device.items():
                RECORDER.pending[name] = RECORDER.pending.get(name, 0) + t


RECORDER = Recorder()
_OFF = contextlib.nullcontext()


def counting() -> bool:
    """Whether the recorder is on (a graph captured while it is on writes the device
    counters, one captured while it is off does not)."""
    return RECORDER.forced or _profiling()


def span(name: str, unit=None):
    """A context that records the block as span ``name`` while the recorder is on, else
    the shared no-op context. ``unit`` (the global step, the frame's index) defaults to the
    parent span's, and for a span without a parent to its occurrence count."""
    if not (RECORDER.forced or _profiling()) or RECORDER.capture is not None:
        return _OFF
    return _Span(RECORDER, name, unit)


def count(name: str, n: int) -> None:
    """Add ``n`` (a host integer) to counter ``name`` while the recorder is on."""
    if RECORDER.forced or _profiling():
        into = RECORDER.counters if RECORDER.capture is None else RECORDER.capture.counts
        into[name] = into.get(name, 0) + int(n)


def count_device(name: str, x: torch.Tensor) -> None:
    """Add ``x``'s sum to device counter ``name`` while the recorder is on: one reduction
    and one add on ``x``'s device, no host read (``flush`` reads it)."""
    if RECORDER.forced or _profiling():
        into = RECORDER.pending if RECORDER.capture is None else RECORDER.capture.device
        into[name] = into.get(name, 0) + x.sum()


@contextlib.contextmanager
def capture():
    """Count the block as a CUDA graph's capture: yields the ``Captured`` that holds its
    counts, for each replay to count again."""
    if RECORDER.capture is not None:
        raise RuntimeError("a capture is already under way")
    RECORDER.capture = Captured()
    try:
        yield RECORDER.capture
    finally:
        RECORDER.capture = None


def flush() -> None:
    """Read the device counters (call it where the host already waits for the device)."""
    RECORDER.flush()


def snapshot() -> dict:
    """``Recorder.snapshot`` of the process's recorder: everything recorded since the
    process started or the last ``reset()``."""
    return RECORDER.snapshot()


def reset() -> None:
    RECORDER.reset()


def enable(on: bool = True) -> None:
    """Keep the recorder on without a profiler (``on`` False: back to the profiler's
    state)."""
    RECORDER.forced = on


@contextlib.contextmanager
def trace(log_dir: str = "results/profile_trace"):
    """Profile the block with ``torch.profiler`` (CPU, plus CUDA when a card is present)
    and write ``<log_dir>/trace_<pid>_<n>.json``, a Chrome trace, and beside it
    ``spans_<pid>_<n>.json``, the recorder's ``snapshot()`` of the block with its span
    records; yields the profiler, whose ``key_averages()`` sums the events by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    RECORDER.reset()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))
    with open(os.path.join(log_dir, f"spans_{os.getpid()}_{n}.json"), "w") as f:
        json.dump(dict(snapshot(), span_records=RECORDER.records), f)


@contextlib.contextmanager
def kernel_launches(names: Sequence[str]):
    """Count the kernels that run on the card in the block, from the kernel events of a
    ``torch.profiler`` window (CUDA activity alone; on a machine without a card the window
    records host activity and counts nothing): yields a dict that holds, once the block has
    ended, the number of kernels whose name holds each of ``names``. A kernel replayed in a
    CUDA graph counts at each replay. The recorder is on inside, as under any profiler."""
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    counts = dict.fromkeys(names, 0)
    with profile(activities=[ProfilerActivity.CUDA if card else ProfilerActivity.CPU]) as prof:
        yield counts
        if card:
            torch.cuda.synchronize()
    # the raw kineto events: the profiler's event tree over a long window takes minutes
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            name = e.name()
            for n in names:
                if n in name:
                    counts[n] += 1
