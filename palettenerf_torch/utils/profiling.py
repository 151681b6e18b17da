"""Phase timing and trace capture.

The port's counterpart of ``palettenerf_tpu/utils/profiling.py``:

- ``device_sync(x)`` waits for the CUDA work that produces ``x`` (a tensor, or a list,
  tuple or dict of them: the first tensor found decides the device); CPU tensors need no
  wait.
- ``PhaseTimer`` sums wall seconds per named phase, with the JAX class's API and the
  same ``report()`` text for the same totals.
- ``trace(log_dir)`` records a ``torch.profiler`` trace (CPU activity, and CUDA
  activity when a card is present) and writes it as a Chrome trace into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


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


@contextlib.contextmanager
def trace(log_dir: str = "results/profile_trace"):
    """Profile the block with ``torch.profiler`` (CPU, plus CUDA when a card is present)
    and write ``<log_dir>/trace_<pid>_<n>.json``, a Chrome trace; yields the profiler,
    whose ``key_averages()`` sums the events by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))
