"""Reduce a ``torch.profiler`` trace of the window to what the per-layer metrics read.

The arithmetic of ``palettenerf_torch/profile_main_path.py`` (device operations of the
trace, their count and summed time), with the busy time taken as the union of the
device operations' intervals inside the window, so that overlapping work is counted
once.
The idle gaps are labelled by the host operation that was running in their middle.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

TOP = 10


@dataclasses.dataclass
class TraceSummary:
    window_s: float                       # the traced window's length
    busy_s: float                         # union of device intervals in the window
    device_ops: int                       # device events (kernels, copies, fills)
    kernels: Dict[str, Tuple[int, float]]  # name -> (count, seconds)
    top_ops: List[list]                   # [[name, seconds], ...] by seconds
    idle_gaps: List[list]                 # [[host op, seconds], ...] by seconds

    def per_launch_s(self, fragment: str):
        """Mean device seconds per launch of the kernels whose name holds ``fragment``, or
        None when none ran."""
        hits = [(n, s) for k, (n, s) in self.kernels.items() if fragment in k]
        count = sum(n for n, _ in hits)
        return sum(s for _, s in hits) / count if count else None


def start():
    import torch

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def _merge(iv: np.ndarray) -> np.ndarray:
    """Sorted, disjoint union of intervals [n, 2]."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    group = np.cumsum(new) - 1
    stops = np.zeros(len(starts))
    np.maximum.at(stops, group, ends)
    return np.stack([starts, stops], 1)


# activity types of the trace's device operations (its GPU user annotations, the copies
# of the host's labels onto the device's timeline, are not operations)
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


def _kind(e) -> str:
    """'device' for a device operation, 'annotation' for a label, else 'host'. Older
    PyTorch events have no ``activity_type``: there a device event is one on the CUDA
    device type that is not a user annotation."""
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        if kind in DEVICE_OPS:
            return "device"
        return "annotation" if kind in ("user_annotation", "gpu_user_annotation") else "host"
    import torch

    label = (e.is_user_annotation() if hasattr(e, "is_user_annotation")
             else e.name().startswith("portbench."))
    if label:
        return "annotation"
    return "device" if e.device_type() == torch.autograd.DeviceType.CUDA else "host"


def _span(e) -> tuple:
    start = e.start_ns()
    return start, (e.end_ns() if hasattr(e, "end_ns") else start + e.duration_ns())


def stop(prof) -> TraceSummary:
    """Close the profiler and reduce its raw events (the kineto results: building the
    profiler's event tree over a window of a million launches takes minutes)."""
    import torch

    prof.__exit__(None, None, None)
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    dev, host, window = [], [], None
    for e in events:
        kind = _kind(e)
        if kind == "device":
            dev.append(e)
        elif e.device_type() == cpu:
            host.append(e)
            if kind == "annotation" and e.name() == "portbench.window":
                window = _span(e)
    if window is None:
        raise RuntimeError("the trace holds no portbench.window span")
    lo, hi = window
    kernels: Dict[str, list] = {}
    iv = []
    for e in dev:
        s, t = _span(e)
        if t <= lo or s >= hi:
            continue
        k = kernels.setdefault(e.name(), [0, 0.0])
        k[0] += 1
        k[1] += (t - s) / 1e9
        iv.append((max(s, lo), min(t, hi)))
    merged = _merge(np.asarray(iv, np.float64).reshape(-1, 2))
    busy = float((merged[:, 1] - merged[:, 0]).sum()) / 1e9
    edges = np.concatenate([[lo], merged.reshape(-1), [hi]]).reshape(-1, 2)
    gaps = edges[:, 1] - edges[:, 0]
    order = np.argsort(-gaps)[:TOP]
    spans = np.array([_span(e) for e in host], np.float64).reshape(-1, 2)
    hs, he = spans[:, 0], spans[:, 1]
    idle = []
    for i in order:
        if gaps[i] <= 0:
            break
        mid = 0.5 * (edges[i, 0] + edges[i, 1])
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        label = host[inside[np.argmax(hs[inside])]].name() if len(inside) else "no host op"
        idle.append([label[:120], float(gaps[i]) / 1e9])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return TraceSummary(
        window_s=(hi - lo) / 1e9, busy_s=busy, device_ops=sum(k[0] for k in kernels.values()),
        kernels={k: (v[0], v[1]) for k, v in kernels.items()},
        top_ops=[[k[:160], v[1]] for k, v in top], idle_gaps=idle)


def idle_percent(summary) -> float:
    """Share of the window in which no device operation ran, in %."""
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
