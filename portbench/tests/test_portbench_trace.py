"""The trace reduction on a made-up event list: busy time as the union of the device
operations in the window, their count, the idle gaps labelled by the host, on events
with and without ``activity_type`` (older PyTorch)."""

from __future__ import annotations

import types

import pytest
import torch

from portbench import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, device, start, end, kind=None):
        self._v = (name, device, start, end)
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]


def events(with_kind: bool):
    k = (lambda x: x) if with_kind else (lambda x: None)
    return [
        Event("portbench.window", CPU, 1000, 11000, k("user_annotation")),
        Event("portbench.window", CUDA, 1000, 11000, k("gpu_user_annotation")),
        Event("aten::mm", CPU, 1500, 2500, k("cpu_op")),
        Event("gemm", CUDA, 2000, 4000, k("kernel")),
        Event("gemm", CUDA, 3000, 5000, k("kernel")),       # overlaps the first
        Event("cudaStreamSynchronize", CPU, 5000, 9000, k("cuda_runtime")),
        Event("memset", CUDA, 9000, 10000, k("gpu_memset")),
        Event("late", CUDA, 20000, 21000, k("kernel")),     # after the window
    ]


@pytest.mark.parametrize("with_kind", [True, False])
def test_reduction(with_kind):
    prof = types.SimpleNamespace(
        __exit__=lambda *a: None,
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(
            events=lambda: events(with_kind))))
    s = trace.stop(prof)
    assert s.window_s == pytest.approx(10e-6)
    assert s.busy_s == pytest.approx(4e-6)                 # [2000, 5000) and [9000, 10000)
    assert s.device_ops == 3 and s.kernels["gemm"][0] == 2
    assert s.idle_gaps[0] == ["cudaStreamSynchronize", pytest.approx(4e-6)]
    assert trace.idle_percent(s) == pytest.approx(60.0)
