"""The general part of a run: find a cell's files by name, time set-up and the window,
trace it, read the per-layer metrics, check the results and print the result line.

What belongs to one configuration, traffic mix or metric lives in files of its own:

- ``BENCHMARK.json`` (repository root): the cells and metrics;
- ``portbench/configs/<config>.json``: a configuration's sizes, recipe and sources;
- ``portbench/workloads/<traffic>.json``: a traffic mix, naming its driver and limits;
- ``portbench/drivers/<driver>.py``: one timed path (``setup``, ``unit``,
  ``end_to_end``, ``check``);
- ``portbench/metrics/<metric>.py``: one per-layer metric (``read(reading)``).

A driver module provides:

- ``setup(ctx) -> state``: load and build, warm up every shape of the cell;
- ``unit(state) -> int``: one unit of the window's work (an epoch, a frame), ending in a
  host read of its result; returns the units of work it did (steps, frames);
- ``end_to_end(state, window) -> dict``: the cell's end-to-end values;
- ``check(state) -> list[Check]``: frees the program's state, runs the plain reference
  and returns the numbers compared, each with its limit;
- ``control(cell, seed, device) -> dict`` and ``FAULTS`` (``portbench.control``): the
  readings its limits are set from. ``setup(ctx, plant=fault)`` plants a fault.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "palettenerf_tpu")
PKG = os.path.dirname(os.path.abspath(__file__))


class CellError(Exception):
    """A cell, or one of its files, that cannot be found or read."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str


def _read_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CellError(f"cannot read {path}: {e}") from e


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its configuration, its traffic
    and the metrics it reports."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _read_json(os.path.join(root, conf["file"]))
    traffic = _read_json(os.path.join(PKG, "workloads", f"{w['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic_name=w["traffic"],
                traffic=traffic,
                end_to_end=e2e, per_layer=per_layer, root=root)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold ``.`` and ``-``)."""
    path = os.path.join(PKG, kind, f"{name}.py")
    if not os.path.exists(path):
        raise CellError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit (the number passes when it
    is at most the limit)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Window:
    units: int = 0              # steps or frames completed
    calls: int = 0              # unit() calls
    seconds: float = 0.0
    latencies: List[float] = dataclasses.field(default_factory=list)  # per call, s


@dataclasses.dataclass
class RunContext:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    spans: Dict[str, float] = dataclasses.field(default_factory=dict)
    workdir: str = ""  # the trainers' workspace (their log lines), under TMPDIR

    def __post_init__(self):
        if not self.workdir:
            self.workdir = tempfile.mkdtemp(prefix="portbench-")

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def sync(self) -> None:
        if getattr(self.device, "type", "cpu") == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        """Seconds of the enclosed calls, the device's work included, in ``spans``."""
        self.sync()
        t = time.perf_counter()
        yield
        self.sync()
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t


@dataclasses.dataclass
class Reading:
    """What a per-layer metric reader may read."""

    cell: Cell
    window: Window
    spans: Dict[str, float]
    trace: Optional[object]  # trace.TraceSummary of the traced window


def run_window(ctx: RunContext, unit: Callable[[], int]) -> tuple:
    """Call ``unit`` until ``ctx.seconds`` have passed (whole calls); under the profiler
    when ``ctx.trace``. Returns (Window, TraceSummary or None)."""
    import torch

    w = Window()
    prof = None
    if ctx.trace:
        from . import trace as trace_mod
        prof = trace_mod.start()
    ctx.sync()
    with (torch.profiler.record_function("portbench.window") if prof else
          contextlib.nullcontext()):
        t_start = time.perf_counter()
        while w.calls == 0 or time.perf_counter() - t_start < ctx.seconds:
            t = time.perf_counter()
            with (torch.profiler.record_function("portbench.unit") if prof else
                  contextlib.nullcontext()):
                w.units += unit()
            w.latencies.append(time.perf_counter() - t)
            w.calls += 1
        ctx.sync()
        w.seconds = time.perf_counter() - t_start
    summary = None
    if prof is not None:
        from . import trace as trace_mod
        summary = trace_mod.stop(prof)
    return w, summary


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device, count: int) -> dict:
    import torch

    if getattr(device, "type", "cpu") == "cuda":
        peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them (or why not)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def measure(ctx: RunContext, plant=None) -> dict:
    """Set-up, window and check of ``ctx``'s cell: everything of a result line but its
    printing. Also what the tests drive, on the CPU, where ``plant`` breaks the timed path
    underneath (``portbench.control.FAULTS``)."""
    cell = ctx.cell
    driver = load_module("drivers", cell.traffic["driver"])
    state = driver.setup(ctx) if plant is None else driver.setup(ctx, plant=plant)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0
    print("portbench: set-up " + ", ".join(f"{k} {v:.3f}" for k, v in ctx.spans.items())
          + f" of {setup_s:.3f} s", file=sys.stderr, flush=True)
    window, summary = run_window(ctx, lambda: driver.unit(state))
    device = device_info(ctx.device, cell.chips)
    e2e = driver.end_to_end(state, window)
    e2e["setup_s"] = setup_s
    checks = driver.check(state)
    del state
    shutil.rmtree(ctx.workdir, ignore_errors=True)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if ctx.trace:
        reading = Reading(cell=cell, window=window, spans=ctx.spans, trace=summary)
        values = {}
        for m in cell.per_layer:
            v = load_module("metrics", m["name"]).read(reading)
            if v is not None:
                values[m["name"]] = v
        device.update(busy_s=summary.busy_s, window_s=summary.window_s)
    else:
        values = {m["name"]: e2e[m["name"]] for m in cell.end_to_end}
    result = {
        "correct": all(c.ok for c in checks) and bool(checks),
        "attempted": window.units,
        "failed": 0,
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
        "device": device,
    }
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.top_ops, "idle_gaps": summary.idle_gaps}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def execute(ctx: RunContext) -> int:
    """Measure, then print the result line (exit 0), or exit non-zero without one when
    JAX or the JAX package got loaded."""
    print(f"portbench: {ctx.cell.name} seed {ctx.seed}, {ctx.seconds:g} s window, trace "
          f"{int(ctx.trace)}; card {power_limit()}", file=sys.stderr, flush=True)
    result = measure(ctx)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
