"""The readings that a cell's limits are set from, beside the program's own: the control
and the planted faults, on the card at the cell's own size.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...] [--fault NAME]

Without ``--fault``: the control (the driver's ``control``), the plain reference put in
the program's place at the next precision below the configuration's, compared with the
reference on the same inputs, seed by seed. With ``--fault``: a run with a fault of the
driver's ``FAULTS`` planted in the program's timed path; with ``--program``, the same run
without one (the program's own readings; training cells need no window). Prints one JSON
line per seed with the numbers the cell compares.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from portbench import harness


def faulty(cell: harness.Cell, seed: int, fault, device, seconds: float = 0.0) -> dict:
    """The cell's checks on a run of ``seconds`` with ``fault`` planted in the program's
    timed path before its first step or frame (None: the program as it is)."""
    driver = harness.load_module("drivers", cell.traffic["driver"])
    ctx = harness.RunContext(cell=cell, seed=seed, seconds=seconds, trace=False,
                             device=device, t0=time.perf_counter())
    result = harness.measure(ctx, plant=fault and driver.FAULTS[fault])
    return {k: v["value"] for k, v in result["checks"].items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", help="a fault of the cell's driver (its FAULTS)")
    p.add_argument("--program", action="store_true",
                   help="the program's own readings (a run's checks), no fault")
    p.add_argument("--seconds", type=float, default=0.0, help="window of a faulty run")
    a = p.parse_args(argv)
    cell = harness.load_cell(os.getcwd(), a.workload)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    driver = harness.load_module("drivers", cell.traffic["driver"])
    print(f"card {harness.power_limit()}", file=sys.stderr)
    for seed in a.seeds:
        t = time.perf_counter()
        got = (faulty(cell, seed, a.fault, dev, a.seconds) if a.fault or a.program
               else driver.control(cell, seed, dev))
        what = a.fault or ("program" if a.program else "control")
        print(json.dumps({"workload": a.workload, "seed": seed, "fault": what,
                          "seconds": time.perf_counter() - t, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
