"""One run of one benchmark cell of ``palettenerf_torch`` on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process: set-up (load, build, warm up every shape of the cell), a measured window of
``--seconds``, the check of what the window produced against the plain reference, then
one JSON line as the last line of standard output. ``--trace 1`` runs the window under
``torch.profiler`` and reports the cell's per-layer metrics in place of its end-to-end
ones. Exits non-zero without a result when no card (or too few) is present, when the
cell's files are missing, and when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

PROCESS_T0 = time.perf_counter()  # set-up is timed from here: before torch is imported

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _environment(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the port builds
    its nvcc kernels under ``palettenerf_torch/build/`` itself), and one host thread for
    the math libraries: a run is one process whose host side is one dispatch loop, and
    idle worker threads spinning beside it on a shared host only add noise."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cache = os.path.join(root, "portbench", ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    root = os.getcwd()
    _environment(root)
    from portbench import harness

    try:
        cell = harness.load_cell(root, args.workload)
    except harness.CellError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    ctx = harness.RunContext(cell=cell, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), device=torch.device("cuda", 0),
                             t0=PROCESS_T0)
    return harness.execute(ctx)


if __name__ == "__main__":
    sys.exit(main())
