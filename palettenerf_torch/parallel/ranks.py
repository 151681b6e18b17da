"""Data-parallel training over rays: one process per rank on ``torch.distributed``.

The port's counterpart of ``palettenerf_tpu/parallel/mesh.py``. The JAX package shards
the ray batch over a device mesh inside one jitted step, with replicated parameters, and
XLA inserts the gradient ``psum``. Here every rank is a process of its own that holds a
full copy of the parameters, the optimizer, the EMA and the occupancy grid, trains on
its share of each batch's rays, and sums the gradients with one all-reduce per step.

- ``spawn(fn, world, args, device)`` starts the ranks (spawn context, a TCP store on
  localhost at a free port), runs ``fn(*args)`` in each after ``init_rank``, and joins
  them, each join with a timeout: a rank that fails or a run past its deadline kills
  the others and raises.
- ``init_rank`` picks the rank's device, ``cuda:(rank % device_count)`` (or the CPU),
  and the backend: ``nccl`` when every rank has a card of its own, ``gloo`` when ranks
  share a card or run on the CPU (gloo all-reduces and broadcasts CUDA tensors, but
  does not all-gather them). Rank 0 prints the choice and why.
- ``RayGroup`` is this process's place in the run: its shard of a batch (``shard``),
  the gradient all-reduce (``reduce_grads``), and the gather of the error map's rows
  (``gather_rows``; the trainer gathers an eval frame's chunks in the same way).

Which rays a rank holds (``RayShard``): a contiguous block of ``n / world`` rays, so a
patch batch is cut only between patches; a paired batch (``--random_size``: pixel i
and its jittered partner i + n/2) gives rank r the same block of both halves, so the
pairs stay on one rank. Every rank draws the whole batch's randomness from the same
generator and takes its rows, which keeps the generators in step and the rays equal to
those of the single-process run.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import socket
import sys
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT_S = 900.0  # a rank waits this long at a collective for the others

_GROUP: Optional["RayGroup"] = None  # the group of this process, set by init_rank


class RayShard(NamedTuple):
    """A rank's rays of a batch of ``n``: ``blocks`` of (start, length) in ray units."""

    n: int
    blocks: Tuple[Tuple[int, int], ...]

    @property
    def size(self) -> int:
        return sum(length for _, length in self.blocks)

    def take(self, a):
        """The rank's rows of ``a`` [n * k, ...] (a tensor or an array; ray i owns rows
        i*k .. i*k + k - 1), as one [size * k, ...]; slices only, no index upload."""
        if a.shape[0] % self.n:
            raise ValueError(f"{a.shape[0]} rows are not a whole number per ray of {self.n}")
        k = a.shape[0] // self.n
        parts = [a[s * k:(s + length) * k] for s, length in self.blocks]
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts) if isinstance(a, torch.Tensor) else np.concatenate(parts)

    def place(self, local: torch.Tensor) -> torch.Tensor:
        """A zero tensor for the full batch [n * k, ...] with ``local`` (this rank's rows,
        ``take``'s layout) at its rows."""
        k = local.shape[0] // self.size
        out = local.new_zeros((self.n * k, *local.shape[1:]))
        at = 0
        for s, length in self.blocks:
            out[s * k:(s + length) * k] = local[at:at + length * k]
            at += length * k
        return out


class RayGroup:
    """This process's rank in a ray data-parallel run."""

    def __init__(self, rank: int, world: int, device: torch.device, backend: str):
        self.rank, self.world, self.device, self.backend = rank, world, device, backend

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def shard(self, n: int, paired: bool = False, patch: int = 1) -> RayShard:
        """This rank's rays of a batch of ``n`` (see the module docstring). Raises where
        the batch does not split evenly: ``n % world`` (as JAX's assertion), a patch of
        ``patch`` rays or a pair that would be cut."""
        w, r = self.world, self.rank
        if paired:
            half = n // 2
            if n % 2 or half % w:
                raise ValueError(f"a paired batch of {n} rays does not split into {w} ranks "
                                 f"with both halves of every pair on one rank")
            b = half // w
            return RayShard(n, ((r * b, b), (half + r * b, b)))
        if n % w or (n // patch) % w or n % patch:
            raise ValueError(f"a batch of {n} rays ({patch} per patch) does not split "
                             f"into {w} ranks of whole patches (num_rays % n_devices)")
        b = n // w
        return RayShard(n, ((r * b, b),))

    # ------------------------------------------------------------------ collectives

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def reduce_grads(self, params: List[torch.Tensor], scalars: torch.Tensor) -> torch.Tensor:
        """Sum the gradients of ``params`` over the ranks, and the f32 ``scalars`` [m]
        with them, in one all-reduce of a flat f32 buffer; returns the summed scalars.
        Every rank sends a gradient for every tensor (zeros where its backward gave
        none) and a flag of whether it had one: a tensor that got a gradient on any rank
        is stepped on every rank, one that got none anywhere keeps ``grad`` None, so
        each rank steps the same tensors as the single-process run would."""
        if any(p.dtype != torch.float32 for p in params):
            raise TypeError("reduce_grads sums float32 parameters only")
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        has = torch.tensor([p.grad is not None for p in params], dtype=torch.float32)
        tail = torch.cat([has.to(scalars.device), scalars.reshape(-1).float()])
        flat = self.all_reduce_(torch._utils._flatten_dense_tensors(grads + [tail]))
        summed = torch._utils._unflatten_dense_tensors(flat, grads + [tail])
        anywhere = (summed[-1][:len(params)] > 0).tolist()
        for p, g, on in zip(params, summed, anywhere):
            p.grad = g if on else None
        # a copy: a view would keep the whole flat buffer alive as long as the scalars
        return summed[-1][len(params):].clone()

    def gather_rows(self, local: torch.Tensor, shard: RayShard) -> torch.Tensor:
        """The full batch's rows from every rank's ``local`` rows (``shard.take``'s
        layout), on every rank: each places its rows in zeros, and an all-reduce sums
        them (a sum with zeros is exact)."""
        return self.all_reduce_(shard.place(local))


def group() -> Optional[RayGroup]:
    """The ray data-parallel group of this process, or None outside a rank."""
    return _GROUP


def group_for(n_devices: int) -> Optional[RayGroup]:
    """The group a trainer of a run with ``--n_devices n_devices`` trains in: None for
    one device; for more, this process's rank, which must have been started for that
    many (``spawn``; the CLIs do it for ``--n_devices``)."""
    if n_devices <= 1:
        return None
    if _GROUP is None or _GROUP.world != n_devices:
        have = "no rank" if _GROUP is None else f"a rank of {_GROUP.world}"
        raise RuntimeError(f"n_devices {n_devices} trains one process per rank and this "
                           f"process is {have}: start the ranks with "
                           f"palettenerf_torch.parallel.spawn, as main_nerf and main_palette "
                           f"do for --n_devices")
    return _GROUP


def check_batch(num_rays: int, n_devices: int, patch_size: int = 1, random_size: int = 0):
    """Raise ValueError where a batch of ``num_rays`` rays does not split into
    ``n_devices`` ranks (JAX trainer.py:96 asserts ``num_rays % n_devices == 0``), with the
    patches or pairs of the batch kept whole."""
    if n_devices <= 1:
        return
    if num_rays % n_devices:
        raise ValueError(f"num_rays={num_rays} must divide n_devices={n_devices}")
    if patch_size > 1 and (num_rays // patch_size ** 2) % n_devices:
        raise ValueError(f"num_rays={num_rays} holds {num_rays // patch_size ** 2} patches of "
                         f"{patch_size}x{patch_size}, not a multiple of n_devices={n_devices}")
    if patch_size <= 1 and random_size > 0 and (num_rays // 2) % n_devices:
        raise ValueError(f"num_rays={num_rays} holds {num_rays // 2} pixel pairs, not a "
                         f"multiple of n_devices={n_devices}")


def run_cli(rank_main: Callable, cfg, argv, workspace: str, *args) -> None:
    """A CLI's ``--n_devices`` run from the parent process: check that the batch splits,
    then run ``rank_main(argv, *args)`` in ``cfg.n_devices`` spawned ranks and wait for
    them. ``argv`` (None: this process's command line) gets ``--version_id`` of
    ``workspace`` (``.../version_N``, resolved here once), so that every rank opens the
    same workspace. ``args[0]`` is the device."""
    check_batch(cfg.num_rays, cfg.n_devices, cfg.patch_size, cfg.random_size)
    if cfg.gui:
        raise ValueError("--gui runs in one process: pass --n_devices 1")
    argv = list(sys.argv[1:] if argv is None else argv)
    argv += ["--version_id", workspace.rstrip("/").split("_")[-1]]
    spawn(rank_main, cfg.n_devices, args=(argv, *args), device=args[0])


def rank_device(rank: int, device="cuda") -> torch.device:
    """``cuda:(rank % device_count)`` for a CUDA run, the CPU for a CPU run."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("CUDA device requested but torch.cuda.device_count() is 0; "
                           "pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", rank % count)


def choose_backend(world: int, device: torch.device) -> Tuple[str, str]:
    """(backend, why): nccl when every rank has a card of its own, else gloo."""
    if device.type != "cuda":
        return "gloo", "the ranks run on the CPU"
    count = torch.cuda.device_count()
    if count >= world:
        return "nccl", f"{world} ranks on {count} cards: one card each"
    return "gloo", f"{world} ranks share {count} card(s) (NCCL needs one card per rank)"


def init_rank(rank: int, world: int, init_method: str, device="cuda",
              timeout_s: float = COLLECTIVE_TIMEOUT_S) -> RayGroup:
    """Join the run as ``rank`` of ``world`` and make this process's group."""
    global _GROUP
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend, why = choose_backend(world, dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _GROUP = RayGroup(rank, world, dev, backend)
    if rank == 0:
        print(f"[DP] {world} ranks over rays, backend {backend}: {why}", flush=True)
    return _GROUP


def shutdown() -> None:
    global _GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUP = None


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn: Callable, rank: int, world: int, init_method: str, device,
                args: tuple, timeout_s: float) -> None:
    init_rank(rank, world, init_method, device, timeout_s)
    try:
        fn(*args)
    finally:
        shutdown()


def spawn(fn: Callable, world: int, args: tuple = (), device="cuda",
          timeout_s: Optional[float] = None,
          collective_timeout_s: float = COLLECTIVE_TIMEOUT_S) -> None:
    """Run ``fn(*args)`` in ``world`` new processes, one per rank (``fn`` must be
    importable: spawn pickles it by name). Each join waits at most a second; when a rank
    exits with an error, or ``timeout_s`` (None: no limit) has passed, the others are
    killed and this raises."""
    ctx = mp.get_context("spawn")
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_entry, name=f"rank{r}",
                         args=(fn, r, world, init_method, device, args,
                               collective_timeout_s))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            for p in procs:
                p.join(timeout=1.0 / world)
            failed = [(p.name, p.exitcode) for p in procs if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"ranks exited with errors: {failed}")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after {timeout_s} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
    failed = [(p.name, p.exitcode) for p in procs if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"ranks exited with errors: {failed}")
