"""Small cells for the CPU: a few views of ``data_proc/proc_toys`` shrunk by block means,
and the benchmark's configurations cut to a size the CPU runs in seconds."""

from __future__ import annotations

import copy
import json
import os
import struct
import time
import zlib

import numpy as np
import torch

from portbench import harness
from portbench.reference.png import read_png

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = {"num_levels": 4, "log2_hashmap_size": 12, "num_rays": 256,
        "train_samples_per_ray": 16, "max_steps": 128}


def write_png(path: str, img: np.ndarray) -> None:
    """8-bit RGBA, each row with a filter type cycling through 0-4 (so a reader meets
    every filter)."""
    H, W, C = img.shape
    x = img.astype(np.int64)
    rows = []
    for r in range(H):
        kind = r % 5
        cur = x[r]
        up = x[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros((1, C), np.int64), cur[:-1]])
        ul = np.concatenate([np.zeros((1, C), np.int64), up[:-1]])
        if kind == 4:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        else:
            pred = [0, left, up, (left + up) // 2][kind]
        rows.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 6, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def small_scene(dst: str, views: int = 4, factor: int = 16) -> str:
    """The first ``views`` training views and two test views of proc_toys, shrunk
    ``factor`` times."""
    src = os.path.join(ROOT, "data_proc", "proc_toys")
    for split, n in (("train", views), ("test", 2)):
        with open(os.path.join(src, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        meta["frames"] = meta["frames"][:n]
        os.makedirs(os.path.join(dst, split), exist_ok=True)
        for fr in meta["frames"]:
            img = read_png(os.path.join(src, fr["file_path"] + ".png")).astype(np.float64)
            H, W, C = img.shape
            small = img.reshape(H // factor, factor, W // factor, factor, C).mean((1, 3))
            write_png(os.path.join(dst, fr["file_path"] + ".png"),
                      np.rint(small).astype(np.uint8))
        with open(os.path.join(dst, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
    return dst


SMALL_TRAFFIC = {
    # at this size the bf16 rounding of the scatter's updates weighs more in a step: the
    # CPU run reads loss 2.7e-6, grad 1.2e-4, change 5.2e-5; the faults 1e-2 and more
    "device-epochs": {"limits": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 3e-3}},
    "orbit-edit": {"resolution": 32, "H": 64, "W": 64, "u_res": 48, "check_every": 1,
                   "check_frames": 2, "warm_frames": 1},
    "exact-frames": {"chunk": 1024, "check_every": 1, "check_frames": 1, "check_chunks": 2},
}


def small_cell(name: str, scene: str, **traffic) -> harness.Cell:
    """Cell ``name`` of BENCHMARK.json at the CPU's size, on ``scene``."""
    cell = harness.load_cell(ROOT, name)
    cell = copy.deepcopy(cell)
    cell.config.update(TINY)
    cell.traffic.update(SMALL_TRAFFIC.get(cell.traffic_name, {}))
    cell.traffic.update(data=os.path.relpath(scene, ROOT), **traffic)
    return cell


def run_cpu(cell: harness.Cell, seed: int = 1234567890123, seconds: float = 0.01,
            trace: bool = False, plant=None) -> dict:
    """A whole run of ``cell`` on the CPU (no look for a card), as a result dict."""
    torch.set_num_threads(2)
    ctx = harness.RunContext(cell=cell, seed=seed, seconds=seconds, trace=trace,
                             device=torch.device("cpu"), t0=time.perf_counter())
    return harness.measure(ctx, plant=plant)
