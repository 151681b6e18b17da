"""The numbers that decide ``correct`` for a training cell, from the program's readings
and the reference's over the same first steps.

- ``loss_gap``: the largest relative gap of a step's loss, ``|L - L_ref| / |L_ref|``.
- ``grad_gap``: over the leaves, the largest gap of the first gradient's norm,
  ``| |g| - |g_ref| |``, over the larger of the leaf's reference norm and the median
  leaf's.
- ``change_gap``: the same of each leaf's change over the steps, of the median leaf, over
  the leaves whose first reference gradient is at least a thousandth of the median leaf's
  (a leaf whose gradient is nought to rounding moves under Adam by round-off alone). The
  median, not the worst: after the first step the program's table differs from the
  reference's where Adam's step took the other sign of a gradient that nearly cancels
  (the bf16 rounding of ``-O``'s backward, or the order of f32 atomics), and the later
  steps carry that into one small leaf or another by up to 5e-4, seed by seed.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

NEGLIGIBLE = 1e-3  # a leaf's gradient under this share of the median leaf's


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> list:
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys]


def training_gaps(losses: List[float], ref_losses: List[float], grads: Dict[str, float],
                  ref_grads: Dict[str, float], changes: Dict[str, float],
                  ref_changes: Dict[str, float]) -> Dict[str, float]:
    """Norms per leaf in, the three gaps out."""
    if set(grads) != set(ref_grads) or set(changes) != set(ref_changes):
        raise ValueError(f"leaves differ: {sorted(grads)} vs {sorted(ref_grads)}")
    med = statistics.median(ref_grads.values())
    moving = [k for k in ref_grads if ref_grads[k] >= NEGLIGIBLE * med]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses, strict=True))
    return {"loss_gap": loss_gap, "grad_gap": max(leaf_gaps(grads, ref_grads, ref_grads)),
            "change_gap": statistics.median(leaf_gaps(changes, ref_changes, moving))}
