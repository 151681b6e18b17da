"""palettenerf_torch — the PyTorch/CUDA port of ``palettenerf_tpu`` for NVIDIA Hopper.

The JAX package beside it is the reference; this package imports nothing from it
(and never imports ``jax``). Its layout mirrors the JAX package so that every
counterpart is easy to find:

  ops/     hash grid, SH, ray/AABB, marching, compositing, occupancy, the kernel wrappers
  csrc/    hand-written CUDA C++ kernels (built with ``nvcc`` at first use)
  models/  stage-1 NeRF and PaletteNeRF (eval) networks as functions on a parameter dict
  render/  NeRF train/eval renderers; palette edits, baking and the shear-warp sweep
  data/    dataset provider, PNG codec, ray generation
  train/   trainer (with the GUI hooks and the mesh export), checkpoints (incl. the
           JAX package's pickles), metrics
  gui/     orbit camera, the headless EditingSession, the optional DearPyGui front-ends
  parallel/  ray data-parallel training over ``torch.distributed``, one process per rank
  native/  the extraction's host kernels in C++ (built with ``g++`` at first use)
  utils/   color conversions, marching tetrahedra + PLY, phase timer and trace capture

Ported: the stage-1 Instant-NGP train step with ``-O`` (bf16 hash-grid backward through
the CUDA scatter kernel), the density-grid refresh, the exact eval render and the mesh
export (``python -m palettenerf_torch.main_nerf``); palette extraction and PaletteNeRF
training (``python -m palettenerf_torch.main_palette``); interactive editing
(``palettenerf_torch.gui``); serving — a trained palette checkpoint baked into dense
volumes, frames by the shear-warp sweep with live recolors (``python -m
palettenerf_torch.main_serve``); every training profile and model option of the JAX
trainers but ``--rand_pose`` (the background net, the linear colour space, the rLPIPS
patch loss, the meters and ``--n_devices > 1`` among them); the leaf ops; and the
window-gather kernel.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the CPU.

    Raises when CUDA is requested and absent — entry points never fall back to
    the CPU on their own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    return dev


__all__ = ["resolve_device", "__version__"]
