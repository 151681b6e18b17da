"""MLPs on weight lists in the JAX layout ``[in, out]`` (``y = x @ W + b``).

Port of ``palettenerf_tpu/models/mlp.py``. A layer is a ``[in, out]`` weight tensor, or
a ``{"w": [in, out], "b": [out]}`` dict where the layer has a bias (the JAX package's
``{"w", "b"}`` layers; the PaletteNeRF ``offsets_radiance_net`` is the one such head).
Initialization is ``torch.nn.Linear``'s default bound, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
for weights and biases, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch


def init_mlp(dims: Sequence[int], generator: torch.Generator, device="cpu",
             dtype=torch.float32, bias: bool = False) -> List:
    """dims = [in, hidden..., out] -> list of [in, out] weights ({"w", "b"} with ``bias``)."""
    layers = []
    for i in range(len(dims) - 1):
        bound = 1.0 / (dims[i] ** 0.5)
        w = torch.empty((dims[i], dims[i + 1]), dtype=dtype, device=device)
        w.uniform_(-bound, bound, generator=generator)
        if bias:
            b = torch.empty((dims[i + 1],), dtype=dtype, device=device)
            layers.append({"w": w, "b": b.uniform_(-bound, bound, generator=generator)})
        else:
            layers.append(w)
    return layers


def apply_linear(layer, x: torch.Tensor) -> torch.Tensor:
    if isinstance(layer, dict):
        y = x @ layer["w"]
        return y + layer["b"] if "b" in layer else y
    return x @ layer


def apply_mlp(layers: Sequence, x: torch.Tensor,
              activation: Callable = torch.relu,
              final_activation: Optional[Callable] = None) -> torch.Tensor:
    h = x
    for i, layer in enumerate(layers):
        h = apply_linear(layer, h)
        if i != len(layers) - 1:
            h = activation(h)
    if final_activation is not None:
        h = final_activation(h)
    return h


def param_leaves(params: dict, skip=()) -> List[torch.Tensor]:
    """Every tensor of a parameter dict in a fixed order (insertion order of the keys,
    layers in order, a biased layer as w then b), without the keys in ``skip``."""
    out = []
    for k, v in params.items():
        if k in skip:
            continue
        for layer in (v if isinstance(v, list) else [v]):
            out.extend(layer.values() if isinstance(layer, dict) else [layer])
    return out
