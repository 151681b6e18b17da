"""Encoder factory (reference ``encoding.py:45-78`` ``get_encoder``).

Port of ``palettenerf_tpu/ops/encoding.py``. Returns ``(encode_fn, output_dim, init_fn)``
for a named encoding: ``encode_fn(params, x, **kw) -> features`` and
``init_fn(generator) -> params or None``, with ``generator`` a ``torch.Generator`` on the
device the parameters should live on. Names: None / frequency / sphere_harmonics /
hashgrid / tiledgrid. No product path calls it.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .freq import freq_encode, freq_output_dim
from .hashgrid import HashGridSpec, init_hashgrid
from .hashgrid_fast import hashgrid_encode_fast_bounded
from .sh import sh_encode


def get_encoder(
    encoding,
    input_dim: int = 3,
    multires: int = 6,
    degree: int = 4,
    num_levels: int = 16,
    level_dim: int = 2,
    base_resolution: int = 16,
    log2_hashmap_size: int = 19,
    desired_resolution: float = 2048,
    align_corners: bool = False,
    **kwargs,
) -> Tuple[Callable, int, Callable]:
    if encoding in (None, "None", "none"):
        return (lambda params, x, **kw: x), input_dim, (lambda generator: None)

    if encoding == "frequency":
        return ((lambda params, x, **kw: freq_encode(x, multires)),
                freq_output_dim(input_dim, multires), (lambda generator: None))

    if encoding == "sphere_harmonics":
        return ((lambda params, d, **kw: sh_encode(d, degree)), degree ** 2,
                (lambda generator: None))

    if encoding in ("hashgrid", "tiledgrid"):
        spec = HashGridSpec.build(
            input_dim=input_dim, num_levels=num_levels, level_dim=level_dim,
            base_resolution=base_resolution, log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution,
            gridtype="hash" if encoding == "hashgrid" else "tiled",
            align_corners=align_corners,
        )

        def encode(params: torch.Tensor, x: torch.Tensor, bound: float = 1.0, **kw):
            return hashgrid_encode_fast_bounded(params, x, spec, bound)

        def init(generator: torch.Generator) -> torch.Tensor:
            return init_hashgrid(spec, generator, generator.device)

        encode.spec = spec  # the grid's construction, for callers that need it
        return encode, spec.output_dim, init

    raise NotImplementedError(
        f"Unknown encoding '{encoding}'; choose from "
        "[None, frequency, sphere_harmonics, hashgrid, tiledgrid]"
    )
