"""Operations and bytes of the measured work, counted from a configuration's widths.

The yardstick of the roofline and peak shares: it reads only the configuration file
(``portbench/configs/<config>.json``), never the program.

FLOPs: a multiply-add is 2. A dense layer of ``i`` inputs and ``o`` outputs is ``2 i o``
per row forward; its backward (input and weight gradients) twice that, so forward and
backward together are three times the forward. A hash-grid encode reads 8 corners of
``C`` features per level and adds each with its weight (``2 C``), the weight being a
product of three factors ``f`` or ``1 - f`` (4): ``L * 8 * (2 C + 4)`` per point forward,
counted three times with its backward like a layer.

Bytes of the hash-grid backward's scatter kernel (``csrc/scatter_add.cu``): one read of
the update stream, ``U * (4 + 2 C)`` (an int32 row and C bf16 values per update; the
kernel reads every one). ``U`` is what the step hands over: every (ray, slot, level,
corner). The table gradient's zero-fill, ``rows * C * 4`` bytes, is a kernel of its own
that the trace times apart, so ``scatter_bytes`` leaves it out.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def level_rows(cfg: dict) -> list:
    """Rows of each level of a hash-grid table: ``min(2^log2_hashmap_size, (res + 1)^3)``
    rounded up to a multiple of 8, ``res = ceil(base * scale^level)``."""
    L, base = cfg["num_levels"], cfg["base_resolution"]
    desired = cfg["desired_resolution_per_bound"] * cfg["bound"]
    scale = 2.0 ** (math.log2(desired / base) / (L - 1))
    return [int(math.ceil(min(2 ** cfg["log2_hashmap_size"],
                              (int(math.ceil(base * scale ** lvl)) + 1) ** 3) / 8) * 8)
            for lvl in range(L)]


def grid_rows(cfg: dict) -> int:
    return sum(level_rows(cfg))


def dense(i: int, o: int) -> int:
    """Forward FLOPs of one row through an ``i`` -> ``o`` layer."""
    return 2 * i * o


def mlp(dims) -> int:
    return sum(dense(a, b) for a, b in zip(dims[:-1], dims[1:]))


def encode(cfg: dict) -> int:
    """Forward FLOPs of one point through one hash-grid encoder."""
    return cfg["num_levels"] * 8 * (2 * cfg["level_dim"] + 4)


def sigma_dims(cfg: dict) -> list:
    enc = cfg["num_levels"] * cfg["level_dim"]
    return [enc] + [cfg["hidden_dim"]] * (cfg["num_layers"] - 1) + [1 + cfg["geo_feat_dim"]]


def color_dims(cfg: dict) -> list:
    return ([cfg["sh_degree"] ** 2 + cfg["geo_feat_dim"]]
            + [cfg["hidden_dim_color"]] * (cfg["num_layers_color"] - 1) + [3])


def ngp_sample_flops(cfg: dict) -> int:
    """Forward FLOPs of one sample of the stage-1 field: encoder, sigma and colour nets."""
    return encode(cfg) + mlp(sigma_dims(cfg)) + mlp(color_dims(cfg))


def palette_sample_flops(cfg: dict) -> dict:
    """Forward FLOPs of one sample of the palette model's parts: the density branch
    (encoder and sigma net, no gradient in this stage), and the heads that train:
    view-dependent colour, diffuse, the palette encoder and basis net, the offsets and
    omega heads."""
    g, P = cfg["geo_feat_dim"], cfg["num_basis"]
    enc = cfg["num_levels"] * cfg["level_dim"]
    diff = [g] + [cfg["hidden_dim_color"]] * (cfg["num_layers_color"] - 1) + [3]
    basis = [enc + 3] + [cfg["hidden_dim"]] * (cfg["num_layers"] - 1) + [g]
    return {
        "density": encode(cfg) + mlp(sigma_dims(cfg)),
        "heads": (mlp(color_dims(cfg)) + mlp(diff) + encode(cfg) + mlp(basis)
                  + dense(g, 3 * P + 1) + dense(g, P)),
    }


def train_step_flops(cfg: dict) -> float:
    """Model FLOPs of one optimizer step over every (ray, train slot): forward and
    backward of what trains, forward alone of what the step only reads."""
    samples = cfg["num_rays"] * cfg["train_samples_per_ray"]
    if cfg["model"] == "ngp":
        return 3.0 * ngp_sample_flops(cfg) * samples
    if cfg["model"] == "palette":
        f = palette_sample_flops(cfg)
        # the render pass, and the smooth loss's second pass on jittered points
        return 2 * (f["density"] + 3.0 * f["heads"]) * samples
    raise ValueError(f"no FLOP count for model {cfg['model']!r}")


def scatter_updates(cfg: dict) -> int:
    """Updates ``U`` of one backward scatter: every (ray, slot, level, corner)."""
    return cfg["num_rays"] * cfg["train_samples_per_ray"] * cfg["num_levels"] * 8


def scatter_bytes(cfg: dict) -> int:
    return scatter_updates(cfg) * (4 + 2 * cfg["level_dim"])


def scatter_bound_s(cfg: dict) -> float:
    """The least time of one backward scatter at the card's memory bandwidth."""
    return scatter_bytes(cfg) / PEAK_HBM_BYTES
