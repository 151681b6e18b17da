"""What the benchmark makes from ``--seed`` and hands to both the program and the plain
reference: initial weights, the random draws of the training steps, the seeded scene.

Everything is made on the run's device from one ``torch.Generator``, in a few large
calls. The parameter dicts have the program's layout (``models/nerf.py``: a ``[rows, C]``
table per encoder and ``[in, out]`` weight lists per MLP), so the program takes them as
given.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from . import costs


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def mlp_dims(cfg: dict) -> Dict[str, list]:
    """The stage-1 field's MLPs as ``[in, hidden..., out]``."""
    return {"sigma_net": costs.sigma_dims(cfg), "color_net": costs.color_dims(cfg)}


def uniform_leaves(gen: torch.Generator, shapes: Dict[str, list], bounds: Dict[str, list],
                   device) -> Dict[str, list]:
    """One draw for all leaves: leaf ``shapes[k][i]`` uniform in ``+-bounds[k][i]``."""
    sizes = [int(torch.Size(s).numel()) for k in shapes for s in shapes[k]]
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, pos = {}, 0
    for k in shapes:
        out[k] = []
        for s, b in zip(shapes[k], bounds[k]):
            n = int(torch.Size(s).numel())
            out[k].append((u[pos:pos + n] * b).reshape(s))
            pos += n
    return out


def ngp_params(cfg: dict, gen: torch.Generator, device) -> dict:
    """The recipe's initial stage-1 parameters: the table uniform in +-1e-4, every MLP
    weight uniform in +-1/sqrt(fan_in)."""
    shapes = {"encoder": [[costs.grid_rows(cfg), cfg["level_dim"]]]}
    bounds = {"encoder": [1e-4]}
    for k, dims in mlp_dims(cfg).items():
        shapes[k] = [[a, b] for a, b in zip(dims[:-1], dims[1:])]
        bounds[k] = [a ** -0.5 for a in dims[:-1]]
    leaves = uniform_leaves(gen, shapes, bounds, device)
    return {"encoder": leaves["encoder"][0], "sigma_net": leaves["sigma_net"],
            "color_net": leaves["color_net"]}


def leaves(params: dict) -> Dict[str, torch.Tensor]:
    """Every tensor of a parameter dict by a dotted name (``sigma_net.0``, ``x.w``)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, list):
            for i, layer in enumerate(v):
                if isinstance(layer, dict):
                    out.update({f"{k}.{i}.{n}": t for n, t in layer.items()})
                else:
                    out[f"{k}.{i}"] = layer
        elif isinstance(v, dict):
            out.update({f"{k}.{n}": t for n, t in v.items()})
        else:
            out[k] = v
    return out


def clone(params: dict) -> dict:
    def one(v):
        if isinstance(v, list):
            return [one(x) for x in v]
        if isinstance(v, dict):
            return {k: one(x) for k, x in v.items()}
        return v.detach().clone()
    return {k: one(v) for k, v in params.items()}


class Draws:
    """The draw source of the training steps (the methods the program's trainers ask
    for: ``palettenerf_torch/train/draws.py``), made from the benchmark's generator.

    The draws up to the start of step ``record_steps`` are kept in order in ``record``
    (``(kind, value)``), for the reference to replay. A step starts with its ``pixels``
    draw; ``on_step(k)`` is called there, before step ``k``'s first draw, with every
    earlier step done.
    """

    def __init__(self, gen: torch.Generator, record_steps: int = 0,
                 on_step: Optional[Callable[[int], None]] = None):
        self.generator = gen
        self.device = gen.device
        self.record_steps = record_steps
        self.on_step = on_step
        self.step = -1  # steps started
        self.record: List[tuple] = []

    def _keep(self, kind: str, value):
        if self.step < self.record_steps:
            self.record.append((kind, value.clone() if torch.is_tensor(value) else value))
        return value

    def _rand(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator, device=self.device)

    def order(self, n: int) -> List[int]:
        return self._keep("order", torch.randperm(n, generator=self.generator,
                                                  device=self.device).tolist())

    def refresh_noise(self, shape) -> torch.Tensor:
        return self._keep("refresh_noise", self._rand(shape) * 2.0 - 1.0)

    def pixels(self, n: int, high: int) -> torch.Tensor:
        self.step += 1
        if self.on_step is not None:
            self.on_step(self.step)
        return self._keep("pixels", torch.randint(0, high, (n,), generator=self.generator,
                                                  device=self.device))

    def background(self, n: int) -> torch.Tensor:
        return self._keep("background", self._rand((n, 3)))

    def jitter(self, n: int) -> torch.Tensor:
        return self._keep("jitter", self._rand((n,)))

    def smooth_jitter(self, rows: int) -> torch.Tensor:
        return self._keep("smooth_jitter", self._rand((rows, 3)))

    def encode(self, spec, rows: int):
        """The ``-O2`` encode draws: none of the benchmark's configurations uses them."""
        if spec.stochastic_trilerp or spec.grad_levels:
            raise NotImplementedError("the benchmark makes no -O2 encode draws")
        return None


def seeded_field(cfg: dict, gen: torch.Generator, device) -> tuple:
    """The seeded scene of the cells that do not train stage 1: a stage-1 field at the
    recipe's init scale whose density is ``exp(density_bias)`` inside the box, and the
    occupancy of ``ellipsoids`` seeded ellipsoids filling ``occupied_share`` of the grid.

    The sigma net has no bias, so the density bias rides on the encoding: the rows of
    the coarsest level (dense, interpolated to a constant inside the box) hold
    ``level0_value``, and the sigma head's weights from the first hidden layer are set so
    that this constant input gives ``density_bias``. Returns (params, occupied bool [H^3]).
    """
    s = cfg["scene"]
    params = ngp_params(cfg, gen, device)
    rows0 = costs.level_rows(cfg)[0]
    params["encoder"][:rows0] = s["level0_value"]
    w1, w2 = params["sigma_net"][0], params["sigma_net"][-1]
    v = torch.relu(w1[:cfg["level_dim"]].sum(0) * s["level0_value"])
    w2[:, 0] = v * (s["density_bias"] / (v * v).sum())
    H = cfg["grid_size"]
    K = s["ellipsoids"]
    u = torch.rand((K, 7), generator=gen, device=device)
    centre = (u[:, :3] * 2.0 - 1.0) * s["centre_extent"]
    lo, hi = s["axis_range"]
    axes = lo + (hi - lo) * u[:, 3:6]
    rot = torch.linalg.qr(torch.randn((K, 3, 3), generator=gen, device=device))[0]
    r = torch.arange(H, dtype=torch.float32, device=device)
    g = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    b = min(1.0, float(cfg["bound"]))
    xyz = (2.0 * g / (H - 1) - 1.0) * (b - b / H)
    dist = torch.stack([(((xyz - centre[k]) @ rot[k]) / axes[k]).norm(dim=-1)
                        for k in range(K)]).amin(0)
    n = int(round(s["occupied_share"] * H ** 3))
    occupied = dist <= dist.kthvalue(n).values
    return params, occupied


def packbits(occ: torch.Tensor) -> torch.Tensor:
    """bool [n * 8] -> uint8 [n]: bit i of byte k is cell 8k + i (the program's
    bitfield order)."""
    w = 2 ** torch.arange(8, dtype=torch.int32, device=occ.device)
    return (occ.reshape(-1, 8).to(torch.int32) * w).sum(-1).to(torch.uint8)


def palette_params(cfg: dict, field: dict, gen: torch.Generator, device) -> dict:
    """The palette model on a stage-1 field: its heads at the recipe's init scale, the
    ``num_basis`` basis colours and the extraction's blending weights [32, 32, 32, P]
    from the seed (the program's ``models/palette.py`` layout)."""
    g, P = cfg["geo_feat_dim"], cfg["num_basis"]
    enc = cfg["num_levels"] * cfg["level_dim"]
    hc, h = cfg["hidden_dim_color"], cfg["hidden_dim"]
    nets = {"diff_net": [g] + [hc] * (cfg["num_layers_color"] - 1) + [3],
            "basis_net": [enc + 3] + [h] * (cfg["num_layers"] - 1) + [g],
            "omega_net": [g, P]}
    table = [costs.grid_rows(cfg), cfg["level_dim"]]
    shapes = {"encoder_palette": [table], "encoder_clip": [table],
              "offsets_radiance_net": [[g, 3 * P + 1], [3 * P + 1]],
              "colors": [[P, 3]], "hist": [[32, 32, 32, P]]}
    bounds = {"encoder_palette": [1e-4], "encoder_clip": [1e-4],
              "offsets_radiance_net": [g ** -0.5] * 2, "colors": [1.0], "hist": [1.0]}
    for k, dims in nets.items():
        shapes[k] = [[a, b] for a, b in zip(dims[:-1], dims[1:])]
        bounds[k] = [a ** -0.5 for a in dims[:-1]]
    d = uniform_leaves(gen, shapes, bounds, device)
    colors = 0.5 + 0.45 * d["colors"][0]
    hist = d["hist"][0].abs() + 0.05
    return {
        "encoder": field["encoder"], "encoder_palette": d["encoder_palette"][0],
        "encoder_clip": d["encoder_clip"][0], "sigma_net": field["sigma_net"],
        "color_net": field["color_net"], "diff_net": d["diff_net"],
        "basis_net": d["basis_net"],
        "offsets_radiance_net": [{"w": d["offsets_radiance_net"][0],
                                  "b": d["offsets_radiance_net"][1]}],
        "omega_net": d["omega_net"], "basis_color": colors, "basis_color_origin": colors.clone(),
        "hist_weights": hist / hist.sum(-1, keepdim=True),
    }
