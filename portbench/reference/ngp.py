"""Stage-1 training steps of PaletteNeRF's Instant-NGP recipe in plain float32 PyTorch
(torch-ngp ``nerf/renderer.py`` and ``raymarching.cu`` with ``--dt_gamma 0`` and one
cascade, ``nerf/utils.py`` for the loss and the optimizer), to replay the first steps of
a run from the same initial weights, draws and images.

- Occupancy grid (128^3, one cascade): cells no training camera sees, or sees closer
  than ``min_near``, are marked untrained (-1). A refresh evaluates the density at each
  cell centre jittered by up to half a cell, takes ``max(old * decay, new)`` where the
  cell is trained, and occupies the cells above ``min(mean(max(grid, 0)),
  density_thresh)``.
- March: from ``near`` (the AABB entry, at least ``min_near``) plus a jitter of one step,
  steps of ``2 sqrt(3) / max_steps``; the first ``S`` steps before ``far`` that land in an
  occupied cell are the samples.
- Composite: ``alpha = 1 - exp(-sigma dt)``, weights ``alpha T`` while the transmittance
  ``T`` entering the sample is at least ``t_thresh``; image plus ``(1 - sum w)`` times the
  background.
- Loss: the mean over rays of the squared error of the image against the ground truth
  composited on the step's random background, plus ``lambda_sparse`` times the weighted
  squared error of the samples' colours.
- Adam (PyTorch's update with bias correction) at ``lr * 0.1^(k / iters)`` for update k.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import field
from .scene import Scene

SQRT3 = math.sqrt(3.0)


def cell_centres(H: int, bound: float, device) -> torch.Tensor:
    """[H^3, 3] world centres of the cells, flat index x * H^2 + y * H + z."""
    r = torch.arange(H, dtype=torch.float32, device=device)
    g = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    b = min(1.0, bound)
    return (2.0 * g / (H - 1) - 1.0) * (b - b / H)


def untrained(cfg: dict, scene: Scene, device) -> torch.Tensor:
    """bool [H^3]: cells that no training camera sees, or one sees closer than min_near."""
    H, bound = cfg["grid_size"], float(cfg["bound"])
    xyz = cell_centres(H, bound, device)
    half = min(1.0, bound) / H
    fx, fy, cx, cy = scene.intrinsics
    seen = torch.zeros(xyz.shape[0], dtype=torch.int64, device=device)
    close = torch.zeros_like(seen)
    for pose in scene.poses:
        p = torch.as_tensor(pose, device=device)
        cam = (xyz - p[:3, 3]) @ p[:3, :3]
        z = cam[:, 2]
        vis = (z > 0) & (cam[:, 0].abs() < cx / fx * z + 2 * half) & \
              (cam[:, 1].abs() < cy / fy * z + 2 * half)
        seen += vis
        close += vis & (z < cfg["min_near"])
    return (seen == 0) | (close > 0)


def refresh(cfg: dict, grid: field.Grid, params: dict, noise: torch.Tensor,
            density_grid: torch.Tensor, chunk: int = 1 << 18):
    """A full refresh; returns (new density grid [H^3], occupied [H^3] bool)."""
    H, bound = cfg["grid_size"], float(cfg["bound"])
    half = min(1.0, bound) / H
    pts = cell_centres(H, bound, noise.device) + noise.reshape(-1, 3) * half
    with torch.no_grad():
        sig = torch.cat([field.density(grid, params, c)[0] for c in pts.split(chunk)])
    new = torch.where(density_grid >= 0,
                      torch.maximum(density_grid * cfg["grid_decay"], sig), density_grid)
    thresh = torch.clamp(new.clamp_min(0.0).mean(), max=cfg["density_thresh"])
    return new, new > thresh


def near_far(o: torch.Tensor, d: torch.Tensor, bound: float, min_near: float):
    t0, t1 = (-bound - o) / d, (bound - o) / d
    near = torch.minimum(t0, t1).amax(-1)
    far = torch.maximum(t0, t1).amin(-1)
    miss = near > far
    near = near.clamp_min(min_near)
    big = torch.full_like(near, 1e10)
    return torch.where(miss, big, near), torch.where(miss, big, far)


def march(cfg: dict, occupied: torch.Tensor, o, d, near, far, jitter, S: int):
    """The first S occupied steps of each ray: (xyz [N, S, 3], dt [N, S], t_cum
    [N, S], mask [N, S])."""
    H, bound, K = cfg["grid_size"], float(cfg["bound"]), cfg["max_steps"]
    if cfg["dt_gamma"] != 0 or bound > 1:
        raise NotImplementedError("the reference marches --dt_gamma 0 in one cascade")
    dt = 2.0 * SQRT3 / K
    start = near + dt * jitter
    k = torch.arange(K, dtype=torch.float32, device=o.device)
    t = start[:, None] + k[None, :] * dt                                     # [N, K]
    xyz = (o[:, None, :] + t[..., None] * d[:, None, :]).clamp(-bound, bound)
    cell = (0.5 * (xyz / min(1.0, bound) + 1.0) * H).to(torch.int64).clamp(0, H - 1)
    flat = (cell[..., 0] * H + cell[..., 1]) * H + cell[..., 2]
    ok = occupied[flat] & (t < far[:, None])
    rank = torch.cumsum(ok.to(torch.int64), 1)
    take = ok & (rank <= S)
    n, dev = o.shape[0], o.device
    slot = torch.where(take, rank - 1, torch.full_like(rank, S))             # S: a sink
    ts = torch.zeros((n, S + 1), dtype=torch.float32, device=dev)
    ts.scatter_(1, slot, t)
    mask = torch.zeros((n, S + 1), dtype=torch.bool, device=dev)
    mask.scatter_(1, slot, take)
    ts, mask = ts[:, :S], mask[:, :S]
    pts = (o[:, None, :] + ts[..., None] * d[:, None, :]).clamp(-bound, bound)
    zero = torch.zeros((), device=dev)
    return (torch.where(mask[..., None], pts, zero), torch.where(mask, dt, zero),
            torch.where(mask, ts + dt - start[:, None], zero), mask)


def composite(sigma, rgb, dt, mask, t_thresh: float):
    """weights [N, S], their sum [N], colour [N, 3]."""
    sigma = torch.where(mask, sigma, torch.zeros_like(sigma))
    alpha = 1.0 - torch.exp(-sigma * dt)
    T = torch.cumprod(1.0 - alpha, -1)
    T = torch.cat([torch.ones_like(T[:, :1]), T[:, :-1]], -1)
    w = alpha * T * (T >= t_thresh) * mask
    return w, w.sum(-1), (w[..., None] * rgb).sum(1)


def step_loss(cfg: dict, grid, params: dict, occupied, o, d, gt_rgba, bg, jitter):
    """The recipe's loss of one batch."""
    near, far = near_far(o, d, float(cfg["bound"]), cfg["min_near"])
    S = cfg["train_samples_per_ray"]
    xyz, dt, _, mask = march(cfg, occupied, o, d, near, far, jitter, S)
    n = o.shape[0]
    sigma, geo = field.density(grid, params, xyz.reshape(-1, 3))
    rgb = field.color(params, d[:, None, :].expand(n, S, 3).reshape(-1, 3), geo)
    sigma, rgb = sigma.reshape(n, S), rgb.reshape(n, S, 3)
    w, ws, img = composite(sigma, rgb, dt, mask, cfg["t_thresh_train"])
    gt = gt_rgba[:, :3] * gt_rgba[:, 3:] + bg * (1.0 - gt_rgba[:, 3:])
    img = img + (1.0 - ws)[:, None] * bg
    sparse = (w * ((gt[:, None, :] - rgb) ** 2).sum(-1)).sum(-1)
    return (((img - gt) ** 2).mean(-1) + cfg["lambda_sparse"] * sparse).mean()


class Adam:
    """PyTorch's Adam update (no weight decay), one state per leaf."""

    def __init__(self, leaves: List[torch.Tensor], betas, eps: float):
        self.leaves, self.b1, self.b2, self.eps = leaves, betas[0], betas[1], eps
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, lr: float):
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, m, v in zip(self.leaves, self.m, self.v):
            m.mul_(self.b1).add_(p.grad, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(p.grad, p.grad, value=1.0 - self.b2)
            p.sub_(lr / c1 * m / (v.sqrt() / math.sqrt(c2) + self.eps))


def named(params: dict) -> Dict[str, torch.Tensor]:
    out = {"encoder": params["encoder"]}
    for k in ("sigma_net", "color_net"):
        out.update({f"{k}.{i}": w for i, w in enumerate(params[k])})
    return out


def replay(cfg: dict, scene: Scene, init: dict, draws: list, steps: int, device) -> dict:
    """The first ``steps`` training steps from ``init`` with the recorded ``draws``
    (``portbench.inputs.Draws.record``). Returns the steps' losses, the first step's
    gradient per leaf and each leaf's change after the steps."""
    grid = field.Grid(cfg)
    params = {k: ([w.detach().clone().requires_grad_(True) for w in v] if isinstance(v, list)
                  else v.detach().clone().requires_grad_(True)) for k, v in init.items()}
    leaves = named(params)
    opt = Adam(list(leaves.values()), cfg["adam_betas"], cfg["adam_eps"])
    H = cfg["grid_size"]
    density_grid = torch.where(untrained(cfg, scene, device),
                               torch.full((H ** 3,), -1.0, device=device),
                               torch.zeros((H ** 3,), device=device))
    occupied = None
    pending = list(draws)

    def take(kind):
        k, v = pending.pop(0)
        if k != kind:
            raise ValueError(f"draw {kind} expected, recorded {k}")
        return v

    order = take("order")
    losses, grads = [], {}
    for i in range(steps):
        if i % cfg["update_extra_interval"] == 0:
            density_grid, occupied = refresh(cfg, grid, params, take("refresh_noise"),
                                             density_grid)
        pixels = take("pixels").to(device)
        img = torch.as_tensor(scene.image(order[i]), device=device).reshape(-1, 4)
        o, d = scene.rays(order[i], pixels)
        loss = step_loss(cfg, grid, params, occupied, o, d, img[pixels],
                         take("background").to(device), take("jitter").to(device))
        for p in leaves.values():
            p.grad = None
        loss.backward()
        if i == 0:
            grads = {k: p.grad.detach().clone() for k, p in leaves.items()}
        opt.step(cfg["lr"] * 0.1 ** min(i / cfg["iters"], 1.0))
        losses.append(float(loss.detach()))
    start = named(init)
    return {"losses": losses, "grads": grads,
            "changes": {k: (p.detach() - start[k]) for k, p in leaves.items()}}
