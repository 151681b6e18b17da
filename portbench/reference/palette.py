"""PaletteNeRF's palette-stage training steps in plain float32 PyTorch (PaletteNeRF
``palette/network.py``, ``palette/renderer.py`` ``run_cuda`` and ``palette/utils.py``'s
loss), to replay the first steps of a run from the same weights, draws and images.

Per sample: density and geo feature of the frozen stage-1 field (no gradient); diffuse
``sigmoid(diff_net(geo))``; view-dependent colour ``sigmoid(color_net([SH(d), geo]))``;
the palette feature ``basis_net([enc_palette(x), diffuse])`` (ELU between layers);
offsets and radiance from ``offsets_radiance_net`` (with a bias), the blend weights
``omega = softplus(omega_net) + 0.05``, normalised. The colour is
``sum_p omega_p softplus(radiance) (clip(c_p, 0, 1) + offset_p)`` plus the detached
view-dependent colour. The smooth loss re-evaluates omega at the sample jittered by
``0.03 * bound * u`` and pulls the two together, weighted by distance and diffuse colour.
Every map is composited with the detached density's weights.

Loss: image and direct colour (diffuse + view-dependent) against the ground truth on
the step's background, the omega sparsity, offset and view-dependent norms, the smooth
term, and the squared gap of the composited omegas to the extraction's weights looked
up trilinearly at the ground-truth colour. Adam on the leaves that train; the basis
colours are frozen (stepped with a zero gradient).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from . import field, ngp
from .scene import Scene

# leaves the palette stage never moves
FIXED = ("encoder", "encoder_clip", "sigma_net", "basis_color_origin", "hist_weights")


def named(params: dict) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in params.items():
        if k in FIXED or k.startswith("sigma_net"):
            continue
        if isinstance(v, list):
            for i, layer in enumerate(v):
                if isinstance(layer, dict):
                    out.update({f"{k}.{i}.{n}": t for n, t in layer.items()})
                else:
                    out[f"{k}.{i}"] = layer
        else:
            out[k] = v
    return out


def elu_mlp(layers, h):
    for i, w in enumerate(layers):
        h = h @ w
        if i < len(layers) - 1:
            h = F.elu(h)
    return h


def heads(grid: field.Grid, p: dict, x, geo, P: int):
    """The palette heads at x [M, 3] with the field's geo feature: omega [M, P], offsets
    [M, P, 3], radiance [M, 1], diffuse colour [M, 3]."""
    diffuse = torch.sigmoid(field.mlp(p["diff_net"], geo))
    feat = elu_mlp(p["basis_net"], torch.cat([grid.encode(p["encoder_palette"], x),
                                               diffuse.detach()], -1))
    head = p["offsets_radiance_net"][0]
    off_rad = feat @ head["w"] + head["b"]
    omega = F.softplus(feat @ p["omega_net"][0]) + 0.05
    omega = omega / omega.sum(-1, keepdim=True)
    return omega, off_rad[:, :-1].reshape(-1, P, 3), off_rad[:, -1:], diffuse


def sample(grid: field.Grid, p: dict, x, d, P: int):
    """Per-sample quantities: sigma, omega, offsets [M, P, 3], radiance [M, 1],
    view-dependent colour, diffuse colour."""
    with torch.no_grad():
        sigma, geo = field.density(grid, p, x)
    omega, offsets, radiance, diffuse = heads(grid, p, x, geo, P)
    return sigma, omega, offsets, radiance, field.color(p, d, geo), diffuse


def hist_lookup(rgb: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """Trilinear lookup of hist [32, 32, 32, P] at colours [N, 3] in [0, 1] (corners at
    rgb * 31)."""
    g = rgb.clamp(0.0, 1.0) * 31.0
    i0 = torch.floor(g).to(torch.int64).clamp(0, 30)
    f = g - i0
    out = 0.0
    for corner in range(8):
        bits = [(corner >> k) & 1 for k in range(3)]
        w = torch.ones_like(f[:, 0])
        for k in range(3):
            w = w * (f[:, k] if bits[k] else 1.0 - f[:, k])
        out = out + hist[i0[:, 0] + bits[0], i0[:, 1] + bits[1], i0[:, 2] + bits[2]] * w[:, None]
    return out


def step_loss(cfg: dict, sched: dict, grid, p: dict, occupied, o, d, gt_rgba, bg, jitter,
              smooth_u):
    P, S, b = cfg["num_basis"], cfg["train_samples_per_ray"], float(cfg["bound"])
    near, far = ngp.near_far(o, d, b, cfg["min_near"])
    xyz, dt, _, mask = ngp.march(cfg, occupied, o, d, near, far, jitter, S)
    n = o.shape[0]
    x = xyz.reshape(-1, 3)
    dd = d[:, None, :].expand(n, S, 3).reshape(-1, 3)
    sigma, omega, offsets, radiance, view_dep, diffuse = sample(grid, p, x, dd, P)
    basis = p["basis_color"].clamp(0.0, 1.0)[None]
    if sched["freeze_basis_color"]:
        basis = basis.detach()
    rgb = (omega[:, :, None] * (F.softplus(radiance)[:, :, None] * (basis + offsets))).sum(1)
    rgb = rgb + view_dep.detach()
    sparsity = omega.sum(-1) / ((omega ** 2).sum(-1) + 1e-6) - 1.0
    offsets_norm = (offsets ** 2).sum((-1, -2))
    view_dep_norm = (view_dep ** 2).sum(-1)
    x_j = (x + smooth_u * b * 0.03).clamp(-b, b)
    _, omega_j, _, _, _, diffuse_j = sample(grid, p, x_j, dd, P)
    with torch.no_grad():
        sw = torch.exp(-((x - x_j) ** 2).sum(-1) / b ** 2 / cfg["smooth_sigma_xyz"]
                       - ((diffuse - diffuse_j) ** 2).sum(-1) / cfg["smooth_sigma_color"])
    smooth = ((omega_j - omega) ** 2).sum(-1) * sw
    w, ws, _ = ngp.composite(sigma.reshape(n, S), torch.zeros((n, S, 0), device=o.device),
                             dt, mask, cfg["t_thresh_train"])

    def comp(v):
        return (w[..., None] * v.reshape(n, S, -1)).sum(1)

    gt = gt_rgba[:, :3] * gt_rgba[:, 3:] + bg * (1.0 - gt_rgba[:, 3:])
    rest = (1.0 - ws)[:, None] * bg
    image = comp(rgb) + rest
    direct = comp(diffuse + view_dep) + rest
    acc = comp(omega)
    loss = ((image - gt) ** 2).mean() + ((direct - gt) ** 2).mean()
    loss = loss + cfg["lambda_sparsity"] * comp(sparsity).mean()
    loss = loss + cfg["lambda_offsets"] * comp(offsets_norm).mean()
    loss = loss + cfg["lambda_view_dep"] * comp(view_dep_norm).mean()
    loss = loss + cfg["lambda_smooth"] * comp(smooth).mean()
    gt_w = hist_lookup(gt, p["hist_weights"])
    return loss + sched["lambda_weight"] * ((gt_w - acc) ** 2).mean()


def replay(cfg: dict, sched: dict, scene: Scene, occupied: torch.Tensor, init: dict,
           draws: list, steps: int, device) -> dict:
    """The first ``steps`` palette-stage steps from ``init`` with the recorded draws;
    ``sched`` holds the epoch's ``lambda_weight`` and ``freeze_basis_color``. Returns as
    ``ngp.replay`` does, over the leaves that train."""
    grid = field.Grid(cfg)
    p = {k: ([({n: t.detach().clone() for n, t in w.items()} if isinstance(w, dict)
               else w.detach().clone()) for w in v] if isinstance(v, list)
             else v.detach().clone()) for k, v in init.items()}
    leaves = named(p)
    for t in leaves.values():
        t.requires_grad_(True)
    opt = ngp.Adam(list(leaves.values()), cfg["adam_betas"], cfg["adam_eps"])
    pending = list(draws)

    def take(kind):
        k, v = pending.pop(0)
        if k != kind:
            raise ValueError(f"draw {kind} expected, recorded {k}")
        return v

    order = take("order")
    losses, grads = [], {}
    for i in range(steps):
        pixels = take("pixels").to(device)
        img = torch.as_tensor(scene.image(order[i]), device=device).reshape(-1, 4)
        o, d = scene.rays(order[i], pixels)
        bg, jitter, u = take("background"), take("jitter"), take("smooth_jitter")
        loss = step_loss(cfg, sched, grid, p, occupied, o, d, img[pixels], bg.to(device),
                         jitter.to(device), u.to(device))
        for t in leaves.values():
            t.grad = None
        loss.backward()
        for t in leaves.values():
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        if i == 0:
            grads = {k: t.grad.detach().clone() for k, t in leaves.items()}
        opt.step(cfg["lr"] * 0.1 ** min(i / cfg["iters"], 1.0))
        losses.append(float(loss.detach()))
    start = named(init)
    return {"losses": losses, "grads": grads,
            "changes": {k: (t.detach() - start[k]) for k, t in leaves.items()}}
