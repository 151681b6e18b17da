"""The stage-1 eval frame in plain float32: torch-ngp's inference march (no jitter, the
first ``S`` occupied steps of each ray) with its alive-ray rounds as a fixed schedule
(every ray marches the first ``s_0`` samples; each later round continues only the
``1/divisor`` rays of the batch with the most transmittance left among those that still
have samples, ties to the lower index), composited over a white background.

A frame is rendered in chunks of ``chunk`` rays; the last, short chunk is padded with
copies of its last ray (rendered, then dropped), as PaletteNeRF's JAX port renders it.
"""

from __future__ import annotations

import torch

from . import field, ngp


@torch.no_grad()
def render_chunk(cfg: dict, grid: field.Grid, params: dict, occupied, o, d, chunk: int,
                 samples: int, rounds, t_thresh: float) -> dict:
    n = o.shape[0]
    if n < chunk:  # pad with copies of the last ray
        o = torch.cat([o, o[-1:].expand(chunk - n, 3)])
        d = torch.cat([d, d[-1:].expand(chunk - n, 3)])
    N = o.shape[0]
    near, far = ngp.near_far(o, d, float(cfg["bound"]), cfg["min_near"])
    xyz, dt, t_cum, mask = ngp.march(cfg, occupied, o, d, near, far, torch.zeros_like(near),
                                     samples)
    img = torch.zeros((N, 3), device=o.device)
    depth = torch.zeros(N, device=o.device)
    ws = torch.zeros(N, device=o.device)
    T = torch.ones(N, device=o.device)
    off = 0
    for divisor, s in rounds:
        cols = slice(off, off + s)
        if divisor == 1:
            sel = torch.arange(N, device=o.device)
        else:
            alive = torch.where(mask[:, off], T, torch.zeros_like(T))
            sel = torch.sort(alive, descending=True, stable=True).indices[:N // divisor]
        m = mask[sel, cols]
        x = xyz[sel, cols][m]
        sigma = torch.zeros(m.shape, device=o.device)
        rgb = torch.zeros(m.shape + (3,), device=o.device)
        if x.shape[0]:
            sg, geo = field.density(grid, params, x)
            dirs = d[sel][:, None, :].expand(*m.shape, 3)[m]
            sigma[m] = sg
            rgb[m] = field.color(params, dirs, geo)
        alpha = 1.0 - torch.exp(-sigma * dt[sel, cols])
        t_rel = torch.cumprod(1.0 - alpha, -1)
        t_in = T[sel][:, None] * torch.cat([torch.ones_like(t_rel[:, :1]), t_rel[:, :-1]], -1)
        w = alpha * t_in * (t_in >= t_thresh) * m
        img.index_add_(0, sel, (w[..., None] * rgb).sum(1))
        depth.index_add_(0, sel, (w * t_cum[sel, cols]).sum(1))
        ws.index_add_(0, sel, w.sum(1))
        T[sel] = T[sel] * t_rel[:, -1]
        off += s
    return {"img": img[:n], "depth": depth[:n], "ws": ws[:n], "near": near[:n],
            "far": far[:n]}


@torch.no_grad()
def render(cfg: dict, params: dict, occupied, o, d, chunks, chunk: int, samples: int,
           rounds, t_thresh: float) -> dict:
    """The frame's chunks ``chunks`` (indices): image [n, 3], depth [n] (normalised to
    the ray's near-far span), weights_sum [n], over the rays of those chunks."""
    grid = field.Grid(cfg)
    out = {"image": [], "depth": [], "weights_sum": []}
    for k in chunks:
        a, b = k * chunk, min((k + 1) * chunk, o.shape[0])
        r = render_chunk(cfg, grid, params, occupied, o[a:b], d[a:b], chunk, samples, rounds,
                         t_thresh)
        out["image"].append(r["img"] + (1.0 - r["ws"])[:, None])
        dep = r["depth"] + r["ws"] * r["near"]
        out["depth"].append((dep - r["near"]).clamp_min(0.0)
                            / (r["far"] - r["near"]).clamp_min(1e-6))
        out["weights_sum"].append(r["ws"])
    return {k: torch.cat(v) for k, v in out.items()}
