"""A frame of the baked palette volume by shear-warp (Lacroute and Levoy, 1994) in plain
float32: the volume is sampled slice by slice along the world axis closest to the view
direction, on an intermediate grid of ``U x U`` rays through the volume face nearest the
camera; each sample is shaded (palette blend, region edit, view-dependent SH) and
composited front to back; the screen image is the bilinear resample of the composited
intermediate maps through the homography of that face.

Written from the serving design of PaletteNeRF's port (one pixel of the intermediate
grid is one camera ray; a sample is bilinear within its slice, zero outside the volume;
a sample's length is the slice spacing along the ray); every step is a plain loop or
gather, in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import field


def plan(pose: np.ndarray, intr, H: int, W: int, bound: float, U: int) -> dict:
    pose = np.asarray(pose, np.float64)
    fx, fy, cx, cy = [float(v) for v in intr]
    o, Rw = pose[:3, 3], pose[:3, :3]
    axis = int(np.argmax(np.abs(Rw @ np.array([0.0, 0.0, 1.0]))))
    perm = [axis, (axis + 1) % 3, (axis + 2) % 3]
    o_p, rot_p = o[perm], Rw[perm, :]
    px = np.array([0.5, W - 0.5, 0.5, W - 0.5, W / 2.0])
    py = np.array([0.5, 0.5, H - 0.5, H - 0.5, H / 2.0])
    d = np.stack([(px - cx) / fx, (py - cy) / fy, np.ones(5)], -1)
    d_p = (d / np.linalg.norm(d, axis=-1, keepdims=True)) @ rot_p.T
    dsign = float(np.sign(d_p[-1, 0]))
    if not np.all(np.sign(d_p[:, 0]) == dsign):
        raise ValueError("the view spans 90 degrees across the sweep axis")
    z_ref = -dsign * bound
    q = o_p[None, 1:] + ((z_ref - o_p[0]) / d_p[:, 0])[:, None] * d_p[:, 1:]
    lo, hi = q.min(0), q.max(0)
    if abs(o_p[0]) > bound:  # clip to the volume's shadow on the face
        c = np.array([[a, b, e] for a in (-bound, bound) for b in (-bound, bound)
                      for e in (-bound, bound)])[:, perm]
        lam = (z_ref - o_p[0]) / (c[:, 0] - o_p[0])
        s = o_p[None, 1:] + lam[:, None] * (c[:, 1:] - o_p[None, 1:])
        lo, hi = np.maximum(lo, s.min(0)), np.minimum(hi, s.max(0))
    pad = 0.5 * np.maximum(hi - lo, 1e-6) / max(U - 1, 1)
    lo, hi = lo - pad, hi + pad
    return {"axis": axis, "perm": perm, "o": o_p.astype(np.float32),
            "rot": rot_p.astype(np.float32), "z_ref": float(z_ref), "flip": dsign < 0,
            "g0": lo.astype(np.float32), "gd": ((hi - lo) / (U - 1)).astype(np.float32)}


def bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """img [A, B, C] at fractional (u along A, v along B) [...], zero outside."""
    A, B = img.shape[:2]
    u0, v0 = torch.floor(u).long(), torch.floor(v).long()
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    out = 0.0
    for du, dv, w in ((0, 0, (1 - fu) * (1 - fv)), (1, 0, fu * (1 - fv)),
                      (0, 1, (1 - fu) * fv), (1, 1, fu * fv)):
        a, b = u0 + du, v0 + dv
        ok = ((a >= 0) & (a < A) & (b >= 0) & (b < B))[..., None]
        out = out + torch.where(ok, img[a.clamp(0, A - 1), b.clamp(0, B - 1)], 0.0) * w
    return out


def rgb_to_hsv(r, g, b):
    """H in degrees, S and V in percent (PaletteNeRF's palette.cu)."""
    cmax = torch.maximum(torch.maximum(r, g), b)
    diff = cmax - torch.minimum(torch.minimum(r, g), b)
    safe = torch.where(diff == 0, 1.0, diff)
    h = torch.where(cmax == r, torch.remainder(60.0 * (g - b) / safe + 360.0, 360.0),
                    torch.where(cmax == g, torch.remainder(60.0 * (b - r) / safe + 120.0, 360.0),
                                torch.remainder(60.0 * (r - g) / safe + 240.0, 360.0)))
    h = torch.where(diff == 0, 0.0, h)
    s = torch.where(cmax == 0, 0.0, diff / torch.where(cmax == 0, 1.0, cmax)) * 100.0
    return h, s, cmax * 100.0


def hsv_to_rgb(h, s, v):
    s, v = s / 100.0, v / 100.0
    h = torch.remainder(h, 360.0) / 60.0
    i = torch.floor(h)
    f = h - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = torch.remainder(i.long(), 6)
    table = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = [torch.zeros_like(v) for _ in range(3)]
    for k, row in enumerate(table):
        out = [torch.where(i == k, c, o) for c, o in zip(row, out)]
    return out


def shade(feat, P: int, B: int, basis, edit: dict, pos, dirs_sh, offsets_weight=1.0,
          view_dep_weight=1.0, low=None):
    """feat [..., C] -> (sigma, rgb [..., 3]); ``pos`` the samples' world positions.
    ``low`` rounds every per-sample colour to a lower precision (the control)."""
    q = low or (lambda t: t)
    sigma = feat[..., 0]
    om = feat[..., 1:1 + P]
    off = [feat[..., 1 + (c + 1) * P:1 + (c + 2) * P] for c in range(3)]
    srad = F.softplus(feat[..., 1 + 4 * P])[..., None]
    f = [q(srad * (basis[:, c] + offsets_weight * off[c])) for c in range(3)]
    w = torch.exp(-((pos - edit["mean"]) ** 2).sum(-1) / edit["std"])[..., None]
    h, s, v = rgb_to_hsv(*f)
    e = hsv_to_rgb(h + edit["dhsv"][:, 0], (s * edit["dhsv"][:, 1]).clamp_min(0.0),
                   (v * edit["dhsv"][:, 2]).clamp_min(0.0))
    f = [q(a + w * (b - a)) for a, b in zip(f, e)]
    rgb = torch.stack([(om * x).sum(-1) for x in f], -1)
    vd0 = 2 + 4 * P
    coef = feat[..., vd0:vd0 + 3 * B].reshape(*feat.shape[:-1], 3, B)
    return sigma, q(rgb + view_dep_weight * (coef * dirs_sh[..., None, :]).sum(-1))


@torch.no_grad()
def render(vol: torch.Tensor, bound: float, P: int, vd_bands: int, basis, edit: dict,
           pose, intr, H: int, W: int, U: int, min_near: float, t_thresh: float,
           bg: float = 1.0, low=None) -> torch.Tensor:
    """The frame's image [H, W, 3] from the world-order volume [R, R, R, C]."""
    dev = vol.device
    p = plan(pose, intr, H, W, bound, U)
    perm, (o0, o1, o2), z_ref = p["perm"], [float(x) for x in p["o"]], p["z_ref"]
    v = vol.permute(*perm, 3)                          # [Z, X, Y, C], sweep axis first
    Z, X, Y = v.shape[:3]
    gx = float(p["g0"][0]) + float(p["gd"][0]) * torch.arange(U, dtype=torch.float32, device=dev)
    gy = float(p["g0"][1]) + float(p["gd"][1]) * torch.arange(U, dtype=torch.float32, device=dev)
    qx, qy = gx[None, :].expand(U, U), gy[:, None].expand(U, U)  # [rows = y, cols = x]
    L = torch.sqrt((qx - o1) ** 2 + (qy - o2) ** 2 + (z_ref - o0) ** 2)
    dz = 2.0 * bound / (Z - 1)
    delta = abs(dz / (z_ref - o0)) * L
    dp = torch.stack([torch.full_like(qx, z_ref - o0), qx - o1, qy - o2], -1)
    dp = dp / torch.linalg.norm(dp, dim=-1, keepdim=True)
    dw = torch.empty_like(dp)
    for i, w in enumerate(perm):
        dw[..., w] = dp[..., i]
    B = vd_bands * vd_bands
    dirs_sh = field.sh4(dw.reshape(-1, 3))[:, :B].reshape(U, U, B)
    mean = edit["mean"][perm]
    ed = dict(edit, mean=mean)
    T = torch.ones((U, U), device=dev)
    acc = torch.zeros((U, U, 5), device=dev)
    for k in (range(Z - 1, -1, -1) if p["flip"] else range(Z)):
        zk = -bound + k * dz
        lam = (zk - o0) / (z_ref - o0)
        px, py = o1 + (qx - o1) * lam, o2 + (qy - o2) * lam
        feat = bilinear(v[k], (px + bound) / (2 * bound) * (X - 1),
                        (py + bound) / (2 * bound) * (Y - 1))
        pos = torch.stack([torch.full_like(px, zk), px, py], -1)
        sigma, rgb = shade(feat, P, B, basis, ed, pos, dirs_sh, low=low)
        t = lam * L
        alpha = torch.where(t > min_near, 1.0 - torch.exp(-sigma * delta), 0.0)
        alpha = torch.where(T > t_thresh, alpha, 0.0)
        w = T * alpha
        acc[..., :3] += w[..., None] * rgb
        acc[..., 3] += w * t
        T = T * (1.0 - alpha)
    acc[..., 4] = 1.0 - T
    # the homography: screen pixel -> ray -> the face -> intermediate grid
    fx, fy, cx, cy = [float(x) for x in intr]
    col = torch.arange(W, dtype=torch.float32, device=dev)[None, :] + 0.5
    row = torch.arange(H, dtype=torch.float32, device=dev)[:, None] + 0.5
    d = torch.stack([((col - cx) / fx).expand(H, W), ((row - cy) / fy).expand(H, W),
                     torch.ones((H, W), device=dev)], -1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    d = d @ torch.as_tensor(p["rot"], device=dev).T
    t_ref = (z_ref - o0) / d[..., 0]
    u = (o1 + t_ref * d[..., 1] - float(p["g0"][0])) / float(p["gd"][0])
    vv = (o2 + t_ref * d[..., 2] - float(p["g0"][1])) / float(p["gd"][1])
    inb = (t_ref > 0) & (u >= 0) & (u <= U - 1) & (vv >= 0) & (vv <= U - 1)
    m = bilinear(acc, vv.clamp(0, U - 1 - 1e-4), u.clamp(0, U - 1 - 1e-4))
    m = torch.where(inb[..., None], m, 0.0)
    return m[..., :3] + (1.0 - m[..., 4:5]) * bg
