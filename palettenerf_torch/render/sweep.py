"""Shear-warp plane-sweep renderer: the serving path's per-frame renderer.

Port of ``palettenerf_tpu/render/sweep.py``. The factorization (shear-warp, Lacroute &
Levoy '94, for pinhole cameras):

1. Pick the volume axis most aligned with the view direction ("sweep axis").
2. Central projection between parallel planes is a homothety, so a fixed
   "intermediate image" grid on a reference plane (one pixel == one camera ray)
   samples every slice through a separable affine resample: two banded bilinear
   interpolation matrices ``A_k [U, X]``, ``B_k [U, Y]`` applied as matrix products
   (``torch.matmul``; bf16 operands with f32 accumulation, f32 when ``shade_bf16`` is
   off). Bilinear at the exact slice plane == trilinear sampling of the baked field at
   the ray/plane crossing.
3. Front-to-back alpha compositing over the slices, with the palette blend and the
   RegionEdit recolor applied per sample (``render/palette_renderer.py`` semantics).
4. One homography warp resamples the composited intermediate maps to the screen.

How the eager port runs the sweep: the JAX package scans slice by slice inside
``lax.cond`` blocks of 8. Here the slices of one block (at most 8, contiguous along the
sweep axis) go through the interpolation products and the shade as ONE batch
(``[K, U, C, U]``), and the block is composited in sweep order with two ``cumprod``s
over its K slices. That is the same function with ~8x fewer kernel launches.

Skips are decided on the host, with no device->host read:

- slice occupancy (``SweepVolume.occ``, host bools) skips whole blocks, the JAX
  package's default (its ``skip="slice"`` / ``"none"`` modes are not ported);
- the JAX package's transmittance test ``max(T) > t_thresh`` is dropped: the per-pixel
  ``valid`` mask (``T > t_thresh``) already makes early termination exact, so running a
  block whose pixels have all terminated adds nothing. (An object-centred frame keeps
  background pixels at T = 1 in every block, so the test would rarely skip anyway, and
  it would cost one device->host read per block.)
- ``edit_cull``: the per-slice edit-mask test depends only on the slice's depth, so
  the host skips the HSV chain for blocks where no slice is near the edit.

Layout of the volume (channel-middle ``[Z, X, C, Y]``, one copy per sweep axis):
  nerf:    [sigma, r, g, b]                                    C = 4
  palette: [sigma, omega(P), off_r(P), off_g(P), off_b(P), rad] C = 2 + 4P
plus 3B view-dependent SH coefficient channels at the tail when ``vd_bands > 0``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.rays import near_far_from_aabb
from ..ops.sh import sh_encode
from ..utils import profiling
from .baking import BakedVolume
from .palette_renderer import RegionEdit, make_region_edit

BLK = 8  # slices per block: the skip granularity and the batch of one shade pass


class SweepVolume(NamedTuple):
    """Baked volume re-packed for sweeping: one axis-major bf16 copy per world axis, plus
    per-slice occupancy on the host."""

    resolution: int
    bound: float
    num_basis: int                       # 0 for a plain NeRF bake
    vols: Tuple[torch.Tensor, ...]       # 3 x [Z, X, C, Y] bf16, axis-major
    occ: Tuple[np.ndarray, ...]          # 3 x [Z] bool: the slice has any density
    vd_bands: int = 0                    # SH bands of the baked view-dep channels


def _upload(a, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """Host array -> tensor on ``device``. To a card it goes through pinned memory and
    a non-blocking copy, so the host does not wait for the stream."""
    t = torch.as_tensor(np.array(a)).to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def build_sweep_volume(baked: BakedVolume, sigma_thresh: float = 1e-3) -> SweepVolume:
    R = baked.resolution
    P = 0
    if baked.omega is not None:
        P = baked.omega.shape[-1]
        parts = [baked.density[..., None], baked.omega,
                 baked.offsets[..., 0::3], baked.offsets[..., 1::3],
                 baked.offsets[..., 2::3], baked.radiance[..., None]]
    else:
        parts = [baked.density[..., None], baked.diffuse]
    if baked.view_sh is not None and baked.vd_bands:
        parts.append(baked.view_sh)
    # cast before concatenating: the same bf16 values as casting the f32 concatenation,
    # at half the transient memory
    vol4 = torch.cat([p.to(torch.bfloat16) for p in parts], -1)  # [R, R, R, C] world order
    occ_any = baked.density > sigma_thresh
    vols, occs = [], []
    for a in range(3):
        vols.append(vol4.permute(a, (a + 1) % 3, 3, (a + 2) % 3).contiguous())  # [Z, X, C, Y]
        occs.append(occ_any.permute(a, (a + 1) % 3, (a + 2) % 3).reshape(R, -1)
                    .any(1).cpu().numpy())
    return SweepVolume(R, float(baked.bound), P, tuple(vols), tuple(occs),
                       vd_bands=(baked.vd_bands if baked.view_sh is not None else 0))


def build_clip_masks(clip_feat: torch.Tensor, mean_clip, std_clip) -> Tuple[torch.Tensor, ...]:
    """Semantic edit-mask volumes for the sweep: exp(-||clip - mean||^2 / std) over the
    baked clip volume, one axis-major [Z, X, Y] bf16 copy per sweep axis."""
    mean = torch.as_tensor(np.array(mean_clip, np.float32), device=clip_feat.device)
    m = torch.exp(-((clip_feat - mean) ** 2).sum(-1) / float(std_clip))
    return tuple(m.permute(a, (a + 1) % 3, (a + 2) % 3).to(torch.bfloat16).contiguous()
                 for a in range(3))


class SweepPlan(NamedTuple):
    """Host-side per-frame camera factorization."""

    axis: int                    # sweep axis (world index) — selects vols[axis]
    perm: Tuple[int, int, int]   # world -> permuted (sweep-axis-first) order
    o_p: np.ndarray              # [3] camera center, permuted frame
    rot_p: np.ndarray            # [3,3] permuted rows of c2w rotation
    dsign: float                 # sign of ray z-components in permuted frame
    z_ref: float                 # reference plane (near volume face)
    gx0: float
    gdx: float
    gy0: float
    gdy: float                   # intermediate grid on the z_ref plane
    flip: bool                   # sweep slices high-to-low instead of low-to-high


def plan_sweep(pose: np.ndarray, intrinsics, H: int, W: int, bound: float,
               U: int) -> SweepPlan:
    """Factorize one camera into sweep parameters (NumPy, as the JAX package)."""
    pose = np.asarray(pose, np.float64)
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    o = pose[:3, 3]
    Rw = pose[:3, :3]

    fwd = Rw @ np.array([0.0, 0.0, 1.0])
    axis = int(np.argmax(np.abs(fwd)))
    perm = (axis, (axis + 1) % 3, (axis + 2) % 3)
    o_p = o[list(perm)]
    rot_p = Rw[list(perm), :]

    # corner + center rays in the permuted frame
    px = np.array([0.5, W - 0.5, 0.5, W - 0.5, W / 2.0])
    py = np.array([0.5, 0.5, H - 0.5, H - 0.5, H / 2.0])
    d = np.stack([(px - cx) / fx, (py - cy) / fy, np.ones(5)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d_p = d @ rot_p.T
    dz = d_p[:, 0]
    dsign = float(np.sign(dz[-1]))
    if not np.all(np.sign(dz) == dsign):
        raise ValueError("sweep renderer: the FOV spans 90 deg across the sweep axis "
                         "(unsupported camera)")

    # reference plane: the volume face nearest the camera along the sweep axis
    z_ref = -dsign * bound

    # intermediate grid extent on z_ref: bbox of the output corner-ray intersections,
    # intersected with the volume's shadow (projection of its 8 corners from o)
    t_ref = (z_ref - o_p[0]) / dz
    q = o_p[None, 1:] + t_ref[:, None] * d_p[:, 1:]
    lo, hi = q.min(0), q.max(0)
    if abs(o_p[0]) > bound:  # camera outside the slab: shadow projection is valid
        c = np.array([[sx, sy, sz] for sx in (-bound, bound)
                      for sy in (-bound, bound) for sz in (-bound, bound)])
        c_p = c[:, list(perm)]
        lam = (z_ref - o_p[0]) / (c_p[:, 0] - o_p[0])
        s = o_p[None, 1:] + lam[:, None] * (c_p[:, 1:] - o_p[None, 1:])
        lo = np.maximum(lo, s.min(0))
        hi = np.minimum(hi, s.max(0))
    span = np.maximum(hi - lo, 1e-6)
    pad = 0.5 * span / max(U - 1, 1)
    lo, hi = lo - pad, hi + pad
    gdx = float((hi[0] - lo[0]) / (U - 1))
    gdy = float((hi[1] - lo[1]) / (U - 1))

    return SweepPlan(axis, perm, o_p.astype(np.float32), rot_p.astype(np.float32),
                     dsign, float(z_ref), float(lo[0]), gdx, float(lo[1]), gdy,
                     bool(dsign < 0))


# --------------------------------------------------------------------------- per-frame

def _interp_matrix(src: torch.Tensor, n_src: int) -> torch.Tensor:
    """src [..., U] fractional voxel coords -> banded bilinear weights [..., U, n_src]
    (bf16). Out-of-range coordinates get all-zero rows (the volume is vacuum-padded)."""
    i = torch.arange(n_src, dtype=torch.float32, device=src.device)
    return (1.0 - (src[..., None] - i).abs()).clamp_min(0.0).to(torch.bfloat16)


def _hsv_edit_planar(r, g, b, dh, ds, dv, wgt):
    """Per-sample RegionEdit recolor on planar per-basis channel tensors.

    One pass rgb -> hsv -> (H + dh, S * ds, V * dv) -> rgb with the weight lerp, the
    sweep form of ``apply_region_edit``; dh/ds/dv broadcast per basis, ``wgt`` is the
    spatial mask (or 1.0). Range-limited mods are single selects.
    """
    cmax = torch.maximum(torch.maximum(r, g), b)
    cmin = torch.minimum(torch.minimum(r, g), b)
    diff = cmax - cmin
    safe = torch.where(diff == 0, 1.0, diff)
    # 60*(g-b)/safe is in [-60, 60], so mod 360 == +360 when negative
    t_r = 60.0 * (g - b) / safe
    h = torch.where(
        diff == 0, 0.0,
        torch.where(cmax == r, torch.where(t_r < 0, t_r + 360.0, t_r),
                    torch.where(cmax == g, 60.0 * (b - r) / safe + 120.0,
                                60.0 * (r - g) / safe + 240.0)))
    s = (torch.where(cmax == 0, 0.0, diff / torch.where(cmax == 0, 1.0, cmax)) * ds
         ).clamp_min(0.0)
    v = (cmax * dv).clamp_min(0.0)

    # hsv -> rgb in the K-function form: chan(n) = v - v*s*clamp(min(k, 4-k), 0, 1),
    # k = (n + h/60) mod 6; dh is modded once so h + dh_n lies in [0, 720)
    h2 = h + torch.remainder(dh, 360.0)
    h2 = torch.where(h2 >= 360.0, h2 - 360.0, h2) * (1.0 / 60.0)
    vs = v * s

    def chan(n):
        k = n + h2
        k = torch.where(k >= 6.0, k - 6.0, k)
        return v - vs * torch.minimum(k, 4.0 - k).clamp(0.0, 1.0)

    r2, g2, b2 = chan(5.0), chan(3.0), chan(1.0)
    return r + wgt * (r2 - r), g + wgt * (g2 - g), b + wgt * (b2 - b)


def _take(x: torch.Tensor, dim: int, idx: List[int]) -> torch.Tensor:
    """``x`` restricted to indices ``idx`` along ``dim``: a view for one contiguous run."""
    if idx == list(range(idx[0], idx[0] + len(idx))):
        return x.narrow(dim, idx[0], len(idx))
    return torch.cat([x.narrow(dim, i, 1) for i in idx], dim)


# layout of the per-frame uniform vector (host numpy f32, as in the JAX package):
#   0:3  o_p (camera center, permuted frame)
#   3:7  gx0 gdx gy0 gdy (intermediate grid)
#   7    z_ref            8  dsign (<0 -> flip)
#   9    offsets_weight  10  density_scale   11  min_near   12  bound
#  13:16 edit mean_xyz (permuted frame)     16  use_xyz     17  std_xyz
#  18    view_dep_weight
#  19:28 world-from-permuted rotation rows (for SH directions in world frame)
_UNI_LEN = 28


def _blocks(occ: np.ndarray, flip: bool) -> List[Tuple[int, int]]:
    """The ascending slice ranges [a, b) of the blocks of BLK slices to run, in sweep
    order. A block with no occupied slice is skipped when Z is a multiple of BLK (else
    every slice runs, as in the JAX package)."""
    Z = occ.shape[0]
    out = []
    for s in range(0, Z, BLK):
        a, b = (max(Z - s - BLK, 0), Z - s) if flip else (s, min(s + BLK, Z))
        if Z % BLK or occ[a:b].any():
            out.append((a, b))
    return out


def _rounded(x, dtype: torch.dtype) -> float:
    """A host scalar rounded to ``dtype`` (the JAX shade casts its scalars to it)."""
    return float(torch.tensor(float(x), dtype=torch.float32).to(dtype))


def _sweep_composite(
    vol: torch.Tensor,         # [Z, X, C, Y] bf16
    occ: np.ndarray,           # [Z] bool (host)
    basis_color: torch.Tensor,  # [P, 3] f32 on the device (or [1, 3] dummy)
    delta_hsv: torch.Tensor,   # [P, 3] f32 on the device: per-basis dH/dS/dV
    uni: np.ndarray,           # [_UNI_LEN] f32 host uniforms (see above)
    mask_vol: Optional[torch.Tensor],   # [Z, X, Y] bf16 semantic edit mask
    stylizer: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],  # dI, dP, dd
    *,
    num_basis: int,
    u_res: int,
    t_thresh: float,
    weight_mode: bool,
    has_edit: bool = True,
    edit_cull: bool = False,
    vd_bands: int = 0,
    edit_bases: Optional[tuple] = None,
    shade_bf16: bool = False,
) -> torch.Tensor:
    """Front-to-back sweep over slices; returns intermediate maps [U, U, 5] =
    (rgb, depth_abs, weights_sum) f32, rows = grid-y, cols = grid-x. Internally every
    plane is [Ucol, Urow] ([K, Ucol, P, Urow] for per-basis math), because the
    channel-middle layout makes the second interpolation product emit [K, Ucol, C, Urow].

    Under the profiler the frame counts its blocks run and skipped, and of those run the
    ones the edit skips (``edit_cull``) and edits in some slices only (``utils.profiling``
    counters ``sweep.blocks_*``)."""
    Z, X, C, Y = vol.shape
    U, P = u_res, num_basis
    dev = vol.device
    fdt = torch.bfloat16 if shade_bf16 else torch.float32
    f32 = np.float32
    u = [f32(v) for v in uni]          # host f32 scalars: host math rounds as the JAX f32 math
    o0, o1, o2 = u[0:3]
    gx0, gdx, gy0, gdy, z_ref = u[3:8]
    offsets_weight, density_scale, min_near, bound = u[9:13]
    m0, m1, m2, use_xyz, std_xyz = u[13], u[14], u[15], u[16] > 0, u[17]

    ar = torch.arange(U, dtype=torch.float32, device=dev)
    gx = float(gx0) + float(gdx) * ar                              # [U] cols
    gy = float(gy0) + float(gdy) * ar                              # [U] rows
    qx = gx[:, None].expand(U, U)                                  # [Ucol, Urow]
    qy = gy[None, :].expand(U, U)
    # ray length from camera to the reference-plane pixel: t along the ray is
    # t_k = lam_k * L, so the segment length per slice is constant per pixel
    L = torch.sqrt((qx - float(o1)) ** 2 + (qy - float(o2)) ** 2 + float((z_ref - o0) ** 2))
    inv_denom = f32(1.0) / (z_ref - o0)
    dz_world = f32(2.0) * bound / f32(Z - 1)
    delta = float(abs(dz_world * inv_denom)) * L                   # [Ucol, Urow]
    two_b = float(f32(2.0) * bound)

    z_all = float(-bound) + float(dz_world) * torch.arange(Z, dtype=torch.float32, device=dev)
    lam_all = (z_all - float(o0)) * float(inv_denom)               # [Z]
    flip = u[8] < 0

    B = vd_bands * vd_bands
    vd0 = C - 3 * B  # view-SH channels occupy the tail of the layout
    if vd_bands:
        # per-intermediate-pixel ray direction, rotated permuted -> world for SH
        dp = torch.stack([torch.full((U, U), float(z_ref - o0), device=dev),
                          qx - float(o1), qy - float(o2)], -1)
        dp = dp / torch.linalg.norm(dp, dim=-1, keepdim=True)
        w_from_p = _upload(np.asarray(uni[19:28]).reshape(3, 3), dev)
        dw = torch.einsum("ij,uvj->uvi", w_from_p, dp)
        Ysh = sh_encode(dw, vd_bands).permute(0, 2, 1).to(fdt)    # [Ucol, B, Urow]
        vdw = _rounded(uni[18], fdt)

    ow = _rounded(offsets_weight, fdt)
    bc = basis_color.clamp(0.0, 1.0).to(fdt)
    if stylizer is not None:
        sty_dI, sty_dP, sty_dd = (t.to(fdt) for t in stylizer)
        bc = bc + sty_dP
    bcol = [bc[:, i].reshape(1, 1, -1, 1) for i in range(3)]      # [1, 1, P, 1]
    if P and has_edit and not weight_mode:
        eb = list(range(P)) if edit_bases is None else list(edit_bases)
        dhsv = _take(delta_hsv.to(fdt), 0, eb)
        dh, ds, dv = (dhsv[:, i].reshape(1, 1, -1, 1) for i in range(3))
    if has_edit and edit_cull:
        cut = f32(6.9) * std_xyz
        z_host = f32(-bound) + dz_world * np.arange(Z, dtype=f32)
        near_host = ((z_host - m0) ** 2 <= cut) | (not use_xyz)
        near_all = ((z_all - float(m0)) ** 2 <= float(cut)) | (not use_xyz)

    def add_vd(feat, r, g, b):
        if not vd_bands:
            return r, g, b
        cr = (feat[:, :, vd0:vd0 + B, :] * Ysh).sum(2)
        cg = (feat[:, :, vd0 + B:vd0 + 2 * B, :] * Ysh).sum(2)
        cb = (feat[:, :, vd0 + 2 * B:vd0 + 3 * B, :] * Ysh).sum(2)
        return r + vdw * cr, g + vdw * cg, b + vdw * cb

    def shade(feat, lam, zk, mask_uv, near):
        """feat [K, Ucol, C, Urow] (fdt) -> sigma f32, r/g/b fdt [K, Ucol, Urow].
        ``near``: None (edit every slice), False (no slice near the edit) or a [K] bool
        tensor of the slices the edit reaches."""
        sigma = feat[:, :, 0, :].float() * float(density_scale)
        if P == 0:
            r, g, b = add_vd(feat, feat[:, :, 1, :], feat[:, :, 2, :], feat[:, :, 3, :])
            return sigma, r, g, b
        om = feat[:, :, 1:1 + P, :]                                # [K, Ucol, P, Urow]
        off = [feat[:, :, 1 + (i + 1) * P:1 + (i + 2) * P, :] for i in range(3)]
        srad = F.softplus(feat[:, :, 1 + 4 * P, :].float())[:, :, None, :].to(fdt)
        if stylizer is not None:
            # Stylizer (palette/renderer.py:166-183): intensity offsets, palette offsets
            # and a 3x3 per-basis transform of the offsets, clipped to [0, 1]
            srad = (srad + sty_dI.reshape(1, 1, -1, 1)).clamp_min(0.0)
            o = [ow * x for x in off]
            t = [o[0] * sty_dd[:, 0, j].reshape(1, 1, -1, 1)
                 + o[1] * sty_dd[:, 1, j].reshape(1, 1, -1, 1)
                 + o[2] * sty_dd[:, 2, j].reshape(1, 1, -1, 1) for j in range(3)]
            fr, fg, fb = ((srad * (bcol[j] + t[j])).clamp(0.0, 1.0) for j in range(3))
        else:
            fr, fg, fb = (srad * (bcol[j] + ow * off[j]) for j in range(3))
        if has_edit:
            # RegionEdit per sample, in the permuted frame (render_sweep permutes
            # edit.mean_xyz to match; the Gaussian is isotropic)
            wgt = 1.0
            if use_xyz:
                lam3 = lam[:, None, None]
                pxs = float(o1) + (qx - float(o1)) * lam3
                pys = float(o2) + (qy - float(o2)) * lam3
                d2 = ((zk - float(m0)) ** 2)[:, None, None] + (pxs - float(m1)) ** 2 \
                    + (pys - float(m2)) ** 2
                wgt = torch.exp(-d2 / float(std_xyz))[:, :, None, :].to(fdt)
            if mask_uv is not None:
                wgt = wgt * mask_uv[:, :, None, :]
            if weight_mode:
                # visualize the mask instead of recoloring (renderer.py:144-147)
                w_rgb = (om * wgt).sum(2)
                return sigma, w_rgb, w_rgb, w_rgb
            if near is not False:
                sel = None if near is None else near[:, None, None]
                if edit_bases is not None:
                    # restricted edit in delta form: the unedited contraction plus the
                    # edited bases' weighted correction om_e * (edited - plain)
                    fe = [_take(x, 2, eb) for x in (fr, fg, fb)]
                    ome = _take(om, 2, eb)
                    ed = _hsv_edit_planar(*fe, dh, ds, dv, wgt)
                    dlt = [(ome * (e - f)).sum(2) for e, f in zip(ed, fe)]
                    if sel is not None:
                        dlt = [torch.where(sel, d, 0.0) for d in dlt]
                    r, g, b = ((om * f).sum(2) + d for f, d in zip((fr, fg, fb), dlt))
                    return (sigma,) + add_vd(feat, r, g, b)
                ed = _hsv_edit_planar(fr, fg, fb, dh, ds, dv, wgt)
                if sel is not None:
                    sel = sel[..., None]
                    ed = [torch.where(sel, e, f) for e, f in zip(ed, (fr, fg, fb))]
                fr, fg, fb = ed
        r, g, b = ((om * f).sum(2) for f in (fr, fg, fb))
        return (sigma,) + add_vd(feat, r, g, b)

    T = torch.ones((U, U), dtype=torch.float32, device=dev)
    acc = [torch.zeros((U, U), dtype=torch.float32, device=dev) for _ in range(4)]
    blocks = _blocks(occ, bool(flip))
    culled = partial = 0  # blocks the edit skips / edits in some slices only
    for a, b in blocks:
        K = b - a
        lam, zk = lam_all[a:b], z_all[a:b]
        sx = (float(o1) + (gx[None] - float(o1)) * lam[:, None] + float(bound)) / two_b * (X - 1)
        sy = (float(o2) + (gy[None] - float(o2)) * lam[:, None] + float(bound)) / two_b * (Y - 1)
        A = _interp_matrix(sx, X).to(fdt)                          # [K, Ucol, X]
        Bt = _interp_matrix(sy, Y).to(fdt).transpose(1, 2)         # [K, Y, Urow]
        t1 = torch.matmul(A, vol[a:b].reshape(K, X, C * Y).to(fdt))   # [K, Ucol, C*Y]
        feat = torch.matmul(t1.reshape(K, U * C, Y), Bt).reshape(K, U, C, U)
        mask_uv = None
        if mask_vol is not None:
            mask_uv = torch.matmul(torch.matmul(A, mask_vol[a:b].to(fdt)), Bt)  # [K, U, U]
        near = None
        if has_edit and edit_cull:
            nh = near_host[a:b]
            near = False if not nh.any() else (None if nh.all() else near_all[a:b])
            culled += near is False
            partial += near is not None and near is not False
        sigma, r, g, b_ = shade(feat, lam, zk, mask_uv, near)
        t_k = lam[:, None, None] * L
        if flip:  # the block's slices in sweep order
            sigma, r, g, b_, t_k = (x.flip(0) for x in (sigma, r, g, b_, t_k))
        # composite the block: T entering each slice is the running product of
        # (1 - alpha) — exact while every earlier slice was valid; a slice is valid
        # while T > t_thresh, and once one is not, none after it is (T only falls)
        alpha = torch.where(t_k > float(min_near), 1.0 - torch.exp(-sigma * delta), 0.0)
        t_enter = torch.cumprod(torch.cat([T[None], 1.0 - alpha]), 0)[:-1]
        alpha = torch.where(t_enter > t_thresh, alpha, 0.0)
        w = t_enter * alpha
        T = torch.cumprod(torch.cat([T[None], 1.0 - alpha]), 0)[-1]
        acc = [s + (w * x).sum(0) for s, x in zip(acc, (r, g, b_, t_k))]
    profiling.count("sweep.blocks_run", len(blocks))
    profiling.count("sweep.blocks_skipped", -(-Z // BLK) - len(blocks))
    profiling.count("sweep.blocks_edit_culled", culled)
    profiling.count("sweep.blocks_edit_partial", partial)
    ws = 1.0 - T
    return torch.stack([acc[0].T, acc[1].T, acc[2].T, acc[3].T, ws.T], -1)   # [U, U, 5]


# warp uniform vector layout:
#   0:3 o_p | 3:12 rot_p row-major | 12:16 fx fy cx cy | 16:20 gx0 gdx gy0 gdy
#   20 z_ref | 21 bound | 22 min_near | 23:26 bg_color
_UNIW_LEN = 26


def _warp_to_screen(inter: torch.Tensor, uniw: np.ndarray, *, h: int, w: int, u_res: int):
    """Homography warp: output pixel -> camera ray -> reference-plane intersection ->
    bilinear sample of the intermediate maps (read in bf16, as the JAX package)."""
    dev = inter.device
    U = u_res
    uw = [np.float32(v) for v in uniw]
    fx, fy, cx, cy = (float(v) for v in uw[12:16])
    gx0, gdx, gy0, gdy, z_ref = (float(v) for v in uw[16:21])
    bound, min_near = float(uw[21]), float(uw[22])
    o_p = _upload(uniw[0:3], dev)
    rot_p = _upload(np.asarray(uniw[3:12]).reshape(3, 3), dev)

    col = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
    row = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5
    dcam = torch.stack([((col - cx) / fx).expand(h, w), ((row - cy) / fy).expand(h, w),
                        torch.ones((h, w), device=dev)], -1)
    dcam = dcam / torch.linalg.norm(dcam, dim=-1, keepdim=True)
    d_p = torch.einsum("ij,hwj->hwi", rot_p, dcam)                # permuted frame

    t_ref = (z_ref - float(uw[0])) / d_p[..., 0]
    qx = float(uw[1]) + t_ref * d_p[..., 1]
    qy = float(uw[2]) + t_ref * d_p[..., 2]
    u = (qx - gx0) / gdx                                           # col coord
    v = (qy - gy0) / gdy                                           # row coord
    inb = (t_ref > 0) & (u >= 0) & (u <= U - 1) & (v >= 0) & (v <= U - 1)
    u = u.clamp(0.0, U - 1.0)
    v = v.clamp(0.0, U - 1.0)
    u0 = torch.clamp(torch.floor(u).to(torch.int64), 0, U - 2)
    v0 = torch.clamp(torch.floor(v).to(torch.int64), 0, U - 2)
    fu = (u - u0).reshape(-1, 1)
    fv = (v - v0).reshape(-1, 1)

    flat = inter.to(torch.bfloat16).reshape(U * U, -1)
    base = (v0 * U + u0).reshape(-1)
    s00, s01, s10, s11 = (flat.index_select(0, base + o).float() for o in (0, 1, U, U + 1))
    out = ((s00 * (1 - fu) + s01 * fu) * (1 - fv)
           + (s10 * (1 - fu) + s11 * fu) * fv).reshape(h, w, -1)
    out = torch.where(inb[..., None], out, 0.0)

    rgb, depth_abs, ws = out[..., 0:3], out[..., 3], out[..., 4]
    image = rgb + (1.0 - ws)[..., None] * _upload(uniw[23:26], dev)

    # normalized depth, as render_baked; near/far in the permuted frame == world frame
    # (the cube is symmetric)
    aabb = _upload([-bound] * 3 + [bound] * 3, dev)
    nears, fars = near_far_from_aabb(o_p.expand(h * w, 3), d_p.reshape(-1, 3), aabb, min_near)
    nears = nears.reshape(h, w)
    fars = fars.reshape(h, w)
    depth = (depth_abs - nears).clamp_min(0.0) / torch.clamp_min(fars - nears, 1e-6)
    return {"image": image, "depth": depth, "depth_origin": depth_abs, "weights_sum": ws}


# --------------------------------------------------------------------------- API

def render_sweep(
    sv: SweepVolume,
    pose,
    intrinsics,
    H: int,
    W: int,
    u_res: int = 512,
    basis_color=None,
    edit: Optional[RegionEdit] = None,
    offsets_weight: float = 1.0,
    view_dep_weight: float = 1.0,
    bg_color=1.0,
    min_near: float = 0.05,
    t_thresh: float = 1e-2,
    density_scale: float = 1.0,
    stylizer=None,
    clip_masks=None,
    shade_bf16: Optional[bool] = None,
):
    """Render one frame from a SweepVolume. Palette mode iff ``sv.num_basis > 0`` (then
    ``basis_color`` [P, 3] is required — pass edited colors to recolor).

    Returns image [H, W, 3], depth, depth_origin, weights_sum, as ``render_baked``.
    RegionEdit (keep its fields on the host), ``offsets_weight``, ``view_dep_weight``,
    basis colors, Stylizer parameters and clip-mask edits apply per sample inside the
    sweep. For a clip-weighted edit pass ``clip_masks = build_clip_masks(...)``.
    ``shade_bf16`` (default: on for palette volumes) runs the per-sample shade in bf16;
    compositing stays f32.
    """
    with profiling.span("sweep.frame"):
        with profiling.span("sweep.plan"):
            dev = sv.vols[0].device
            plan = plan_sweep(np.asarray(pose), intrinsics, H, W, sv.bound, u_res)
            P = sv.num_basis
            if shade_bf16 is None:
                shade_bf16 = P > 0
            if P:
                if basis_color is None:
                    raise ValueError("palette sweep needs basis_color [P, 3]")
                bc = basis_color.to(dev, torch.float32) if torch.is_tensor(basis_color) \
                    else _upload(basis_color, dev)
            else:
                bc = torch.zeros((1, 3), device=dev)
            has_edit = edit is not None
            has_mask = False
            edit_bases = None
            if has_edit and not edit.weight_mode:
                # bases the edit touches (the neutral delta (0, 1, 1) is an HSV identity):
                # none -> drop the edit, all -> None
                d = np.asarray(edit.delta_hsv.cpu() if torch.is_tensor(edit.delta_hsv)
                               else edit.delta_hsv, np.float32)
                touched = tuple(
                    int(p) for p in range(d.shape[0])
                    if abs((d[p, 0] + 180.0) % 360.0 - 180.0) > 1e-4
                    or abs(d[p, 1] - 1.0) > 1e-4 or abs(d[p, 2] - 1.0) > 1e-4)
                if not touched:
                    has_edit = False
                elif len(touched) < d.shape[0]:
                    edit_bases = touched
            if edit is None:
                edit = make_region_edit(max(P, 1), clip_dim=1)
            elif bool(np.asarray(edit.use_clip)):
                if clip_masks is None:
                    raise ValueError(
                        "clip-weighted sweep edit needs clip_masks="
                        "build_clip_masks(baked.clip_feat, edit.mean_clip, edit.std_clip)")
                has_mask = True

            mean_p = np.asarray(edit.mean_xyz, np.float32)[list(plan.perm)]
            uni = np.empty(_UNI_LEN, np.float32)
            uni[0:3] = plan.o_p
            uni[3:9] = (plan.gx0, plan.gdx, plan.gy0, plan.gdy, plan.z_ref, plan.dsign)
            uni[9:13] = (offsets_weight, density_scale, min_near, sv.bound)
            uni[13:16] = mean_p
            uni[16] = float(np.asarray(edit.use_xyz))
            uni[17] = float(np.asarray(edit.std_xyz))
            uni[18] = view_dep_weight
            w_from_p = np.zeros((3, 3), np.float32)
            for i, pi in enumerate(plan.perm):
                w_from_p[pi, i] = 1.0
            uni[19:28] = w_from_p.reshape(-1)

            uniw = np.empty(_UNIW_LEN, np.float32)
            uniw[0:3] = plan.o_p
            uniw[3:12] = plan.rot_p.reshape(-1)
            uniw[12:16] = [float(v) for v in intrinsics]
            uniw[16:21] = (plan.gx0, plan.gdx, plan.gy0, plan.gdy, plan.z_ref)
            uniw[21:23] = (sv.bound, min_near)
            uniw[23:26] = np.broadcast_to(np.asarray(bg_color, np.float32), (3,))

            # per-slice HSV culling only when the edit is tight enough that many slices skip
            edit_cull = bool(has_edit and np.asarray(edit.use_xyz) and not has_mask
                             and 6.9 * float(np.asarray(edit.std_xyz)) < sv.bound ** 2)
            sty = None
            if stylizer is not None:
                sty = tuple(_upload(np.asarray(x.cpu() if torch.is_tensor(x) else x, np.float32)
                                    .reshape(shape), dev)
                            for x, shape in ((stylizer.dI, (-1,)), (stylizer.dP, (-1, 3)),
                                             (stylizer.ddelta, (-1, 3, 3))))
            dhsv = edit.delta_hsv.to(dev, torch.float32) if torch.is_tensor(edit.delta_hsv) \
                else _upload(np.asarray(edit.delta_hsv, np.float32), dev)
        with profiling.span("sweep.composite"):
            inter = _sweep_composite(
                sv.vols[plan.axis], sv.occ[plan.axis], bc, dhsv, uni,
                clip_masks[plan.axis] if has_mask else None, sty,
                num_basis=P, u_res=u_res, t_thresh=float(t_thresh),
                weight_mode=bool(edit.weight_mode), has_edit=has_edit,
                edit_cull=edit_cull, vd_bands=sv.vd_bands,
                edit_bases=edit_bases, shade_bf16=bool(shade_bf16),
            )
        with profiling.span("sweep.warp"):
            return _warp_to_screen(inter, uniw, h=H, w=W, u_res=u_res)
