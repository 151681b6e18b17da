"""NeRF volume renderer (stage 1): train path and exact eval paths.

Port of ``palettenerf_tpu/render/nerf_renderer.py``:

    near/far -> closed-form candidate march (ops.march) -> network over [N*S] samples
             -> masked composite (ops.composite)

``render_nerf_train`` (:142-217) is differentiable; its march jitter ``noise`` [N],
background ``bg_color`` and encode draws ``rand`` (``models.nerf.encode_rand_for``) are
arguments (drawn by the trainer). ``render_nerf_eval`` (:414-475) renders without
jitter; with ``compaction_rounds`` it dispatches to ``render_nerf_eval_compact``
(:299-411), the fixed-schedule version of the reference's alive-ray loop.

The opt-in options of ``RenderSettings`` act as in JAX: ``march_groups`` takes the
hierarchical march (``_sup`` derives its supercell mip from the bitfield),
``fine_grid_size`` expects the bitfield pair ``(train_bits, fine_bits)``, and
``compact_frac`` runs the network only on the march-valid samples, packed into a static
budget (``forward_compact``): valid samples past the budget are dropped and counted in
the output's ``compact_overflow`` [1], a device tensor.

The background of every render is ``_resolve_bg``'s (JAX :132-139): with
``bg_radius > 0`` the background net at the ray's exit from the background sphere, else
the explicit colour, else white. ``render_nerf_uniform`` (:220-297) is the grid-free
render of the reference's pure-PyTorch path (uniform samples, ``sample_pdf``
upsampling); no product path calls it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch

from ..models.nerf import NeRFSpec, Params, nerf_background, nerf_density, nerf_forward
from ..ops.composite import composite_rays, composite_weights
from ..ops.hashgrid_fast import EncodeRand
from ..ops.march import build_super_bitfield, march_rays, super_bitfield_ok
from ..ops.rays import near_far_from_aabb, sph_from_ray
from ..ops.sampling import sample_pdf
from ..utils import profiling


@dataclass(frozen=True)
class RenderSettings:
    bound: float = 1.0
    cascade: int = 1
    grid_size: int = 128
    dt_gamma: float = 0.0
    max_steps: int = 1024       # candidate budget K (reference max_steps)
    num_samples: int = 128      # retained sample slots S
    density_scale: float = 1.0
    t_thresh: float = 1e-4
    min_near: float = 0.2
    # radius of the background sphere (> 0: the background net colours what the rays
    # leave behind)
    bg_radius: float = -1.0
    # eval compaction schedule ((ray_divisor, samples), ...); round 0 has divisor 1.
    # Empty = one fixed-width pass.
    compaction_rounds: tuple = ()
    # group slots of the hierarchical march (0: flat candidate tests)
    march_groups: int = 0
    # the network runs on the valid samples only, in ceil-to-128 of frac * N * S slots
    # (0: off); valid samples past the budget are dropped and counted
    compact_frac: float = 0.0
    # eval-only finer culling grid: the renders then take bitfield=(train, fine bits)
    fine_grid_size: int = 0


@functools.lru_cache(maxsize=None)
def _aabb_of(bound: float, device: torch.device) -> torch.Tensor:
    b = bound
    return torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32, device=device)


def _aabb(settings: RenderSettings, device) -> torch.Tensor:
    """The scene box [6] on ``device`` (read-only; uploaded once, not per render)."""
    return _aabb_of(settings.bound, torch.device(device))


def _sup(bitfield, settings: RenderSettings):
    """The supercell mip of the hierarchical march (JAX :71-83), or None when the
    settings do not take it or it is statically unsound. Derived from the train bitfield
    (of a ``(train, fine)`` pair, the first) at each render, as in JAX."""
    if settings.march_groups <= 0 or not super_bitfield_ok(
            settings.bound, settings.grid_size, settings.cascade):
        return None
    if isinstance(bitfield, (tuple, list)):
        bitfield = bitfield[0]
    return build_super_bitfield(bitfield, settings.grid_size, settings.cascade)


def _march(rays_o, rays_d, nears, fars, bitfield, settings: RenderSettings,
           num_samples: int, noise=None):
    return march_rays(rays_o, rays_d, nears, fars, bitfield, settings.bound,
                      settings.cascade, settings.grid_size, settings.dt_gamma,
                      settings.max_steps, num_samples, noise,
                      sup_bitfield=_sup(bitfield, settings),
                      max_groups=settings.march_groups,
                      fine_grid_size=settings.fine_grid_size)


def forward_compact(forward_fn, valid: torch.Tensor, budget: int, *sample_args,
                    ahead: Optional[torch.Tensor] = None):
    """Run ``forward_fn`` on the ``valid`` [M] samples only (JAX :86-114).

    The valid slots are packed, in order, into the front of a static ``budget``-slot
    buffer (a cumsum and one scatter of slot ids; samples past the budget go to a sink
    row that is cut off, JAX's ``mode="drop"``); ``forward_fn(*[a[src] for a in
    sample_args])`` returns a tuple of [budget, ...] tensors, each expanded back to
    [M, ...] with one gather, zero at invalid and dropped slots. Slots of the buffer past
    the valid count evaluate sample 0 and are never read. Gradients flow through both
    gathers; dropped samples get none. No host synchronisation.

    ``ahead`` [M] (int): valid samples of rays that are not rendered here (``pad_to``'s
    copies of the last ray) packed before each sample; they take budget slots from it.
    The buffer is then at most M slots: a budget counted over a padded batch may exceed
    the samples there are.
    """
    M = valid.shape[0]
    dev = valid.device
    pos = torch.cumsum(valid.to(torch.int32), 0) - 1
    in_budget = valid & ((pos if ahead is None else pos + ahead) < budget)
    budget = min(budget, M)
    src = torch.zeros((budget + 1,), dtype=torch.int64, device=dev)
    src.scatter_(0, torch.where(in_budget, pos, budget).to(torch.int64),
                 torch.arange(M, dtype=torch.int64, device=dev))
    src = src[:budget]
    outs = forward_fn(*(a.index_select(0, src) for a in sample_args))
    posc = pos.clamp(0, budget - 1).to(torch.int64)
    expanded = []
    for o in outs:
        e = o.index_select(0, posc)
        keep = in_budget.reshape(in_budget.shape + (1,) * (e.ndim - 1))
        expanded.append(torch.where(keep, e, torch.zeros((), dtype=e.dtype, device=dev)))
    return tuple(expanded)


def _compact_budget(settings: RenderSettings, n_slots: int) -> int:
    """Compact buffer slots: ``compact_frac`` of ``n_slots``, rounded up to 128."""
    b = int(n_slots * settings.compact_frac + 0.5)
    return max(128, min(n_slots, (b + 127) // 128 * 128))


def compact_overflow(valid: torch.Tensor, budget: int) -> torch.Tensor:
    """Valid samples dropped by the budget, int32 [1], on the device (JAX :122-129)."""
    return (valid.sum(dtype=torch.int32) - budget).clamp_min(0)[None]


def _resolve_bg(params: Params, spec, rays_o: torch.Tensor, rays_d: torch.Tensor, bg_color,
                settings: RenderSettings) -> torch.Tensor:
    """Background colour per ray: the background net of ``spec`` (a NeRFSpec or
    PaletteSpec) with ``bg_radius > 0`` ([N, 3]), else ``bg_color``, else white [3]
    (JAX :132-139, renderer.py:274-279)."""
    if settings.bg_radius > 0:
        sph = sph_from_ray(rays_o, rays_d, settings.bg_radius)
        return nerf_background(params, spec, sph, rays_d)
    if bg_color is None:
        return torch.ones((3,), dtype=torch.float32, device=rays_o.device)
    return bg_color


def render_nerf_train(
    params: Params,
    spec: NeRFSpec,
    bitfield: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    settings: RenderSettings,
    bg_color: Optional[torch.Tensor] = None,
    rays_gt: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    rand: Optional[EncodeRand] = None,
):
    """Differentiable render of a flat ray batch [N, 3]. The network runs in training
    mode (``-O2``: the stochastic trilerp and level subsampling over ``rand``, whose ``u``
    has ``train_rows(settings, N)`` rows; without ``rand`` the corner draw hashes the
    positions and every level is scattered).

    Returns dict(image [N,3], depth [N], weights_sum [N], rgb_norm [N]), and
    ``compact_overflow`` [1] with ``compact_frac``.
    """
    n = rays_o.shape[0]
    nears, fars = near_far_from_aabb(rays_o, rays_d, _aabb(settings, rays_o.device),
                                     settings.min_near)
    bg = _resolve_bg(params, spec, rays_o, rays_d, bg_color, settings)
    m = _march(rays_o, rays_d, nears, fars, bitfield, settings, settings.num_samples, noise)
    profiling.count_device("train.valid_samples", m.mask)
    dirs = rays_d[:, None, :].expand_as(m.xyzs).reshape(-1, 3)
    x = m.xyzs.reshape(-1, 3)
    overflow = None
    if settings.compact_frac > 0:
        budget = _compact_budget(settings, x.shape[0])
        valid = m.mask.reshape(-1)
        overflow = compact_overflow(valid, budget)
        sigmas, rgbs = forward_compact(
            lambda xc, dc: nerf_forward(params, spec, xc, dc, training=True, rand=rand),
            valid, budget, x, dirs)
    else:
        sigmas, rgbs = nerf_forward(params, spec, x, dirs, training=True, rand=rand)
    sigmas = sigmas.reshape(n, -1) * settings.density_scale
    rgbs = rgbs.reshape(n, -1, 3)

    ws, depth, image = composite_rays(sigmas, rgbs, m.dts, m.t_cum, m.mask, settings.t_thresh)
    if rays_gt is not None:
        # per-sample GT error composited back to rays (sparsity term, renderer.py:301-307)
        err = ((rays_gt[:, None, :] - rgbs) ** 2).sum(-1)
        w, _, _ = composite_weights(sigmas, m.dts, m.mask, settings.t_thresh)
        rgb_norm = (w * err).sum(-1)
    else:
        rgb_norm = torch.zeros((n,), dtype=torch.float32, device=rays_o.device)

    image = image + (1.0 - ws)[:, None] * bg
    depth_out = (depth - nears).clamp_min(0.0) / (fars - nears).clamp_min(1e-6)
    out = {"image": image, "depth": depth_out, "weights_sum": ws, "rgb_norm": rgb_norm}
    if overflow is not None:
        out["compact_overflow"] = overflow
    return out


def train_rows(settings: RenderSettings, n_rays: int) -> int:
    """Rows the train render runs the network on (and the ``-O2`` draw covers): every
    sample slot, or the compact budget with ``compact_frac`` (JAX :178-186)."""
    n_slots = n_rays * settings.num_samples
    return _compact_budget(settings, n_slots) if settings.compact_frac > 0 else n_slots


class _Copies:
    """The ``pad_to - n`` copies of a batch's last ray that JAX's ``render_image`` pads
    every chunk with (trainer.py:496-527), counted and not rendered.

    Eval has no jitter, so a copy marches the last ray's samples and composites its
    colours; what can set a copy apart is its remaining transmittance only: a round of
    ``render_nerf_eval_compact`` that selects some copies and not others, or a compact
    budget that drops some of their samples, leaves the copies in groups of different
    transmittance. ``groups`` holds them in index order as [count, trans (0-d tensor)].
    A group whose transmittance equals the last ray's before a round in which both keep
    every sample takes the last ray's own result, so that the two tie exactly in the next
    round's sort, as identical rays in JAX's batch do."""

    def __init__(self, count: int, trans: torch.Tensor, last_alpha):
        self.groups = [[count, trans]]
        self._last_alpha, self._alpha = last_alpha, None
        self.chosen, self.keys = None, None  # the last ``select``'s

    def alpha(self) -> torch.Tensor:
        """The last ray's alphas over all its slots [S], from a forward of its own."""
        if self._alpha is None:
            self._alpha = self._last_alpha()
        return self._alpha

    def select(self, alive, order, last_live, n_sel):
        """A later round's selection over the padded batch of ``n_sel`` rays: the real
        rays selected (a prefix of ``order``) and, per real ray selected, the selected
        copies sorted ahead of it. Keeps each group's selected count and sort key.

        In the stable descending sort the copies of a group follow every real ray whose
        key (``alive``; a group's: its transmittance where the last ray's first slot of the
        round holds a sample, else 0) is at least theirs, the real rays having the lower
        indices, and precede the rest."""
        dev = alive.device
        t = torch.stack([g[1] for g in self.groups])
        keys = torch.where(last_live, t, torch.zeros_like(t))
        counts = torch.tensor([g[0] for g in self.groups], dtype=torch.int64, device=dev)
        a_sorted = alive[order]
        shifted = torch.arange(alive.shape[0], device=dev) + (
            (keys[None, :] > a_sorted[:, None]) * counts[None, :]).sum(1)
        n_real = int((shifted < n_sel).sum())
        rank = (alive[None, :] >= keys[:, None]).sum(1) + (
            _groups_before(keys) * counts[None, :]).sum(1)
        chosen = (n_sel - rank).clamp(min=0).minimum(counts)
        if n_real + int(chosen.sum()) != n_sel:
            raise RuntimeError("padded selection does not add up: "
                               f"{n_real} rays + {int(chosen.sum())} copies != {n_sel}")
        self.chosen, self.keys = chosen.tolist(), keys
        ahead = ((keys[None, :] > a_sorted[:n_real, None]) * chosen[None, :]).sum(1)
        return order[:n_real], ahead

    def advance(self, v, budget, t_rel_last, cols, last_valid, alive, valid_rows, sel,
                total_real) -> int:
        """The groups after a round (``sel`` None: round 0, every copy selected, packed
        after every real ray); returns the copies the round selected.

        A selected copy that the budget keeps whole takes the last ray's transmittance
        factor over the round's slots ``cols`` (``t_rel_last``, the one the last ray's row
        computed when it kept every sample, else from ``alpha()``), the one copy the budget
        cuts the factor of the valid samples it kept (``last_valid`` [s_r] marks the last
        ray's), and a dropped or unselected copy keeps its transmittance. ``valid_rows``
        [rows] are the round's valid samples per real row (in ``sel``'s order),
        ``total_real`` their sum, ``v`` the last ray's; ``alive`` the real rays' keys."""
        if sel is None:
            chosen, starts = [g[0] for g in self.groups], []
            for c in chosen:
                starts.append(total_real + v * sum(chosen[:len(starts)]))
        else:
            # a group's copies follow the real rays whose key is at least theirs (all of
            # them selected when any copy of the group is) and the groups sorted before it
            chosen, keys, keyed = self.chosen, self.keys, alive[sel]
            counts = torch.tensor(chosen, dtype=torch.int64, device=keys.device)
            ahead = ((_groups_before(keys) * counts[None, :]).sum(1) * v).tolist()
            starts = [int(valid_rows[keyed >= k].sum()) + a for k, a in zip(keys, ahead)]

        def factor(keep=None):
            a = self.alpha()[cols]
            a = a if keep is None else torch.where(keep, a, torch.zeros_like(a))
            return torch.cumprod(1.0 - a, 0)[-1]

        new = []
        for (count, t_in), c, start in zip(self.groups, chosen, starts):
            full, cut, dropped = _copy_fates(c, start, v, budget)
            if full:
                # with the last ray's own factor, a group of its transmittance gets its
                # result bit for bit
                new.append([full, t_in * (factor() if t_rel_last is None else t_rel_last)])
            if cut:
                kept = last_valid & (torch.cumsum(last_valid.to(torch.int32), 0) <= cut)
                new.append([1, t_in * factor(kept)])
            new.append([dropped + count - c, t_in])
        self._regroup(new)
        return sum(chosen)

    def _regroup(self, groups):
        """Set the groups (index order), dropping empty ones and merging neighbours of
        equal transmittance."""
        out = []
        for count, t in groups:
            if count == 0:
                continue
            if out and bool(out[-1][1] == t):
                out[-1][0] += count
            else:
                out.append([count, t])
        self.groups = out


def _groups_before(keys: torch.Tensor) -> torch.Tensor:
    """[G, G] bool: copy group h (column) sorts before group g (row): a higher key, or an
    equal key and a lower index."""
    idx = torch.arange(keys.shape[0], device=keys.device)
    return (keys[None, :] > keys[:, None]) | (
        (keys[None, :] == keys[:, None]) & (idx[None, :] < idx[:, None]))


def _copy_fates(count: int, start: int, v: int, budget: Optional[int]):
    """How ``count`` copies, each with ``v`` valid samples packed from compact slot
    ``start`` on, fare against ``budget`` (None: no budget): (fully kept, samples kept of
    the one copy cut by the budget (0: none), fully dropped)."""
    if budget is None or v == 0:
        return count, 0, 0
    full = min(count, max(0, (budget - start) // v))
    cut = budget - start - full * v if full < count else 0
    cut = cut if 0 < cut < v else 0
    return full, cut, count - full - (1 if cut else 0)


@torch.no_grad()
def render_nerf_eval_compact(
    params: Params,
    spec: NeRFSpec,
    bitfield: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    settings: RenderSettings,
    bg_color: Optional[torch.Tensor] = None,
    pad_to: Optional[int] = None,
):
    """Eval render with static alive-ray compaction rounds: round 0 marches every
    ray for a few samples; each later round continues only the top 1/divisor rays by
    remaining transmittance (nerf/renderer.py:336-386 semantics).

    With ``pad_to`` > N the rays count as ``pad_to``, the rest copies of the last ray, as
    JAX renders a frame's short last chunk: each round selects from, and each compact
    budget is sized for, the padded batch, and the copies that sort ahead of a ray take
    its place in the round and their valid samples take budget slots ahead of its own
    (``_Copies``); the dropped samples counted include the copies'. The copies are not
    rendered: the real rays' outputs are JAX's on the padded batch.

    Under the profiler each round is the span ``eval.round``, counted in ``eval.rounds``,
    and its real rays' valid samples in the device counter ``eval.valid_samples.r<k>``
    (``utils.profiling``)."""
    rounds = settings.compaction_rounds
    if not rounds or rounds[0][0] != 1:
        raise ValueError(f"compaction round 0 must cover all rays, got {rounds}")
    n = rays_o.shape[0]
    n_pad = max(n, pad_to or n)
    device = rays_o.device
    nears, fars = near_far_from_aabb(rays_o, rays_d, _aabb(settings, device), settings.min_near)
    bg = _resolve_bg(params, spec, rays_o, rays_d, bg_color, settings)
    m = _march(rays_o, rays_d, nears, fars, bitfield, settings, sum(s for _, s in rounds))

    image = torch.zeros((n, 3), dtype=torch.float32, device=device)
    depth = torch.zeros((n,), dtype=torch.float32, device=device)
    ws = torch.zeros((n,), dtype=torch.float32, device=device)
    trans = torch.ones((n,), dtype=torch.float32, device=device)
    overflow = torch.zeros((1,), dtype=torch.int32, device=device)
    compact = settings.compact_frac > 0

    def last_alpha():
        """The last ray's alphas over every slot, from its own forward."""
        sig, _ = nerf_forward(params, spec, m.xyzs[-1], rays_d[-1:].expand_as(m.xyzs[-1]))
        sig = torch.where(m.mask[-1], sig.float() * settings.density_scale,
                          torch.zeros_like(m.dts[-1]))
        return 1.0 - torch.exp(-sig * m.dts[-1])

    copies = _Copies(n_pad - n, trans[-1].clone(), last_alpha) if n_pad > n else None

    offset = 0
    for k, (divisor, s_r) in enumerate(rounds):
        profiling.count("eval.rounds", 1)
        with profiling.span("eval.round"):
            cols = slice(offset, offset + s_r)
            budget = _compact_budget(settings, n_pad // divisor * s_r) if compact else None
            ahead = None
            if divisor == 1:
                sel = None
                xyz, dts = m.xyzs[:, cols], m.dts[:, cols]
                t_cum, mask = m.t_cum[:, cols], m.mask[:, cols]
                rd_r, t_in = rays_d, trans
            else:
                # the top n_r rays by remaining transmittance; among equal ones the lower
                # index, as lax.top_k orders them (torch.topk leaves ties in no set order)
                alive = torch.where(m.mask[:, offset], trans, torch.zeros_like(trans))
                order = torch.sort(alive, descending=True, stable=True).indices
                if copies is None:
                    sel = order[:n // divisor]
                else:
                    sel, ahead_rows = copies.select(alive, order, m.mask[-1, offset],
                                                    n_pad // divisor)
                xyz, dts = m.xyzs[sel, cols], m.dts[sel, cols]
                t_cum, mask = m.t_cum[sel, cols], m.mask[sel, cols]
                rd_r, t_in = rays_d[sel], trans[sel]
            profiling.count_device(f"eval.valid_samples.r{k}", mask)
            n_r = xyz.shape[0]
            if copies is not None:
                v = int(m.mask[-1, cols].sum())  # the last ray's valid samples in the round
                if divisor > 1 and compact:
                    ahead = (ahead_rows * v)[:, None].expand(-1, s_r).reshape(-1)
                # the last ray's row in the round, and whether the budget keeps all of it
                row_valid = mask.sum(-1, dtype=torch.int32)
                total_real = int(row_valid.sum())
                if sel is None:
                    last_row = n - 1
                else:
                    hit = (sel == n - 1).nonzero()
                    last_row = int(hit[0, 0]) if hit.numel() else None
                last_whole = last_row is not None
                if last_whole and budget is not None:
                    start = int(row_valid[:last_row].sum()) + (
                        0 if ahead is None else int(ahead[last_row * s_r]))
                    last_whole = start + int(row_valid[last_row]) <= budget

            dirs = rd_r[:, None, :].expand_as(xyz)
            sig, rgb = _eval_forward(params, spec, xyz, dirs, mask, budget, ahead)
            sig = sig.reshape(n_r, s_r).float() * settings.density_scale
            rgb = rgb.reshape(n_r, s_r, 3).float()

            sig = torch.where(mask, sig, torch.zeros_like(sig))
            alpha = 1.0 - torch.exp(-sig * dts)
            t_rel = torch.cumprod(1.0 - alpha, dim=-1)
            t_enter = t_in[:, None] * torch.cat([torch.ones_like(t_rel[:, :1]), t_rel[:, :-1]], -1)
            w = alpha * t_enter * (t_enter >= settings.t_thresh) * mask

            d_img = torch.einsum("ns,nsc->nc", w, rgb)
            d_ws = w.sum(-1)
            d_depth = (w * t_cum).sum(-1)
            t_out = t_in * t_rel[:, -1]
            if sel is None:
                image, ws, depth, trans = image + d_img, ws + d_ws, depth + d_depth, t_out
            else:
                image.index_add_(0, sel, d_img)
                ws.index_add_(0, sel, d_ws)
                depth.index_add_(0, sel, d_depth)
                trans[sel] = t_out
            if copies is not None:
                n_copies = copies.advance(
                    v, budget, t_rel[last_row, -1] if last_whole else None, cols, m.mask[-1, cols],
                    alive if divisor > 1 else None, row_valid, sel, total_real)
                if compact:
                    overflow = overflow + max(0, total_real + v * n_copies - budget)
            elif compact:
                overflow = overflow + compact_overflow(mask.reshape(-1), budget)
        offset += s_r

    image = image + (1.0 - ws)[:, None] * bg
    depth_abs = depth + ws * nears
    depth_out = (depth_abs - nears).clamp_min(0.0) / (fars - nears).clamp_min(1e-6)
    out = {"image": image, "depth": depth_out, "depth_origin": depth_abs, "weights_sum": ws}
    if compact:
        out["compact_overflow"] = overflow
    return out


def _eval_forward(params, spec, xyz, dirs, mask, budget=None, ahead=None):
    """``nerf_forward`` over the sample slots [..., 3], or with a compact ``budget`` over
    the valid ones it keeps (``forward_compact``): (sigma [M], rgb [M, 3])."""
    x, d = xyz.reshape(-1, 3), dirs.reshape(-1, 3)
    if budget is None:
        return nerf_forward(params, spec, x, d)
    return forward_compact(lambda xc, dc: nerf_forward(params, spec, xc, dc),
                           mask.reshape(-1), budget, x, d, ahead=ahead)


def padded_overflow(mask: torch.Tensor, budget: int, n_pad: int) -> torch.Tensor:
    """``compact_overflow`` of a one-pass render whose [N, S] ``mask`` counts as ``n_pad``
    rays, the rest copies of the last (packed after the real rays, so they take no slot
    from them): the samples the budget drops, the copies' included, int32 [1]."""
    copies = (n_pad - mask.shape[0]) * mask[-1].sum(dtype=torch.int32)
    return (mask.sum(dtype=torch.int32) + copies - budget).clamp_min(0)[None]


@torch.no_grad()
def render_nerf_eval(
    params: Params,
    spec: NeRFSpec,
    bitfield: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    settings: RenderSettings,
    bg_color: Optional[torch.Tensor] = None,
    pad_to: Optional[int] = None,
):
    """Eval render (no jitter). Returns image, depth, depth_origin (absolute composited
    distance, palette/renderer.py:526) and weights_sum. With ``pad_to`` > N the batch
    counts as ``pad_to`` rays, the rest copies of the last one, as JAX pads a frame's last
    chunk (its rounds and compact budgets; ``render_nerf_eval_compact``)."""
    n = rays_o.shape[0]
    n_pad = max(n, pad_to or n)
    if settings.compaction_rounds and n_pad >= 64:
        # tiny batches skip compaction: top-k over n//16 rays needs a population
        return render_nerf_eval_compact(params, spec, bitfield, rays_o, rays_d,
                                        settings, bg_color, pad_to)
    nears, fars = near_far_from_aabb(rays_o, rays_d, _aabb(settings, rays_o.device),
                                     settings.min_near)
    bg = _resolve_bg(params, spec, rays_o, rays_d, bg_color, settings)
    m = _march(rays_o, rays_d, nears, fars, bitfield, settings, settings.num_samples)
    dirs = rays_d[:, None, :].expand_as(m.xyzs)
    budget = (_compact_budget(settings, n_pad * settings.num_samples)
              if settings.compact_frac > 0 else None)
    sigmas, rgbs = _eval_forward(params, spec, m.xyzs, dirs, m.mask, budget)
    sigmas = sigmas.reshape(n, -1) * settings.density_scale
    rgbs = rgbs.reshape(n, -1, 3)
    ws, depth, image = composite_rays(sigmas, rgbs, m.dts, m.t_cum, m.mask, settings.t_thresh)
    image = image + (1.0 - ws)[:, None] * bg
    # inference depth is absolute in the reference (raymarching.cu:1078-1079)
    depth_abs = depth + ws * nears
    depth_out = (depth_abs - nears).clamp_min(0.0) / (fars - nears).clamp_min(1e-6)
    out = {"image": image, "depth": depth_out, "depth_origin": depth_abs, "weights_sum": ws}
    if budget is not None:
        out["compact_overflow"] = padded_overflow(m.mask, budget, n_pad)
    return out


def _alpha_weights(z_vals: torch.Tensor, sample_dist: torch.Tensor, sigmas: torch.Tensor,
                   density_scale: float) -> torch.Tensor:
    """Compositing weights of samples at z_vals [N, T] (the last one's interval
    ``sample_dist``), in the reference's alphas-shifted form (renderer.py:209-211)."""
    deltas = torch.diff(z_vals, dim=-1)
    deltas = torch.cat([deltas, sample_dist * torch.ones_like(deltas[..., :1])], -1)
    alphas = 1.0 - torch.exp(-deltas * density_scale * sigmas)
    shifted = torch.cat([torch.ones_like(alphas[..., :1]), 1 - alphas + 1e-15], -1)
    return alphas * torch.cumprod(shifted, -1)[..., :-1]


def render_nerf_uniform(
    params: Params,
    spec: NeRFSpec,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    settings: RenderSettings,
    num_steps: int = 128,
    upsample_steps: int = 128,
    bg_color: Optional[torch.Tensor] = None,
    jitter: Optional[torch.Tensor] = None,
    pdf_u: Optional[torch.Tensor] = None,
):
    """Grid-free render of the reference's pure-PyTorch ``run()`` (nerf/renderer.py:
    127-255; JAX :220-297): ``num_steps`` uniform samples in [near, far], a density pass
    without gradient that drives ``sample_pdf`` to ``upsample_steps`` more, merged and
    sorted, then the alphas-shifted composite; depth is the normalised z.

    ``jitter`` [N, num_steps] in [0, 1) perturbs the uniform samples by (u - 0.5) times
    their spacing, and ``pdf_u`` [N, upsample_steps] are the upsampler's uniforms (the
    JAX ``perturb`` path draws both); without ``pdf_u`` the upsampler is deterministic.
    Returns dict(image [N, 3], depth [N], weights_sum [N]).
    """
    n = rays_o.shape[0]
    b = settings.bound
    nears, fars = near_far_from_aabb(rays_o, rays_d, _aabb(settings, rays_o.device),
                                     settings.min_near)
    nears_, fars_ = nears[:, None], fars[:, None]
    z = torch.linspace(0.0, 1.0, num_steps, device=rays_o.device)[None, :]
    z_vals = nears_ + (fars_ - nears_) * z
    sample_dist = (fars_ - nears_) / num_steps
    if jitter is not None:
        z_vals = z_vals + (jitter - 0.5) * sample_dist

    def clip_pts(zv):
        return (rays_o[:, None, :] + rays_d[:, None, :] * zv[..., None]).clamp(-b, b)

    xyzs = clip_pts(z_vals)
    sigmas = nerf_density(params, spec, xyzs.reshape(-1, 3))["sigma"].reshape(n, num_steps)
    total = num_steps
    if upsample_steps > 0:
        with torch.no_grad():
            weights = _alpha_weights(z_vals, sample_dist, sigmas, settings.density_scale)
            z_mid = z_vals[..., :-1] + 0.5 * torch.diff(z_vals, dim=-1)
            new_z = sample_pdf(z_mid, weights[:, 1:-1], upsample_steps, u=pdf_u,
                               det=pdf_u is None)
        z_vals = torch.sort(torch.cat([z_vals, new_z], -1), -1).values
        xyzs = clip_pts(z_vals)
        total = num_steps + upsample_steps
        sigmas = nerf_density(params, spec, xyzs.reshape(-1, 3))["sigma"].reshape(n, total)

    weights = _alpha_weights(z_vals, sample_dist, sigmas, settings.density_scale)
    dirs = rays_d[:, None, :].expand_as(xyzs)
    _, rgbs = nerf_forward(params, spec, xyzs.reshape(-1, 3), dirs.reshape(-1, 3))
    rgbs = rgbs.reshape(n, total, 3)

    ws = weights.sum(-1)
    ori_z = ((z_vals - nears_) / (fars_ - nears_)).clamp(0, 1)
    depth = (weights * ori_z).sum(-1)
    image = torch.einsum("ns,nsc->nc", weights, rgbs)
    bg = _resolve_bg(params, spec, rays_o, rays_d, bg_color, settings)
    image = image + (1.0 - ws)[:, None] * bg
    return {"image": image, "depth": depth, "weights_sum": ws}
