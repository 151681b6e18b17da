"""Tests of the port that need the card (marker ``cuda``; they skip without one).

This file imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch + CUDA:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each CUDA result is held against the port's own plain version of the same function,
run on the same inputs.
"""

import numpy as np
import pytest
import torch

from palettenerf_torch.config import Config
from palettenerf_torch.models.mlp import init_mlp, param_leaves
from palettenerf_torch.models.nerf import NeRFSpec, init_nerf, param_list
from palettenerf_torch.models.palette import FROZEN, PaletteSpec, init_palette
from palettenerf_torch.ops import hashgrid_fast, scatter, window_gather
from palettenerf_torch.ops.hashgrid import HashGridSpec
from palettenerf_torch.train.palette_trainer import PaletteTrainer
from palettenerf_torch.train.trainer import Trainer
from torch_support import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda


def _within(got, ref, scale, rtol):
    return bool(((got - ref).abs() <= rtol * scale + 1e-12).all())


@pytest.mark.parametrize("C", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("period", [None, 128])
def test_scatter_kernel_matches_plain_version(cuda_device, C, period):
    gen = torch.Generator(device=cuda_device).manual_seed(C)
    total, U = 100_003, 1 << 20
    idx = torch.randint(0, total, (U,), generator=gen, device=cuda_device, dtype=torch.int32)
    vals = torch.randn((U, C), generator=gen, device=cuda_device).to(torch.bfloat16)
    before = scatter.scatter_add.launches
    got = scatter.scatter_add(idx, vals, total, period)
    assert scatter.scatter_add.launches == before + 1
    ref = scatter.scatter_add_reference(idx, vals, total)
    scale = scatter.scatter_add_reference(idx, vals.abs(), total)
    torch.cuda.synchronize()
    scatter.check_refused()
    assert _within(got, ref, scale, 1e-5)  # f32 atomics sum in another order


# the path's call (column walk), the call without a period (one vector atomic per row in
# stream order) and the yardstick they are timed against: (period, scalar) of _scatter_add
KERNELS = {"columns": (128, False), "rows": (None, False), "scalar": (128, True)}


@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_scatter_kernel_exact_on_periodic_duplicates(cuda_device, C, kernel):
    """Equal rows one period apart (12 points in a row share each row), a zero-valued
    stretch, and a point count that no walk length or block divides: counts are exact."""
    n_pts, P = 1000 + 3, 128
    point = torch.arange(n_pts, device=cuda_device, dtype=torch.int32)
    idx = ((point // 12)[:, None] * P
           + torch.arange(P, device=cuda_device, dtype=torch.int32)[None, :]).reshape(-1)
    vals = torch.ones((n_pts, P, C), device=cuda_device, dtype=torch.bfloat16)
    vals[200:300] = 0
    vals = vals.reshape(-1, C)
    total = int(idx.max()) + 7
    got = scatter._scatter_add(idx, vals, total, *KERNELS[kernel])
    torch.cuda.synchronize()
    scatter.check_refused()
    assert torch.equal(got, scatter.scatter_add_reference(idx, vals, total))
    assert float(got.max()) == 12.0 and float(got[-6:].abs().max()) == 0.0


def test_scatter_kernel_exact_on_duplicates_and_empty_rows(cuda_device):
    idx = (torch.arange(1 << 16, device=cuda_device, dtype=torch.int32) % 5).contiguous()
    got = scatter.scatter_add(idx, torch.ones((1 << 16, 2), device=cuda_device,
                                              dtype=torch.bfloat16), 1000)
    torch.cuda.synchronize()
    counts = torch.bincount(idx.long(), minlength=1000).float()
    assert torch.equal(got[:, 0], counts) and torch.equal(got[:, 1], counts)
    before = scatter.scatter_add.launches
    empty = scatter.scatter_add(torch.zeros(0, dtype=torch.int32, device=cuda_device),
                                torch.zeros((0, 2), dtype=torch.bfloat16, device=cuda_device), 7)
    assert empty.shape == (7, 2) and float(empty.abs().max()) == 0.0
    assert scatter.scatter_add.launches == before  # nothing to launch


def test_scatter_kernel_rejects_what_it_does_not_take(cuda_device):
    idx = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    ones = torch.ones((4, 2), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        scatter.scatter_add(idx, torch.ones((4, 2), device=cuda_device), 8)  # f32 vals
    with pytest.raises(TypeError):
        scatter.scatter_add(idx.long(), ones, 8)
    with pytest.raises(ValueError):
        scatter.scatter_add(idx, torch.ones((4, 2), dtype=torch.bfloat16), 8)  # mixed devices
    with pytest.raises(ValueError, match="period"):
        scatter.scatter_add(idx, ones, 8, 3)
    with pytest.raises(ValueError, match="contiguous"):
        scatter.scatter_add(idx, torch.ones((4, 4), device=cuda_device,
                                            dtype=torch.bfloat16)[:, ::2], 8)
    flat = torch.ones(9, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        scatter.scatter_add(idx, flat[1:].view(4, 2), 8)  # rows at an odd 2-byte offset


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_scatter_kernel_refuses_rows_out_of_range(cuda_device, kernel):
    """A row outside [0, total_rows) is never written and never silent: the call
    returns without reading the device, the next check_refused() raises, once."""
    idx = torch.tensor([0, 1, 9, 3, 0, 1, -1, 3], dtype=torch.int32, device=cuda_device)
    period, scalar = KERNELS[kernel]
    got = scatter._scatter_add(idx, torch.ones((8, 2), device=cuda_device, dtype=torch.bfloat16),
                               8, period and 4, scalar)
    torch.cuda.synchronize()
    want = torch.zeros((8, 2), device=cuda_device)
    want[[0, 1, 3]] = 2.0
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="2 indices outside"):
        scatter.check_refused()
    scatter.check_refused()


def test_wrappers_read_nothing_back_from_the_card(cuda_device):
    """No device-to-host read (which would stall the launch queue) in either wrapper:
    PyTorch's sync debug mode turns any synchronising call into an error."""
    idx = torch.arange(1 << 12, dtype=torch.int32, device=cuda_device) % 77
    vals = torch.ones((1 << 12, 2), device=cuda_device, dtype=torch.bfloat16)
    W = torch.randn((8, 128), device=cuda_device)
    r = torch.zeros((4, 128), dtype=torch.int32, device=cuda_device)
    scatter.scatter_add(idx, vals, 100, 128)      # builds and loads outside the guard
    window_gather.window_gather(W, r, r)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = scatter.scatter_add(idx, vals, 100, 128)
        got_rows = scatter.scatter_add(idx, vals, 100)
        picked = window_gather.window_gather(W, r, r)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(got, got_rows) and float(got.sum()) == 2.0 * (1 << 12)
    assert torch.equal(picked, W[0, 0].expand(4, 128))


def test_bf16_table_grad_on_card_matches_cpu(cuda_device):
    spec = HashGridSpec.build(num_levels=8, desired_resolution=512, log2_hashmap_size=14)
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.total_params, 2)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0, 1, (4096, 3)).astype(np.float32))
    co = torch.from_numpy(rng.normal(size=(4096, spec.output_dim)).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda_device):
        t = table.to(dev, copy=True).requires_grad_(True)
        out = hashgrid_fast.hashgrid_encode_fast(t, x.to(dev), spec, torch.bfloat16)
        (out * co.to(dev)).sum().backward()
        grads.append((out.detach().cpu(), t.grad.cpu()))
    (out_c, g_c), (out_g, g_g) = grads
    torch.testing.assert_close(out_g, out_c, rtol=0, atol=1e-6)
    # one bf16 ulp of an update (2^-8 relative) when the f32 update differs in its last bit
    assert float((g_g - g_c).abs().max()) <= 1e-2 * float(g_c.abs().max())


# the -O2 backward streams: (nearest_corner_grad, stochastic, grad_levels)
O2_MODES = {"O2": (True, True, 8), "fast_grad": (True, False, 0),
            "stochastic": (False, True, 0), "exact_levels": (False, False, 8)}


@pytest.mark.parametrize("gridtype", ["hash", "hash_xadd"])
@pytest.mark.parametrize("mode", list(O2_MODES))
@pytest.mark.parametrize("walk", ["columns", "rows"])
def test_scatter_kernel_on_O2_streams(cuda_device, gridtype, mode, walk):
    """B1 on the backward streams of -O2, --fast_grad, the drawn row and grad_levels, in
    both of its modes (the column walk over the stream's columns per point, and the
    stream in its own order), against its plain version."""
    nearest, stochastic, levels = O2_MODES[mode]
    spec = HashGridSpec.build(num_levels=16, desired_resolution=2048, log2_hashmap_size=15,
                              gridtype=gridtype)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.rand((1 << 14, 3), generator=gen, device=cuda_device)
    rand = hashgrid_fast.make_encode_rand(gen, x.shape[0], spec, levels)
    _, res = hashgrid_fast._encode(torch.zeros((spec.total_params, 2), device=cuda_device),
                                   spec, x, rand.u, stochastic)
    g = torch.randn((x.shape[0], spec.output_dim), generator=gen, device=cuda_device)
    rows, upd, period = hashgrid_fast._backward_stream(spec, res, rand.lvls, g, nearest,
                                                       stochastic, levels)
    vals = upd.to(torch.bfloat16).contiguous()
    got = scatter.scatter_add(rows, vals, spec.total_params,
                              period if walk == "columns" else None)
    torch.cuda.synchronize()
    scatter.check_refused()
    ref = scatter.scatter_add_reference(rows, vals, spec.total_params)
    scale = scatter.scatter_add_reference(rows, vals.abs(), spec.total_params)
    assert _within(got, ref, scale, 1e-5)


@pytest.mark.parametrize("gridtype", ["hash", "hash_xadd"])
@pytest.mark.parametrize("mode", list(O2_MODES))
def test_O2_encode_on_card_matches_cpu(cuda_device, gridtype, mode):
    """The -O2 encoder on the card against the CPU on the same points and draws: the
    drawn rows (a one-ulp weight can flip a draw at u = sum of weights: at most 1e-5 of
    them), the forward where the draws agree, the bf16 table gradient."""
    nearest, stochastic, levels = O2_MODES[mode]
    spec = HashGridSpec.build(num_levels=8, desired_resolution=512, log2_hashmap_size=14,
                              gridtype=gridtype)
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.uniform(-1, 1, (spec.total_params, 2)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0, 1, (4096, 3)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=(4096, 8)).astype(np.float32))
    lvls = torch.tensor([5, 0, 2, 7])
    co = torch.from_numpy(rng.normal(size=(4096, spec.output_dim)).astype(np.float32))
    res = []
    for dev in ("cpu", cuda_device):
        t = table.to(dev, copy=True).requires_grad_(True)
        rand = hashgrid_fast.EncodeRand(u=u.to(dev), lvls=lvls.to(dev))
        out = hashgrid_fast.hashgrid_encode_fast(t, x.to(dev), spec, torch.bfloat16, nearest,
                                                 stochastic, rand, levels and 4)
        (out * co.to(dev)).sum().backward()
        picks = hashgrid_fast._encode(t.detach(), spec, x.to(dev), u.to(dev), stochastic)[1][0]
        res.append((out.detach().cpu(), t.grad.cpu(), picks.cpu()))
    (out_c, g_c, p_c), (out_g, g_g, p_g) = res
    flipped = p_g != p_c
    assert float(flipped.float().mean()) <= 1e-5
    same = ~flipped.reshape(4096, 8, -1).any(-1)[..., None].expand(-1, -1, 2).reshape(4096, -1)
    torch.testing.assert_close(out_g[same], out_c[same], rtol=0, atol=1e-6)
    if not flipped.any():
        assert float((g_g - g_c).abs().max()) <= 1e-2 * float(g_c.abs().max())


def test_train_step_on_card_matches_cpu(cuda_device, tmp_path):
    cfg = Config(O=True, fp16=True, bound=1.0, grid_size=32, num_rays=512, max_steps=256,
                 train_samples_per_ray=32, log2_hashmap_size=14, grid_levels=8, iters=100)
    spec = NeRFSpec.build(bound=1.0, fp16=True, log2_hashmap_size=14, grid_levels=8)
    gen = torch.Generator().manual_seed(1)
    params = init_nerf(spec, gen)
    params["encoder"].uniform_(-1, 1, generator=gen)
    n = cfg.num_rays
    o = torch.randn((n, 3), generator=gen)
    o = o / o.norm(dim=-1, keepdim=True) * 2.0
    d = -o + 0.5 * torch.randn((n, 3), generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    img, bg, noise = (torch.rand((n, 4), generator=gen), torch.rand((n, 3), generator=gen),
                      torch.rand((n,), generator=gen))
    out = []
    for dev in ("cpu", cuda_device):
        tr = Trainer("t", cfg, spec, params={k: (v.clone() if torch.is_tensor(v)
                                                 else [w.clone() for w in v])
                                             for k, v in params.items()},
                     workspace=str(tmp_path), use_checkpoint="scratch", mute=True, device=dev)
        tr.grid_state = tr.grid_state._replace(
            bitfield=torch.full_like(tr.grid_state.bitfield, 255))
        before = scatter.scatter_add.launches
        loss, _ = tr.train_step(o.to(tr.device), d.to(tr.device), img.to(tr.device),
                                bg=bg.to(tr.device), noise=noise.to(tr.device))
        launched = scatter.scatter_add.launches - before
        out.append((float(loss), [p.grad.cpu() for p in param_list(tr.params)], launched))
    (loss_c, g_c, n_c), (loss_g, g_g, n_g) = out
    assert (n_c, n_g) == (0, 1)
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    for a, b in zip(g_c, g_g):
        assert float((a - b).abs().max()) <= 1e-2 * float(a.abs().max())


def test_scatter_kernel_on_a_compacted_train_stream(cuda_device, tmp_path):
    """``--train_compact_frac 0.25``: the train step on the card against the CPU (loss,
    overflow, every gradient) with one B1 launch; then B1 against its plain version on the
    stream the compacted encode gives it: the valid samples packed first, the budget's
    unused slots at the tail with zero updates."""
    from palettenerf_torch.render.nerf_renderer import forward_compact, train_rows

    cfg = Config(O=True, fp16=True, bound=1.0, grid_size=32, num_rays=512, max_steps=256,
                 train_samples_per_ray=32, log2_hashmap_size=14, grid_levels=8, iters=100,
                 train_compact_frac=0.25)
    spec = NeRFSpec.build(bound=1.0, fp16=True, log2_hashmap_size=14, grid_levels=8)
    gen = torch.Generator().manual_seed(3)
    params = init_nerf(spec, gen)
    params["encoder"].uniform_(-1, 1, generator=gen)
    n = cfg.num_rays
    o = torch.randn((n, 3), generator=gen)
    o = o / o.norm(dim=-1, keepdim=True) * 2.0
    d = -o + 0.5 * torch.randn((n, 3), generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    img, bg, noise = (torch.rand((n, 4), generator=gen), torch.rand((n, 3), generator=gen),
                      torch.rand((n,), generator=gen))
    c = (torch.arange(32) + 0.5) / 32 * 2 - 1
    ball = (torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1) ** 2).sum(-1) < 0.4
    bits = (ball.reshape(-1, 8).int() << torch.arange(8)).sum(-1).to(torch.uint8)
    out = []
    for dev in ("cpu", cuda_device):
        tr = Trainer("t", cfg, spec, params={k: (v.clone() if torch.is_tensor(v)
                                                 else [w.clone() for w in v])
                                             for k, v in params.items()},
                     workspace=str(tmp_path), use_checkpoint="scratch", mute=True, device=dev)
        tr.grid_state = tr.grid_state._replace(bitfield=bits.to(dev))
        before = scatter.scatter_add.launches
        loss, _ = tr.train_step(o.to(tr.device), d.to(tr.device), img.to(tr.device),
                                bg=bg.to(tr.device), noise=noise.to(tr.device))
        launched = scatter.scatter_add.launches - before
        out.append((float(loss), [p.grad.cpu() for p in param_list(tr.params)], launched,
                    int(tr._overflow)))
    (loss_c, g_c, n_c, over_c), (loss_g, g_g, n_g, over_g) = out
    assert (n_c, n_g) == (0, 1) and over_c == over_g > 0
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    for a, b in zip(g_c, g_g):
        assert float((a - b).abs().max()) <= 1e-2 * float(a.abs().max())

    # B1 on the compacted stream of the same batch, marched through the same grid
    from palettenerf_torch.ops.rays import near_far_from_aabb
    from palettenerf_torch.render.nerf_renderer import _aabb, _march

    st = tr.train_settings
    ro, rd = o.to(cuda_device), d.to(cuda_device)
    nears, fars = near_far_from_aabb(ro, rd, _aabb(st, cuda_device), st.min_near)
    m = _march(ro, rd, nears, fars, bits.to(cuda_device), st, st.num_samples,
               noise.to(cuda_device))
    budget = train_rows(st, n)
    x01 = (m.xyzs.reshape(-1, 3) + 1.0) / 2.0
    packed = []
    forward_compact(lambda x: packed.append(x) or (x[:, 0],), m.mask.reshape(-1), budget, x01)
    idx = hashgrid_fast.corner_indices(spec.grid, packed[0])[0].reshape(-1).contiguous()
    held = min(int(m.mask.sum()), budget)
    vals = torch.randn((idx.numel(), 2), device=cuda_device)
    vals[held * 64:] = 0.0
    vals = vals.to(torch.bfloat16)
    got = scatter.scatter_add(idx, vals, spec.grid.total_params, 64)
    ref = scatter.scatter_add_reference(idx, vals, spec.grid.total_params)
    scale = scatter.scatter_add_reference(idx, vals.abs(), spec.grid.total_params)
    torch.cuda.synchronize()
    scatter.check_refused()
    assert held == budget and idx.numel() == budget * 64
    assert _within(got, ref, scale, 1e-5)


def test_bg_encoder_on_card_matches_cpu(cuda_device):
    """The background net's 2D grid at full width (levels 16, 81, 407, 2048: three dense,
    one hashed): features and the f32 table gradient (``index_add_``) on the card against
    the CPU; the gradient within 1e-4 of its largest entry (f32 atomics)."""
    from palettenerf_torch.models.nerf import background_grid

    spec = background_grid(32.0)
    gen = torch.Generator().manual_seed(9)
    table = torch.empty((spec.total_params, 2)).uniform_(-1, 1, generator=gen)
    x = torch.rand((1 << 16, 2), generator=gen)
    cot = torch.randn((1 << 16, spec.output_dim), generator=gen)
    out = []
    for dev in ("cpu", cuda_device):
        t = table.to(dev, copy=True).requires_grad_(True)
        before = scatter.scatter_add.launches
        f = hashgrid_fast.hashgrid_encode_fast(t, x.to(dev), spec)
        (f * cot.to(dev)).sum().backward()
        assert scatter.scatter_add.launches == before  # f32: no B1
        out.append((f.detach().cpu(), t.grad.cpu()))
    (f_c, g_c), (f_g, g_g) = out
    torch.testing.assert_close(f_g, f_c, rtol=0, atol=1e-5)
    assert float((g_c - g_g).abs().max()) <= 1e-4 * float(g_c.abs().max())


def test_scatter_kernel_on_a_patch_stream(cuda_device, tmp_path, monkeypatch):
    """``--bg_radius --patch_size 16 --lambda_lpips 0.1``: the train step on the card
    against the CPU (loss, every gradient, the background net's included) with one B1
    launch; then B1 against its plain version on the stream of that batch: 8 patches of
    16x16 pixels, whose samples cluster in space, so rows repeat more than on a uniform
    stream. TF32 is off for the patch loss's convolutions, as in ``chip_smoke.py``;
    ``dt_gamma`` 0 places the samples bit for bit on both devices. The background net's
    gradients are held in L2 within ``chip_smoke.py:BG_GRAD_L2_RTOL`` (3e-2):
    ``sph_from_ray`` differs by ulps between the devices, which moves its samples at the
    finest background level."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    import numpy as np

    from palettenerf_torch.data.rays import gen_rays, sample_ray_indices
    from palettenerf_torch.ops.rays import near_far_from_aabb
    from palettenerf_torch.render.nerf_renderer import _aabb, _march

    cfg = Config(O=True, fp16=True, bound=1.0, grid_size=32, num_rays=2048, max_steps=256,
                 train_samples_per_ray=32, log2_hashmap_size=14, grid_levels=8, iters=100,
                 bg_radius=32.0, patch_size=16, lambda_lpips=0.1, dt_gamma=0.0)
    spec = NeRFSpec.build(bound=1.0, fp16=True, log2_hashmap_size=14, grid_levels=8,
                          bg_radius=32.0)
    gen = torch.Generator().manual_seed(4)
    params = init_nerf(spec, gen)
    params["encoder"].uniform_(-1, 1, generator=gen)
    params["encoder_bg"].uniform_(-1, 1, generator=gen)
    H = W = 64
    inds, _ = sample_ray_indices(np.random.default_rng(4), H, W, cfg.num_rays,
                                 patch_size=cfg.patch_size)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -2.2  # the camera looks along +z, at the ball
    o, d = (torch.from_numpy(np.ascontiguousarray(a)) for a in gen_rays(
        pose, np.array([50.0, 50.0, 32.0, 32.0]), H, W, inds))
    img, noise = torch.rand((cfg.num_rays, 4), generator=gen), torch.rand((cfg.num_rays,),
                                                                          generator=gen)
    c = (torch.arange(32) + 0.5) / 32 * 2 - 1
    ball = (torch.stack(torch.meshgrid(c, c, c, indexing="ij"), -1) ** 2).sum(-1) < 0.4
    bits = (ball.reshape(-1, 8).int() << torch.arange(8)).sum(-1).to(torch.uint8)
    out = []
    for dev in ("cpu", cuda_device):
        tr = Trainer("t", cfg, spec, params={k: (v.clone() if torch.is_tensor(v)
                                                 else [w.clone() for w in v])
                                             for k, v in params.items()},
                     workspace=str(tmp_path), use_checkpoint="scratch", mute=True, device=dev)
        tr.grid_state = tr.grid_state._replace(bitfield=bits.to(dev))
        before = scatter.scatter_add.launches
        loss, _ = tr.train_step(o.to(tr.device), d.to(tr.device), img.to(tr.device),
                                noise=noise.to(tr.device))
        launched = scatter.scatter_add.launches - before
        out.append((float(loss), [p.grad.cpu() for p in param_list(tr.params)], launched))
    (loss_c, g_c, n_c), (loss_g, g_g, n_g) = out
    assert (n_c, n_g) == (0, 1)
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    n_fg = len(param_list({k: params[k] for k in ("encoder", "sigma_net", "color_net")}))
    for i, (a, b) in enumerate(zip(g_c, g_g)):
        if i < n_fg:
            tol = 1e-2 if i == 0 else 1e-4   # bf16 table updates; f32 elsewhere
            rel = float((a - b).abs().max()) / float(a.abs().max())
        else:
            tol, rel = 3e-2, float((a - b).norm() / a.norm())
        assert rel <= tol, (i, rel)

    st = tr.train_settings
    ro, rd = o.to(cuda_device), d.to(cuda_device)
    nears, fars = near_far_from_aabb(ro, rd, _aabb(st, cuda_device), st.min_near)
    m = _march(ro, rd, nears, fars, bits.to(cuda_device), st, st.num_samples,
               noise.to(cuda_device))
    idx = hashgrid_fast.corner_indices(spec.grid, (m.xyzs.reshape(-1, 3) + 1.0) / 2.0)[0]
    idx = idx.reshape(-1).contiguous()
    vals = torch.randn((idx.numel(), 2), device=cuda_device)
    vals = (vals.view(-1, 64, 2) * m.mask.reshape(-1, 1, 1)).view(-1, 2).to(torch.bfloat16)
    got = scatter.scatter_add(idx, vals, spec.grid.total_params, 64)
    ref = scatter.scatter_add_reference(idx, vals, spec.grid.total_params)
    scale = scatter.scatter_add_reference(idx, vals.abs(), spec.grid.total_params)
    torch.cuda.synchronize()
    scatter.check_refused()
    assert float(m.mask.float().mean()) > 0.05
    assert _within(got, ref, scale, 1e-5)


PAL_KW = dict(bound=1.0, log2_hashmap_size=14, grid_levels=8)


def _palette_setup():
    """A small palette field with lively tables, a color on the clamp's bound and hist
    weights; rays, pixels and every draw of one step. All on the CPU, from one seed."""
    cfg = Config(O=True, fp16=True, grid_size=32, num_rays=512, max_steps=256,
                 train_samples_per_ray=32, iters=100, use_initialization_from_rgbxy=True,
                 **PAL_KW)
    spec = PaletteSpec.build(num_basis=4, fp16=True, **PAL_KW)
    gen = torch.Generator().manual_seed(2)
    params = init_palette(spec, gen)
    for name in ("encoder", "encoder_palette"):
        params[name].uniform_(-4, 4, generator=gen)
    params["sigma_net"][-1][:, 0] *= 8.0
    params["omega_net"] = init_mlp([spec.geo_feat_dim, 4], gen)
    params["omega_net"][0] *= 8.0
    params["basis_color"] = torch.tensor([[1.0, 0.2, 0.1], [0.1, 0.8, 0.3], [0.2, 0.3, 0.9],
                                          [0.8, 0.8, 0.2]])
    params["basis_color_origin"] = params["basis_color"] - 0.01
    hist = torch.rand((32, 32, 32, 4), generator=gen)
    params["hist_weights"] = hist / hist.sum(-1, keepdim=True)
    n, S = cfg.num_rays, cfg.train_samples_per_ray
    o = torch.randn((n, 3), generator=gen)
    o = o / o.norm(dim=-1, keepdim=True) * 2.0
    d = -o + 0.5 * torch.randn((n, 3), generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    draws = [torch.rand(shape, generator=gen) for shape in ((n, 4), (n, 3), (n,), (n * S, 3))]
    return cfg, spec, params, (o, d, *draws)


def _palette_trainer(cfg, spec, params, dev, tmp_path, smooth=True):
    tr = PaletteTrainer("t", cfg, spec, params=params, workspace=str(tmp_path),
                        use_checkpoint="scratch", mute=True, device=dev)
    tr.grid_state = tr.grid_state._replace(bitfield=torch.full_like(tr.grid_state.bitfield, 255))
    tr.freeze_basis_color, tr.require_smooth_loss = False, smooth
    tr.lambda_palette = cfg.lambda_palette
    return tr


def _palette_step(tr, batch):
    o, d, img, bg, noise, jit_u = (t.to(tr.device) for t in batch)
    return tr.train_step(o, d, img, bg=bg, noise=noise, jit_u=jit_u)


def test_palette_train_step_on_card_matches_cpu(cuda_device, tmp_path):
    """Smooth loss on, colors unfrozen, hist weights present: loss and every gradient;
    the scatter kernel once per ``encoder_palette`` backward and never for ``encoder``."""
    cfg, spec, params, batch = _palette_setup()
    out = []
    for dev in ("cpu", cuda_device):
        tr = _palette_trainer(cfg, spec, params, dev, tmp_path)
        before = scatter.scatter_add.launches
        loss, _ = _palette_step(tr, batch)
        launched = scatter.scatter_add.launches - before
        fixed = param_leaves({k: tr.params[k] for k in ("encoder", "sigma_net")})
        assert all(p.grad is None for p in fixed)
        moving = param_leaves(tr.params, skip=("encoder", "sigma_net", "encoder_clip") + FROZEN)
        out.append((float(loss), [p.grad.cpu() for p in moving], launched))
    (loss_c, g_c, n_c), (loss_g, g_g, n_g) = out
    assert (n_c, n_g) == (0, 2)   # the samples and their jittered copies
    assert loss_g == pytest.approx(loss_c, rel=1e-5)
    for a, b in zip(g_c, g_g):
        assert float(a.abs().max()) > 0
        assert float((a - b).abs().max()) <= 1e-2 * float(a.abs().max())
    torch.cuda.synchronize()
    scatter.check_refused()


def test_palette_train_step_launches_one_scatter_without_smooth_loss(cuda_device, tmp_path):
    cfg, spec, params, batch = _palette_setup()
    tr = _palette_trainer(cfg, spec, params, cuda_device, tmp_path, smooth=False)
    before = scatter.scatter_add.launches
    _palette_step(tr, batch)
    assert scatter.scatter_add.launches == before + 1


def test_palette_train_step_makes_no_host_sync(cuda_device, tmp_path):
    """After a first step (kernel build, allocator, cached constants) and the capture of
    the step's graph, a palette train step with every draw made on the device reads nothing
    back, replayed or (the first step of another kind of step) eager: PyTorch's sync debug
    mode turns any synchronising call into an error. The epoch's loss read is outside."""
    cfg, spec, params, batch = _palette_setup()
    tr = _palette_trainer(cfg, spec, params, cuda_device, tmp_path)
    o, d, img = (t.to(cuda_device) for t in batch[:3])
    for _ in range(2):  # the eager warm-up, then the capture
        tr.train_step(o, d, img)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replayed, _ = tr.train_step(o, d, img)
        tr.require_smooth_loss = False
        eager, _ = tr.train_step(o, d, img)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(replayed)) and bool(torch.isfinite(eager))
    scatter.check_refused()


@pytest.mark.parametrize("rows", [1, 8, 32])
@pytest.mark.parametrize("m8", [1, 3, 100, 65536])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_gather_kernel_is_bit_exact(cuda_device, rows, m8, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(rows + m8)
    W = torch.randn((rows, 128), generator=gen, device=cuda_device).to(dtype)
    r = torch.randint(0, rows, (m8, 128), generator=gen, device=cuda_device, dtype=torch.int32)
    c = torch.randint(0, 128, (m8, 128), generator=gen, device=cuda_device, dtype=torch.int32)
    before = window_gather.window_gather.launches
    got = window_gather.window_gather(W, r, c)
    assert window_gather.window_gather.launches == before + 1
    ref = window_gather.window_gather_reference(W, r, c)
    torch.cuda.synchronize()
    window_gather.check_refused()
    assert got.dtype == dtype and torch.equal(got, ref)


def test_window_gather_kernel_rejects_what_it_does_not_take(cuda_device):
    W = torch.zeros((8, 128), device=cuda_device)
    r = torch.zeros((4, 128), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        window_gather.window_gather(W.double(), r, r)
    with pytest.raises(ValueError):
        window_gather.window_gather(W.cpu(), r, r)  # mixed devices
    with pytest.raises(ValueError):
        window_gather.window_gather(W.t().contiguous().t(), r, r.t().contiguous().t())
    flat = torch.zeros(4 * 128 + 1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        window_gather.window_gather(W, flat[1:].view(4, 128), r)  # 4 bytes off a 16-byte line


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_gather_kernel_refuses_indices_out_of_range(cuda_device, dtype):
    """An index outside the window is never used as an address: its output is zero
    bits, every other output is right, and the next check_refused() raises, once."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    W = (torch.rand((8, 128), generator=gen, device=cuda_device) + 1.0).to(dtype)
    r = torch.randint(0, 8, (5, 128), generator=gen, device=cuda_device, dtype=torch.int32)
    c = torch.randint(0, 128, (5, 128), generator=gen, device=cuda_device, dtype=torch.int32)
    want = window_gather.window_gather_reference(W, r, c)
    r[0, 1], r[4, 127], c[2, 64], c[3, 3] = 8, -1, 128, -5
    for i, j in ((0, 1), (4, 127), (2, 64), (3, 3)):
        want[i, j] = 0
    got = window_gather.window_gather(W, r, c)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="4 indices outside"):
        window_gather.check_refused()
    window_gather.check_refused()
