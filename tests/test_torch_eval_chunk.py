"""The eval frame's last chunk, as the JAX package renders it (ROADMAP C21).

JAX's ``Trainer.render_image`` (``palettenerf_tpu/train/trainer.py:496-527``) renders a
frame in chunks of ``chunk`` rays and pads the short last chunk with copies of its last
ray, so that the eval rounds' selections (the top 1/4 and 1/16 of the chunk's rays by
transmittance), the compact budgets of ``--eval_compact_frac`` and the dropped-sample
count are the padded chunk's, and a last chunk of fewer than 64 rays still takes the
rounds. ``scripts/serve_vs_gt.py``'s exact path pads the same way. The port counts the
copies without rendering them (``render_nerf_eval(..., pad_to=)``).

Here both packages' ``render_image`` render frames of three chunks of 256 rays and a last
chunk of 40 (under the rounds' 64-ray floor) or 100 rays, on the same state: the stage-1
trainer (rounds of 16 + 16 + 32 samples) and the palette trainer (one pass), without a
budget and with ``--eval_compact_frac`` 0.1 (the budget drops samples in every chunk,
copies' included), the last ray once through the occupied sphere and once past it (its
copies then sort last). Held: every output within 2e-5 of JAX's (f32 sums in another
order, the ``ATOL`` of ``tests/test_torch_palette_train.py``), the frame's dropped samples
equal. ``serve_vs_gt``'s exact path, in chunks of 300 rays over 32x32 test views, against
the JAX pipeline of ``scripts/serve_vs_gt.py`` with the same chunks, likewise.

And, without JAX, the counted copies against copies the port renders: a batch padded with
real copies of its last ray and the same batch with ``pad_to``, over chunk sizes of 64-256,
every tail, budgets from none to 2% of the slots and the last ray through or past the
occupied sphere. The rounds then leave the copies in up to six groups of different
transmittance, and budgets cut through a copy. Held: the real rays' outputs bit for bit,
the dropped samples equal (the same arithmetic on the same values, row for row).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.config import Config as JConfig
from palettenerf_tpu.models import nerf as jnerf
from palettenerf_tpu.train.palette_trainer import PaletteTrainer as JPaletteTrainer
from palettenerf_tpu.train.trainer import Trainer as JTrainer
from palettenerf_torch.config import Config as TConfig
from palettenerf_torch.models import nerf as tnerf
from palettenerf_torch.render import nerf_renderer as trender
from palettenerf_torch.render import palette_renderer as tpr
from palettenerf_torch.train import checkpoint as tckpt
from palettenerf_torch.train.palette_trainer import PaletteTrainer as TPaletteTrainer
from palettenerf_torch.train.trainer import Trainer as TTrainer
from test_torch_palette_train import _model, _scene
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
ATOL = 2e-5
CHUNK = 256
TAILS = (40, 100)
FRACS = (0.0, 0.1)
CFG = dict(bound=1.0, grid_size=16, max_steps=128, infer_samples_per_ray=64, seed=0,
           log2_hashmap_size=12, grid_levels=4, dt_gamma=0.0, min_near=0.05)
NERF_KW = dict(bound=1.0, log2_hashmap_size=12, grid_levels=4, hidden_dim=16,
               hidden_dim_color=16)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=[(m, f) for m in ("nerf", "palette") for f in FRACS],
                ids=lambda p: f"{p[0]}-frac{p[1]}")
def pair(request, tmp_path_factory):
    """Both packages' trainer of one model on the same weights and bitfield, with
    ``--eval_compact_frac``; the JAX trainer's log kept for its overflow warnings."""
    model, frac = request.param
    tmp = tmp_path_factory.mktemp(f"eval_chunk_{model}")
    cfg = dict(CFG, eval_compact_frac=frac)
    _, _, bits = _scene(8)
    if model == "nerf":
        jspec, tspec = jnerf.NeRFSpec.build(**NERF_KW), tnerf.NeRFSpec.build(**NERF_KW)
        jparams = jnerf.init_nerf(jax.random.PRNGKey(1), jspec)
        jparams["encoder"] = jnp.asarray(np.random.default_rng(1).uniform(
            -1, 1, jparams["encoder"].shape).astype(np.float32))
        tparams = tckpt.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
        jtr = JTrainer("ngp", JConfig(**cfg), jspec, params=jparams,
                       workspace=str(tmp / "jax"), use_checkpoint="scratch", mute=True)
        ttr = TTrainer("ngp", TConfig(**cfg), tspec, params=tparams,
                       workspace=str(tmp / "torch"), use_checkpoint="scratch", mute=True,
                       device="cpu")
        assert ttr.eval_settings.compaction_rounds == ((1, 16), (4, 16), (16, 32))
    else:
        jspec, tspec, jparams, tparams = _model()
        cfg["use_initialization_from_rgbxy"] = True
        jtr = JPaletteTrainer("palette", JConfig(**cfg), jspec, params=jparams,
                              workspace=str(tmp / "jax"), use_checkpoint="scratch", mute=True)
        ttr = TPaletteTrainer("palette", TConfig(**cfg), tspec, params=tparams,
                              workspace=str(tmp / "torch"), use_checkpoint="scratch",
                              mute=True, device="cpu")
    jtr.grid_state = jtr.grid_state._replace(bitfield=jnp.asarray(bits))
    ttr.grid_state = ttr.grid_state._replace(bitfield=T(bits))
    log = []
    jtr.log = lambda *a: log.append(" ".join(str(x) for x in a))
    return model, frac, jtr, ttr, log


def _frame(tail: int, last: str):
    """Rays of a frame of three full chunks and ``tail`` more, the last ray through the
    sphere's centre ("hit") or past the sphere ("miss")."""
    o, d, _ = _scene(3 * CHUNK + tail, seed=3)
    if last == "hit":
        d[-1] = -o[-1] / np.linalg.norm(o[-1])
    else:
        side = np.cross(o[-1], [0.0, 0.0, 1.0])
        d[-1] = side / np.linalg.norm(side)
    return o, d.astype(np.float32)


def _jax_dropped(log) -> int:
    """The dropped samples of the JAX frame, from its warning (none logged: 0)."""
    said = [m for m in log if "compact budget overflow" in m]
    return int(said[-1].split("overflow: ")[1].split()[0]) if said else 0


@pytest.mark.parametrize("last", ["hit", "miss"])
@pytest.mark.parametrize("tail", TAILS)
def test_short_last_chunk_matches_jax(pair, tail, last):
    model, frac, jtr, ttr, log = pair
    o, d = _frame(tail, last)
    log.clear()
    ref = jtr.render_image(o, d, chunk=CHUNK)
    got = ttr.render_image(o, d, chunk=CHUNK)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=ATOL, err_msg=k)
    if frac > 0:
        dropped = _jax_dropped(log)
        assert dropped > 0  # the budget binds, so the copies' samples are counted
        assert ttr.last_compact_overflow == dropped
    # the last ray keeps its own value, not the copies' (the frame has no padding rows)
    assert got["image"].shape[0] == 3 * CHUNK + tail


def test_serve_vs_gt_exact_path_pads_its_last_chunk(tmp_path):
    """``serve_vs_gt``'s exact frames in chunks of 300 rays (three full chunks and 124
    rays per 32x32 view) equal the JAX pipeline's with the same padded chunks
    (``scripts/serve_vs_gt.py:59-68``), and its ``exact_dropped`` is JAX's overflow over
    the padded chunks, on ``tests/test_torch_serve_vs_gt.py``'s checkpoint."""
    from palettenerf_tpu.data.provider import NeRFDataset as JDataset
    from palettenerf_tpu.models import palette as jpal
    from palettenerf_tpu.render import nerf_renderer as jrender
    from palettenerf_tpu.render import palette_renderer as jpr
    from palettenerf_torch import serve_vs_gt as svg
    from synthetic import make_sphere_dataset
    from test_torch_serve_vs_gt import BC, G, HW, SMALL

    scene = make_sphere_dataset(str(tmp_path / "scene"), n_train=2, n_val=1, n_test=2,
                                H=HW, W=HW)
    spec = jpal.PaletteSpec.build(**SMALL)
    params = jpal.initialize_palette(jpal.init_palette(jax.random.PRNGKey(0), spec), spec,
                                     color_list=BC)
    rng = np.random.default_rng(0)
    for name in ("encoder", "encoder_palette"):
        params[name] = jnp.asarray(rng.uniform(-2, 2, params[name].shape).astype(np.float32))
    params = jax.tree_util.tree_map(np.asarray, params)
    occ = rng.random(G ** 3) < 0.6
    gs = {"density_grid": np.where(occ, 20.0, 0.0).astype(np.float32)[None],
          "bitfield": np.packbits(occ, bitorder="little")}
    ws = str(tmp_path / "ws")
    tckpt.save_reference_checkpoint(
        f"{ws}/checkpoints/palette_ep0001.ckpt", tckpt.palette_params_from_jax(params),
        grid_state={k: torch.from_numpy(v) for k, v in gs.items()})
    chunk = 300
    got = svg.serve_vs_gt(ws, scene, device="cpu", resolution=16, grid_levels=4,
                          log2_hashmap_size=13, verbose=False, chunk=chunk)

    eset = jrender.RenderSettings(bound=1.0, cascade=1, grid_size=G, dt_gamma=0.0,
                                  max_steps=512, num_samples=192, t_thresh=1e-2,
                                  min_near=0.05, march_groups=48, compact_frac=0.375)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    bitfield = jnp.asarray(gs["bitfield"][: G ** 3 // 8])
    exact = jax.jit(lambda ro, rd: jpr.render_palette_eval(
        jp, spec, bitfield, ro, rd, eset, bg_color=jnp.ones(3), gui_mode=True))
    ds = JDataset(JConfig(path=scene, bound=1.0, scale=0.8, dt_gamma=0.0, min_near=0.05,
                          bg_radius=0, fp16=True), type="test")
    for i, data in enumerate(ds.iter_epoch()):
        ro, rd = data["rays_o"].reshape(-1, 3), data["rays_d"].reshape(-1, 3)
        frame, dropped = [], 0
        for s in range(0, ro.shape[0], chunk):
            r1, r2 = ro[s:s + chunk], rd[s:s + chunk]
            pad = chunk - r1.shape[0]
            if pad:
                r1 = np.concatenate([r1, np.tile(r1[-1:], (pad, 1))])
                r2 = np.concatenate([r2, np.tile(r2[-1:], (pad, 1))])
            out = exact(jnp.asarray(r1), jnp.asarray(r2))
            frame.append(np.asarray(out["image"])[: chunk - pad])
            dropped += int(np.asarray(out["compact_overflow"])[0])
        ref = np.concatenate(frame).reshape(data["H"], data["W"], 3)
        np.testing.assert_allclose(got.exact_frames[i], ref, rtol=0, atol=ATOL)
        assert got.exact_dropped[i] == dropped
    assert len(got.exact_frames) == 2 and sum(got.exact_dropped) > 0


@pytest.mark.parametrize("seed", range(12))
def test_counted_copies_equal_rendered_copies(seed):
    rng = np.random.default_rng(seed)
    chunk = int(rng.choice([64, 128, 256]))
    n = int(rng.integers(1, chunk))
    frac = float(rng.choice([0.0, 0.02, 0.05, 0.1, 0.3]))
    o, d, bits = _scene(n, seed=seed)
    if seed % 2:
        d[-1] = -o[-1] / np.linalg.norm(o[-1])
    rounds = ((1, 16), (4, 16), (16, 32))
    _, tspec, _, tparams = _model(seed=seed % 3)
    nspec = tnerf.NeRFSpec.build(**NERF_KW)
    nparams = {k: tparams[k] for k in ("encoder", "sigma_net", "color_net")}
    ro, rd, bits = T(o), T(d), T(bits)
    pro = torch.cat([ro, ro[-1:].expand(chunk - n, 3)])
    prd = torch.cat([rd, rd[-1:].expand(chunk - n, 3)])
    renders = [
        lambda o_, d_, **kw: trender.render_nerf_eval(
            nparams, nspec, bits, o_, d_, trender.RenderSettings(
                grid_size=16, max_steps=128, num_samples=64, min_near=0.05,
                compaction_rounds=rounds, compact_frac=frac), **kw),
        lambda o_, d_, **kw: tpr.render_palette_eval(
            tparams, tspec, bits, o_, d_, tpr.RenderSettings(
                grid_size=16, max_steps=128, num_samples=32, min_near=0.05,
                compact_frac=frac), **kw)]
    for render in renders:
        ref = render(pro, prd)
        got = render(ro, rd, pad_to=chunk)
        assert set(got) == set(ref)
        for k in got:
            if k == "compact_overflow":
                assert int(got[k][0]) == int(ref[k][0])
            else:
                torch.testing.assert_close(got[k], ref[k][:n], rtol=0, atol=0)
