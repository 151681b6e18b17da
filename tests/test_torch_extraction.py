"""Port parity of the palette extraction and the palette dataset: the port's own copies
(``palettenerf_torch.extraction``, NumPy + SciPy, no scikit-learn, no PIL, no cv2)
against ``palettenerf_tpu.extraction`` on the same arrays; and the port's three CLIs in
one chain on the CPU (nerf -> extract -> palette -> ``--test`` -> serve).

Tolerances: the copies are the same NumPy code, so results are equal or within 1e-10
(the JAX package may take its C++ fast path for the histogram and the triangle
distances). The port's weighted Lloyd iteration follows scikit-learn's float32
arithmetic (on the histogram's lattice of bin centers exact ties are common, and the
rounding decides them): labels equal, centers within 1e-5 (the order of an f32 sum).
The palette goes through the hull's linear programs after that: 1e-4.
"""

import json
import os

import numpy as np
import pytest
import torch

from palettenerf_tpu.config import Config as JConfig
from palettenerf_tpu.data.palette_provider import PaletteDataset as JPaletteDataset
from palettenerf_tpu.extraction import extract as jextract
from palettenerf_tpu.extraction import geometry as jgeom
from palettenerf_tpu.extraction import histogram as jhist
from palettenerf_tpu.extraction import hull as jhull
from palettenerf_tpu.extraction import tan18 as jtan
from palettenerf_tpu.models import palette as jpal
from palettenerf_torch import main_nerf, main_palette, main_serve
from palettenerf_torch.config import Config as TConfig
from palettenerf_torch.data.palette_provider import PaletteDataset as TPaletteDataset
from palettenerf_torch.data.palette_provider import bilinear_resize
from palettenerf_torch.data.png import read_png
from palettenerf_torch.extraction import extract as textract
from palettenerf_torch.extraction import geometry as tgeom
from palettenerf_torch.extraction import histogram as thist
from palettenerf_torch.extraction import hull as thull
from palettenerf_torch.extraction import tan18 as ttan
from palettenerf_torch.models import palette as tpal
from palettenerf_torch.train import checkpoint as tckpt
from palettenerf_torch.utils.mcubes import read_ply
from synthetic import make_sphere_dataset
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(REPO, "deploy", "proc_toys")


def T(a):
    return torch.from_numpy(np.array(a))


def _colors(n=20000, seed=0):
    """Colors around six pigments and their mixtures, as a scene's foreground gives."""
    rng = np.random.default_rng(seed)
    pigments = np.array([[0.9, 0.1, 0.1], [0.1, 0.8, 0.2], [0.15, 0.2, 0.9], [0.95, 0.9, 0.2],
                         [0.05, 0.05, 0.05], [0.9, 0.9, 0.9]])
    w = rng.dirichlet(np.full(6, 0.3), n)
    return np.clip(w @ pigments + rng.normal(scale=0.01, size=(n, 3)), 0, 1).astype(np.float32)


@pytest.mark.parametrize("bits", [3, 5])
def test_histogram_matches(bits):
    colors = _colors()
    w = np.random.default_rng(1).uniform(0, 2, len(colors)).astype(np.float32)
    got_w, got_c = thist.compute_rgb_histogram(colors, w, bits)
    ref_w, ref_c = jhist.compute_rgb_histogram(colors, w, bits)
    assert got_w.shape == ((1 << bits) ** 3,)
    np.testing.assert_allclose(got_w, ref_w, rtol=0, atol=1e-10 * w.sum())
    np.testing.assert_array_equal(got_c, ref_c)


def test_point_triangle_distance_and_hull_projection_match():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(200, 3))
    tris = rng.normal(size=(7, 3, 3))
    got = tgeom.point_triangle_distance(pts[:, None], tris[None])
    ref = jgeom.point_triangle_distance(pts[:, None], tris[None])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    from scipy.spatial import ConvexHull
    hull = ConvexHull(rng.uniform(size=(30, 3)))
    got = tgeom.closest_point_on_hull(pts, hull.points, hull.simplices)
    ref = jgeom.closest_point_on_hull(pts, hull.points, hull.simplices)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-10)


def _centers(seed=3, n=40):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.05, 0.95, (n, 3)), rng.uniform(0.5, 2.0, n)


@pytest.mark.parametrize("target", [None, 5])
def test_hull_simplification_matches(target):
    pts, counts = _centers()
    got = thull.hull_simplification(pts, counts, error_thres=5 / 255, target_size=target)
    ref = jhull.hull_simplification(pts, counts, error_thres=5 / 255, target_size=target)
    assert 4 <= len(got) <= 10 and (target is None or len(got) == target)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    assert thull.outside_hull_rmse(got, pts, counts) == pytest.approx(
        jhull.outside_hull_rmse(ref, pts, counts), abs=1e-10)


def test_star_tetra_weights_match():
    pts, _ = _centers(4, 500)
    palette = np.array([[0.02, 0.03, 0.02], [0.95, 0.1, 0.1], [0.1, 0.9, 0.15], [0.1, 0.15, 0.95],
                        [0.97, 0.96, 0.9]])
    got = ttan.star_tetra_weights(pts * 1.2 - 0.1, palette)      # some points outside the hull
    ref = jtan.star_tetra_weights(pts * 1.2 - 0.1, palette)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-9)
    assert got.min() > -1e-9


def test_weighted_lloyd_matches_scikit_learn():
    cluster = pytest.importorskip("sklearn.cluster")
    rng = np.random.default_rng(5)
    x = _colors(3000, seed=5)
    w = rng.uniform(0.1, 3.0, len(x))
    init = x[rng.choice(len(x), 7, replace=False)]
    km = cluster.KMeans(n_clusters=7, init=init, n_init=1).fit(x, sample_weight=w)
    centers, labels = textract.weighted_lloyd(x, init, w)
    np.testing.assert_allclose(centers, km.cluster_centers_, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(labels, km.labels_)
    # the sorted form the extraction uses, against the JAX package's run_kmeans
    got_c, got_w = textract.run_kmeans(7, x, init, w)
    ref_c, ref_w = jextract.run_kmeans(7, x, init, w)
    np.testing.assert_allclose(got_c, ref_c, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_w, ref_w, rtol=1e-9)
    assert (np.diff(got_w) <= 0).all()


def test_weighted_lloyd_survives_an_empty_cluster():
    """A center no point is nearest to takes the point farthest from its own center."""
    x = np.array([[0.0, 0, 0], [0.1, 0, 0], [1.0, 0, 0], [1.1, 0, 0], [5.0, 0, 0]])
    init = np.array([[0.05, 0, 0], [1.05, 0, 0], [-50.0, 0, 0]])
    init[2] = [0.05, 0.0, 1e-3]   # loses every point to center 0 by a hair
    centers, labels = textract.weighted_lloyd(x, init, np.ones(5))
    assert np.isfinite(centers).all() and len(np.unique(labels)) == 3
    assert sorted(np.round(centers[:, 0], 3)) == [0.05, 1.05, 5.0]


@pytest.mark.parametrize("normalize", [False, True], ids=["plain", "normalized"])
def test_palette_extraction_end_to_end_matches(tmp_path, normalize):
    pytest.importorskip("sklearn")   # the JAX package's k-means
    colors = _colors(30000, seed=6)
    if normalize:
        colors = colors + 0.05
        colors = colors / np.linalg.norm(colors, axis=-1, keepdims=True)
    got = textract.palette_extraction({"colors": colors}, str(tmp_path / "t"),
                                      normalize_input=normalize)
    ref = jextract.palette_extraction({"colors": colors}, str(tmp_path / "j"),
                                      normalize_input=normalize)
    assert got[0].shape == ref[0].shape and 4 <= len(got[0]) <= 8
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-2)   # weights follow the palette
    assert got[1].shape == (32, 32, 32, len(got[0]))
    np.testing.assert_allclose(got[1].sum(-1), 1.0, atol=1e-6)
    saved = np.load(tmp_path / "t" / "palette.npz")["palette"]
    np.testing.assert_array_equal(saved, got[0])
    np.testing.assert_array_equal(np.load(tmp_path / "t" / "hist_weights.npz")["hist_weights"],
                                  got[1])
    # the swatch strip, written without PIL: one 50-pixel cell per color
    strip = read_png(str(tmp_path / "t" / "extract-palette.png"))
    assert strip.shape == (50, 50 * len(saved), 3)
    np.testing.assert_array_equal(strip[25, 25::50], (saved * 255).round().astype(np.uint8))
    with open(tmp_path / "t" / "extract-palette.txt") as f, \
            open(tmp_path / "j" / "extract-palette.txt") as g:
        assert len(f.read().splitlines()) == len(g.read().splitlines()) == len(saved)


def test_deploy_palette_round_trips_through_initialize_palette():
    """The committed extraction of proc_toys (f64 files) becomes the same f32 palette
    state in both packages, and the lookup at a palette color gives that color's weights."""
    import jax

    palette = np.load(os.path.join(DEPLOY, "palette.npz"))["palette"]
    hist = np.load(os.path.join(DEPLOY, "hist_weights.npz"))["hist_weights"]
    P = len(palette)
    kw = dict(bound=1.0, num_basis=P, log2_hashmap_size=8, grid_levels=2)
    jspec, tspec = jpal.PaletteSpec.build(**kw), tpal.PaletteSpec.build(**kw)
    got = tpal.initialize_palette(tpal.init_palette(tspec, torch.Generator().manual_seed(0)),
                                  tspec, palette, hist)
    ref = jpal.initialize_palette(jpal.init_palette(jax.random.PRNGKey(0), jspec), jspec,
                                  palette, hist)
    for k in ("basis_color", "basis_color_origin", "hist_weights"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert got["hist_weights"].shape == (32, 32, 32, P) and float(got["basis_color"].max()) == 1.0
    rgb = np.random.default_rng(0).uniform(size=(500, 3)).astype(np.float32)
    w_t = tpal.get_palette_weight_with_hist(torch.from_numpy(rgb), got["hist_weights"])
    w_j = jpal.get_palette_weight_with_hist(rgb, ref["hist_weights"])
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(w_t.sum(-1).numpy(), 1.0, atol=1e-5)


# --------------------------------------------------------------------------- dataset

def test_bilinear_resize_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    for (h, w, H, W) in [(12, 16, 32, 32), (40, 30, 16, 20), (7, 9, 7, 9)]:
        a = rng.normal(size=(h, w, 5)).astype(np.float32)
        ref = cv2.resize(a, (W, H), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(bilinear_resize(a, H, W), ref, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def clip_scene(tmp_path_factory):
    """The sphere scene with made-up LSeg feature dumps (half resolution, 6 channels)
    and a pose-only video split."""
    root = make_sphere_dataset(str(tmp_path_factory.mktemp("clip_scene")), n_train=3, n_val=1,
                               n_test=1, H=16, W=16)
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "lseg_feature"))
    for k in range(3):
        np.save(os.path.join(root, "lseg_feature", f"train_{k:03d}.npy"),
                rng.normal(size=(8, 8, 6)).astype(np.float32))
    with open(os.path.join(root, "transforms_train.json")) as f:
        tr = json.load(f)
    video = dict(tr, frames=[dict(fr, file_path=f"video/none_{i}")
                             for i, fr in enumerate(tr["frames"])])
    with open(os.path.join(root, "transforms_video.json"), "w") as f:
        json.dump(video, f)
    return root


@pytest.mark.parametrize("split", ["train", "traintest", "video", "val"])
def test_palette_dataset_matches(clip_scene, split):
    kw = dict(path=clip_scene, bound=1.0, scale=0.5, pred_clip=True, clip_dim=6, num_rays=64,
              H=16, W=16)
    jds = JPaletteDataset(JConfig(**kw), type=split)
    tds = TPaletteDataset(TConfig(**kw), type=split)
    np.testing.assert_array_equal(tds.poses, jds.poses)
    assert (tds.H, tds.W, len(tds)) == (jds.H, jds.W, len(jds)) == (16, 16, len(jds))
    assert (tds.images is None) == (jds.images is None) == (split == "video")
    assert (tds.feat_images is None) == (jds.feat_images is None) == (split in ("video", "val"))
    if tds.feat_images is not None:
        assert tds.feat_images.shape == (3, 16, 16, 6)
        np.testing.assert_allclose(tds.feat_images, jds.feat_images, rtol=0, atol=1e-5)
    jb, tb = jds.collate(0), tds.collate(0)
    assert set(tb) == set(jb)
    if split == "train":
        # each package samples its own pixels; the features follow the sample
        assert tb["feat_images"].shape == (64, 6) == jb["feat_images"].shape
        np.testing.assert_array_equal(tb["feat_images"],
                                      tds.feat_images[0].reshape(-1, 6)[tb["inds"]])
        return
    for k in tb:
        np.testing.assert_allclose(np.asarray(tb[k], np.float64), np.asarray(jb[k], np.float64),
                                   rtol=0, atol=1e-5, err_msg=k)
    if split == "traintest":
        assert tb["feat_images"].shape == (16, 16, 6) and tb["rays_o"].shape == (256, 3)


# --------------------------------------------------------------------------- the CLI

COMMON = ["-O", "--bound", "1", "--scale", "0.7", "--dt_gamma", "0", "--min_near", "0.05",
          "--num_rays", "512", "--max_steps", "96", "--train_samples_per_ray", "32",
          "--infer_samples_per_ray", "64", "--log2_hashmap_size", "12", "--grid_levels", "6"]


def test_main_palette_end_to_end_on_cpu(tmp_path, monkeypatch):
    """nerf (96 steps) -> extract -> 3 palette epochs (one per schedule phase) -> --test
    -> serve, through the CLIs on the sphere scene."""
    monkeypatch.chdir(tmp_path)
    scene = make_sphere_dataset(str(tmp_path / "scene"), n_train=8, n_val=1, n_test=2, H=32, W=32)
    nerf = main_nerf.main([scene] + COMMON + ["--iters", "96", "--eval_interval", "100",
                                              "--workspace", "sphere", "--lambda_sparse", "0"],
                          device="cpu", mesh_resolution=40)
    # the CLI's tail, the mesh at density 10 (this short run may stay below it), parses;
    # at half the field's peak the mesh is the sphere (radius 0.5 x scale 0.7)
    mesh = tmp_path / "results" / "sphere" / "version_1" / "meshes" / f"ngp_{nerf.epoch}.ply"
    verts, faces = read_ply(mesh)
    assert np.abs(verts).max(initial=0.0) <= 1.0 and faces.max(initial=-1) < len(verts)
    peak = float(nerf.density_lattice(40).max())
    verts, faces = read_ply(nerf.save_mesh(resolution=40, threshold=peak / 2))
    assert len(faces) > 100 and faces.min() >= 0 and faces.max() < len(verts)
    assert np.abs(verts).max() <= 1.0
    radius = np.linalg.norm(verts, axis=-1)
    assert 0.2 < np.median(radius) < 0.5, (peak, np.median(radius))
    pal = ["--use_normalized_palette"]
    ex = main_palette.main([scene, "results/sphere"] + COMMON + pal + ["--extract_palette"],
                           device="cpu")
    pal_ws = tmp_path / "results_palette" / "sphere" / "normalized_version_1"
    assert ex.workspace == os.path.join("results_palette", "sphere", "normalized_version_1")
    assert ex.extract_stats["foreground_samples"] > 500
    palette = np.load(pal_ws / "palette.npz")["palette"]
    hist = np.load(pal_ws / "hist_weights.npz")["hist_weights"]
    P = len(palette)
    assert 4 <= P <= 8 and hist.shape == (32, 32, 32, P)
    np.testing.assert_allclose(hist.sum(-1), 1.0, atol=1e-6)
    assert (pal_ws / "extract-palette.png").exists()

    train = pal + ["--use_initialization_from_rgbxy", "--iters", "24",
                   "--smooth_loss_start_epoch", "1", "--max_freeze_palette_epoch", "2",
                   "--eval_interval", "3"]
    tr = main_palette.main([scene, "results/sphere"] + COMMON + train, device="cpu")
    ws = tmp_path / "results_palette" / "sphere" / "version_1"
    assert (tr.epoch, tr.global_step, tr.palette_spec.num_basis) == (3, 24, P)
    assert (tr.freeze_basis_color, tr.require_smooth_loss) == (False, True)
    assert tr.stats["loss"][2] < tr.stats["loss"][0]
    ep2 = tckpt.load_checkpoint(str(ws / "checkpoints" / "palette_ep0002.ckpt"))["params"]
    assert torch.equal(ep2["basis_color"], T(palette.astype(np.float32)))
    assert not torch.equal(tr.params["basis_color"].detach(), ep2["basis_color"])
    assert torch.equal(tr.params["basis_color_origin"], ep2["basis_color"])
    stage1 = tckpt.load_checkpoint(tckpt.latest_checkpoint(
        "results/sphere/version_1/checkpoints", "ngp"))
    assert torch.equal(tr.params["encoder"], stage1["params"]["encoder"])
    assert torch.equal(tr.grid_state.bitfield, stage1["grid_state"]["bitfield"])
    assert (ws / "validation" / "palette_ep0003_0000_basis00_rgb.png").exists()
    assert (ws / "results" / f"palette_ep0003_0001_basis{P - 1:02d}.png").exists()

    te = main_palette.main([scene, "results/sphere"] + COMMON + pal + [
        "--use_initialization_from_rgbxy", "--test"], device="cpu")
    assert te.epoch == 3 and [m.name for m in te.metrics] == [
        "PSNR", "SSIM", "LPIPS (alex)", "rLPIPS", "TV", "Sparsity"]
    assert te.stats["results"][-1] == pytest.approx(tr.stats["results"][-1], abs=1e-4)
    assert not (tmp_path / "results_palette" / "sphere" / "version_2").exists()
    # --gui reaches the DearPyGui front-end, which needs the dearpygui package
    with pytest.raises(ImportError, match=r"palettenerf_torch\.gui\.EditingSession"):
        main_palette.main([scene, "results/sphere"] + COMMON + pal + ["--test", "--gui"],
                          device="cpu")

    r = main_serve.main([str(ws), "--resolution", "32", "--W", "64", "--H", "64", "--u_res",
                         "96", "--n_frames", "2", "--grid_levels", "6", "--log2_hashmap_size",
                         "12", "--out", str(tmp_path / "frame.png")], device="cpu")
    assert r.frames[0].shape == (64, 64, 3) and np.isfinite(r.frames[0]).all()
    assert r.sv.num_basis == P
