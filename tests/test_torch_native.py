"""The port's native extraction kernels (``palettenerf_torch/native``, built with g++)
against their NumPy versions in the port and against the JAX package's native kernels,
on seeded inputs.

Tolerances: the histogram is the same loop over the same float32 bin arithmetic in every
version, summed in input order in float64, so its bin weights are equal bit for bit. The
point-triangle distances take the same region decomposition in another order of
operations: within 1e-10 (as ``tests/test_native.py``). The closest points agree to the
same bound wherever the nearest point is unique (every point outside a convex hull); a
point inside the hull may be equally near to two faces, and there the two versions may
name different points at the same distance. End to end, the extraction with the native
kernels equals the port's NumPy extraction (palette bit for bit, weights within 1e-10),
and the JAX package's within the tolerances of ``tests/test_torch_extraction.py`` (its
k-means is scikit-learn's, the port's its own f32 Lloyd iteration: palette 1e-4).
"""

import os

import numpy as np
import pytest
import torch

from palettenerf_tpu import native as jnative
from palettenerf_tpu.extraction import extract as jextract
from palettenerf_torch import native as tnative
from palettenerf_torch.extraction import extract as textract
from palettenerf_torch.extraction import geometry as tgeom
from palettenerf_torch.extraction import histogram as thist
from palettenerf_torch.extraction import hull as thull
from palettenerf_torch.extraction import tan18 as ttan
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)


@pytest.fixture(scope="module")
def jax_lib():
    lib = jnative.get_lib()
    if lib is None:  # the JAX package's build fell back; the port's would have raised
        pytest.fail("the JAX package's native library did not build with g++")
    return lib


def _colors(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)   # some outside [0, 1]: clamped
    return c, rng.uniform(0, 2, n).astype(np.float32)


@pytest.mark.parametrize("bpc", [1, 3, 5, 8])
def test_histogram_bit_equal(bpc, jax_lib):
    colors, w = _colors(50_000, bpc)
    got_w, got_c = tnative.rgb_histogram_native(colors, w, bpc)
    plain_w, plain_c = thist.rgb_histogram_reference(colors, w, bpc)
    ref_w, ref_c = jnative.rgb_histogram_native(colors, w, bpc)
    assert got_w.dtype == np.float64 and got_w.shape == ((1 << bpc) ** 3,)
    for other in (plain_w, ref_w):
        np.testing.assert_array_equal(got_w, other)
    for other in (plain_c, ref_c):
        np.testing.assert_array_equal(got_c, other)
    # the extraction's entry point takes the native kernel
    np.testing.assert_array_equal(thist.compute_rgb_histogram(colors, w, bpc)[0], got_w)


@pytest.mark.parametrize("seed", [0, 1])
def test_point_triangle_min_dist(seed, jax_lib):
    rng = np.random.default_rng(seed)
    tris = rng.normal(size=(25, 3, 3))
    pts = rng.normal(size=(300, 3)) * 1.5
    got_d, got_c = tnative.point_triangle_min_dist_native(pts, tris.reshape(-1, 9))
    ref_d, ref_c = jnative.point_triangle_min_dist_native(pts, tris.reshape(-1, 9))
    np.testing.assert_array_equal(got_d, ref_d)   # the same source and command line
    np.testing.assert_array_equal(got_c, ref_c)
    d, c = tgeom.point_triangle_min_dist_reference(pts, tris.reshape(-1, 9))
    np.testing.assert_allclose(got_d, d, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got_c, c, rtol=0, atol=1e-10)
    # the closest point is at the distance reported
    np.testing.assert_allclose(np.linalg.norm(got_c - pts, axis=-1), got_d, rtol=0, atol=1e-12)


def _hull_plain(points, hull):
    return tgeom.point_triangle_min_dist_reference(points, hull.points[hull.simplices])


def test_closest_point_on_hull_native_and_plain():
    """Outside a convex hull the nearest point is unique: both versions name it. At the
    centre of a cube six faces (twelve triangles) are equally near: the distance agrees,
    the point named may not, and each is on the hull at that distance."""
    from scipy.spatial import ConvexHull

    rng = np.random.default_rng(7)
    hull = ConvexHull(rng.uniform(size=(40, 3)))
    pts = rng.normal(size=(500, 3)) * 2.0
    outside = np.linalg.norm(pts - 0.5, axis=-1) > 1.0
    got = tgeom.closest_point_on_hull(pts[outside], hull.points, hull.simplices)
    plain = _hull_plain(pts[outside], hull)
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g, p, rtol=0, atol=1e-10)

    cube = ConvexHull(np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                               np.float64))
    centre = np.full((1, 3), 0.5)
    (dn,), (cn,) = tgeom.closest_point_on_hull(centre, cube.points, cube.simplices)
    (dp,), (cp,) = _hull_plain(centre, cube)
    assert abs(dn - 0.5) < 1e-12 and abs(dp - 0.5) < 1e-12
    for c in (cn, cp):   # on a face of the cube, half a side from the centre
        assert np.isclose(np.abs(c - 0.5).max(), 0.5, atol=1e-12)


@pytest.fixture
def plain_kernels(monkeypatch):
    """Every call of the native kernels runs their NumPy versions instead."""
    def use():
        monkeypatch.setattr(tnative, "rgb_histogram_native", thist.rgb_histogram_reference)
        monkeypatch.setattr(tnative, "point_triangle_min_dist_native",
                            tgeom.point_triangle_min_dist_reference)
    return use


def test_hull_steps_native_equal_plain(plain_kernels):
    rng = np.random.default_rng(3)
    pts, counts = rng.uniform(0.05, 0.95, (40, 3)), rng.uniform(0.5, 2.0, 40)
    grid = rng.uniform(size=(4000, 3))
    got = thull.hull_simplification(pts, counts, error_thres=5 / 255)
    got_w = ttan.star_tetra_weights(grid, got)
    plain_kernels()
    plain = thull.hull_simplification(pts, counts, error_thres=5 / 255)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_allclose(got_w, ttan.star_tetra_weights(grid, got), rtol=0, atol=1e-10)


def _scene_colors(n=30000, seed=6):
    """Colors around six pigments and their mixtures, as a scene's foreground gives them
    (``tests/test_torch_extraction.py``'s sample), intensity-normalized."""
    rng = np.random.default_rng(seed)
    pigments = np.array([[0.9, 0.1, 0.1], [0.1, 0.8, 0.2], [0.15, 0.2, 0.9], [0.95, 0.9, 0.2],
                         [0.05, 0.05, 0.05], [0.9, 0.9, 0.9]])
    w = rng.dirichlet(np.full(6, 0.3), n)
    c = np.clip(w @ pigments + rng.normal(scale=0.01, size=(n, 3)), 0, 1) + 0.05
    return (c / np.linalg.norm(c, axis=-1, keepdims=True)).astype(np.float32)


def test_extraction_end_to_end_native(tmp_path, jax_lib, plain_kernels):
    pytest.importorskip("sklearn")   # the JAX package's k-means
    colors = _scene_colors()
    got = textract.palette_extraction({"colors": colors}, str(tmp_path / "n"),
                                      normalize_input=True)
    ref = jextract.palette_extraction({"colors": colors}, str(tmp_path / "j"),
                                      normalize_input=True)
    plain_kernels()
    plain = textract.palette_extraction({"colors": colors}, str(tmp_path / "p"),
                                        normalize_input=True)
    np.testing.assert_array_equal(got[0], plain[0])
    np.testing.assert_allclose(got[1], plain[1], rtol=0, atol=1e-10)
    assert got[0].shape == ref[0].shape and 4 <= len(got[0]) <= 8
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-2)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No quiet fallback: a source that does not compile raises, naming both command
    lines and what g++ said."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" void rgb_histogram( { }\n")
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    lib = tnative.NativeLibrary(str(bad))
    with pytest.raises(RuntimeError) as err:
        lib.get()
    msg = str(err.value)
    assert "g++ could not build" in msg and "-fopenmp" in msg and "error" in msg
    assert msg.count("$ g++") == 2
    assert not os.listdir(tmp_path / "build")   # nothing half-built is left to load


def test_build_is_reused_and_named():
    path = tnative.LIBRARY.build()
    assert os.path.exists(path) and os.path.basename(path).startswith("libpalette_native.")
    assert tnative.LIBRARY.build_command[0] == "g++"
    assert tnative.LIBRARY.build() == path   # the same source and command: no rebuild
