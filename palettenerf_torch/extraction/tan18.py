"""Tan et al. 2016/2018 "ASAP" mixing weights via star tetrahedralization.

Fresh vectorized re-implementation of the reference
``Get_ASAP_weights_using_Tan_2016_triangulation_and_then_barycentric_coordinates``
(``Additive_mixing_layers_extraction.py:397-566``):

1. order the palette by distance to black (order=0 convention),
2. project points outside the simplified hull onto its surface,
3. star-tetrahedralize: every hull facet not containing vertex 0 forms a tetra with
   vertex 0; each point is assigned to the first containing tetra,
4. barycentric coordinates inside the assigned tetra give the per-palette weights,
   scattered back in the original palette order.
"""

# The port's own copy of ``palettenerf_tpu/extraction/tan18.py`` (NumPy + SciPy, unchanged).

from __future__ import annotations

import numpy as np
from scipy.spatial import ConvexHull, Delaunay

from .geometry import closest_point_on_hull


def _barycentric_in_tetra(tetra: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """tetra [4,3], pts [N,3] -> weights [N,4] (affine solve; rows sum to 1)."""
    T = (tetra[1:] - tetra[0]).T  # [3,3] columns = edges
    try:
        inv = np.linalg.inv(T)
    except np.linalg.LinAlgError:
        inv = np.linalg.pinv(T)
    b = (pts - tetra[0]) @ inv.T  # [N,3]
    return np.concatenate([1.0 - b.sum(-1, keepdims=True), b], axis=-1)


def star_tetra_weights(points: np.ndarray, palette: np.ndarray, order: int = 0) -> np.ndarray:
    """points [N,3] in [0,1]-ish, palette [P,3] -> mixing weights [N,P] (rows sum 1)."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    palette = np.asarray(palette, np.float64)
    P = len(palette)

    if order == 0:
        anchor = np.zeros(3)
    elif order == 1:
        anchor = np.ones(3)
    else:
        raise ValueError("order must be 0 (black) or 1 (white)")
    perm = np.argsort(np.abs(palette - anchor).sum(-1))
    verts = palette[perm]  # verts[0] = anchor-closest pigment

    hull = ConvexHull(verts)
    de = Delaunay(verts)
    lab = de.find_simplex(points, tol=1e-8)
    pts = points.copy()
    outside = lab < 0
    if outside.any():
        _, proj = closest_point_on_hull(pts[outside], hull.points, hull.simplices)
        pts[outside] = proj

    # unique colors only (the 32^3 grid has no dupes, but keep general)
    uniq, inverse = np.unique(pts, axis=0, return_inverse=True)

    weights_u = np.zeros((len(uniq), P))
    assigned = np.zeros(len(uniq), bool)

    star_faces = [f for f in hull.simplices if (f != 0).all()]
    for f in star_faces:
        if assigned.all():
            break
        tetra = np.vstack([verts[0], verts[f]])
        try:
            d = Delaunay(tetra)
        except Exception:
            continue  # nearly-flat tetra; skip like the reference
        todo = ~assigned
        inside = d.find_simplex(uniq[todo], tol=1e-8) >= 0
        idx = np.where(todo)[0][inside]
        if len(idx) == 0:
            continue
        w = _barycentric_in_tetra(tetra, uniq[idx])  # [n,4] for [v0, f0, f1, f2]
        cols = np.concatenate([[0], f])
        weights_u[idx[:, None], cols[None, :]] = w
        assigned[idx] = True

    if not assigned.all():
        # numerically-marginal points: fall back to closest star tetra by barycentric clamp
        rem = np.where(~assigned)[0]
        best_err = np.full(len(rem), np.inf)
        for f in star_faces:
            tetra = np.vstack([verts[0], verts[f]])
            w = _barycentric_in_tetra(tetra, uniq[rem])
            err = np.clip(-w, 0, None).sum(-1)
            better = err < best_err
            if better.any():
                cols = np.concatenate([[0], f])
                wclip = np.clip(w[better], 0, None)
                wclip /= wclip.sum(-1, keepdims=True)
                weights_u[rem[better]] = 0.0
                weights_u[rem[better][:, None], cols[None, :]] = wclip
                best_err[better] = err[better]
        assigned[:] = True

    weights = weights_u[inverse]
    # un-permute to the original palette order
    out = np.zeros_like(weights)
    out[:, perm] = weights
    return out
