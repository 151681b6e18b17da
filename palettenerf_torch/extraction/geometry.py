"""Vectorized point-to-triangle distance (replaces the Cython GteDistPointTriangle,
reference ``palette/rgbsg/fastLayerDecomposition/GteDistPointTriangle.pyx``). The port's
own copy of ``palettenerf_tpu/extraction/geometry.py``: ``closest_point_on_hull`` runs
the C++ kernel of ``native/``, the JAX package's default path;
``point_triangle_min_dist_reference`` is its plain NumPy version. The two agree on the
distance to 1e-10; they clamp
differently off the triangle (the C++ kernel takes the projection when it lies inside,
else the best of the three clamped edges; NumPy the same, with the interior solution
clamped into [0, 1] first), and may break a tie between equally near edges or
triangles differently, so the closest points can differ where two are equally near.

Implementation: orthogonal projection onto the triangle plane followed by clamping into
the triangle via edge-region analysis — the classic Eberly region decomposition,
vectorized over an arbitrary (points x triangles) broadcast. Used by hull-simplification
RMSE and the Tan18 out-of-hull projection.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .. import native


def point_triangle_distance(points: np.ndarray, triangles: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """points [..., 3], triangles [..., 3, 3] (broadcastable) ->
    (distance [...], closest [..., 3])."""
    p = np.asarray(points, np.float64)
    tri = np.asarray(triangles, np.float64)
    a = tri[..., 0, :]
    e0 = tri[..., 1, :] - a  # edge a->b
    e1 = tri[..., 2, :] - a  # edge a->c
    d = a - p

    aa = (e0 * e0).sum(-1)
    ab = (e0 * e1).sum(-1)
    bb = (e1 * e1).sum(-1)
    ad = (e0 * d).sum(-1)
    bd = (e1 * d).sum(-1)

    det = np.maximum(aa * bb - ab * ab, 1e-30)
    s = ab * bd - bb * ad
    t = ab * ad - aa * bd

    # interior solution
    s_in = s / det
    t_in = t / det

    # candidate closest points: interior + three clamped edges
    def clamp01(x):
        return np.clip(x, 0.0, 1.0)

    # edge a->b (t=0): s = -ad/aa
    s_ab = clamp01(-ad / np.maximum(aa, 1e-30))
    c_ab = a + s_ab[..., None] * e0
    # edge a->c (s=0): t = -bd/bb
    t_ac = clamp01(-bd / np.maximum(bb, 1e-30))
    c_ac = a + t_ac[..., None] * e1
    # edge b->c: param u along (c-b)
    b_pt = a + e0
    e2 = e1 - e0  # b->c
    u_bc = clamp01(((p - b_pt) * e2).sum(-1) / np.maximum((e2 * e2).sum(-1), 1e-30))
    c_bc = b_pt + u_bc[..., None] * e2

    inside = (s_in >= 0) & (t_in >= 0) & (s_in + t_in <= 1)
    c_int = a + np.clip(s_in, 0, 1)[..., None] * e0 + np.clip(t_in, 0, 1)[..., None] * e1

    cands = np.stack([c_ab, c_ac, c_bc], axis=-2)  # [..., 3, 3]
    dists = np.linalg.norm(cands - p[..., None, :], axis=-1)
    best = np.argmin(dists, axis=-1)
    c_edge = np.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]

    closest = np.where(inside[..., None], c_int, c_edge)
    distance = np.linalg.norm(closest - p, axis=-1)
    return distance, closest


def closest_point_on_hull(points: np.ndarray, hull_vertices: np.ndarray, simplices: np.ndarray):
    """For each point, min distance + closest point over all hull facets.

    points [N,3]; hull_vertices [V,3]; simplices [F,3] indices into hull_vertices.
    Returns (dist [N], closest [N,3]).
    """
    return native.point_triangle_min_dist_native(points, hull_vertices[simplices].reshape(-1, 9))


def point_triangle_min_dist_reference(points: np.ndarray,
                                      tris: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``native.point_triangle_min_dist_native`` in NumPy, its plain version: points
    [N, 3], triangles [T, 9] -> (the distance to the nearest triangle [N], the closest
    point on it [N, 3])."""
    tris = np.asarray(tris, np.float64).reshape(-1, 3, 3)
    d, c = point_triangle_distance(points[:, None, :], tris[None, :, :, :])  # [N,T]
    best = np.argmin(d, axis=1)
    n = np.arange(len(points))
    return d[n, best], c[n, best]
