"""Convex-hull palette simplification via LP-guided edge collapse.

Re-implementation of the reference algorithm (``rgbsg/hull_simplification_posternerf.py``
+ ``fastLayerDecomposition/Convexhull_simplification.py:149-280``) without cvxopt/GLPK or
the halfedge TriMesh: each iteration considers every hull edge, solves a small LP
(``scipy.optimize.linprog``) for the apex point that stays outside all faces adjacent to
the edge's endpoints, scores it by total added tetra volume, collapses the cheapest edge
(drop both endpoints, add the apex, re-hull), and stops when the weighted out-of-hull
reconstruction RMSE would exceed ``error_thres`` (or when ``target_size`` is reached).
"""

# The port's own copy of ``palettenerf_tpu/extraction/hull.py`` (NumPy + SciPy, and the
# C++ point-triangle kernel of ``native/``).

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.optimize import linprog
from scipy.spatial import ConvexHull, Delaunay

from .geometry import closest_point_on_hull


def outside_hull_rmse(hull_vertices: np.ndarray, points: np.ndarray, counts: np.ndarray) -> float:
    """Weighted RMSE of points outside the hull (Additive_mixing_layers_extraction.py:185-204)."""
    hull = ConvexHull(hull_vertices)
    de = Delaunay(hull_vertices)
    outside = de.find_simplex(points, tol=1e-8) < 0
    if not outside.any():
        return 0.0
    d, _ = closest_point_on_hull(points[outside], hull.points, hull.simplices)
    return float(np.sqrt((d ** 2 * counts[outside]).sum() / counts.sum()))


def _edges_of_hull(hull: ConvexHull):
    edges = set()
    for f in hull.simplices:
        for i in range(3):
            a, b = int(f[i]), int(f[(i + 1) % 3])
            edges.add((min(a, b), max(a, b)))
    return sorted(edges)


def _collapse_candidates(hull_of_verts: ConvexHull):
    """For every hull edge, the LP apex point + added volume.

    ``hull_of_verts`` must be a hull whose ``points`` are exactly its vertices.
    Returns (list of (volume, v0, v1, apex), verts).
    """
    verts = hull_of_verts.points
    faces = hull_of_verts.simplices                 # indices into verts
    eqs = hull_of_verts.equations                   # outward unit normals: n.x + d <= 0 inside

    # adjacency: faces touching each vertex
    vert_faces = [[] for _ in range(len(verts))]
    for fi, f in enumerate(faces):
        for v in f:
            vert_faces[int(v)].append(fi)

    out = []
    for (v0, v1) in _edges_of_hull(hull_of_verts):
        face_ids = sorted(set(vert_faces[v0]) | set(vert_faces[v1]))
        normals = eqs[face_ids, :3]                 # outward unit normals
        offsets = -eqs[face_ids, 3]                 # plane: n.x = offset
        # apex must lie on-or-outside every adjacent face plane: n.x >= offset
        # (tiny slack keeps near-degenerate cones feasible; the reference's GLPK run
        # simply skips such edges, stalling the collapse earlier than necessary)
        A = -normals
        b = -offsets + 1e-9
        c = normals.sum(0)
        res = linprog(c, A_ub=A, b_ub=b, bounds=[(-10, 10)] * 3, method="highs")
        if not res.success:
            continue
        apex = res.x
        vol = 0.0
        for fi in face_ids:
            p0, p1, p2 = verts[faces[fi][0]], verts[faces[fi][1]], verts[faces[fi][2]]
            n_raw = np.cross(p1 - p0, p2 - p0)
            vol += abs(np.dot(n_raw, apex - p0)) / 6.0
        out.append((vol, v0, v1, apex))
    return out, verts


def hull_simplification(
    data: np.ndarray,
    pixel_counts: Optional[np.ndarray] = None,
    error_thres: float = 2.0 / 255.0,
    target_size: Optional[int] = None,
    max_loop: int = 5000,
) -> np.ndarray:
    """Simplify the convex hull of ``data`` [N,3] down to a small palette.

    Returns palette_rgb [P,3] clipped to [0,1]. Mirrors
    Hull_Simplification_posternerf (hull_simplification_posternerf.py:19-77).
    """
    data = np.asarray(data, np.float64).reshape(-1, 3)
    if pixel_counts is None:
        data, pixel_counts = np.unique(data, axis=0, return_counts=True)
    hull = ConvexHull(data)
    current = hull.points[hull.vertices]

    for _ in range(max_loop):
        old_vertices = current.copy()
        cands, verts = _collapse_candidates(ConvexHull(current))
        if not cands:
            return current.clip(0, 1)
        vol, v0, v1, apex = min(cands, key=lambda t: t[0])
        keep = [i for i in range(len(verts)) if i not in (v0, v1)]
        new_pts = np.vstack([verts[keep], apex])
        hull = ConvexHull(new_pts)
        current = hull.points[hull.vertices]
        nv = len(current)

        if nv <= 10:
            if target_size is None:
                try:
                    err = outside_hull_rmse(current.clip(0, 1), data, pixel_counts)
                except Exception:
                    err = np.inf
                if err > error_thres:
                    return ConvexHull(old_vertices).points[
                        ConvexHull(old_vertices).vertices
                    ].clip(0, 1)
            elif nv == target_size:
                return current.clip(0, 1)

        if nv == len(old_vertices) or nv == 4:
            return current.clip(0, 1)

    return current.clip(0, 1)
