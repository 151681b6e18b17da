"""Isosurface extraction via marching tetrahedra (pure NumPy, vectorized).

Replaces the reference's ``mcubes.marching_cubes`` dependency (``nerf/utils.py:205-217``
extract_geometry): each grid cube is split into 6 tetrahedra; each tet contributes 0-2
triangles with vertices linearly interpolated onto the isosurface. Produces ~2x the
triangles of classic marching cubes but needs no 256-case table and vectorizes cleanly.

The port's own copy of ``palettenerf_tpu/utils/mcubes.py``: it runs on the host, as
there, and writes the same bytes for the same field. ``read_ply`` (the port's addition)
reads back what ``write_ply`` writes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# 6-tet decomposition of the unit cube (vertex ids 0..7 = (x<<2|y<<1|z) ordering below)
_CUBE_VERTS = np.array([
    [0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
    [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1],
])
_TETS = np.array([
    [0, 5, 1, 3], [0, 5, 3, 7], [0, 5, 7, 4],
    [0, 7, 3, 2], [0, 7, 2, 6], [0, 7, 6, 4],
])
# tet edges: pairs of local tet-vertex ids
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])
# triangles (edge-id triples) per inside-mask case (bit i = tet vertex i inside)
_CASE_TRIS = {
    0b0001: [(0, 2, 1)],
    0b0010: [(0, 3, 4)],
    0b0100: [(1, 5, 3)],
    0b1000: [(2, 4, 5)],
    0b0011: [(1, 2, 4), (1, 4, 3)],
    0b0101: [(0, 3, 5), (0, 5, 2)],
    0b1001: [(0, 4, 5), (0, 5, 1)],
    0b0110: [(0, 1, 5), (0, 5, 4)],
    0b1010: [(0, 2, 5), (0, 5, 3)],
    0b1100: [(1, 2, 4), (1, 4, 3)],
    0b0111: [(2, 4, 5)],
    0b1011: [(1, 3, 5)],
    0b1101: [(0, 4, 3)],
    0b1110: [(0, 1, 2)],
}


def marching_tetrahedra(field: np.ndarray, threshold: float) -> Tuple[np.ndarray, np.ndarray]:
    """field [X, Y, Z] scalar; returns (vertices [V,3] in index coords, triangles [F,3])."""
    X, Y, Z = field.shape
    # cube corner values for all cells: [X-1, Y-1, Z-1, 8]
    corners = np.stack(
        [field[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz] for dx, dy, dz in _CUBE_VERTS],
        axis=-1,
    )
    base = np.stack(np.meshgrid(
        np.arange(X - 1), np.arange(Y - 1), np.arange(Z - 1), indexing="ij"), -1)
    corners = corners.reshape(-1, 8)
    base = base.reshape(-1, 3).astype(np.float64)

    verts_out = []
    for tet in _TETS:
        vals = corners[:, tet]                       # [C, 4]
        inside = vals > threshold
        case = (inside * (1 << np.arange(4))).sum(-1)  # [C]
        tet_pos = _CUBE_VERTS[tet].astype(np.float64)  # [4, 3]

        for c, tris in _CASE_TRIS.items():
            sel = np.where(case == c)[0]
            if len(sel) == 0:
                continue
            v_sel = vals[sel]                         # [S, 4]
            b_sel = base[sel]                         # [S, 3]
            # interpolated point on each tet edge
            edge_pts = {}
            for ei, (a, b) in enumerate(_TET_EDGES):
                va, vb = v_sel[:, a], v_sel[:, b]
                denom = np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
                t = np.clip((threshold - va) / denom, 0.0, 1.0)
                edge_pts[ei] = b_sel + tet_pos[a] + t[:, None] * (tet_pos[b] - tet_pos[a])
            for (e0, e1, e2) in tris:
                verts_out.append(np.stack([edge_pts[e0], edge_pts[e1], edge_pts[e2]], 1))

    if not verts_out:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    tri_verts = np.concatenate(verts_out, 0)          # [F, 3, 3]
    flat = tri_verts.reshape(-1, 3)
    uniq, inv = np.unique(np.round(flat, 6), axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    return uniq, faces[ok]


def write_obj(path: str, vertices: np.ndarray, faces: np.ndarray):
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in faces + 1:
            f.write(f"f {t[0]} {t[1]} {t[2]}\n")


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray):
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(vertices)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        f.write(header.encode())
        f.write(vertices.astype("<f4").tobytes())
        counts = np.full((len(faces), 1), 3, np.uint8)
        rec = np.empty(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        rec["n"] = 3
        rec["idx"] = faces
        f.write(rec.tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices [V, 3] float32, faces [F, 3] int32) of a binary PLY in the layout
    ``write_ply`` writes; raises ValueError on any other layout."""
    with open(path, "rb") as f:
        head, _, body = f.read().partition(b"end_header\n")
    lines = head.decode().splitlines()
    counts = {ln.split()[1]: int(ln.split()[2]) for ln in lines if ln.startswith("element ")}
    n_v, n_f = counts.get("vertex", -1), counts.get("face", -1)
    if lines[:2] != ["ply", "format binary_little_endian 1.0"] or len(body) != 12 * n_v + 13 * n_f:
        raise ValueError(f"{path}: not a PLY as write_ply writes it")
    verts = np.frombuffer(body, "<f4", count=3 * n_v).reshape(n_v, 3)
    rec = np.frombuffer(body, np.dtype([("n", "u1"), ("idx", "<i4", 3)]), count=n_f,
                        offset=12 * n_v)
    if (rec["n"] != 3).any():
        raise ValueError(f"{path}: a face that is not a triangle")
    return verts, rec["idx"]
