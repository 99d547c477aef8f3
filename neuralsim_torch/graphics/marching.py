"""Isosurface extraction by marching tetrahedra, and mesh / point-cloud PLY
files (a numpy copy of neuralsim_tpu/graphics/marching.py:24-212; the port
keeps its own, importing nothing of the JAX package).

Each cube of the grid splits into 6 tetrahedra along its main diagonal (the
case table is derived, not a 256-entry lookup); the whole grid is processed
at once in numpy, each zero crossing interpolated linearly along its edge,
the vertices on shared edges merged. ``extract_mesh`` samples an SDF (any
callable of points [P, 3] -> [P], such as a field's query on the card) on a
dense grid in chunks of 65,536 points. The PLY files are binary
little-endian.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

# 6-tetrahedra decomposition of the unit cube (vertex indices into the cube's
# 8 corners, standard Kuhn split along the main diagonal 0-7).
_CUBE_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                          [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]])
_TETS = np.array([[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7],
                  [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]])


def _tet_triangles(inside: np.ndarray) -> list:
    """Case analysis for one sign pattern (bool[4]) -> list of edge triples;
    an edge is an (i, j) corner pair with a zero crossing."""
    ins = [i for i in range(4) if inside[i]]
    outs = [i for i in range(4) if not inside[i]]
    if len(ins) == 0 or len(ins) == 4:
        return []
    if len(ins) == 1:
        a = ins[0]
        b, c, d = outs
        return [((a, b), (a, c), (a, d))]
    if len(ins) == 3:
        a = outs[0]
        b, c, d = ins
        return [((a, b), (a, d), (a, c))]
    a, b = ins
    c, d = outs
    return [((a, c), (a, d), (b, d)), ((a, c), (b, d), (b, c))]


_CASES = [_tet_triangles(np.array([(m >> i) & 1 for i in range(4)], bool))
          for m in range(16)]


def marching_tets(grid: np.ndarray, *, level: float = 0.0,
                  origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``level`` isosurface of a scalar grid [X, Y, Z].

    Returns (verts [V, 3] world coords, faces [F, 3] int). Vectorized over
    all cubes; duplicate vertices along shared edges are merged.
    """
    g = np.asarray(grid, np.float32) - level
    X, Y, Z = g.shape
    nx, ny, nz = X - 1, Y - 1, Z - 1
    if min(nx, ny, nz) < 1:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    # cube corner values [nx, ny, nz, 8]
    cvals = np.empty((nx, ny, nz, 8), np.float32)
    cidx = np.empty((nx, ny, nz, 8), np.int64)
    lin = np.arange(X * Y * Z).reshape(X, Y, Z)
    for k, (dx, dy, dz) in enumerate(_CUBE_CORNERS):
        cvals[..., k] = g[dx:dx + nx, dy:dy + ny, dz:dz + nz]
        cidx[..., k] = lin[dx:dx + nx, dy:dy + ny, dz:dz + nz]

    cvals = cvals.reshape(-1, 8)
    cidx = cidx.reshape(-1, 8)
    # keep only cubes whose values straddle the level
    straddle = (cvals.min(1) < 0) & (cvals.max(1) > 0)
    cvals = cvals[straddle]
    cidx = cidx[straddle]
    if cvals.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    tri_edges = []  # list of [M, 3, 2] arrays of global grid-vertex pairs
    for tet in _TETS:
        tv = cvals[:, tet]                       # [M, 4]
        ti = cidx[:, tet]                        # [M, 4]
        mask_bits = (tv < 0).astype(np.int32)
        case = (mask_bits * np.array([1, 2, 4, 8])).sum(1)
        for m in range(1, 15):
            tris = _CASES[m]
            if not tris:
                continue
            sel = case == m
            if not sel.any():
                continue
            si = ti[sel]
            for tri in tris:
                pairs = np.stack([np.stack([si[:, e[0]], si[:, e[1]]], -1)
                                  for e in tri], axis=1)  # [S, 3, 2]
                tri_edges.append(pairs)

    if not tri_edges:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    E = np.concatenate(tri_edges, 0)             # [F, 3, 2]

    # unique edges -> one interpolated vertex each
    e_flat = np.sort(E.reshape(-1, 2), axis=1)
    key = e_flat[:, 0] * (X * Y * Z) + e_flat[:, 1]
    uniq, inv = np.unique(key, return_inverse=True)
    ua = (uniq // (X * Y * Z)).astype(np.int64)
    ub = (uniq % (X * Y * Z)).astype(np.int64)

    gf = g.reshape(-1)
    va, vb = gf[ua], gf[ub]
    t = va / np.where(np.abs(va - vb) < 1e-12, 1e-12, va - vb)
    t = np.clip(t, 0.0, 1.0)

    def to_xyz(idx):
        x = idx // (Y * Z)
        y = (idx // Z) % Y
        z = idx % Z
        return np.stack([x, y, z], -1).astype(np.float32)

    pa, pb = to_xyz(ua), to_xyz(ub)
    verts = pa + t[:, None] * (pb - pa)
    verts = verts * np.asarray(spacing, np.float32) + np.asarray(origin, np.float32)
    faces = inv.reshape(-1, 3)
    # drop degenerate faces (two corners on the same edge vertex)
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    return verts, faces[ok]


def extract_mesh(sdf_fn: Callable[[np.ndarray], np.ndarray], *,
                 aabb_min, aabb_max, resolution: int = 128, level: float = 0.0,
                 chunk: int = 65536, to_world: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Sample an SDF on a dense grid and extract the level set (reference
    ``extract_mesh`` consumed at code_single/tools/extract_mesh.py:26)."""
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    xs = [np.linspace(aabb_min[i], aabb_max[i], resolution) for i in range(3)]
    pts = np.stack(np.meshgrid(*xs, indexing="ij"), -1).reshape(-1, 3)
    vals = np.empty(pts.shape[0], np.float32)
    for i in range(0, pts.shape[0], chunk):
        vals[i:i + chunk] = np.asarray(sdf_fn(pts[i:i + chunk].astype(np.float32)))
    grid = vals.reshape(resolution, resolution, resolution)
    spacing = (aabb_max - aabb_min) / (resolution - 1)
    verts, faces = marching_tets(grid, level=level, origin=aabb_min,
                                 spacing=spacing)
    if to_world is not None and verts.shape[0]:
        R, t = to_world[:3, :3], to_world[:3, 3]
        verts = verts @ R.T + t
    return verts, faces


def export_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray,
                    colors: Optional[np.ndarray] = None) -> None:
    """Write a binary-little-endian PLY (reference export_pcl_ply analog)."""
    import struct
    V, F = len(verts), len(faces)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {V}",
               "property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {F}",
                "property list uchar int vertex_indices", "end_header", ""]
        f.write("\n".join(hdr).encode())
        if colors is not None:
            c8 = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
            for i in range(V):
                f.write(struct.pack("<3f", *verts[i]) + bytes(c8[i]))
        else:
            f.write(np.asarray(verts, "<f4").tobytes())
        for i in range(F):
            f.write(struct.pack("<B3i", 3, *faces[i]))


def load_mesh_ply(path: str):
    """Read a binary-little-endian PLY written by export_mesh_ply
    -> (verts [V,3] f32, faces [F,3] i32)."""
    import struct
    with open(path, "rb") as f:
        V = F = 0
        props = []
        while True:
            line = f.readline().decode().strip()
            if line.startswith("element vertex"):
                V = int(line.split()[-1])
                props = []
            elif line.startswith("element face"):
                F = int(line.split()[-1])
            elif line.startswith("property") and "list" not in line:
                props.append(line.split()[-1])
            elif line == "end_header":
                break
        has_color = "red" in props
        verts = np.empty((V, 3), np.float32)
        for i in range(V):
            verts[i] = struct.unpack("<3f", f.read(12))
            if has_color:
                f.read(3)
        faces = np.empty((F, 3), np.int32)
        for i in range(F):
            n = struct.unpack("<B", f.read(1))[0]
            idx = struct.unpack(f"<{n}i", f.read(4 * n))
            faces[i] = idx[:3]
    return verts, faces


def export_pcl_ply(path: str, pts: np.ndarray,
                   colors: Optional[np.ndarray] = None) -> None:
    export_mesh_ply(path, pts, np.zeros((0, 3), np.int64), colors)
