"""Mesh extraction from the density field (marching tetrahedra) and export.

Counterpart of enerf_tpu/utils/mesh.py (reference nerf/utils.py:219-249,
Trainer.save_mesh :712-732): the density is queried on a dense grid, the
threshold isosurface is extracted by marching tetrahedra (six tetrahedra a
cube, no 256-case table) and written as .obj or .ply.

The JAX package extracts with a Python loop over the crossing cells x 6
tetrahedra and a dict of edge vertices, millions of iterations at 256^3.
Here the extraction is a handful of tensor operations on the grid's device,
and gives the same mesh:
  - every (cell, tet) pair of the crossing cells, in the loop's order,
    emits its edge visits from a 16-case table of the tet's inside mask, in
    the loop's call order and orientation;
  - `torch.unique` over the sorted endpoint keys finds each edge's first
    visit (`scatter_reduce(amin)`), and vertices are numbered in order of
    first visit;
  - a vertex is interpolated in the orientation of its first visit: t in
    the grid's dtype (numpy's promotion of `threshold - va` for a float32
    `va`), the point in float64, rounded to float32.
"""

import numpy as np
import torch

from enerf_torch.backend import resolve_device

# 6-tetrahedra decomposition of a cube (indices into the 8 cube corners,
# corner i has offset bits (x=i&1, y=(i>>1)&1, z=(i>>2)&1))
_TETS = np.array([[0, 5, 1, 3], [0, 5, 3, 7], [0, 5, 7, 4],
                  [0, 7, 3, 2], [0, 7, 2, 6], [0, 7, 6, 4]], np.int64)
_CORNER_OFFSETS = np.array([[(i & 1), (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.int64)


def _case_table():
    """For each 4-bit inside mask of a tet's corners (bit j = position j):
    the edge visits (from, to) in tet positions, in the JAX loop's call
    order and orientation, padded with -1, and the triangles as indices
    into those visits, padded with -1."""
    edges = np.full((16, 4, 2), -1, np.int64)
    tris = np.full((16, 2, 3), -1, np.int64)
    for m in range(16):
        ins = [j for j in range(4) if m >> j & 1]
        outs = [j for j in range(4) if not m >> j & 1]
        if len(ins) == 1:
            calls, tri = [(ins[0], b) for b in outs], [[0, 1, 2]]
        elif len(ins) == 3:
            calls, tri = [(b, outs[0]) for b in ins], [[0, 2, 1]]
        elif len(ins) == 2:
            (a, b), (c, d) = ins, outs
            calls, tri = [(a, c), (a, d), (b, c), (b, d)], [[0, 1, 3], [0, 3, 2]]
        else:
            continue
        edges[m, :len(calls)] = calls
        tris[m, :len(tri)] = tri
    return edges, tris


_CASE_EDGES, _CASE_TRIS = _case_table()


def extract_fields(bound_min, bound_max, resolution, query_fn, device=None):
    """Evaluate query_fn([N, 3] float32 tensor) -> [N] density over a dense
    grid (ij order: x slowest) in chunks of 2^20 points, on `device` (None:
    the card).  The axes are np.linspace in float64, as the JAX package
    builds them, rounded to float32 (the points it queries).  Returns u
    [R, R, R] float32 on `device`."""
    R, chunk = resolution, 1 << 20
    device = resolve_device(device)
    axes = [torch.as_tensor(np.linspace(bound_min[i], bound_max[i], R).astype(np.float32),
                            device=device) for i in range(3)]
    u = torch.empty(R ** 3, dtype=torch.float32, device=device)
    for s in range(0, R ** 3, chunk):
        i = torch.arange(s, min(s + chunk, R ** 3), device=device)
        pts = torch.stack([axes[0][i // (R * R)], axes[1][i // R % R], axes[2][i % R]], -1)
        u[s:s + i.shape[0]] = query_fn(pts).reshape(-1).float()
    return u.reshape(R, R, R)


def marching_tets(u, threshold):
    """The threshold isosurface of u [R, R, R] (a tensor, or an array taken
    to the CPU) -> (verts [V, 3] float32 in grid coords, tris [T, 3] int64),
    on u's device; the JAX package's marching_tets's mesh, vertex for vertex
    and triangle for triangle."""
    u = torch.as_tensor(u)
    dev, R = u.device, u.shape[0]
    n = R - 1
    corner_vals = torch.stack([u[ox:ox + n, oy:oy + n, oz:oz + n].reshape(-1)
                               for ox, oy, oz in _CORNER_OFFSETS.tolist()], -1)  # [C, 8]
    # cells crossing the surface only (NaN corners never cross, as in numpy)
    crossing = (corner_vals.amax(-1) > threshold) & (corner_vals.amin(-1) < threshold)
    cells = torch.nonzero(crossing).reshape(-1)  # ascending = the loop's order
    del corner_vals, crossing
    if cells.numel() == 0:
        return (torch.zeros((0, 3), dtype=torch.float32, device=dev),
                torch.zeros((0, 3), dtype=torch.int64, device=dev))
    # grid index of each crossing cell's corner 0: g = x * R^2 + y * R + z
    base = ((cells // (n * n)) * R + cells // n % n) * R + cells % n
    del cells
    uf = u.reshape(-1)
    offs = _CORNER_OFFSETS @ np.array([R * R, R, 1])  # cube corner -> grid offset
    inside = uf[base[:, None] + torch.as_tensor(offs, device=dev)] > threshold  # [N, 8]
    case = torch.zeros((base.shape[0], 6), dtype=torch.int64, device=dev)  # [N, 6]
    for j in range(4):  # bit j: the tet's corner at position j is inside
        case |= inside[:, torch.as_tensor(_TETS[:, j], device=dev)].long() << j
    del inside

    # the visits of each (cell, tet) pair, in the loop's order: tables by
    # (tet, case) of the grid offsets of each visit's from / to corner
    tet = torch.arange(6, device=dev)[None, :]
    rows, edges = np.arange(6)[:, None, None], _CASE_EDGES.clip(min=0)[None]
    off_a = torch.as_tensor(offs[_TETS[rows, edges[..., 0]]], device=dev)  # [6, 16, 4]
    off_b = torch.as_tensor(offs[_TETS[rows, edges[..., 1]]], device=dev)
    visit = torch.as_tensor(_CASE_EDGES[..., 0] >= 0, device=dev)[case]  # [N, 6, 4]
    ga = (base[:, None, None] + off_a[tet, case])[visit]  # [M] from-corner
    gb = (base[:, None, None] + off_b[tet, case])[visit]  # [M] to-corner
    M = ga.shape[0]

    # first visit of each edge, vertices numbered in order of first visit
    key = torch.minimum(ga, gb) * R ** 3 + torch.maximum(ga, gb)
    uniq, inv = torch.unique(key, return_inverse=True)
    del key
    first = torch.full((uniq.shape[0],), M, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, inv, torch.arange(M, device=dev), "amin")
    order = torch.argsort(first)
    vid = torch.empty_like(order)
    vid[order] = torch.arange(order.shape[0], device=dev)
    call_vid = vid[inv]  # [M]

    fa, fb = ga[first[order]], gb[first[order]]  # first visit's orientation
    va, vb = uf[fa], uf[fb]
    t = (threshold - va) / (vb - va)  # in u's dtype
    pa = torch.stack([fa // (R * R), fa // R % R, fa % R], -1).double()
    pb = torch.stack([fb // (R * R), fb // R % R, fb % R], -1).double()
    verts = (pa + t.double()[:, None] * (pb - pa)).float()

    # triangles: per (cell, tet) pair with visits, indices into its visits
    # (numbered from the pair's first visit) -> vertex ids
    nvis = visit.sum(-1).reshape(-1)  # [N * 6]
    start = torch.cumsum(nvis, 0) - nvis
    pairs = nvis > 0
    tri_local = torch.as_tensor(_CASE_TRIS, device=dev)[case.reshape(-1)[pairs]]  # [P, 2, 3]
    has_tri = tri_local[..., 0] >= 0  # [P, 2]
    tris = call_vid[(start[pairs][:, None, None] + tri_local)[has_tri]]
    return verts, tris


def to_world(verts, bound_min, bound_max, resolution):
    """Grid coords -> world coords as the JAX package's extract_geometry
    scales them: verts / (R - 1) in float32, then float64 scale and shift,
    rounded to float32."""
    bmin = torch.as_tensor(np.asarray(bound_min, np.float64), device=verts.device)
    bmax = torch.as_tensor(np.asarray(bound_max, np.float64), device=verts.device)
    g = verts / torch.tensor(resolution - 1.0, dtype=verts.dtype, device=verts.device)
    return (g.double() * (bmax - bmin)[None, :] + bmin[None, :]).float()


def extract_geometry(bound_min, bound_max, resolution, threshold, query_fn, device=None):
    """Reference utils.py:237-249 equivalent: (verts [V, 3] float32 in world
    coords, tris [T, 3] int64), tensors on `device`."""
    u = extract_fields(bound_min, bound_max, resolution, query_fn, device=device)
    verts, tris = marching_tets(u, threshold)
    return to_world(verts, bound_min, bound_max, resolution), tris


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _lines(fmt, rows):
    """One formatted line per row of `rows`, in one string: numpy float32
    values format as their exact float64 value, as an f-string does."""
    a = _np(rows)
    flat = a.astype(np.float64 if a.dtype.kind == "f" else np.int64).reshape(-1)
    return (fmt * len(a)) % tuple(flat.tolist())


def write_obj(path, verts, tris):
    """Wavefront OBJ, byte-identical to the JAX package's writer ("%.6f"
    coordinates, 1-based faces), formatted in bulk."""
    with open(path, "w") as f:
        f.write(_lines("v %.6f %.6f %.6f\n", verts) + _lines("f %d %d %d\n", _np(tris) + 1))


def write_ply(path, verts, tris):
    """ASCII PLY, byte-identical to the JAX package's writer."""
    head = ("ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(tris)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write((head + _lines("%.6f %.6f %.6f\n", verts) + _lines("3 %d %d %d\n", tris)).encode())
