"""Isosurface extraction by marching tetrahedra (port of
invesalius3_tpu/ops/marching.py: ``mask_to_surface_device`` and what it
calls, ``mesh_to_host`` and the host variants ``marching_cubes`` and
``mask_to_surface``).

Each cube splits into six tetrahedra around its 0-6 diagonal; a tet with s
inside corners emits min(s, 4 - s) triangles from a 16-case table, turned
to face away from the tet's inside corners.  Vertices on shared lattice
edges are merged by one stable sort of their edge keys.

PyTorch has dynamic shapes, so the port sizes every array from the real
counts: no bucket rounding, no retry on overflow, no padding slots.  The
JAX mesh's padding slots form one extra "orphan" vertex at id 0 whenever
the JAX package padded; here there is none, so vertex ids are the JAX ids
minus one in that case (``convert.from_jax_mesh``).  Triangle order is
(tet, k, cell), as in the JAX package, so face lists agree.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from invesalius3_tpu_torch.device import DEFAULT_DEVICE, as_tensor, resolve_device
from invesalius3_tpu_torch.ops.morphology import pad_const

# Cube corners, bit i at offset CUBE_OFFSETS[i] (z, y, x)
CUBE_OFFSETS = np.array(
    [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0),
     (1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0)], np.int64)

# 6 tetrahedra around the 0-6 body diagonal (each row: 4 cube-corner ids)
TETS = np.array([(0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
                 (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6)], np.int64)

# Tet edges: local corner pairs
TET_EDGES = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], np.int64)

# For each of 16 inside-bitmasks, up to 2 triangles of 3 edge ids (-1 unused)
_T = -1
TET_TRIS = np.array(
    [
        [[_T] * 3, [_T] * 3],                  # 0000
        [[0, 1, 2], [_T] * 3],                 # 0001 (v0 in)
        [[0, 3, 4], [_T] * 3],                 # 0010 (v1 in)
        [[1, 3, 4], [1, 4, 2]],                # 0011 (v0,v1)
        [[1, 3, 5], [_T] * 3],                 # 0100 (v2 in)
        [[0, 3, 5], [0, 5, 2]],                # 0101 (v0,v2)
        [[0, 1, 5], [0, 5, 4]],                # 0110 (v1,v2)
        [[2, 4, 5], [_T] * 3],                 # 0111 (v3 out)
        [[2, 4, 5], [_T] * 3],                 # 1000 (v3 in)
        [[0, 4, 5], [0, 5, 1]],                # 1001 (v0,v3)
        [[0, 3, 5], [0, 5, 2]],                # 1010 (v1,v3)
        [[1, 3, 5], [_T] * 3],                 # 1011 (v2 out)
        [[1, 3, 4], [1, 4, 2]],                # 1100 (v2,v3)
        [[0, 3, 4], [_T] * 3],                 # 1101 (v1 out)
        [[0, 1, 2], [_T] * 3],                 # 1110 (v0 out)
        [[_T] * 3, [_T] * 3],                  # 1111
    ],
    np.int8,
)

# triangles emitted per tet case
TET_TRI_COUNT = np.array([int(t[0][0] >= 0) + int(t[1][0] >= 0) for t in TET_TRIS],
                         np.int64)


@dataclasses.dataclass
class DeviceMesh:
    """A device-resident triangle mesh plus the dedup sort's byproducts,
    handed from marching to smoothing to the STL writer."""

    verts3v: torch.Tensor          # (3 xyz world mm, V) float32
    faces3t: torch.Tensor          # (3 corners, T) int32, outward winding
    inverse: torch.Tensor          # (3T,) corner -> vertex, corner-major
    order: torch.Tensor            # (3T,) corners sorted by vertex (stable)
    group_of_sorted: torch.Tensor  # (3T,) vertex id per sorted corner
    spacing: Tuple[float, float, float]
    vol_shape: Tuple[int, int, int]  # field shape the mesh came from
    origin_shift: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # world mm

    @property
    def n_verts(self) -> int:
        return int(self.verts3v.shape[1])

    @property
    def n_tris(self) -> int:
        return int(self.faces3t.shape[1])


def _materialize_tables(vol_shape):
    """Per-(tet, k, case, corner) lookup tables (see the JAX package's
    ``_materialize_tables``): geom packs endpoint ids, endpoint a's cube
    offset and b - a; keyoff is the lattice-edge key offset; cent packs the
    4 tet-corner offsets."""
    Z, Y, X = vol_shape
    off = CUBE_OFFSETS[:, 0] * (Y * X) + CUBE_OFFSETS[:, 1] * X + CUBE_OFFSETS[:, 2]
    geom = np.zeros((3, 192), np.int64)
    keyoff = np.zeros((3, 192), np.int64)
    for t in range(6):
        for k in range(2):
            for case_id in range(16):
                idx = t * 32 + k * 16 + case_id
                for c in range(3):
                    e = int(TET_TRIS[case_id][k][c])
                    if e < 0:
                        continue
                    ea, eb = (int(v) for v in TET_EDGES[e])
                    ca, cb = int(TETS[t][ea]), int(TETS[t][eb])
                    oa = CUBE_OFFSETS[ca]
                    dd = CUBE_OFFSETS[cb] - oa
                    code = abs(int(dd[2])) + 2 * abs(int(dd[1])) + 4 * abs(int(dd[0]))
                    keyoff[c, idx] = int(min(off[ca], off[cb])) * 8 + code
                    geom[c, idx] = (
                        ea | (eb << 2)
                        | (int(oa[0]) << 4) | (int(oa[1]) << 5) | (int(oa[2]) << 6)
                        | ((int(dd[0]) + 1) << 7) | ((int(dd[1]) + 1) << 9)
                        | ((int(dd[2]) + 1) << 11))
    cent = np.zeros((6,), np.int64)
    for t in range(6):
        v = 0
        for j in range(4):
            o = CUBE_OFFSETS[int(TETS[t][j])]
            v |= (int(o[0]) | (int(o[1]) << 1) | (int(o[2]) << 2)) << (3 * j)
        cent[t] = v
    return geom, keyoff, cent


def cell_corners(inside: torch.Tensor):
    """The eight (Z-1, Y-1, X-1) views of a boolean grid, one per cube
    corner in ``CUBE_OFFSETS`` order: corner i of cell (z, y, x)."""
    Z, Y, X = inside.shape
    return [inside[dz:dz + Z - 1, dy:dy + Y - 1, dx:dx + X - 1]
            for dz, dy, dx in CUBE_OFFSETS.tolist()]


def active_of(corners) -> torch.Tensor:
    """Cells whose corners are neither all inside nor all outside."""
    agg_any = agg_all = corners[0]
    for c in corners[1:]:
        agg_any = agg_any | c
        agg_all = agg_all & c
    return agg_any & ~agg_all


def triangles_of(corners) -> torch.Tensor:
    """uint8 triangles per cell: a tet with s inside corners emits
    min(s, 4 - s), so no case table is read."""
    total = None
    for tet in TETS.tolist():
        s = corners[tet[0]].to(torch.uint8)
        for j in tet[1:]:
            s = s + corners[j].to(torch.uint8)
        n = torch.minimum(s, 4 - s)
        total = n if total is None else total + n
    return total


def _inside(field: torch.Tensor, iso: float, iso_greater: bool) -> torch.Tensor:
    return field > iso if iso_greater else field < iso


def count_active_cells(field: torch.Tensor, iso: float,
                       iso_greater: bool = True) -> torch.Tensor:
    """Number of cells whose corners straddle the iso surface (a 0-d int64
    tensor on the field's device)."""
    return active_of(cell_corners(_inside(field, iso, iso_greater))).sum()


def count_cells_and_triangles(field: torch.Tensor, iso: float,
                              iso_greater: bool = True):
    """(active cells, triangles the extraction emits), 0-d int64 tensors."""
    corners = cell_corners(_inside(field, iso, iso_greater))
    return (active_of(corners).sum(),
            triangles_of(corners).sum(dtype=torch.int64))


def count_triangles(field: torch.Tensor, iso: float,
                    iso_greater: bool = True) -> torch.Tensor:
    return count_cells_and_triangles(field, iso, iso_greater)[1]


def _active_cells(field: torch.Tensor, iso: float):
    """(8, A) lattice ids of the corners of the cells whose corners
    straddle ``iso``, cells in ascending id order."""
    Z, Y, X = field.shape
    Zc, Yc, Xc = Z - 1, Y - 1, X - 1
    active = active_of(cell_corners(field > iso)).reshape(-1)
    cell_ids = torch.nonzero(active).squeeze(1)  # ascending
    cz = cell_ids // (Yc * Xc)
    rem = cell_ids % (Yc * Xc)
    cy = rem // Xc
    cx = rem % Xc
    corner_lin = torch.stack([(cz + dz) * (Y * X) + (cy + dy) * X + (cx + dx)
                              for dz, dy, dx in CUBE_OFFSETS.tolist()])
    return corner_lin


def _emit_slots(ins: torch.Tensor):
    """Per-tet case codes (6, A) and the ascending ids of the valid
    triangle slots, flat tet-major: slot = t * 2A + k * A + a."""
    dev = ins.device
    tet_in = ins[torch.as_tensor(TETS, device=dev)].to(torch.int64)  # (6,4,A)
    case = tet_in[:, 0] + 2 * tet_in[:, 1] + 4 * tet_in[:, 2] + 8 * tet_in[:, 3]
    n_per_tet = torch.as_tensor(TET_TRI_COUNT, device=dev)[case]  # (6, A)
    tri_valid = torch.arange(2, device=dev)[None, :, None] < n_per_tet[:, None, :]
    tri_slots = torch.nonzero(tri_valid.reshape(-1)).squeeze(1)
    return case, tri_slots


def _materialize(corner_lin, vals, case, tri_slots, iso: float, vol_shape):
    """Triangle corner coordinates (3 corners, 3 zyx, T) float32, outward
    wound, and lattice-edge keys (3, T): the JAX package's arithmetic in
    the same float32 operation order."""
    dev = vals.device
    geom_np, keyoff_np, cent_np = _materialize_tables(vol_shape)
    geom_t = torch.as_tensor(geom_np, device=dev)
    keyoff_t = torch.as_tensor(keyoff_np, device=dev)
    cent_t = torch.as_tensor(cent_np, device=dev)
    A = corner_lin.shape[1]
    case_f = case.reshape(-1)
    vals_f = vals.reshape(-1)
    t_idx = tri_slots // (2 * A)
    k_idx = (tri_slots // A) % 2
    a_idx = tri_slots % A

    tri_case = case_f[t_idx * A + a_idx]
    cell0 = corner_lin[0][a_idx]  # lattice id of the cell origin
    Z, Y, X = vol_shape
    cz = (cell0 // (Y * X)).to(torch.float32)
    rem = cell0 % (Y * X)
    cy = (rem // X).to(torch.float32)
    cx = (rem % X).to(torch.float32)

    cja_f = torch.as_tensor((TETS * A).reshape(-1), device=dev)  # (24,)
    vj = [vals_f[cja_f[t_idx * 4 + j] + a_idx] for j in range(4)]

    def sel4(code2, xs):
        lo = torch.where(code2 == 0, xs[0], xs[1])
        hi = torch.where(code2 == 2, xs[2], xs[3])
        return torch.where(code2 < 2, lo, hi)

    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    iso_t, half, one, zero = f32(iso), f32(0.5), f32(1.0), f32(0.0)
    idx_tk = t_idx * 32 + k_idx * 16 + tri_case
    pcs, lakeys = [], []
    for c in range(3):
        g = geom_t[c][idx_tk]
        fa = sel4(g & 3, vj)
        fb = sel4((g >> 2) & 3, vj)
        denom = fb - fa
        t = torch.where(denom == 0, half,
                        (iso_t - fa) / torch.where(denom == 0, one, denom))
        t = torch.clamp(t, 0.0, 1.0)
        pz = cz + ((g >> 4) & 1).to(torch.float32) + t * (((g >> 7) & 3) - 1).to(torch.float32)
        py = cy + ((g >> 5) & 1).to(torch.float32) + t * (((g >> 9) & 3) - 1).to(torch.float32)
        px = cx + ((g >> 6) & 1).to(torch.float32) + t * (((g >> 11) & 3) - 1).to(torch.float32)
        pcs.append((pz, py, px))
        lakeys.append(cell0 * 8 + keyoff_t[c][idx_tk])

    # inside-corner centroid of the tet
    cb_ = cent_t[t_idx]
    czs = cys = cxs = wsum = None
    for j in range(4):
        wj = (vj[j] > iso_t).to(torch.float32)
        z_ = ((cb_ >> (3 * j)) & 1).to(torch.float32) * wj
        y_ = ((cb_ >> (3 * j + 1)) & 1).to(torch.float32) * wj
        x_ = ((cb_ >> (3 * j + 2)) & 1).to(torch.float32) * wj
        if czs is None:
            czs, cys, cxs, wsum = z_, y_, x_, wj
        else:
            czs, cys, cxs, wsum = czs + z_, cys + y_, cxs + x_, wsum + wj
    wsum = torch.clamp(wsum, min=1.0)
    icz = cz + czs / wsum
    icy = cy + cys / wsum
    icx = cx + cxs / wsum

    (p0z, p0y, p0x), (p1z, p1y, p1x), (p2z, p2y, p2x) = pcs
    e1z, e1y, e1x = p1z - p0z, p1y - p0y, p1x - p0x
    e2z, e2y, e2x = p2z - p0z, p2y - p0y, p2x - p0x
    nz = e1y * e2x - e1x * e2y
    ny = e1x * e2z - e1z * e2x
    nx = e1z * e2y - e1y * e2z
    three = f32(3.0)
    tcz = (p0z + p1z + p2z) / three
    tcy = (p0y + p1y + p2y) / three
    tcx = (p0x + p1x + p2x) / three
    outward = nz * (tcz - icz) + ny * (tcy - icy) + nx * (tcx - icx) >= zero

    # inward triangles swap corners 1 and 2
    out_p = [pcs[0],
             [torch.where(outward, a, b) for a, b in zip(pcs[1], pcs[2])],
             [torch.where(outward, a, b) for a, b in zip(pcs[2], pcs[1])]]
    out_k = [lakeys[0],
             torch.where(outward, lakeys[1], lakeys[2]),
             torch.where(outward, lakeys[2], lakeys[1])]
    pts = torch.stack([torch.stack(list(corner)) for corner in out_p])
    keys = torch.stack(out_k)
    return pts, keys


def _mul_add_f32(v: torch.Tensor, scale: float, shift: float) -> torch.Tensor:
    """v * scale + shift in float32 with ONE rounding, as the JAX package's
    compiled transform (a fused multiply-add) gives.  The float64 sum is
    exact here (v holds multiples of 1/2 below 2^10, and scale and shift
    are float32), so rounding it once to float32 is the fused result."""
    s32, o32 = float(np.float32(scale)), float(np.float32(shift))
    return (v.to(torch.float64) * s32 + o32).to(torch.float32)


def _dedup_structure(keys: torch.Tensor):
    """Shared-vertex dedup by lattice-edge key: (inverse corner -> vertex,
    order, group_of_sorted, starts).  The sort is stable, so each vertex's
    representative is its first corner in corner-major order."""
    ks, order = torch.sort(keys, stable=True)
    new_group = torch.ones_like(ks, dtype=torch.bool)
    new_group[1:] = ks[1:] != ks[:-1]
    group_of_sorted = torch.cumsum(new_group, 0) - 1
    inverse = torch.empty_like(group_of_sorted)
    inverse[order] = group_of_sorted  # permutation inverse: no collisions
    starts = torch.nonzero(new_group).squeeze(1)
    return inverse, order, group_of_sorted, starts


def marching_cubes_device(
    field: torch.Tensor,
    iso: float,
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    origin_shift: Tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> DeviceMesh:
    """Isosurface of ``field`` at ``iso`` (inside = field > iso), on the
    field's device; vertices in world mm (x, y, z)."""
    if 8 * field.numel() >= 2**31:
        raise ValueError("volume too large for int32 lattice-edge keys "
                         "(> ~640^3)")
    vol_shape = tuple(int(s) for s in field.shape)
    corner_lin = _active_cells(field, iso)
    vals_native = field.reshape(-1)[corner_lin]  # (8, A) input dtype
    ins = vals_native > iso
    case, tri_slots = _emit_slots(ins)
    pts, keys = _materialize(corner_lin, vals_native.to(torch.float32), case,
                             tri_slots, float(iso), vol_shape)
    del corner_lin, vals_native, ins, case, tri_slots

    T = pts.shape[2]
    pts_m = pts.transpose(0, 1).reshape(3, 3 * T)  # (3 zyx, M) corner-major
    inverse, order, group_of_sorted, starts = _dedup_structure(keys.reshape(-1))
    verts_zyx = pts_m[:, order[starts]]
    sx, sy, sz = spacing
    ox, oy, oz = origin_shift
    # voxel (z, y, x) -> world (x, y, z); the axis swap mirrors space, so
    # the winding flips (corner order reversed)
    verts3v = torch.stack([_mul_add_f32(verts_zyx[2], sx, ox),
                           _mul_add_f32(verts_zyx[1], sy, oy),
                           _mul_add_f32(verts_zyx[0], sz, oz)])
    faces3t = inverse.reshape(3, T).flip(0).to(torch.int32).contiguous()
    return DeviceMesh(
        verts3v=verts3v, faces3t=faces3t, inverse=inverse, order=order,
        group_of_sorted=group_of_sorted, spacing=tuple(spacing),
        vol_shape=vol_shape, origin_shift=tuple(origin_shift))


def mask_to_surface_device(mask: torch.Tensor,
                           spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
                           ) -> DeviceMesh:
    """Surface of a visible mask (>= 127), padded by one empty voxel layer
    so border-touching masks still close (reference surface_process.py:52);
    the pad offset is folded into the world transform."""
    vis = (mask >= 127).to(torch.uint8)
    vis = pad_const(vis, [(1, 1)] * 3, 0)
    sx, sy, sz = spacing
    return marching_cubes_device(vis, 0.5, spacing, origin_shift=(-sx, -sy, -sz))


def mesh_to_host(dm: DeviceMesh, fp16: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(verts (V, 3) float32 world mm, faces (F, 3) int32) on the host.
    With ``fp16`` the vertices are rounded through float16 on the device
    first, as the JAX package's packed transfer does (its ulp at 256 mm is
    0.125 mm); without it they keep their float32 values."""
    v = dm.verts3v.to(torch.float16).to(torch.float32) if fp16 else dm.verts3v
    verts = v.t().contiguous()
    faces = dm.faces3t.t().contiguous()
    return verts.cpu().numpy(), faces.cpu().numpy()


def marching_cubes(field, iso: float,
                   spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                   device=DEFAULT_DEVICE) -> Tuple[np.ndarray, np.ndarray]:
    """Host-array variant of ``marching_cubes_device`` on ``device`` (the
    card unless the caller passes "cpu"): (vertices (V, 3) float32 world mm
    (x, y, z), faces (F, 3) int32), the vertices not rounded."""
    dm = marching_cubes_device(as_tensor(field, resolve_device(device)), iso, spacing)
    return mesh_to_host(dm, fp16=False)


def mask_to_surface(mask, spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                    device=DEFAULT_DEVICE) -> Tuple[np.ndarray, np.ndarray]:
    """Host-array variant of ``mask_to_surface_device`` on ``device``, the
    vertices not rounded."""
    dm = mask_to_surface_device(as_tensor(mask, resolve_device(device)), spacing)
    return mesh_to_host(dm, fp16=False)
