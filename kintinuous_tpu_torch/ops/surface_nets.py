"""Surface-nets meshing of the TSDF volume (port of
kintinuous_tpu/ops/surface_nets.py).

Naive surface nets: one vertex per sign-changed cell (the mean of its
edge crossings), one quad (two triangles) per sign-changed interior
edge. Corners are voxel centres; a cell is the cube between 8 adjacent
voxel centres; cells and edges on the sub-box border are dropped. Every
vertex carries its global integer cell, so band patches weld by cell
identity (backend/meshing.weld_patches).

Vertices and faces are compacted in row-major order into fixed-capacity
buffers with the counts kept on the device, so meshing a band inside
the tracker step reads nothing on the host. The compaction is the
mask -> inclusive cumsum of ops/extract.py, read back with a
`searchsorted` of each output slot's rank: slot k takes the first
element whose running count reaches k+1. Only the selected cells and
edges are gathered, so a whole 512^3 volume needs no buffer of all its
edges' faces (about 800 million triangles' worth of candidates). Past
capacity, entries are dropped as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from kintinuous_tpu_torch.ops.tsdf import VolumeState, unpack_cw


class MeshResult(NamedTuple):
    vertices: torch.Tensor  # (vcap,3) f32 global metres
    colors: torch.Tensor  # (vcap,3) f32 RGB 0..255
    faces: torch.Tensor  # (fcap,3) i32 indices into vertices
    n_vertices: torch.Tensor  # () i32
    n_faces: torch.Tensor  # () i32
    cells: torch.Tensor = None  # (vcap,3) i32 global integer cell [x,y,z]


def _rank_lookup(csum: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Index of the element whose inclusive running count first reaches
    rank (1-based), clamped into range for ranks past the total."""
    idx = torch.searchsorted(csum, rank.to(csum.dtype))
    return torch.clamp(idx, max=csum.numel() - 1)


def _unravel(flat: torch.Tensor, shape) -> Tuple[torch.Tensor, ...]:
    _, s1, s2 = shape
    return flat // (s1 * s2), (flat // s2) % s1, flat % s2


def _box(arr: torch.Tensor, lo, n) -> torch.Tensor:
    """arr (Z,Y,X) edge-padded by one at the + side, then the (n_z,n_y,
    n_x) box at lo [x,y,z] (start clamped so the box fits, as
    dynamic_slice does)."""
    out = arr
    for dim, ax in ((0, 2), (1, 1), (2, 0)):
        size = arr.shape[dim]
        start = min(max(int(lo[ax]), 0), size + 1 - n[ax])
        idx = torch.clamp(torch.arange(start, start + n[ax], device=arr.device),
                          max=size - 1)
        out = out.index_select(dim, idx)
    return out


def extract_mesh(vol: VolumeState, lo, size, voxel_size: float,
                 vertex_capacity: int, face_capacity: int,
                 min_weight: float = 1.0, clamp_edges: bool = False,
                 coord_offset: Optional[Tuple[int, int, int]] = None) -> MeshResult:
    """vol.tsdf may be a non-cubic [z,y,x] band slab. lo, size and
    coord_offset are host ints [x,y,z]. clamp_edges: the box's corners
    are edge-padded at the array's + edge instead of wrapping;
    coord_offset shifts the emitted coordinates by the slab's offset."""
    Rz, Ry, Rx = vol.tsdf.shape
    dev = vol.tsdf.device
    sx, sy, sz = (int(s) for s in size)
    lo = [int(v) for v in lo]
    co = [0, 0, 0] if coord_offset is None else [int(v) for v in coord_offset]
    n_corner = (sx + 1, sy + 1, sz + 1)

    if clamp_edges:
        t = _box(vol.tsdf, lo, n_corner)
        cw = _box(vol.cw, lo, n_corner)
    else:
        def phys(axis, R):
            logical = (lo[axis] + torch.arange(n_corner[axis], device=dev)) % R
            return (logical + vol.wrap[axis].long()) % R

        px, py, pz = phys(0, Rx), phys(1, Ry), phys(2, Rz)

        def gather(arr):
            return arr.index_select(0, pz).index_select(1, py).index_select(2, px)

        t, cw = gather(vol.tsdf), gather(vol.cw)
    w, cr, cg, cb = unpack_cw(cw)
    del cw
    obs = w >= min_weight
    del w

    def corner(axis, n):
        return (co[axis] + lo[axis] + torch.arange(n, device=dev)).to(torch.float32) + 0.5

    cx, cy, cz = corner(0, sx + 1), corner(1, sy + 1), corner(2, sz + 1)

    def edges(axis):
        """Crossing mask, crossing fraction, and direction (t0 > 0) of
        every grid edge along axis."""
        sl0 = [slice(None)] * 3
        sl1 = [slice(None)] * 3
        d = 2 - axis
        sl0[d], sl1[d] = slice(None, -1), slice(1, None)
        t0, t1 = t[tuple(sl0)], t[tuple(sl1)]
        o0, o1 = obs[tuple(sl0)], obs[tuple(sl1)]
        cross = o0 & o1 & (((t0 > 0) & (t1 < 0)) | ((t0 < 0) & (t1 > 0)))
        denom = t0 - t1
        dt = torch.clamp(torch.where(torch.abs(denom) > 1e-12, t0 / denom, 0.5), 0.0, 1.0)
        return cross, dt, t0 > 0

    mx, dx_, sxp = edges(0)  # (sz+1, sy+1, sx)
    my, dy_, syp = edges(1)  # (sz+1, sy, sx+1)
    mz, dz_, szp = edges(2)  # (sz, sy+1, sx+1)
    del obs

    def cell_sum(arr, axis):
        """Sum the 4 edges of each cell along axis (arr on the edge grid)."""
        if axis == 0:
            return arr[:-1, :-1, :] + arr[:-1, 1:, :] + arr[1:, :-1, :] + arr[1:, 1:, :]
        if axis == 1:
            return arr[:-1, :, :-1] + arr[:-1, :, 1:] + arr[1:, :, :-1] + arr[1:, :, 1:]
        return arr[:, :-1, :-1] + arr[:, :-1, 1:] + arr[:, 1:, :-1] + arr[:, 1:, 1:]

    mxf, myf, mzf = (m.to(torch.float32) for m in (mx, my, mz))
    cnt = cell_sum(mxf, 0) + cell_sum(myf, 1) + cell_sum(mzf, 2)  # (sz,sy,sx)
    has_vert = cnt > 0

    # crossing positions per edge, summed per cell
    ex_x = cx[None, None, :-1] + dx_
    ey_y = cy[None, :-1, None] + dy_
    ez_z = cz[:-1, None, None] + dz_
    del dx_, dy_, dz_
    vx = (cell_sum(ex_x * mxf, 0) + cell_sum(cx[None, None, :] * myf, 1)
          + cell_sum(cx[None, None, :] * mzf, 2))
    vy = (cell_sum(cy[None, :, None] * mxf, 0) + cell_sum(ey_y * myf, 1)
          + cell_sum(cy[None, :, None] * mzf, 2))
    vz = (cell_sum(cz[:, None, None] * mxf, 0) + cell_sum(cz[:, None, None] * myf, 1)
          + cell_sum(ez_z * mzf, 2))
    del ex_x, ey_y, ez_z, mxf, myf, mzf
    denom = torch.clamp(cnt, min=1.0)

    # --- vertex compaction ------------------------------------------------
    grid = (sz, sy, sx)
    vcsum = torch.cumsum(has_vert.reshape(-1), 0, dtype=torch.int32)
    n_vertices = torch.clamp(vcsum[-1], max=vertex_capacity).to(torch.int32)
    slot = torch.arange(vertex_capacity, device=dev)
    vvalid = slot < n_vertices
    k, j, i = _unravel(_rank_lookup(vcsum, slot + 1), grid)

    origin = vol.origin
    # elementwise, so computed at the selected cells only
    vertices = torch.stack([
        torch.where(vvalid, v[k, j, i] / denom[k, j, i] * voxel_size + origin[a], 0.0)
        for a, v in enumerate((vx, vy, vz))
    ], dim=-1)
    colors = torch.stack([torch.where(vvalid, c[k, j, i], 0.0) for c in (cr, cg, cb)],
                         dim=-1)
    # global integer cell: the origin is a whole number of voxels
    oi = torch.round(origin / voxel_size).to(torch.int32)
    cells = torch.stack([
        torch.where(vvalid, oi[a] + co[a] + lo[a] + idx.to(torch.int32), 0)
        for a, idx in ((0, i), (1, j), (2, k))
    ], dim=-1)
    vid_grid = torch.where(has_vert, vcsum.reshape(grid) - 1, -1)
    del vx, vy, vz, denom, cnt, vcsum, cr, cg, cb

    # --- faces: one quad per sign-changed interior edge ---------------------
    def quads(axis):
        """(ok mask, positive, corner cells c00, c01, c11, c10) of the
        interior edges along axis, as views of the cell grid."""
        if axis == 0:
            m, pos = mx[1:-1, 1:-1, :], sxp[1:-1, 1:-1, :]
            c = (vid_grid[:-1, :-1, :], vid_grid[:-1, 1:, :],
                 vid_grid[1:, 1:, :], vid_grid[1:, :-1, :])
        elif axis == 1:
            m, pos = my[1:-1, :, 1:-1], syp[1:-1, :, 1:-1]
            c = (vid_grid[:-1, :, :-1], vid_grid[1:, :, :-1],  # swapped: winding
                 vid_grid[1:, :, 1:], vid_grid[:-1, :, 1:])
        else:
            m, pos = mz[:, 1:-1, 1:-1], szp[:, 1:-1, 1:-1]
            c = (vid_grid[:, :-1, :-1], vid_grid[:, :-1, 1:],
                 vid_grid[:, 1:, 1:], vid_grid[:, 1:, :-1])
        ok = m & (c[0] >= 0) & (c[1] >= 0) & (c[2] >= 0) & (c[3] >= 0)
        return ok, pos, c

    # the candidate triangles in the JAX package's order: for each axis
    # its first triangles, then its second ones
    fslot = torch.arange(face_capacity, device=dev)
    faces = torch.zeros((face_capacity, 3), dtype=torch.int32, device=dev)
    start = torch.zeros((), dtype=torch.int64, device=dev)
    for axis in range(3):
        ok, pos, c = quads(axis)
        if ok.numel() == 0:
            continue
        csum = torch.cumsum(ok.reshape(-1), 0, dtype=torch.int32)
        n_ok = csum[-1].to(torch.int64)
        del ok
        second = fslot >= start + n_ok
        rank = torch.where(second, fslot - start - n_ok, fslot - start)
        zz, yy, xx = _unravel(_rank_lookup(csum, rank + 1), pos.shape)
        del csum
        a, b, cc, d = (ci[zz, yy, xx] for ci in c)
        p = pos[zz, yy, xx]
        # winding flips with crossing direction:
        # tri1 = (a,b,c) | (a,c,b);  tri2 = (a,c,d) | (a,d,c)
        f1 = torch.where(second, torch.where(p, cc, d), torch.where(p, b, cc))
        f2 = torch.where(second, torch.where(p, d, cc), torch.where(p, cc, b))
        mine = (fslot >= start) & (fslot < start + 2 * n_ok)
        faces = torch.where(mine[:, None], torch.stack([a, f1, f2], dim=-1), faces)
        start = start + 2 * n_ok
    n_faces = torch.clamp(start, max=face_capacity).to(torch.int32)
    faces = torch.where((fslot < n_faces)[:, None], faces, 0)
    return MeshResult(vertices=vertices, colors=colors, faces=faces,
                      n_vertices=n_vertices, n_faces=n_faces, cells=cells)
