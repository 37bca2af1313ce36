# Frozen copy of kintinuous_tpu_torch/ops/extract.py, the benchmark's plain
# reference: imports point into this package, and it is never updated
# to follow the program, which it judges.
"""Cloud-slice extraction from the volume (port of
kintinuous_tpu/ops/extract.py: PackedExtract, extract_points_packed,
extract_points).

A voxel whose tsdf changes sign toward its +x, +y or +z neighbour (both
observed) emits ONE point: its centre plus the mean of its crossing-axis
interpolants, in global metres, with its colour and weight. Points are
compacted in row-major voxel order into a fixed-capacity buffer by a
cumsum scatter, with the count kept on the device, so extraction reads
nothing on the host. The JAX package's row-level two-stage compaction
for big boxes gives the same output and exists because a scatter is
costly on the TPU; it is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from slambench.reference.tsdf import VolumeState, unpack_cw


class ExtractResult(NamedTuple):
    points: torch.Tensor  # (cap,3) f32 global metres [x,y,z]
    colors: torch.Tensor  # (cap,3) f32 RGB 0..255
    weights: torch.Tensor  # (cap,) f32
    count: torch.Tensor  # () i32


class PackedExtract(NamedTuple):
    """Columns [x, y, z, r, g, b, w, 0]."""

    vals: torch.Tensor  # (cap, 8) f32
    count: torch.Tensor  # () i32


def _crossing(t0, t1, w0, w1, min_weight):
    cross = (w0 >= min_weight) & (w1 >= min_weight) & (
        ((t0 > 0) & (t1 < 0)) | ((t0 < 0) & (t1 > 0))
    )
    denom = t0 - t1
    safe = torch.where(torch.abs(denom) > 1e-12, denom, 1.0)
    dt = torch.where(torch.abs(denom) > 1e-12, t0 / safe, 0.5)
    return cross, torch.clamp(dt, 0.0, 1.0)


def _extract_packed(vol: VolumeState, lo: Tuple[int, int, int],
                    size: Tuple[int, int, int], voxel_size: float,
                    capacity: int, min_weight: float = 1.0,
                    clamp_edges: bool = False,
                    coord_offset: Tuple[int, int, int] = (0, 0, 0)) -> PackedExtract:
    """vol.tsdf may be a non-cubic [z,y,x] band slab. lo/size/coord_offset
    are host ints [x,y,z] (the tracker knows the shift on the host).
    clamp_edges=True: the box is taken as is and a neighbour past its +
    edge is the box's own plane (no crossing), except along dim 0 where
    the next plane of the slab is used when it exists."""
    Rz, Ry, Rx = vol.tsdf.shape
    dev = vol.tsdf.device
    sx, sy, sz = (int(s) for s in size)
    lo = [int(v) for v in lo]

    if clamp_edges:
        def box(arr):
            return arr[lo[2]:lo[2] + sz, lo[1]:lo[1] + sy, lo[0]:lo[0] + sx]

        top = min(max(lo[2] + sz, 0), Rz - 1)  # dynamic_slice clamps the start

        def top_nb(arr):
            return arr[top:top + 1, lo[1]:lo[1] + sy, lo[0]:lo[0] + sx]

        t0 = box(vol.tsdf)
        w0, cr0, cg0, cb0 = unpack_cw(box(vol.cw))
        t_top = top_nb(vol.tsdf)
        w_top = unpack_cw(top_nb(vol.cw))[0]

        def shifted(a, dim, tail=None):
            hi = a.narrow(dim, 1, a.shape[dim] - 1)
            if tail is None:
                tail = a.narrow(dim, a.shape[dim] - 1, 1)
            return torch.cat([hi, tail], dim=dim)

        cx_mask, cx_dt = _crossing(t0, shifted(t0, 2), w0, shifted(w0, 2), min_weight)
        cy_mask, cy_dt = _crossing(t0, shifted(t0, 1), w0, shifted(w0, 1), min_weight)
        cz_mask, cz_dt = _crossing(
            t0, shifted(t0, 0, t_top), w0, shifted(w0, 0, w_top), min_weight
        )
        gx = torch.arange(sx, device=dev) + lo[0]
        gy = torch.arange(sy, device=dev) + lo[1]
        gz = torch.arange(sz, device=dev) + lo[2]
        gx = torch.clamp(gx, 0, Rx - 1)
        gy = torch.clamp(gy, 0, Ry - 1)
        gz = torch.clamp(gz, 0, Rz - 1)
    else:
        def phys(axis, n, R):
            logical = (lo[axis] + torch.arange(n, device=dev)) % R
            return (logical + vol.wrap[axis].long()) % R, logical

        px, gx = phys(0, sx + 1, Rx)
        py, gy = phys(1, sy + 1, Ry)
        pz, gz = phys(2, sz + 1, Rz)

        def gather(arr):
            return arr[pz[:, None, None], py[None, :, None], px[None, None, :]]

        t = gather(vol.tsdf)
        w, cr, cg, cb = unpack_cw(gather(vol.cw))
        t0 = t[:sz, :sy, :sx]
        w0 = w[:sz, :sy, :sx]
        cr0, cg0, cb0 = cr[:sz, :sy, :sx], cg[:sz, :sy, :sx], cb[:sz, :sy, :sx]
        cx_mask, cx_dt = _crossing(t0, t[:sz, :sy, 1:], w0, w[:sz, :sy, 1:], min_weight)
        cy_mask, cy_dt = _crossing(t0, t[:sz, 1:, :sx], w0, w[:sz, 1:, :sx], min_weight)
        cz_mask, cz_dt = _crossing(t0, t[1:, :sy, :sx], w0, w[1:, :sy, :sx], min_weight)
        # the +neighbour of the last plane of a full-extent box wraps
        if sx == Rx:
            cx_mask = cx_mask & (torch.arange(sx, device=dev) < sx - 1)[None, None, :]
        if sy == Ry:
            cy_mask = cy_mask & (torch.arange(sy, device=dev) < sy - 1)[None, :, None]
        if sz == Rz:
            cz_mask = cz_mask & (torch.arange(sz, device=dev) < sz - 1)[:, None, None]
        gx, gy, gz = gx[:sx], gy[:sy], gz[:sz]

    any_cross = cx_mask | cy_mask | cz_mask
    n_cross = (cx_mask.to(torch.float32) + cy_mask.to(torch.float32)
               + cz_mask.to(torch.float32))
    denom = torch.clamp(n_cross, min=1.0)
    base_x = (gx + coord_offset[0]).to(torch.float32)[None, None, :] + 0.5
    base_y = (gy + coord_offset[1]).to(torch.float32)[None, :, None] + 0.5
    base_z = (gz + coord_offset[2]).to(torch.float32)[:, None, None] + 0.5
    px_g = (base_x + torch.where(cx_mask, cx_dt, 0.0) / denom) * voxel_size + vol.origin[0]
    py_g = (base_y + torch.where(cy_mask, cy_dt, 0.0) / denom) * voxel_size + vol.origin[1]
    pz_g = (base_z + torch.where(cz_mask, cz_dt, 0.0) / denom) * voxel_size + vol.origin[2]
    planes = (px_g, py_g, pz_g, cr0, cg0, cb0, w0)
    return _compact_flat(any_cross, planes, capacity)


def _compact_flat(any_cross: torch.Tensor, planes, capacity: int) -> PackedExtract:
    """Row-major compaction of the set voxels into (capacity, 8)."""
    dev = any_cross.device
    mask = any_cross.reshape(-1)
    n = mask.numel()
    idx = torch.cumsum(mask.to(torch.int32), 0) - 1
    dest = torch.where(mask & (idx < capacity), idx, capacity)
    count = torch.clamp(mask.sum(), max=capacity).to(torch.int32)
    src = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    src.scatter_(0, dest.long(), torch.arange(n, device=dev))
    src = src[:capacity]
    valid = torch.arange(capacity, device=dev) < count
    vals = torch.stack(
        [torch.where(valid, p.expand(any_cross.shape).reshape(-1)[src], 0.0)
         for p in planes],
        dim=-1,
    )
    vals = torch.cat([vals, torch.zeros((capacity, 1), device=dev)], dim=1)
    return PackedExtract(vals=vals, count=count)


def extract_points_packed(*args, **kwargs) -> PackedExtract:
    return _extract_packed(*args, **kwargs)


def extract_points(*args, **kwargs) -> ExtractResult:
    p = _extract_packed(*args, **kwargs)
    return ExtractResult(points=p.vals[:, 0:3], colors=p.vals[:, 3:6],
                         weights=p.vals[:, 6], count=p.count)
