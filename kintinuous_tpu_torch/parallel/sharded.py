"""The z-slab sharded dense step (port of
kintinuous_tpu/parallel/sharded.py: ShardedTrackerState,
ShardedStepOutputs, make_sharded_state, _slab_trilinear, _halo_extend,
_empty_extract, extract_slab, _raycast_slab, make_sharded_step and
make_sharded_extract).

The dense (R,R,R) [z,y,x] volume is split into n z-slabs of R/n planes
over a SlabMesh (parallel/mesh.py); slab i lives on mesh.devices[i] as
its own tensors. Per frame, as in the JAX package:

- preprocessing runs once, replicated on the mesh's home device;
- odometry shards pixel ROWS: each slab builds its rows' 6x6 systems,
  the mesh sums them, and the one solve runs on home
  (ops/reduce.icp_solve_level(reduce=...)); the fused ICP + RGB-D mode
  (-r / -ri) builds both systems per slab with the photometric sigma
  summed first;
- the shift's band extraction is slab-local: each slab emits the
  zero-crossings whose base voxel's physical z-plane it owns, with the
  next slab's first plane as its +z halo, into a buffer of its own;
  with meshing on, the departing band's box is assembled from the
  slabs' owned planes and meshed once;
- the recycled bands are cleared slab by slab, and wrap, origin and pose
  move as on one device;
- integration is slab-local (`integrate(z_phys_offset=...)`);
- the raycast is slab-local too (`slab_raycast`, the default): every
  slab marches every ray over its planes plus ring-neighbour halos and
  claims the crossings whose leading sample it owns; the first hits
  meet in a pmin and the winner's attributes in a psum. With
  slab_raycast=False the slabs are gathered and the whole volume is
  raycast (the JAX package's all-gather baseline).

The shift is read on the host once a frame, with the wrap, as the
single-device step reads it: the JAX package's `lax.cond`s become
Python `if`s, and a slab's extraction gathers only the planes it owns.
Everything is plain PyTorch: the JAX sharded dense step reaches no
Pallas kernel.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from kintinuous_tpu_torch.config import CameraIntrinsics, KintinuousConfig
from kintinuous_tpu_torch.geometry import se3
from kintinuous_tpu_torch.ops import preprocess as pp
from kintinuous_tpu_torch.ops.extract import PackedExtract, _compact_flat, _crossing
from kintinuous_tpu_torch.ops.raycast import RaycastResult, _ray_box, raycast
from kintinuous_tpu_torch.ops.reduce import (
    gn_update, icp_solve_level, icp_step, pack_maps, round_to_int, sum_systems)
from kintinuous_tpu_torch.ops.rgbd import (
    MIN_GRAD2, build_rgbd_pyramid, pack_prev_texture, rgb_system)
from kintinuous_tpu_torch.ops.surface_nets import extract_mesh
from kintinuous_tpu_torch.ops.tsdf import (
    VolumeState, integrate, trilinear_gradient, unpack_cw)
from kintinuous_tpu_torch.parallel.mesh import SlabMesh
from kintinuous_tpu_torch.tracking.odometry import build_map_pyramid, pyramid_from_maps
from kintinuous_tpu_torch.tracking.tracker import preprocess_frame


class ShardedTrackerState(NamedTuple):
    vol: VolumeState  # tsdf, cw: tuples of per-slab tensors; wrap, origin on home
    pose: torch.Tensor  # (4,4) on home
    pred_vmap: torch.Tensor  # (3,H,W) on home
    pred_nmap: torch.Tensor
    pred_pose: torch.Tensor
    frame: torch.Tensor
    rgbd: object = None  # previous frame's RGB-D pyramid on home (-r / -ri)


class ShardedStepOutputs(NamedTuple):
    """Per-frame outputs of a sharded step. `slices` holds, per axis,
    None when that axis held still, else one PackedExtract per slab
    (its own buffer and count; the host concatenates the prefixes)."""

    pose_global: torch.Tensor  # (4,4)
    shift: torch.Tensor  # (3,) i32
    slices: Tuple
    icp_count: torch.Tensor  # () f32
    icp_residual: torch.Tensor  # () f32
    raycast_fallback: torch.Tensor = 0.0  # () f32 (the dense step's is 0)
    mesh_patches: Tuple = ()  # per axis: MeshResult or None (meshing on)


def slab_planes(cfg: KintinuousConfig, mesh: SlabMesh) -> int:
    R = cfg.volume_resolution
    if R % mesh.n:
        raise ValueError("the volume resolution must divide across the mesh")
    return R // mesh.n


def _init_rgbd(cfg: KintinuousConfig, h: int, w: int, levels: int, device):
    if not (cfg.rgbd_odometry or cfg.icp_plus_rgbd):
        return None
    zero = torch.zeros((h, w), dtype=torch.float32, device=device)
    return build_rgbd_pyramid(zero, zero, levels)


def _initial_pose(cfg: KintinuousConfig, device) -> torch.Tensor:
    pose = torch.eye(4, dtype=torch.float32, device=device)
    pose[:3, 3] = cfg.volume_size / 2.0
    return pose


def make_sharded_state(cfg: KintinuousConfig, mesh: SlabMesh) -> ShardedTrackerState:
    """An empty dense volume in z-slabs, the camera at its centre, NaN
    predictions."""
    R = cfg.volume_resolution
    slab = slab_planes(cfg, mesh)
    H, W = cfg.camera.height, cfg.camera.width
    home = mesh.home
    pose = _initial_pose(cfg, home)
    vol = VolumeState(
        tsdf=tuple(torch.zeros((slab, R, R), dtype=torch.float32, device=d)
                   for d in mesh.devices),
        cw=tuple(torch.zeros((slab, R, R), dtype=torch.int32, device=d)
                 for d in mesh.devices),
        wrap=torch.zeros(3, dtype=torch.int32, device=home),
        origin=torch.zeros(3, dtype=torch.float32, device=home),
    )
    return ShardedTrackerState(
        vol=vol, pose=pose,
        pred_vmap=torch.full((3, H, W), torch.nan, device=home),
        pred_nmap=torch.full((3, H, W), torch.nan, device=home),
        pred_pose=pose.clone(), frame=torch.zeros((), dtype=torch.int32, device=home),
        rgbd=_init_rgbd(cfg, H, W, cfg.pyramid_levels, home),
    )


# ------------------------------------------------------------- sampling
def _slab_trilinear(arr_h, wrap, idx, slab: int, halo: int, R: int, pos_vox):
    """Trilinear samples against halo-extended z-slabs, several slabs of
    one device at once.

    arr_h: (g, halo + slab + halo, R, R), slab idx[k]'s physical planes
    [idx[k]*slab - halo, idx[k]*slab + slab + halo) mod R in row k; idx
    (g,) i32; pos_vox (...,3), the same for every slab. Returns (val
    (g,...), corners (g,...,8), frac (...,3), own (g,...)) where `own`
    marks the samples whose base z-plane slab idx[k] owns (each sample
    has one owner). Elementwise, so each slab's values are the ones it
    would get alone."""
    base = torch.floor(pos_vox).to(torch.int32)
    frac = pos_vox - base.to(torch.float32)
    g, nloc = arr_h.shape[0], arr_h.shape[1]
    flat = arr_h.reshape(-1)
    expand = (g,) + (1,) * (pos_vox.dim() - 1)
    idx = idx.reshape(expand)
    slab_row = torch.arange(g, dtype=torch.int32, device=arr_h.device).reshape(expand) * nloc
    pz0 = torch.remainder(base[..., 2] + wrap[2], R)
    lz0 = torch.remainder(pz0 - idx * slab + halo, R)
    own = (lz0 >= halo) & (lz0 < halo + slab)
    reachable = lz0 < nloc - 1

    def corner(cx, cy, cz):
        ix = torch.remainder(base[..., 0] + cx + wrap[0], R)
        iy = torch.remainder(base[..., 1] + cy + wrap[1], R)
        lz = torch.clamp(lz0 + cz, 0, nloc - 1) + slab_row
        return flat[((lz * R + iy) * R + ix).long()]

    c = [corner(k & 1, (k >> 1) & 1, (k >> 2) & 1) for k in range(8)]
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    c00 = c[0] * (1 - fx) + c[1] * fx
    c10 = c[2] * (1 - fx) + c[3] * fx
    c01 = c[4] * (1 - fx) + c[5] * fx
    c11 = c[6] * (1 - fx) + c[7] * fx
    val = (c00 * (1 - fy) + c10 * fy) * (1 - fz) + (c01 * (1 - fy) + c11 * fy) * fz
    return val, torch.stack(c, dim=-1), frac, own & reachable


def _halo_extend(mesh: SlabMesh, slabs: Sequence[torch.Tensor], halo: int):
    """Each (slab,R,R) slab -> (halo+slab+halo,R,R) with its ring
    neighbours' boundary planes: two ppermutes per array."""
    hi = mesh.ppermute_from_next([s[:halo] for s in slabs])
    lo = mesh.ppermute_from_prev([s[-halo:] for s in slabs])
    return [torch.cat([a, s, b], dim=0) for a, s, b in zip(lo, slabs, hi)]


def _empty_extract(capacity: int, device) -> PackedExtract:
    return PackedExtract(vals=torch.zeros((capacity, 8), device=device),
                         count=torch.zeros((), dtype=torch.int32, device=device))


def extract_slab(tsdf_h: torch.Tensor, cw_h: torch.Tensor, wrap: Sequence[int],
                 origin: torch.Tensor, lo: Sequence[int], size: Sequence[int],
                 voxel_size: float, capacity: int, idx: int, slab: int, R: int,
                 min_weight: float = 1.0, clamp_edges: bool = False) -> PackedExtract:
    """Slab-local band extraction (JAX extract_slab): the crossings of
    the logical box [lo, lo + size) (host ints [x,y,z]) whose base
    voxel's physical z-plane this slab owns. tsdf_h / cw_h are the
    slab's (slab + 1, R, R) planes with the next slab's first plane
    appended (the +z halo; the ring wrap matches the volume's mod-R
    addressing). wrap (host ints) is the volume's. Only the box planes
    the slab owns are gathered; their points come out in the box's
    row-major order, as the JAX package's masked compaction gives them.
    The union over the slabs is the single-device extraction.
    clamp_edges: a voxel at logical coordinate R - 1 has no + neighbour
    on that axis (the fast step's convention: its single-device band
    slab ends there, where the dense step's box wraps to plane 0)."""
    dev = tsdf_h.device
    sx, sy, sz = (int(s) for s in size)
    lo = [int(v) for v in lo]
    wrap = [int(w) for w in wrap]
    # the box's z planes this slab owns, and their local plane index
    gz_all = [(lo[2] + k) % R for k in range(sz)]
    own_k = [k for k in range(sz)
             if ((gz_all[k] + wrap[2]) % R - idx * slab) % R < slab]
    if not own_k:
        return _empty_extract(capacity, dev)
    lz0 = [((gz_all[k] + wrap[2]) % R - idx * slab) % R for k in own_k]
    kz = torch.tensor(lz0, dtype=torch.long, device=dev)

    def phys(axis, m):
        logical = (lo[axis] + torch.arange(m, device=dev)) % R
        return (logical + wrap[axis]) % R, logical

    px, gx = phys(0, sx + 1)
    py, gy = phys(1, sy + 1)

    def gather(arr, planes):
        return arr[planes[:, None, None], py[None, :, None], px[None, None, :]]

    t = gather(tsdf_h, kz)
    w, cr, cg, cb = unpack_cw(gather(cw_h, kz))
    t_up = gather(tsdf_h, kz + 1)[:, :sy, :sx]  # own plane + 1 <= slab: available
    w_up = unpack_cw(gather(cw_h, kz + 1)[:, :sy, :sx])[0]

    t0, w0 = t[:, :sy, :sx], w[:, :sy, :sx]
    c0 = (cr[:, :sy, :sx], cg[:, :sy, :sx], cb[:, :sy, :sx])
    cx_mask, cx_dt = _crossing(t0, t[:, :sy, 1:], w0, w[:, :sy, 1:], min_weight)
    cy_mask, cy_dt = _crossing(t0, t[:, 1:, :sx], w0, w[:, 1:, :sx], min_weight)
    cz_mask, cz_dt = _crossing(t0, t_up, w0, w_up, min_weight)
    if sx == R:  # the +x neighbour of the last column wraps
        cx_mask = cx_mask & (torch.arange(sx, device=dev) < sx - 1)[None, None, :]
    if sy == R:
        cy_mask = cy_mask & (torch.arange(sy, device=dev) < sy - 1)[None, :, None]
    if sz == R:
        last = torch.tensor([k < sz - 1 for k in own_k], device=dev)
        cz_mask = cz_mask & last[:, None, None]
    if clamp_edges:
        cx_mask = cx_mask & (gx[:sx] != R - 1)[None, None, :]
        cy_mask = cy_mask & (gy[:sy] != R - 1)[None, :, None]
        last = torch.tensor([gz_all[k] != R - 1 for k in own_k], device=dev)
        cz_mask = cz_mask & last[:, None, None]
    any_cross = cx_mask | cy_mask | cz_mask
    n_cross = (cx_mask.to(torch.float32) + cy_mask.to(torch.float32)
               + cz_mask.to(torch.float32))
    denom = torch.clamp(n_cross, min=1.0)
    gz = torch.tensor([gz_all[k] for k in own_k], dtype=torch.float32, device=dev)
    base_x = gx[:sx].to(torch.float32)[None, None, :] + 0.5
    base_y = gy[:sy].to(torch.float32)[None, :, None] + 0.5
    base_z = gz[:, None, None] + 0.5
    px_g = (base_x + torch.where(cx_mask, cx_dt, 0.0) / denom) * voxel_size + origin[0]
    py_g = (base_y + torch.where(cy_mask, cy_dt, 0.0) / denom) * voxel_size + origin[1]
    pz_g = (base_z + torch.where(cz_mask, cz_dt, 0.0) / denom) * voxel_size + origin[2]
    return _compact_flat(any_cross, (px_g, py_g, pz_g, *c0, w0), capacity)


def _plus_z_halo(mesh: SlabMesh, tsdf: Sequence[torch.Tensor], cw: Sequence[torch.Tensor]):
    """Each slab's planes with the next slab's first plane appended."""
    t_hi = mesh.ppermute_from_next([t[:1] for t in tsdf])
    c_hi = mesh.ppermute_from_next([c[:1] for c in cw])
    return ([torch.cat([t, h]) for t, h in zip(tsdf, t_hi)],
            [torch.cat([c, h]) for c, h in zip(cw, c_hi)])


def extract_all_slabs(mesh: SlabMesh, tsdf, cw, wrap_h, origin, lo, size,
                      voxel_size: float, capacity: int, R: int,
                      clamp_edges: bool = False) -> List[PackedExtract]:
    """extract_slab on every slab, each with its +z halo plane."""
    slab = tsdf[0].shape[0]
    t_h, c_h = _plus_z_halo(mesh, tsdf, cw)
    return [extract_slab(t_h[i], c_h[i], wrap_h, mesh.to_slab(origin, i), lo, size,
                         voxel_size, capacity, i, slab, R, clamp_edges=clamp_edges)
            for i in range(mesh.n)]


def band_box(mesh: SlabMesh, tsdf, cw, wrap_h, lo3: Sequence[int],
             ext_xyz: Sequence[int], R: int, clamp: bool):
    """The departing band's logical box (ext_xyz [x,y,z] voxels from
    lo3), assembled on home from the planes each slab owns (the JAX
    package's masked gathers and psum). clamp: the runs clamp at R - 1
    (the fast step's convention) instead of wrapping mod R."""
    slab = tsdf[0].shape[0]
    home = mesh.home
    runs = []
    for a in range(3):
        r = [lo3[a] + k for k in range(ext_xyz[a])]
        r = [min(max(v, 0), R - 1) for v in r] if clamp else [v % R for v in r]
        runs.append([(v + int(wrap_h[a])) % R for v in r])
    t_box, c_box = [], []
    for i in range(mesh.n):
        dev = mesh.devices[i]
        lz = torch.tensor([p - i * slab for p in runs[2]], device=dev)
        own = (lz >= 0) & (lz < slab)
        lzc = torch.clamp(lz, 0, slab - 1)
        py = torch.tensor(runs[1], device=dev)
        px = torch.tensor(runs[0], device=dev)
        gi = (lzc[:, None, None], py[None, :, None], px[None, None, :])
        t_box.append(torch.where(own[:, None, None], tsdf[i][gi], 0.0))
        c_box.append(torch.where(own[:, None, None], cw[i][gi], 0))
    return mesh.psum_home(t_box), mesh.psum_home(c_box).to(torch.int32)


def _keep_planes(axis_shift: int, S: int, R: int, wrap_a, phys: torch.Tensor):
    """KEEP mask (bool) of physical coordinates `phys` along an axis that
    shifted by axis_shift: its departing band is cleared."""
    lo, hi = (0, S) if axis_shift > 0 else (R - S, R)
    logical = torch.remainder(phys - wrap_a, R)
    return torch.logical_not((logical >= lo) & (logical < hi))


# -------------------------------------------------------------- raycast
def _raycast_slab(mesh: SlabMesh, vol: VolumeState, cam: CameraIntrinsics,
                  T_cam_to_local: torch.Tensor, voxel_size: float, volume_size: float,
                  trunc_dist: float, slab: int, step_factor: float = 0.8,
                  min_range: float = 0.3, max_range: Optional[float] = None) -> RaycastResult:
    """Slab-local raycast: each slab marches every ray over its
    halo-extended planes and owns only the sample pairs whose leading
    sample sits in its physical z-slab; first hits combine with a pmin
    and the winning slab's attributes with a psum."""
    H, W = cam.height, cam.width
    R = vol.tsdf[0].shape[1]
    step = step_factor * trunc_dist
    if max_range is None:
        max_range = volume_size * math.sqrt(3.0)
    n_steps = int(math.ceil((max_range - min_range) / step))
    # halo: one step of ray advance (<= step/voxel planes) + trilinear
    halo = min(int(math.ceil(step_factor * trunc_dist / voxel_size)) + 2, slab)
    tsdf_h = _halo_extend(mesh, vol.tsdf, halo)
    cw_h = _halo_extend(mesh, vol.cw, halo)

    home = mesh.home
    Rot = T_cam_to_local[:3, :3]
    o = T_cam_to_local[:3, 3]
    u = torch.arange(W, dtype=torch.float32, device=home)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=home)[:, None]
    rx = (u - cam.cx) / cam.fx
    ry = (v - cam.cy) / cam.fy
    ones = torch.ones((H, W), dtype=torch.float32, device=home)
    d_cam = torch.stack([rx * ones, ry * ones, ones], dim=0)
    d = torch.einsum("ij,jhw->ihw", Rot, d_cam)
    dn = d / torch.sqrt(torch.sum(d * d, dim=0, keepdim=True))
    cos_z = torch.einsum("j,jhw->hw", Rot[:, 2], dn)
    t_near, t_far = _ray_box(o, dn, volume_size)
    t_start = torch.clamp(t_near + 1e-5, min=min_range)
    t_stop = torch.clamp(t_far - 1e-5, max=max_range)
    INF = 1e9

    # the slabs of one device march together, stacked: the same values
    # as one slab at a time, with a launch per step for the group
    groups = {}
    for i, dev in enumerate(mesh.devices):
        groups.setdefault(dev, []).append(i)
    step32 = np.float32(step)
    per = [None] * mesh.n  # per slab: (found, t_hit) after its march
    for dev, members in groups.items():
        arr = torch.stack([tsdf_h[i] for i in members])
        idx = torch.tensor(members, dtype=torch.int32, device=dev)
        o_d, dn_d, wrap_d = (x.to(dev, non_blocking=True) for x in (o, dn, vol.wrap))
        ts_d, tstop_d = (x.to(dev, non_blocking=True) for x in (t_start, t_stop))

        def sample_at(t):
            pos = o_d[:, None, None] + t[None] * dn_d
            pos_vox = torch.movedim(pos, 0, -1) / voxel_size - 0.5
            val, _, _, own = _slab_trilinear(arr, wrap_d, idx, slab, halo, R, pos_vox)
            return val, own

        prev, own_prev = sample_at(ts_d)
        found = torch.zeros(prev.shape, dtype=torch.bool, device=dev)
        t_hit = torch.full(prev.shape, INF, dtype=torch.float32, device=dev)
        for k in range(n_steps):
            t = ts_d + float(np.float32(k + 1) * step32)
            if k and k % 32 == 0 and not bool((~found & (t <= tstop_d)).any()):
                break  # no ray can cross at this t or any later one
            val, own = sample_at(t)
            active = torch.logical_not(found) & (t <= tstop_d) & own_prev
            crossing = active & (prev > 0) & (val < 0)
            denom = prev - val
            frac_t = torch.where(torch.abs(denom) > 1e-12, prev / denom, 0.5)
            t_hit = torch.where(crossing, (t - step) + step * frac_t, t_hit)
            found = found | crossing
            prev, own_prev = val, own
        for k, i in enumerate(members):
            per[i] = (found[k], t_hit[k])

    t_loc = [torch.where(f, th, INF) for f, th in per]
    t_min = mesh.pmin(t_loc)
    parts = []
    for i in range(mesh.n):
        found_l = per[i][0]
        found = t_min[i] < INF
        winner = found_l & (t_loc[i] <= t_min[i])
        t_hit = torch.where(found, t_min[i], 0.0)
        o_i, dn_i, wrap_i = (mesh.to_slab(x, i) for x in (o, dn, vol.wrap))
        pos_hit = o_i[:, None, None] + t_hit[None] * dn_i
        pos_vox = torch.movedim(pos_hit, 0, -1) / voxel_size - 0.5
        idx = torch.tensor([i], dtype=torch.int32, device=mesh.devices[i])
        _, corners, frac, _ = _slab_trilinear(tsdf_h[i][None], wrap_i, idx, slab, halo, R,
                                              pos_vox)
        grad = trilinear_gradient(corners[0], frac)
        gnorm = torch.sqrt(torch.sum(grad * grad, dim=-1, keepdim=True))
        normal = torch.movedim(grad / torch.clamp(gnorm, min=1e-12), -1, 0)
        ok_l = winner & (gnorm[..., 0] > 1e-9)
        # nearest colour and weight from the halo-extended cw slab
        gi = round_to_int(pos_vox)
        ix = torch.remainder(gi[..., 0] + wrap_i[0], R)
        iy = torch.remainder(gi[..., 1] + wrap_i[1], R)
        pz = torch.remainder(gi[..., 2] + wrap_i[2], R)
        lz = torch.clamp(torch.remainder(pz - i * slab + halo, R), 0, cw_h[i].shape[0] - 1)
        wgt, cr, cg, cb = unpack_cw(cw_h[i].reshape(-1)[((lz * R + iy) * R + ix).long()])
        parts.append((ok_l, normal, torch.stack([cr, cg, cb]), wgt, t_hit, pos_hit))

    def merge(k, mask_of):
        return mesh.psum_home([torch.where(mask_of(p), p[k], 0.0) for p in parts])

    ok = mesh.psum_home([p[0].to(torch.float32) for p in parts]) > 0
    normal_g = merge(1, lambda p: p[0][None])
    col_g = merge(2, lambda p: p[0][None])
    wgt_g = merge(3, lambda p: p[0])
    t_hit = mesh.to_home([parts[0][4]])[0]
    pos_hit = mesh.to_home([parts[0][5]])[0]
    nan = torch.nan
    return RaycastResult(
        vmap=torch.where(ok[None], pos_hit, nan),
        nmap=torch.where(ok[None], normal_g, nan),
        color=torch.where(ok[None], col_g, 0.0),
        weight=torch.where(ok, wgt_g, 0.0),
        depth=torch.where(ok, t_hit * cos_z, 0.0),
    )


# ------------------------------------------------------------- odometry
def row_blocks(mesh: SlabMesh, x: torch.Tensor, dim: int) -> List[torch.Tensor]:
    """x split into mesh.n equal pixel-row blocks along `dim`, block i
    on slab i's device."""
    rows = x.shape[dim] // mesh.n
    return [mesh.to_slab(x.narrow(dim, i * rows, rows), i) for i in range(mesh.n)]


def sharded_icp(cfg: KintinuousConfig, mesh: SlabMesh, cam: CameraIntrinsics,
                levels: int, iters, state, curr_pyr, reassoc: Optional[int]):
    """Coarse-to-fine ICP with pixel rows sharded over the slabs and the
    systems summed (the JAX sharded steps' ICP block): (T, count, res).
    reassoc: cfg.icp_reassoc_every on the finest level (fast step), or
    None for one association a step (dense step)."""
    sin_t = math.sin(math.radians(cfg.icp_angle_thresh_deg))
    Tinv = se3.inverse(state.pred_pose)
    Rm, tm = Tinv[:3, :3], Tinv[:3, 3]
    pv = torch.einsum("ij,jhw->ihw", Rm, state.pred_vmap) + tm[:, None, None]
    pn = torch.einsum("ij,jhw->ihw", Rm, state.pred_nmap)
    pred_pyr = pyramid_from_maps(pv, pn, levels)
    home = mesh.home
    T = torch.eye(4, dtype=torch.float32, device=home)
    cnt = res = torch.zeros((), dtype=torch.float32, device=home)
    for lvl in range(levels - 1, -1, -1):
        it = int(iters[lvl]) if lvl < len(iters) else 0
        if it == 0:
            continue
        vc, nc = curr_pyr[lvl]
        vp, np_ = pred_pyr[lvl]
        T, cnt, res = icp_solve_level(
            cam.at_level(lvl), T, row_blocks(mesh, vc, 1), row_blocks(mesh, nc, 1),
            mesh.replicate(pack_maps(vp, np_)), tuple(vp.shape[1:]), it,
            cfg.icp_dist_thresh, sin_t,
            reassoc_every=(reassoc if (reassoc and lvl == 0) else 1),
            reduce=mesh.psum_home)
    return T, cnt, res


def sharded_fused(cfg: KintinuousConfig, mesh: SlabMesh, cam: CameraIntrinsics,
                  levels: int, iters, state, curr_pyr, curr_rgbd):
    """Fused photometric (+ ICP with -ri) odometry with pixel rows
    sharded, as the JAX sharded steps write it: at each level
    max(it - 2, 0) steps with nearest texture taps, then the rest
    bilinear, on every row; each step sums both systems over the slabs
    and solves the trace-normalised fusion; a jump past
    rgbd_jump_reject falls back to identity. (T, count, residual)."""
    sin_t = math.sin(math.radians(cfg.icp_angle_thresh_deg))
    home = mesh.home
    use_icp_term = cfg.icp_plus_rgbd and not cfg.frame_to_frame_rgbd
    w2 = cfg.rgbd_icp_weight * cfg.rgbd_icp_weight
    Tinv = se3.inverse(state.pred_pose)
    Rm, tm = Tinv[:3, :3], Tinv[:3, 3]
    pv = torch.einsum("ij,jhw->ihw", Rm, state.pred_vmap) + tm[:, None, None]
    pn = torch.einsum("ij,jhw->ihw", Rm, state.pred_nmap)
    pred_pyr = pyramid_from_maps(pv, pn, levels)
    T = torch.eye(4, dtype=torch.float32, device=home)
    cnt = res = torch.zeros((), dtype=torch.float32, device=home)
    for lvl in range(levels - 1, -1, -1):
        it = int(iters[lvl]) if lvl < len(iters) else 0
        if it == 0:
            continue
        cam_l = cam.at_level(lvl)
        vc, nc = curr_pyr[lvl]
        vcs, ncs = row_blocks(mesh, vc, 1), row_blocks(mesh, nc, 1)
        ints = row_blocks(mesh, curr_rgbd.intensity[lvl], 0)
        mg2 = MIN_GRAD2[min(lvl, len(MIN_GRAD2) - 1)]
        texs = mesh.replicate(pack_prev_texture(
            state.rgbd.intensity[lvl], state.rgbd.gradx[lvl],
            state.rgbd.grady[lvl], state.rgbd.depth[lvl]))
        prev_hw = tuple(state.rgbd.intensity[lvl].shape)
        vp, np_ = pred_pyr[lvl]
        packeds = mesh.replicate(pack_maps(vp, np_))

        def body(T, bilinear):
            rgbs = rgb_system(cam_l, T, vcs, ints, texs, prev_hw, mg2,
                              max_depth_delta=cfg.rgbd_max_depth_delta,
                              bilinear=bilinear, reduce=mesh.psum_home)
            icp = None
            if use_icp_term:
                icp = sum_systems(
                    [icp_step(cam_l, Tk, v, n_, vp, np_, cfg.icp_dist_thresh, sin_t,
                              packed_prev=pk)
                     for Tk, v, n_, pk in zip(mesh.replicate(T), vcs, ncs, packeds)],
                    mesh.psum_home)
            T = gn_update(rgbs.A, rgbs.b, rgbs.count, T, icp=icp, w2=w2)
            # the JAX step psums every field of the system, sigma too: its
            # residual is mesh.n times the whole image's sigma
            return T, rgbs.count, rgbs.residual * mesh.n

        n_coarse = max(it - 2, 0)
        for k in range(it):
            T, cnt, res = body(T, bilinear=k >= n_coarse)
    eye = torch.eye(4, dtype=torch.float32, device=home)
    T = torch.where(torch.linalg.norm(T[:3, 3]) < cfg.rgbd_jump_reject, T, eye)
    return T, cnt, res


def shift_of(cfg: KintinuousConfig, pose: torch.Tensor) -> torch.Tensor:
    """(3,) i32 shift from the camera (with -d, the point 0.35 of the
    volume ahead of it), as the JAX sharded steps decide it."""
    anchor = pose[:3, 3]
    if cfg.dynamic_cube:
        anchor = anchor + pose[:3, 2] * (0.35 * cfg.volume_size)
    off = anchor - cfg.volume_size / 2.0
    S = cfg.voxel_shift
    thresh = S * cfg.voxel_size
    return torch.where(off >= thresh, S, torch.where(off <= -thresh, -S, 0)).to(torch.int32)


def read_shift_wrap(shift: torch.Tensor, wrap: torch.Tensor):
    """The step's one host read: the shift and the wrap, as ints."""
    h = torch.cat([shift, wrap.to(shift.device)]).cpu().tolist()
    return [int(v) for v in h[:3]], [int(v) for v in h[3:]]


def make_sharded_step(cfg: KintinuousConfig, mesh: SlabMesh, use_odometry: bool = True,
                      slab_raycast: bool = True):
    """The sharded dense step over `mesh`: step(state, depth_raw,
    rgb_raw, ext_delta) -> (new_state, ShardedStepOutputs); inputs on
    the mesh's home device, the slabs updated in place. The volume's
    resolution and each pyramid level's rows must divide by mesh.n."""
    cam = cfg.camera
    R = cfg.volume_resolution
    slab = slab_planes(cfg, mesh)
    levels = cfg.pyramid_levels
    if (cam.height >> (levels - 1)) % mesh.n:
        raise ValueError("pixel rows must divide across the mesh at every level")
    iters = cfg.icp_fast_iterations if cfg.fast_odometry else cfg.icp_iterations
    vsz = cfg.voxel_size
    S = cfg.voxel_shift
    OV = cfg.shift_overlap
    cap = cfg.extraction_capacity
    use_rgbd = cfg.rgbd_odometry or cfg.icp_plus_rgbd
    band = {0: (S + OV, R, R), 1: (R, S + OV, R), 2: (R, R, S + OV)}

    def step(state: ShardedTrackerState, depth_raw, rgb_raw, ext_delta):
        home = mesh.home
        depth_m, rgb, _, color_w = preprocess_frame(cfg, depth_raw, rgb_raw, half=False)
        curr_pyr = build_map_pyramid(cam, depth_m, levels)
        curr_rgbd = (build_rgbd_pyramid(pp.rgb_to_intensity(rgb), depth_m, levels)
                     if use_rgbd else None)
        zero = torch.zeros((), dtype=torch.float32, device=home)
        if use_odometry and use_rgbd:
            delta, icp_count, icp_res = sharded_fused(cfg, mesh, cam, levels, iters,
                                                      state, curr_pyr, curr_rgbd)
        elif use_odometry:
            delta, icp_count, icp_res = sharded_icp(cfg, mesh, cam, levels, iters,
                                                    state, curr_pyr, None)
        else:
            delta, icp_count, icp_res = ext_delta, zero, zero
        pose = state.pose @ delta

        vol = state.vol
        slices = (None, None, None)
        meshes = (None, None, None)
        shift = torch.zeros(3, dtype=torch.int32, device=home)
        if not cfg.static_mode:
            shift = shift_of(cfg, pose)
            shift_h, wrap_h = read_shift_wrap(shift, vol.wrap)
            if any(shift_h):
                per_slices, per_mesh = [None] * 3, [None] * 3
                for axis, s in enumerate(shift_h):
                    if s == 0:
                        continue
                    lo = [0, 0, 0]
                    lo[axis] = 0 if s > 0 else R - S - OV
                    per_slices[axis] = extract_all_slabs(
                        mesh, vol.tsdf, vol.cw, wrap_h, vol.origin, lo, band[axis],
                        vsz, cap, R)
                    if cfg.incremental_mesh:
                        ext = [R, R, R]
                        ext[axis] = S + OV + 1
                        t_box, c_box = band_box(mesh, vol.tsdf, vol.cw, wrap_h, lo, ext,
                                                R, clamp=False)
                        view = VolumeState(tsdf=t_box, cw=c_box,
                                           wrap=torch.zeros(3, dtype=torch.int32, device=home),
                                           origin=vol.origin)
                        size = [R, R, R]
                        size[axis] = S + OV
                        per_mesh[axis] = extract_mesh(
                            view, (0, 0, 0), size, vsz, cfg.mesh_vertex_capacity,
                            cfg.mesh_face_capacity, coord_offset=lo)
                slices, meshes = tuple(per_slices), tuple(per_mesh)
                for i in range(mesh.n):
                    dev = mesh.devices[i]
                    wrap_i = mesh.to_slab(vol.wrap, i)
                    keep = torch.ones((slab, R, R), dtype=torch.bool, device=dev)
                    phys_xy = torch.arange(R, dtype=torch.int32, device=dev)
                    phys_z = i * slab + torch.arange(slab, dtype=torch.int32, device=dev)
                    for axis, s in enumerate(shift_h):
                        if s == 0:
                            continue
                        k = _keep_planes(s, S, R, wrap_i[axis], phys_z if axis == 2 else phys_xy)
                        keep &= k.reshape([-1 if a == 2 - axis else 1 for a in range(3)])
                    vol.tsdf[i].mul_(keep)  # tsdf * keep, as the JAX package
                    vol.cw[i].masked_fill_(~keep, 0)
                vol = vol._replace(wrap=(vol.wrap + shift) % R,
                                   origin=vol.origin + shift.to(torch.float32) * vsz)
                pose = pose.clone()
                pose[:3, 3] -= shift.to(torch.float32) * vsz

        for i in range(mesh.n):
            integrate(VolumeState(tsdf=vol.tsdf[i], cw=vol.cw[i],
                                  wrap=mesh.to_slab(vol.wrap, i), origin=vol.origin),
                      cam, *(mesh.to_slab(x, i) for x in (depth_m, rgb, color_w, pose)),
                      vsz, cfg.trunc_dist, float(cfg.max_weight), z_chunk=min(slab, 64),
                      z_phys_offset=i * slab)
        if slab_raycast:
            rc = _raycast_slab(mesh, vol, cam, pose, vsz, cfg.volume_size, cfg.trunc_dist,
                               slab, cfg.raycast_step_factor, cfg.raycast_min_range,
                               cfg.raycast_max_range)
        else:
            full = VolumeState(tsdf=torch.cat(mesh.to_home(vol.tsdf)),
                               cw=torch.cat(mesh.to_home(vol.cw)),
                               wrap=vol.wrap, origin=vol.origin)
            rc = raycast(full, cam, pose, vsz, cfg.volume_size, cfg.trunc_dist,
                         cfg.raycast_step_factor, cfg.raycast_min_range,
                         cfg.raycast_max_range)
        pose_global = pose.clone()
        pose_global[:3, 3] += vol.origin
        new_state = ShardedTrackerState(
            vol=vol, pose=pose, pred_vmap=rc.vmap, pred_nmap=rc.nmap, pred_pose=pose,
            frame=state.frame + 1, rgbd=curr_rgbd)
        out = ShardedStepOutputs(
            pose_global=pose_global, shift=shift, slices=slices, icp_count=icp_count,
            icp_residual=icp_res, raycast_fallback=zero,
            mesh_patches=meshes if cfg.incremental_mesh else ())
        return new_state, out

    return step


def make_sharded_extract(cfg: KintinuousConfig, mesh: SlabMesh):
    """The whole volume's slab-local extraction (the FINAL slice):
    fetch(vol) -> one PackedExtract per slab."""
    R = cfg.volume_resolution

    def fetch(vol: VolumeState) -> List[PackedExtract]:
        wrap_h = [int(v) for v in vol.wrap.cpu().tolist()]
        return extract_all_slabs(mesh, vol.tsdf, vol.cw, wrap_h, vol.origin, (0, 0, 0),
                                 (R, R, R), cfg.voxel_size, cfg.extraction_capacity, R)

    return fetch
