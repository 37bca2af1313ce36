"""The z-slab sharded fast step (port of
kintinuous_tpu/parallel/fast_sharded.py: FastShardedState, _init_rgbd,
make_fast_sharded_state, blocked_slab_to_dense, _blocked_halo_extend,
_SlabAddr, _slab_local_z, _slab_nearest_pairs, _slab_trilinear_pairs,
raycast_fast_slab, make_fast_sharded_step,
make_batched_fast_sharded_step and make_fast_sharded_extract).

The blocked (B^3, 4, 128) volume is block-z-major, so slab i of a
SlabMesh (parallel/mesh.py) is the contiguous rows of block-planes
[i*Bz, (i+1)*Bz), Bz = B/n, held on mesh.devices[i]. Per frame:

- preprocessing runs once on the home device (half-resolution maps);
- odometry shards the half-resolution pixel rows, as the dense sharded
  step does (ICP, or fused ICP + RGB-D with -r / -ri);
- the shift keeps the wrap (the single-device step rolls the volume
  instead, which would move block-planes across slabs); the departing
  band is extracted slab-locally through sharded.extract_slab on a
  dense view of each slab, and its mesh (meshing on) from the box the
  slabs' owned planes assemble; then each slab clears its share of the
  recycled bands;
- integration is slab-local: `integrate_cuda(resolution=R,
  z_block_offset=i*Bz)` classifies the slab's blocks and launches the
  band fusion (K1) and the free carve (K2) on its rows, once per slab
  per frame, on the card (their plain versions on the CPU);
- the raycast is the warm-started gather raycast (window 6, two Newton
  steps), per slab against its rows plus two ring-neighbour
  block-planes each side; a slab claims the crossings whose first tap
  it owns, first hits meet in a pmin and the winner's attributes in a
  psum. The sharded steps keep no mirror: K3, K4 and K5 never run.

The shift is read on the host once a frame, with the wrap.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

from kintinuous_tpu_torch.config import CameraIntrinsics, KintinuousConfig
from kintinuous_tpu_torch.ops import preprocess as pp
from kintinuous_tpu_torch.ops.blocked import BLOCK, BlockedVolume
from kintinuous_tpu_torch.ops.cuda_integrate import integrate_cuda
from kintinuous_tpu_torch.ops.extract import PackedExtract
from kintinuous_tpu_torch.ops.raycast_fast import (
    FastRaycastResult, build_pair_texture, ray_directions)
from kintinuous_tpu_torch.ops.reduce import round_to_int
from kintinuous_tpu_torch.ops.rgbd import build_rgbd_pyramid
from kintinuous_tpu_torch.ops.surface_nets import extract_mesh
from kintinuous_tpu_torch.ops.tsdf import VolumeState, trilinear_gradient, unpack_cw
from kintinuous_tpu_torch.parallel.mesh import SlabMesh
from kintinuous_tpu_torch.parallel.sharded import (
    ShardedStepOutputs,
    _initial_pose,
    band_box,
    extract_all_slabs,
    read_shift_wrap,
    sharded_fused,
    sharded_icp,
    shift_of,
)
from kintinuous_tpu_torch.tracking.odometry import build_map_pyramid
from kintinuous_tpu_torch.tracking.tracker import preprocess_frame


class FastShardedState(NamedTuple):
    vol: BlockedVolume  # tsdf, cw: tuples of per-slab row blocks; wrap, origin on home
    pose: torch.Tensor  # (4,4) camera -> local, on home
    pred_vmap: torch.Tensor  # (3,h,w) half-resolution prediction, on home
    pred_nmap: torch.Tensor
    pred_pose: torch.Tensor
    frame: torch.Tensor
    rgbd: object = None  # previous frame's half-resolution RGB-D pyramid (-r / -ri)


def _levels(cfg: KintinuousConfig) -> int:
    return max(2, cfg.pyramid_levels - 1)


def _init_rgbd(cfg: KintinuousConfig, device):
    if not (cfg.rgbd_odometry or cfg.icp_plus_rgbd):
        return None
    cam = cfg.camera
    zero = torch.zeros((cam.height // 2, cam.width // 2), dtype=torch.float32,
                       device=device)
    return build_rgbd_pyramid(zero, zero, _levels(cfg))


def slab_blocks(cfg: KintinuousConfig, mesh: SlabMesh) -> int:
    B = cfg.volume_resolution // BLOCK
    if B % mesh.n:
        raise ValueError("the volume's block count must divide across the mesh")
    return B // mesh.n


def make_fast_sharded_state(cfg: KintinuousConfig, mesh: SlabMesh) -> FastShardedState:
    """An empty blocked volume in block-z slabs, the camera at its
    centre, NaN half-resolution predictions."""
    B = cfg.volume_resolution // BLOCK
    rows = slab_blocks(cfg, mesh) * B * B
    cam = cfg.camera
    h, w = cam.height // 2, cam.width // 2
    home = mesh.home
    pose = _initial_pose(cfg, home)
    vol = BlockedVolume(
        tsdf=tuple(torch.zeros((rows, 4, 128), dtype=torch.float32, device=d)
                   for d in mesh.devices),
        cw=tuple(torch.zeros((rows, 4, 128), dtype=torch.int32, device=d)
                 for d in mesh.devices),
        wrap=torch.zeros(3, dtype=torch.int32, device=home),
        origin=torch.zeros(3, dtype=torch.float32, device=home),
    )
    return FastShardedState(
        vol=vol, pose=pose,
        pred_vmap=torch.full((3, h, w), torch.nan, device=home),
        pred_nmap=torch.full((3, h, w), torch.nan, device=home),
        pred_pose=pose.clone(), frame=torch.zeros((), dtype=torch.int32, device=home),
        rgbd=_init_rgbd(cfg, home),
    )


def blocked_slab_to_dense(arr: torch.Tensor, xy_blocks: int) -> torch.Tensor:
    """(Bz*B*B, 4, 128) block-z slab -> dense (Bz*8, R, R) [z,y,x]."""
    B = xy_blocks
    Bz = arr.shape[0] // (B * B)
    return (arr.reshape(Bz, B, B, BLOCK, BLOCK, BLOCK)
            .permute(0, 3, 1, 4, 2, 5)
            .reshape(Bz * BLOCK, B * BLOCK, B * BLOCK))


def _blocked_halo_extend(mesh: SlabMesh, slabs: Sequence[torch.Tensor], halo_b: int,
                         xy_blocks: int) -> List[torch.Tensor]:
    """Each block-z slab extended by `halo_b` block-planes from each ring
    neighbour: ((halo_b + Bz + halo_b)*B*B, 4, 128). The rows are
    block-z-major, so a neighbour's planes are a contiguous row range:
    two ppermutes per array."""
    rows = halo_b * xy_blocks * xy_blocks
    hi = mesh.ppermute_from_next([s[:rows] for s in slabs])
    lo = mesh.ppermute_from_prev([s[-rows:] for s in slabs])
    return [torch.cat([a, s, b], dim=0) for a, s, b in zip(lo, slabs, hi)]


def _slab_rowoff(B: int, lz, py, px):
    """Local (extended) voxel coords -> flat index into a blocked slab
    array whose leading dim covers lz's range."""
    row = ((lz >> 3) * B + (py >> 3)) * B + (px >> 3)
    off = ((lz & 7) << 6) | ((py & 7) << 3) | (px & 7)
    return row * 512 + off


class _SlabAddr(NamedTuple):
    """Static addressing of a halo-extended slab."""

    R: int
    B: int
    slab_v: int  # owned z-planes per slab
    halo_v: int  # halo z-planes per side


def _slab_local_z(addr: _SlabAddr, z0: int, pz):
    """Physical plane -> (local extended plane index, own, reachable)."""
    lzr = torch.remainder(pz - z0, addr.R)
    own = lzr < addr.slab_v
    lz_ext = torch.where(lzr >= addr.R - addr.halo_v, lzr - addr.R, lzr) + addr.halo_v
    reach = (lz_ext >= 0) & (lz_ext < addr.slab_v + 2 * addr.halo_v)
    return torch.clamp(lz_ext, 0, addr.slab_v + 2 * addr.halo_v - 1), own, reach


def _pair_at(pairs, idx):
    p = pairs[idx.long()].to(torch.float32)
    return p[..., 0], p[..., 1]


def _slab_nearest_pairs(pairs, addr: _SlabAddr, wrap, z0: int, pos_vox):
    """Nearest-voxel tsdf (lane 0 of the x-pair) and ownership."""
    gi = round_to_int(pos_vox)
    px = torch.remainder(gi[..., 0] + wrap[0], addr.R)
    py = torch.remainder(gi[..., 1] + wrap[1], addr.R)
    pz = torch.remainder(gi[..., 2] + wrap[2], addr.R)
    lz, own, reach = _slab_local_z(addr, z0, pz)
    return _pair_at(pairs, _slab_rowoff(addr.B, lz, py, px))[0], own & reach


def _slab_trilinear_pairs(pairs, addr: _SlabAddr, wrap, z0: int, pos_vox):
    """Trilinear value, corners (...,8) and fractions from four x-pair
    gathers against the halo-extended slab."""
    base = torch.floor(pos_vox).to(torch.int32)
    frac = pos_vox - base.to(torch.float32)
    px = torch.remainder(base[..., 0] + wrap[0], addr.R)

    def ypair(cy, cz):
        py = torch.remainder(base[..., 1] + cy + wrap[1], addr.R)
        pz = torch.remainder(base[..., 2] + cz + wrap[2], addr.R)
        lz, _, _ = _slab_local_z(addr, z0, pz)
        return _pair_at(pairs, _slab_rowoff(addr.B, lz, py, px))

    c000, c100 = ypair(0, 0)
    c010, c110 = ypair(1, 0)
    c001, c101 = ypair(0, 1)
    c011, c111 = ypair(1, 1)
    corners = torch.stack([c000, c100, c010, c110, c001, c101, c011, c111], dim=-1)
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    val = (c00 * (1 - fy) + c10 * fy) * (1 - fz) + (c01 * (1 - fy) + c11 * fy) * fz
    return val, corners, frac


def raycast_fast_slab(mesh: SlabMesh, vol: BlockedVolume, cam: CameraIntrinsics,
                      T_cam_to_local: torch.Tensor, measured_depth: torch.Tensor,
                      voxel_size: float, trunc_dist: float, resolution: int,
                      window: int = 6, halo_blocks: int = 2) -> FastRaycastResult:
    """The gather raycast over the slabs: warm start from the measured
    depth, a `window`-sample nearest search, two Newton steps. Each slab
    claims the crossings whose first tap's z-plane it owns; the first
    hits meet in a pmin; every slab refines the winning t on its own
    halo-extended field and the winner's attributes merge in a psum.
    The result is on the mesh's home device."""
    h, w = cam.height, cam.width
    R = resolution
    B = R // BLOCK
    Bz = B // mesh.n
    halo_b = min(halo_blocks, Bz)
    addr = _SlabAddr(R=R, B=B, slab_v=Bz * BLOCK, halo_v=halo_b * BLOCK)
    step = 0.8 * trunc_dist
    tsdf_ext = _blocked_halo_extend(mesh, vol.tsdf, halo_b, B)
    cw_ext = _blocked_halo_extend(mesh, vol.cw, halo_b, B)
    o = T_cam_to_local[:3, 3]
    dn, cos_z, lam = ray_directions(cam, T_cam_to_local)
    INF = 1e9
    has_warm = measured_depth > 0
    t_warm = torch.where(has_warm, measured_depth * lam, 0.0)
    t0 = t_warm - (window // 2) * step
    inv_vsz = 1.0 / voxel_size

    pairs, per = [], []
    for i in range(mesh.n):
        dev = mesh.devices[i]
        pairs.append(build_pair_texture(tsdf_ext[i], xy_blocks=B))
        o_i, dn_i, wrap_i, t0_i, warm_i = (
            mesh.to_slab(x, i) for x in (o, dn, vol.wrap, t0, has_warm))
        z0 = i * addr.slab_v

        def sample_t(t):
            pos = o_i[:, None, None] + t[None] * dn_i
            pos_vox = torch.movedim(pos, 0, -1) * inv_vsz - 0.5
            return _slab_nearest_pairs(pairs[i], addr, wrap_i, z0, pos_vox)

        ts = [t0_i + k * step for k in range(window)]
        samples = [sample_t(t) for t in ts]
        found = torch.zeros((h, w), dtype=torch.bool, device=dev)
        t_hit = torch.zeros((h, w), dtype=torch.float32, device=dev)
        for k in range(window - 1):
            (a, own_a), (b, _) = samples[k], samples[k + 1]
            # the first tap's owner claims the crossing; own implies the
            # second tap (at most one step on) is in the halo
            crossing = torch.logical_not(found) & own_a & (a > 0) & (b < 0)
            denom = a - b
            frac_t = torch.where(torch.abs(denom) > 1e-12, a / denom, 0.5)
            t_hit = torch.where(crossing, ts[k] + step * frac_t, t_hit)
            found = found | crossing
        per.append((found & warm_i, t_hit))

    t_loc = [torch.where(f, th, INF) for f, th in per]
    t_min = mesh.pmin(t_loc)
    parts = []
    for i in range(mesh.n):
        found_g = t_min[i] < INF
        winner = per[i][0] & (t_loc[i] <= t_min[i])
        t_ref = torch.where(found_g, t_min[i], 0.0)
        o_i, dn_i, wrap_i = (mesh.to_slab(x, i) for x in (o, dn, vol.wrap))
        z0 = i * addr.slab_v
        dn_hw = torch.movedim(dn_i, 0, -1)
        grad = torch.zeros((h, w, 3), dtype=torch.float32, device=mesh.devices[i])
        for _ in range(2):
            pos_vox = torch.movedim(o_i[:, None, None] + t_ref[None] * dn_i, 0, -1) \
                * inv_vsz - 0.5
            val, corners, frac = _slab_trilinear_pairs(pairs[i], addr, wrap_i, z0, pos_vox)
            grad = trilinear_gradient(corners, frac)
            dval_dt = torch.sum(grad * dn_hw, dim=-1) * inv_vsz
            newton = torch.where(torch.abs(dval_dt) > 1e-6, val / dval_dt, 0.0)
            t_ref = t_ref - torch.clamp(newton, -2.0 * trunc_dist, 2.0 * trunc_dist)
        t_fin = torch.where(found_g, t_ref, 0.0)
        pos_vox = torch.movedim(o_i[:, None, None] + t_fin[None] * dn_i, 0, -1) \
            * inv_vsz - 0.5
        gnorm = torch.sqrt(torch.sum(grad * grad, dim=-1, keepdim=True))
        normal = torch.movedim(grad / torch.clamp(gnorm, min=1e-12), -1, 0)
        ok_l = winner & (gnorm[..., 0] > 1e-9)
        # nearest colour and weight from the halo-extended cw slab
        gi = round_to_int(pos_vox)
        px = torch.remainder(gi[..., 0] + wrap_i[0], R)
        py = torch.remainder(gi[..., 1] + wrap_i[1], R)
        pz = torch.remainder(gi[..., 2] + wrap_i[2], R)
        lz, _, _ = _slab_local_z(addr, z0, pz)
        cwv = cw_ext[i].reshape(-1)[_slab_rowoff(B, lz, py, px).long()]
        wgt, cr, cg, cb = unpack_cw(cwv)
        parts.append((ok_l, torch.where(ok_l, t_fin, 0.0), normal,
                      torch.stack([cr, cg, cb]), wgt))

    def merge(k, expand):
        return mesh.psum_home([torch.where(p[0][None] if expand else p[0], p[k], 0.0)
                               for p in parts])

    ok = mesh.psum_home([p[0].to(torch.float32) for p in parts]) > 0
    # the winner's refined t is exact; the others add 0
    t_g = merge(1, False)
    pos_g = o[:, None, None] + t_g[None] * dn
    normal_g = merge(2, True)
    col_g = merge(3, True)
    wgt_g = merge(4, False)
    nan = torch.nan
    return FastRaycastResult(
        vmap=torch.where(ok[None], pos_g, nan),
        nmap=torch.where(ok[None], normal_g, nan),
        color=torch.where(ok[None], col_g, 0.0),
        weight=torch.where(ok, wgt_g, 0.0),
        depth=torch.where(ok, t_g * cos_z, 0.0),
    )


def _keep_blocked(shift_h, S: int, R: int, wrap, i: int, Bz: int, device) -> torch.Tensor:
    """(Bz*B*B, 4, 128) KEEP mask of slab i for the recycled bands."""
    B = R // BLOCK
    masks = []
    for axis, s in enumerate(shift_h):
        n = Bz * BLOCK if axis == 2 else R
        phys = torch.arange(n, dtype=torch.int32, device=device) + (i * Bz * BLOCK
                                                                   if axis == 2 else 0)
        if s == 0:
            masks.append(torch.ones(n, dtype=torch.bool, device=device))
            continue
        lo, hi = (0, S) if s > 0 else (R - S, R)
        logical = torch.remainder(phys - wrap[axis], R)
        masks.append(torch.logical_not((logical >= lo) & (logical < hi)))
    kx = masks[0].reshape(B, BLOCK)
    ky = masks[1].reshape(B, BLOCK)
    kz = masks[2].reshape(Bz, BLOCK)
    return (kz[:, None, None, :, None, None] & ky[None, :, None, None, :, None]
            & kx[None, None, :, None, None, :]).reshape(Bz * B * B, 4, 128)


def make_fast_sharded_step(cfg: KintinuousConfig, mesh: SlabMesh, use_odometry: bool = True):
    """The sharded fast step over `mesh`: step(state, depth_raw, rgb_raw,
    ext_delta) -> (new_state, ShardedStepOutputs); inputs on the mesh's
    home device, the slabs updated in place. The volume's block count
    (R/8) and the half-resolution rows at every ICP level must divide by
    mesh.n; voxel_shift is a multiple of 8 (fast mode's rule)."""
    cam = cfg.camera
    cam_half = cam.at_level(1)
    R = cfg.volume_resolution
    B = R // BLOCK
    Bz = slab_blocks(cfg, mesh)
    slab_v = Bz * BLOCK
    levels = _levels(cfg)
    if (cam_half.height >> (levels - 1)) % mesh.n:
        raise ValueError("half-resolution rows must divide across the mesh at every level")
    base_iters = cfg.icp_fast_iterations if cfg.fast_odometry else cfg.icp_iterations
    iters = tuple(base_iters[1:]) if len(base_iters) > 1 else (10, 5)
    vsz = cfg.voxel_size
    S = cfg.voxel_shift
    OV = cfg.shift_overlap
    cap = cfg.extraction_capacity
    use_rgbd = cfg.rgbd_odometry or cfg.icp_plus_rgbd
    band = {0: (S + OV, R, R), 1: (R, S + OV, R), 2: (R, R, S + OV)}

    def step(state: FastShardedState, depth_raw, rgb_raw, ext_delta):
        home = mesh.home
        depth_m, rgb, depth_half, color_w = preprocess_frame(cfg, depth_raw, rgb_raw)
        curr_pyr = build_map_pyramid(cam_half, depth_half, levels)
        curr_rgbd = None
        if use_rgbd:
            intensity_half = pp.pyr_down_gauss(pp.rgb_to_intensity(rgb))
            curr_rgbd = build_rgbd_pyramid(intensity_half, depth_half, levels)
        zero = torch.zeros((), dtype=torch.float32, device=home)
        if use_odometry and use_rgbd:
            delta, icp_count, icp_res = sharded_fused(cfg, mesh, cam_half, levels, iters,
                                                      state, curr_pyr, curr_rgbd)
        elif use_odometry:
            delta, icp_count, icp_res = sharded_icp(cfg, mesh, cam_half, levels, iters,
                                                    state, curr_pyr, cfg.icp_reassoc_every)
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
                dense_t = [blocked_slab_to_dense(t, B) for t in vol.tsdf]
                dense_c = [blocked_slab_to_dense(c, B) for c in vol.cw]
                per_slices, per_mesh = [None] * 3, [None] * 3
                for axis, s in enumerate(shift_h):
                    if s == 0:
                        continue
                    lo = [0, 0, 0]
                    lo[axis] = 0 if s > 0 else R - S - OV
                    per_slices[axis] = extract_all_slabs(
                        mesh, dense_t, dense_c, wrap_h, vol.origin, lo, band[axis], vsz,
                        cap, R, clamp_edges=True)
                    if cfg.incremental_mesh:
                        ext = [R, R, R]
                        ext[axis] = S + OV + 1
                        t_box, c_box = band_box(mesh, dense_t, dense_c, wrap_h, lo, ext,
                                                R, clamp=True)
                        view = VolumeState(tsdf=t_box, cw=c_box,
                                           wrap=torch.zeros(3, dtype=torch.int32, device=home),
                                           origin=vol.origin)
                        size = [R, R, R]
                        size[axis] = S + OV
                        per_mesh[axis] = extract_mesh(
                            view, (0, 0, 0), size, vsz, cfg.mesh_vertex_capacity,
                            cfg.mesh_face_capacity, clamp_edges=True, coord_offset=lo)
                del dense_t, dense_c
                slices, meshes = tuple(per_slices), tuple(per_mesh)
                for i in range(mesh.n):
                    keep = _keep_blocked(shift_h, S, R, mesh.to_slab(vol.wrap, i), i, Bz,
                                         mesh.devices[i])
                    # a cleared voxel is +0.0 (the JAX product by a bool
                    # mask selects, as in ops/blocked.shift_roll_clear)
                    vol.tsdf[i].masked_fill_(~keep, 0.0)
                    vol.cw[i].masked_fill_(~keep, 0)
                vol = vol._replace(wrap=(vol.wrap + shift) % R,
                                   origin=vol.origin + shift.to(torch.float32) * vsz)
                pose = pose.clone()
                pose[:3, 3] -= shift.to(torch.float32) * vsz

        for i in range(mesh.n):
            integrate_cuda(
                BlockedVolume(tsdf=vol.tsdf[i], cw=vol.cw[i],
                              wrap=mesh.to_slab(vol.wrap, i), origin=vol.origin),
                cam, *(mesh.to_slab(x, i) for x in (depth_m, rgb, color_w, pose)),
                vsz, cfg.trunc_dist, float(cfg.max_weight), band_cap=cfg.band_cap,
                resolution=R, z_block_offset=i * Bz)
        rc = raycast_fast_slab(mesh, vol, cam_half, pose, depth_half, vsz, cfg.trunc_dist, R)
        # the share of measured pixels the model raycast could not serve
        measured = (depth_half > 0).sum().to(torch.float32)
        served = (rc.depth > 0).sum().to(torch.float32)
        fallback = 1.0 - served / torch.clamp(measured, min=1.0)
        pose_global = pose.clone()
        pose_global[:3, 3] += vol.origin
        new_state = FastShardedState(
            vol=vol, pose=pose, pred_vmap=rc.vmap, pred_nmap=rc.nmap, pred_pose=pose,
            frame=state.frame + 1, rgbd=curr_rgbd)
        out = ShardedStepOutputs(
            pose_global=pose_global, shift=shift, slices=slices, icp_count=icp_count,
            icp_residual=icp_res, raycast_fallback=fallback,
            mesh_patches=meshes if cfg.incremental_mesh else ())
        return new_state, out

    return step


def make_batched_fast_sharded_step(cfg: KintinuousConfig, mesh: SlabMesh,
                                   use_odometry: bool = True):
    """batched(state, depths (N,H,W), rgbs (N,H,W,3)) -> (state, the
    frames' outputs): the per-frame step in a loop, as the port's
    single-device batched step is (eager PyTorch launches every frame's
    work either way, and the shift is read on every frame); every slice
    of the batch is kept."""
    step = make_fast_sharded_step(cfg, mesh, use_odometry)

    def batched(state, depths, rgbs):
        outs = []
        for d, c in zip(depths, rgbs):
            state, out = step(state, d, c, None)
            outs.append(out)
        return state, outs

    return batched


def make_fast_sharded_extract(cfg: KintinuousConfig, mesh: SlabMesh):
    """The whole blocked volume's slab-local extraction (the FINAL
    slice): fetch(vol) -> one PackedExtract per slab."""
    R = cfg.volume_resolution
    B = R // BLOCK

    def fetch(vol: BlockedVolume) -> List[PackedExtract]:
        wrap_h = [int(v) for v in vol.wrap.cpu().tolist()]
        return extract_all_slabs(
            mesh, [blocked_slab_to_dense(t, B) for t in vol.tsdf],
            [blocked_slab_to_dense(c, B) for c in vol.cw], wrap_h, vol.origin, (0, 0, 0),
            (R, R, R), cfg.voxel_size, cfg.extraction_capacity, R, clamp_edges=True)

    return fetch
