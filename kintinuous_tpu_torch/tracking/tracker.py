"""The tracker steps (port of kintinuous_tpu/tracking/tracker.py:
TrackerState, StepOutputs, CloudSlice, make_step, make_step_fast, and
Tracker with its per-frame and batched paths).

The fast step (`make_step_fast`, fast_mode on), one frame: bilateral
filter, metres, half-resolution pyramids, ICP or fused ICP+RGB-D
odometry (or an external delta), the shift decision with band
extraction (and, with meshing on, the band's surface-nets mesh) and the
roll of the blocked volume, block-classified fusion with the mirror
refresh, and the warm-started raycast that predicts the next frame's
maps. The volume and the mirror are updated in place; the RGB-D pyramid
of the frame is carried to the next one in the state. A volume with an
odd number of blocks an edge keeps no mirror (`keeps_mirror`): the
raycast rebuilds it from the volume every frame. With `cfg.pallas`
False the step is the JAX package's non-Pallas one: the same fusion,
no mirror, and the gather raycast (`ops/raycast_fast.py`) in place of
the kernel raycast.

The dense step (`make_step`, fast_mode off: the JAX CLI's default, a
run without --fast): full-resolution pyramids and odometry against a
full-resolution prediction, the shift with band extraction (and band
meshes) from the dense rolling volume, whose recycled bands are cleared
(one masked pass an axis that moved) and which is re-addressed by its
wrap, then the dense `integrate` and
`raycast` (ops/tsdf.py, ops/raycast.py). The JAX package reaches no
Pallas kernel there, and the port no CUDA kernel: it is plain PyTorch.
The volume is updated in place.

The shift decision is the fast step's only host synchronisation:
`jax.lax.cond` on the shift becomes a Python `if` on one host read of
the three shift counts, after odometry; a static-mode step reads
nothing. The dense step reads the shift the same way, and its raycast
reads every 32 march steps whether a ray is still marching. The stages run inside torch.profiler ranges (kt.preprocess,
kt.odometry, kt.shift, kt.integrate, kt.raycast) that a trace can sum.
Outputs are consumed one frame late, so downloading poses and slices
overlaps the next device work.

The JAX package's batched step (make_batched_step_fast) scans a batch
in one program and reads its outputs one batch late, with the batch's
slices in a fixed-size device pool. Eager PyTorch launches every
frame's work either way, and the shift read already waits for the
device on every frame, so here a batch is the per-frame step in a loop
(`Tracker.process_batch_device`) and keeps every slice.
"""

from __future__ import annotations

import time as _time
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from kintinuous_tpu_torch.backend.meshing import MeshPatch, patch_from_result
from kintinuous_tpu_torch.config import KintinuousConfig
from kintinuous_tpu_torch.device import resolve_device
from kintinuous_tpu_torch.geometry import se3
from kintinuous_tpu_torch.ops import maps as map_ops
from kintinuous_tpu_torch.ops import preprocess as pp
from kintinuous_tpu_torch.ops.blocked import (
    VIEW_AXES,
    VIEW_INV,
    BlockedVolume,
    as_dense,
    make_blocked_volume,
    shift_roll_clear,
    slab_to_dense,
)
from kintinuous_tpu_torch.ops.cuda_integrate import integrate_cuda
from kintinuous_tpu_torch.ops.cuda_raycast import raycast_cuda
from kintinuous_tpu_torch.ops.extract import extract_points, extract_points_packed
from kintinuous_tpu_torch.ops.raycast import raycast
from kintinuous_tpu_torch.ops.raycast_fast import raycast_fast
from kintinuous_tpu_torch.ops.rgbd import (
    RGBDFramePyramid,
    build_rgbd_pyramid,
    rgbd_icp_odometry,
)
from kintinuous_tpu_torch.ops.surface_nets import extract_mesh
from kintinuous_tpu_torch.ops.tsdf import VolumeState, clear_band, integrate, make_volume
from kintinuous_tpu_torch.tracking.odometry import (
    build_map_pyramid,
    icp_odometry,
    pyramid_from_maps,
)


class TrackerState(NamedTuple):
    vol: BlockedVolume  # the fast step's; the dense step's is a VolumeState
    pose: torch.Tensor  # (4,4) camera -> local volume
    pred_vmap: torch.Tensor  # (3,h,w) raycast prediction, local frame (dense: (3,H,W))
    pred_nmap: torch.Tensor  # (3,h,w)
    pred_pose: torch.Tensor  # (4,4) pose the prediction was cast from
    frame: torch.Tensor  # () i32
    rgbd: Optional[RGBDFramePyramid] = None  # previous frame's (RGB-D odometry)
    dc: torch.Tensor = None  # () f32 dynamic-cube anchor offset (0 = off)
    prev_delta: torch.Tensor = None  # (4,4) previous odometry delta
    pw: torch.Tensor = None  # () f32 constant-velocity prior weight
    logical: Optional[torch.Tensor] = None  # (R,R,R) bf16 dense mirror


class StepOutputs(NamedTuple):
    pose_local: torch.Tensor  # (4,4)
    pose_global: torch.Tensor  # (4,4) local pose + volume origin
    shift: torch.Tensor  # (3,) i32 voxels shifted this frame [x,y,z]
    slices: Tuple  # per axis: PackedExtract, or None when that axis held still
    icp_count: torch.Tensor  # () f32 inliers at the finest solved level
    icp_residual: torch.Tensor  # () f32
    raycast_hits: torch.Tensor  # () f32 pixels with a predicted surface
    mesh_patches: Tuple = ()  # per axis: MeshResult or None (meshing on)
    raycast_fallback: torch.Tensor = 0.0  # () f32 in [0,1]


@dataclass
class CloudSlice:
    """Host-side slice record."""

    points: np.ndarray  # (N,3) global metres
    colors: np.ndarray  # (N,3) uint8
    weights: np.ndarray  # (N,)
    dimension: str  # 'XPlus','XMinus','YPlus',...,'FINAL'
    pose: np.ndarray  # (4,4) global camera pose at emission
    timestamp_us: int
    frame_index: int
    processed: Optional[dict] = None
    wall_time: float = 0.0


_AXIS_DIM = {
    (0, 1): "XPlus", (0, -1): "XMinus",
    (1, 1): "YPlus", (1, -1): "YMinus",
    (2, 1): "ZPlus", (2, -1): "ZMinus",
}


def keeps_mirror(cfg: KintinuousConfig) -> bool:
    """Whether the step keeps the dense bf16 mirror current (K3): not
    with pallas=False, whose gather raycast reads the volume itself, and
    only with an even number of blocks an edge, as the refresh works on
    (bz, by) row-pairs. Otherwise the state carries no mirror, as the
    JAX package's Tracker does (its logical0 = None), and the kernel
    raycast rebuilds one from the volume every frame (K5)."""
    return cfg.pallas is not False and (cfg.volume_resolution // 8) % 2 == 0


def preprocess_frame(cfg: KintinuousConfig, depth_raw, rgb_raw, half: bool = True):
    """Raw depth (mm) and rgb -> (bilateral-filtered depth in metres,
    rgb f32, half-resolution depth (None unless half), per-pixel colour
    fusion weight)."""
    depth_m = pp.depth_to_metres(
        pp.bilateral_filter(
            depth_raw.to(torch.float32), cfg.bilateral_sigma_depth,
            cfg.bilateral_sigma_space, cfg.bilateral_radius,
        ),
        cfg.max_depth,
    )
    depth_half = pp.pyr_down_depth(depth_m, sigma=0.09) if half else None
    disc = pp.depth_discontinuity_mask(
        depth_m, radius=3, jump_m=cfg.depth_discontinuity_mm * 1e-3
    )
    color_w = map_ops.color_fusion_weight(
        cfg.camera, depth_m, disc, angle=cfg.color_angle_weight
    )
    return depth_m, rgb_raw.to(torch.float32), depth_half, color_w


def _shift_of(cfg: KintinuousConfig, pose: torch.Tensor, dc: torch.Tensor):
    """(3,) i32 voxel shift [x,y,z] of the volume: +-voxel_shift on an
    axis where the anchor (the camera, moved dc down its optical axis
    with -dc) is voxel_shift voxels or more from the volume's centre."""
    thresh = cfg.voxel_shift * cfg.voxel_size
    off = pose[:3, 3] + pose[:3, 2] * dc - cfg.volume_size / 2.0
    S = cfg.voxel_shift
    return torch.where(off >= thresh, S, torch.where(off <= -thresh, -S, 0)).to(torch.int32)


def _odometry(cfg, cam, levels, iters, state, curr_pyr, curr_rgbd, reassoc_icp: int):
    """ICP, RGB-D or fused odometry of the current pyramids against the
    state's prediction (or, with -r/-ftf, its previous RGB-D frame):
    (T_curr_to_prev, inliers, residual)."""
    use_rgbd = cfg.rgbd_odometry or cfg.icp_plus_rgbd
    # the fused solve's ICP term against the raycast prediction (-ri);
    # RGB-D alone (-r) and frame-to-frame RGB-D (-ftf) drop it
    rgbd_icp = cfg.icp_plus_rgbd and not cfg.frame_to_frame_rgbd
    pred_pyr = None
    if rgbd_icp or not use_rgbd:
        Tinv = se3.inverse(state.pred_pose)
        Rm, tm = Tinv[:3, :3], Tinv[:3, 3]
        pv = torch.einsum("ij,jhw->ihw", Rm, state.pred_vmap) + tm[:, None, None]
        pn = torch.einsum("ij,jhw->ihw", Rm, state.pred_nmap)
        pred_pyr = pyramid_from_maps(pv, pn, levels)
    eye = torch.eye(4, dtype=torch.float32, device=state.pose.device)
    T0 = torch.where(state.pw > 0, state.prev_delta, eye)
    if use_rgbd:
        # the count is the RGB inlier count here
        return rgbd_icp_odometry(
            cam, curr_pyr, curr_rgbd, state.rgbd, pred_pyr, iters,
            icp_weight=cfg.rgbd_icp_weight, dist_thresh=cfg.icp_dist_thresh,
            angle_thresh_deg=cfg.icp_angle_thresh_deg,
            jump_reject_m=cfg.rgbd_jump_reject, reassoc_every=cfg.icp_reassoc_every,
            T_init=T0, T_prior=state.prev_delta, prior_weight=state.pw,
        )
    return icp_odometry(
        cam, curr_pyr, pred_pyr, iters, cfg.icp_dist_thresh, cfg.icp_angle_thresh_deg,
        reassoc_every=reassoc_icp, T_init=T0, T_prior=state.prev_delta,
        prior_weight=state.pw,
    )


def make_step(cfg: KintinuousConfig, use_odometry: bool):
    """The dense per-frame step (JAX make_step, tracking/tracker.py:162-
    359): step(state, depth_raw, rgb_raw, ext_delta) -> (new_state,
    outputs), as make_step_fast's, on a dense VolumeState updated in
    place. The shift is read on the host once, after odometry; only the
    axes that moved extract their band."""
    cam = cfg.camera
    R = cfg.volume_resolution
    vsz = cfg.voxel_size
    S = cfg.voxel_shift
    OV = cfg.shift_overlap
    levels = cfg.pyramid_levels
    iters = cfg.icp_fast_iterations if cfg.fast_odometry else cfg.icp_iterations
    use_rgbd = cfg.rgbd_odometry or cfg.icp_plus_rgbd
    band = {0: (S + OV, R, R), 1: (R, S + OV, R), 2: (R, R, S + OV)}

    def extract_axis(vol, axis: int, s: int):
        """The leaving band's points and, with meshing on, its mesh."""
        lo = [0, 0, 0]
        lo[axis] = 0 if s > 0 else R - S - OV
        pts = extract_points_packed(vol, lo, band[axis], vsz, cfg.extraction_capacity,
                                    min_weight=1.0)
        if not cfg.incremental_mesh:
            return pts, None
        return pts, extract_mesh(vol, lo, band[axis], vsz, cfg.mesh_vertex_capacity,
                                 cfg.mesh_face_capacity)

    def step(state: TrackerState, depth_raw, rgb_raw, ext_delta):
        dev = depth_raw.device
        with record_function("kt.preprocess"):
            depth_m, rgb, _, color_w = preprocess_frame(cfg, depth_raw, rgb_raw, half=False)
            curr_pyr = build_map_pyramid(cam, depth_m, levels)
            curr_rgbd = None
            if use_rgbd:
                curr_rgbd = build_rgbd_pyramid(pp.rgb_to_intensity(rgb), depth_m, levels)

        with record_function("kt.odometry"):
            if use_odometry:
                delta, icp_count, icp_res = _odometry(
                    cfg, cam, levels, iters, state, curr_pyr, curr_rgbd, reassoc_icp=1)
            else:
                delta = ext_delta
                icp_count = torch.zeros((), dtype=torch.float32, device=dev)
                icp_res = torch.zeros((), dtype=torch.float32, device=dev)
            pose = state.pose @ delta

        vol = state.vol
        slices = (None, None, None)
        meshes = (None, None, None)
        shift = torch.zeros(3, dtype=torch.int32, device=dev)
        if not cfg.static_mode:
            with record_function("kt.shift"):
                shift = _shift_of(cfg, pose, state.dc)
                shift_h = [int(s) for s in shift.cpu()]  # the shift's one host read
                if any(shift_h):
                    per_axis = [extract_axis(vol, a, s) if s != 0 else (None, None)
                                for a, s in enumerate(shift_h)]
                    slices = tuple(p for p, _ in per_axis)
                    meshes = tuple(m for _, m in per_axis)
                    # the recycled bands: logical [0, S) after a + shift,
                    # [R-S, R) after a - one (JAX tracker.py:295-314)
                    for axis, s in enumerate(shift_h):
                        if s:
                            clear_band(vol, axis, *((0, S) if s > 0 else (R - S, R)))
                    vol = vol._replace(
                        wrap=(vol.wrap + shift) % R,
                        origin=vol.origin + shift.to(torch.float32) * vsz,
                    )
                    pose = pose.clone()
                    pose[:3, 3] -= shift.to(torch.float32) * vsz

        with record_function("kt.integrate"):
            integrate(vol, cam, depth_m, rgb, color_w, pose, vsz, cfg.trunc_dist,
                      float(cfg.max_weight))
        with record_function("kt.raycast"):
            rc = raycast(vol, cam, pose, vsz, cfg.volume_size, cfg.trunc_dist,
                         cfg.raycast_step_factor, cfg.raycast_min_range,
                         cfg.raycast_max_range)
        pose_global = pose.clone()
        pose_global[:3, 3] += vol.origin
        new_state = state._replace(
            vol=vol, pose=pose, pred_vmap=rc.vmap, pred_nmap=rc.nmap,
            pred_pose=pose, frame=state.frame + 1, prev_delta=delta, rgbd=curr_rgbd,
        )
        out = StepOutputs(
            pose_local=pose, pose_global=pose_global, shift=shift, slices=slices,
            icp_count=icp_count, icp_residual=icp_res,
            raycast_hits=(rc.depth > 0).sum().to(torch.float32),
            mesh_patches=meshes if cfg.incremental_mesh else (),
        )
        return new_state, out

    return step


def make_step_fast(cfg: KintinuousConfig, use_odometry: bool):
    """The per-frame step: step(state, depth_raw, rgb_raw, ext_delta) ->
    (new_state, outputs). depth_raw (H,W) and rgb_raw (H,W,3) are tensors
    on the state's device; ext_delta (4,4) is used when use_odometry is
    False. The state's volume and mirror are updated in place."""
    cam = cfg.camera
    cam_half = cam.at_level(1)
    R = cfg.volume_resolution
    vsz = cfg.voxel_size
    S = cfg.voxel_shift
    OV = cfg.shift_overlap
    cap = cfg.extraction_capacity
    levels = max(2, cfg.pyramid_levels - 1)
    # schedule shifted one level: fast schedule (0,10,5,0) -> (10,5,0)
    base_iters = cfg.icp_fast_iterations if cfg.fast_odometry else cfg.icp_iterations
    iters = tuple(base_iters[1:]) if len(base_iters) > 1 else (10, 5)
    SLAB_B = max(2, -(-(S + OV + 1) // 8))  # block-planes around a band
    B_grid = R // 8
    use_rgbd = cfg.rgbd_odometry or cfg.icp_plus_rgbd
    # pallas=False: the JAX package's non-Pallas step, whose raycast is
    # the gather raycast (window 6, two Newton steps) and which keeps no
    # mirror; None or True run the kernels
    gather = cfg.pallas is False

    def extract_axis(vol, axis: int, s: int):
        """Points of the band leaving along `axis`, from a band-leading
        slab of the blocked volume, and with meshing on the band's mesh
        (else None)."""
        b0 = 0 if s > 0 else B_grid - SLAB_B
        view = VolumeState(
            tsdf=slab_to_dense(vol.tsdf, axis, b0, SLAB_B, leading=True),
            cw=slab_to_dense(vol.cw, axis, b0, SLAB_B, leading=True),
            wrap=torch.zeros(3, dtype=torch.int32, device=vol.tsdf.device),
            origin=vol.origin[list(VIEW_AXES[axis])],
        )
        lo = (0, 0, 0 if s > 0 else SLAB_B * 8 - S - OV)
        pts = extract_points_packed(
            view, lo, (R, R, S + OV), vsz, cap,
            clamp_edges=True, coord_offset=(0, 0, b0 * 8),
        )
        inv = list(VIEW_INV[axis])
        pts = pts._replace(vals=pts.vals[:, inv + [3, 4, 5, 6, 7]])
        if not cfg.incremental_mesh:
            return pts, None
        m = extract_mesh(view, lo, (R, R, S + OV), vsz, cfg.mesh_vertex_capacity,
                         cfg.mesh_face_capacity, clamp_edges=True,
                         coord_offset=(0, 0, b0 * 8))
        # an even permutation of the axes: the winding stays right
        return pts, m._replace(vertices=m.vertices[:, inv], cells=m.cells[:, inv])

    def step(state: TrackerState, depth_raw, rgb_raw, ext_delta):
        dev = depth_raw.device
        with record_function("kt.preprocess"):
            depth_m, rgb, depth_half, color_w = preprocess_frame(cfg, depth_raw, rgb_raw)
            curr_pyr = build_map_pyramid(cam_half, depth_half, levels)
            curr_rgbd = None
            if use_rgbd:
                intensity_half = pp.pyr_down_gauss(pp.rgb_to_intensity(rgb))
                curr_rgbd = build_rgbd_pyramid(intensity_half, depth_half, levels)

        with record_function("kt.odometry"):
            if use_odometry:
                delta, icp_count, icp_res = _odometry(
                    cfg, cam_half, levels, iters, state, curr_pyr, curr_rgbd,
                    reassoc_icp=cfg.icp_reassoc_every)
            else:
                delta = ext_delta
                icp_count = torch.zeros((), dtype=torch.float32, device=dev)
                icp_res = torch.zeros((), dtype=torch.float32, device=dev)
            pose = state.pose @ delta

        vol = state.vol
        slices = (None, None, None)
        meshes = (None, None, None)
        shift = torch.zeros(3, dtype=torch.int32, device=dev)
        shift_any = False
        if not cfg.static_mode:
            with record_function("kt.shift"):
                shift = _shift_of(cfg, pose, state.dc)
                # the step's one host synchronisation
                shift_h = [int(s) for s in shift.cpu()]
                shift_any = any(shift_h)
                if shift_any:
                    per_axis = [extract_axis(vol, a, s) if s != 0 else (None, None)
                                for a, s in enumerate(shift_h)]
                    slices = tuple(p for p, _ in per_axis)
                    meshes = tuple(m for _, m in per_axis)
                    t, c = shift_roll_clear(vol.tsdf, vol.cw, shift, S, R)
                    vol = vol._replace(
                        tsdf=t, cw=c,
                        origin=vol.origin + shift.to(torch.float32) * vsz,
                    )
                    pose = pose.clone()
                    pose[:3, 3] -= shift.to(torch.float32) * vsz

        with record_function("kt.integrate"):
            integrate_cuda(
                vol, cam, depth_m, rgb, color_w, pose, vsz, cfg.trunc_dist,
                float(cfg.max_weight), band_cap=cfg.band_cap,
                mirror=state.logical, dirty_all=shift_any,
            )
        with record_function("kt.raycast"):
            # warm start from the measured depth only (as the JAX package)
            if gather:
                rc = raycast_fast(vol, cam_half, pose, None, depth_half, vsz,
                                  cfg.volume_size, cfg.trunc_dist)
            else:
                rc = raycast_cuda(
                    vol, cam_half, pose, depth_half, vsz, cfg.volume_size,
                    cfg.trunc_dist, mirror=state.logical,
                    newton=cfg.raycast_newton_iters,
                )
        pose_global = pose.clone()
        pose_global[:3, 3] += vol.origin
        new_state = state._replace(
            vol=vol, pose=pose, pred_vmap=rc.vmap, pred_nmap=rc.nmap,
            pred_pose=pose, frame=state.frame + 1, prev_delta=delta,
            rgbd=curr_rgbd,
        )
        out = StepOutputs(
            pose_local=pose, pose_global=pose_global, shift=shift,
            slices=slices, icp_count=icp_count, icp_residual=icp_res,
            raycast_hits=(rc.depth > 0).sum().to(torch.float32),
            mesh_patches=meshes if cfg.incremental_mesh else (),
            raycast_fallback=rc.fallback_frac,
        )
        return new_state, out

    return step


def initial_state(cfg: KintinuousConfig, device) -> TrackerState:
    """Empty volume, camera at the volume centre, NaN predictions, and
    for RGB-D odometry the pyramid of an all-zero frame. Fast mode: the
    blocked volume, half-resolution maps and pyramid, and the mirror
    (none with an odd block count); dense: the dense volume and
    full-resolution maps and pyramid, no mirror."""
    fast = cfg.fast_mode
    h, w = cfg.camera.height, cfg.camera.width
    levels = cfg.pyramid_levels
    if fast:
        h, w, levels = h // 2, w // 2, max(2, levels - 1)
    R = cfg.volume_resolution
    pose = torch.eye(4, dtype=torch.float32, device=device)
    pose[:3, 3] = cfg.volume_size / 2.0
    rgbd = None
    if cfg.rgbd_odometry or cfg.icp_plus_rgbd:
        zero = torch.zeros((h, w), dtype=torch.float32, device=device)
        rgbd = build_rgbd_pyramid(zero, zero, levels)
    return TrackerState(
        vol=(make_blocked_volume if fast else make_volume)(R, device=device),
        pose=pose,
        pred_vmap=torch.full((3, h, w), torch.nan, device=device),
        pred_nmap=torch.full((3, h, w), torch.nan, device=device),
        pred_pose=pose.clone(),
        frame=torch.zeros((), dtype=torch.int32, device=device),
        rgbd=rgbd,
        dc=torch.full((), 0.35 * cfg.volume_size if cfg.dynamic_cube else 0.0,
                      dtype=torch.float32, device=device),
        prev_delta=torch.eye(4, dtype=torch.float32, device=device),
        pw=torch.full((), cfg.odom_prior_weight, dtype=torch.float32,
                      device=device),
        # zeros == the mirror of the zero volume
        logical=(torch.zeros((R, R, R), dtype=torch.bfloat16, device=device)
                 if fast and keeps_mirror(cfg) else None),
    )


def state_from_numpy(st, device) -> TrackerState:
    """A tracker state given as numpy arrays under the JAX package's
    field names (e.g. its TrackerState after device_get) -> this port's
    state on `device`: tsdf f32, cw u32 as int32 bits, the bf16 mirror
    through its 16-bit pattern, the RGB-D pyramid level by level. A
    cubic (R,R,R) tsdf is the dense step's volume (a VolumeState), any
    other the blocked one."""
    dev = resolve_device(device)

    def t(x, dtype=np.float32):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(dev)

    vol = st.vol
    mirror = None
    if st.logical is not None:
        bits = np.ascontiguousarray(np.asarray(st.logical)).view(np.int16)
        mirror = torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)
    rgbd = None
    if st.rgbd is not None:
        rgbd = RGBDFramePyramid(*(tuple(t(x) for x in field) for field in st.rgbd))
    shape = np.shape(vol.tsdf)
    dense = len(set(shape)) == 1
    return TrackerState(
        vol=(VolumeState if dense else BlockedVolume)(
            tsdf=t(vol.tsdf),
            cw=torch.from_numpy(
                np.array(vol.cw, dtype=np.uint32).view(np.int32)).to(dev),
            wrap=t(vol.wrap, np.int32), origin=t(vol.origin),
        ),
        pose=t(st.pose), pred_vmap=t(st.pred_vmap), pred_nmap=t(st.pred_nmap),
        pred_pose=t(st.pred_pose), frame=t(st.frame, np.int32),
        dc=t(st.dc), prev_delta=t(st.prev_delta), pw=t(st.pw),
        logical=mirror, rgbd=rgbd,
    )


def state_to_numpy(state: TrackerState) -> TrackerState:
    """The port's state as numpy arrays under the same field names: cw as
    uint32, the mirror as the uint16 bit pattern of its bf16 values
    (view it as ml_dtypes.bfloat16 to hand it to JAX)."""
    def n(x):
        return x.detach().cpu().numpy()

    vol = state.vol
    return state._replace(
        vol=vol._replace(tsdf=n(vol.tsdf), cw=n(vol.cw).view(np.uint32),
                         wrap=n(vol.wrap), origin=n(vol.origin)),
        pose=n(state.pose), pred_vmap=n(state.pred_vmap),
        pred_nmap=n(state.pred_nmap), pred_pose=n(state.pred_pose),
        frame=n(state.frame), dc=n(state.dc), prev_delta=n(state.prev_delta),
        pw=n(state.pw),
        logical=(None if state.logical is None
                 else n(state.logical.view(torch.int16)).view(np.uint16)),
        rgbd=(None if state.rgbd is None else RGBDFramePyramid(
            *(tuple(n(x) for x in field) for field in state.rgbd))),
    )


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`: pinned and non-blocking on a card, so the
    upload does not wait for the previous frame's device work. A decoded
    log frame is a read-only view: copied only then."""
    t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Tracker:
    """Host wrapper: owns the device state, streams frames through the
    step, and materialises poses and slices on the host one frame late.

    device=None means the CUDA card and raises without one; the tests
    pass device="cpu", where every kernel runs its plain version."""

    def __init__(self, cfg: KintinuousConfig, device=None,
                 slice_callback: Optional[Callable[[CloudSlice], None]] = None,
                 mesh_callback: Optional[Callable[[MeshPatch], None]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        make = make_step_fast if cfg.fast_mode else make_step
        self._step_odom = make(cfg, use_odometry=True)
        self._step_ext = make(cfg, use_odometry=False)
        self.state = initial_state(cfg, self.device)
        self._pending: deque = deque()  # (out, timestamp_us, frame_idx)
        self.slices: List[CloudSlice] = []
        self.mesh_patches: List[MeshPatch] = []  # band meshes (meshing on)
        self.poses: List[np.ndarray] = []
        self.stamps_us: List[int] = []
        self.slice_callback = slice_callback
        self.mesh_callback = mesh_callback
        self.pose_callback: Optional[Callable] = None
        self._frame_idx = 0
        self.stats = {"icp_count": [], "icp_residual": [], "raycast_fallback": []}
        self.shift_log: List[np.ndarray] = []
        self.collect_slices: bool = True

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return upload(arr, self.device)

    def process_frame(self, depth_mm: np.ndarray, rgb: Optional[np.ndarray],
                      timestamp_us: int,
                      ext_delta: Optional[np.ndarray] = None) -> None:
        """Feed one frame. depth_mm (H,W) uint16/float, rgb (H,W,3) uint8
        or None. ext_delta replaces odometry (ground-truth replay) when
        given; the first frame always uses identity."""
        dn = np.asarray(depth_mm)
        d = self._upload(dn if dn.dtype == np.uint16 else dn.astype(np.float32))
        if rgb is None:
            c = torch.zeros((*dn.shape, 3), dtype=torch.uint8, device=self.device)
        else:
            c = self._upload(np.asarray(rgb, dtype=np.uint8))
        first = self._frame_idx == 0
        if ext_delta is not None or first:
            delta = np.eye(4, dtype=np.float32) if (first or ext_delta is None) \
                else np.asarray(ext_delta, dtype=np.float32)
            self.state, out = self._step_ext(self.state, d, c, self._upload(delta))
        else:
            self.state, out = self._step_odom(self.state, d, c, None)
        self._push(out, timestamp_us)

    def _push(self, out: StepOutputs, timestamp_us: int) -> None:
        """Queue a frame's outputs and consume the previous frame's."""
        self._pending.append((out, timestamp_us, self._frame_idx))
        self._frame_idx += 1
        while len(self._pending) > 1:
            self._consume(*self._pending.popleft())

    def process_frames(self, frames) -> None:
        """Batched offline path: frames is a list of (depth_u16 (H,W),
        rgb_u8 (H,W,3) or None, timestamp_us). The first frame of a run
        goes through process_frame (identity delta); the rest run as one
        batch with odometry on every frame. Fast mode only, as in the JAX
        package."""
        if not self.cfg.fast_mode:
            raise ValueError("the batched path needs fast_mode")
        while frames and self._frame_idx == 0:
            self.process_frame(*frames[0])
            frames = frames[1:]
        if not frames:
            return
        self.process_batch_device(*self.upload_batch(frames))
        self.flush()

    def upload_batch(self, frames):
        """Host -> device upload of a frame batch, callable from a
        prefetch thread so the copy overlaps device work. Returns
        (depths, rgbs, ts_list) for process_batch_device."""
        H, W = self.cfg.camera.height, self.cfg.camera.width
        depths = np.stack([np.asarray(f[0], np.uint16) for f in frames])
        rgbs = np.stack([np.asarray(f[1], np.uint8) if f[1] is not None
                         else np.zeros((H, W, 3), np.uint8) for f in frames])
        return self._upload(depths), self._upload(rgbs), [f[2] for f in frames]

    def process_batch_device(self, depths, rgbs, ts_list) -> None:
        """A batch of uploaded frames (depths (B,H,W), rgbs (B,H,W,3) on
        the device): the per-frame step with odometry on each, outputs
        consumed one frame late as in process_frame."""
        if not self.cfg.fast_mode:
            raise ValueError("the batched path needs fast_mode")
        if self._frame_idx == 0:
            raise ValueError("the first frame must go through process_frame")
        for d, c, ts in zip(depths, rgbs, ts_list):
            self.state, out = self._step_odom(self.state, d, c, None)
            self._push(out, ts)

    def warm_per_frame_step(self) -> None:
        """Build the CUDA kernels ahead of need, so the offline tail's
        first per-frame step does not pay for it inside the run (the JAX
        package compiles its per-frame program here; PyTorch has nothing
        to compile). Safe to call from a background thread."""
        if self.device.type == "cuda":
            from kintinuous_tpu_torch.ops import kernels

            kernels.build()

    def _take_mesh_patch(self, res, timestamp_us: int) -> None:
        patch = patch_from_result(res, timestamp_us)
        if len(patch.vertices) == 0 or len(patch.faces) == 0:
            return
        self.mesh_patches.append(patch)
        if self.mesh_callback:
            self.mesh_callback(patch)

    def _consume(self, out: StepOutputs, timestamp_us: int, frame_idx: int) -> None:
        zero = torch.zeros_like(out.shift[0])
        counts = [s.count if s is not None else zero for s in out.slices]
        scal = torch.cat([
            out.pose_global.reshape(-1),
            torch.stack([out.icp_count, out.icp_residual,
                         torch.as_tensor(out.raycast_fallback,
                                         device=out.shift.device)]).float(),
            torch.stack(counts).float(), out.shift.float(),
        ]).cpu().numpy()  # one read for every scalar
        pose_g = scal[:16].reshape(4, 4).astype(np.float32)
        icp_c, icp_r, fb = scal[16:19]
        cnt3 = scal[19:22].astype(np.int64)
        shift = scal[22:25].astype(np.int32)
        self.poses.append(pose_g)
        self.stamps_us.append(timestamp_us)
        if self.pose_callback:
            self.pose_callback(timestamp_us, pose_g)
        self.stats["icp_count"].append(float(icp_c))
        self.stats["icp_residual"].append(float(icp_r))
        self.stats["raycast_fallback"].append(float(fb))
        self.shift_log.append(shift)
        if not self.collect_slices:
            return
        for axis in range(3):
            s, cnt = int(shift[axis]), int(cnt3[axis])
            if s == 0 or cnt == 0:
                continue
            v = out.slices[axis].vals[:cnt].cpu().numpy()
            sl = CloudSlice(
                points=v[:, 0:3], colors=np.clip(v[:, 3:6], 0, 255).astype(np.uint8),
                weights=v[:, 6], dimension=_AXIS_DIM[(axis, 1 if s > 0 else -1)],
                pose=pose_g, timestamp_us=timestamp_us, frame_index=frame_idx,
                wall_time=_time.time(),
            )
            self.slices.append(sl)
            if self.slice_callback:
                self.slice_callback(sl)
            if out.mesh_patches:
                self._take_mesh_patch(out.mesh_patches[axis], timestamp_us)

    def flush(self) -> None:
        while self._pending:
            self._consume(*self._pending.popleft())

    def finalise(self) -> CloudSlice:
        """Extract the whole remaining volume as the FINAL slice, and with
        meshing on its mesh as the last patch."""
        self.flush()
        cfg = self.cfg
        R = cfg.volume_resolution
        dense = as_dense(self.state.vol)
        res = extract_points(dense, (0, 0, 0), (R, R, R), cfg.voxel_size,
                             cfg.extraction_capacity)
        cnt = int(res.count)
        sl = CloudSlice(
            points=res.points[:cnt].cpu().numpy(),
            colors=np.clip(res.colors[:cnt].cpu().numpy(), 0, 255).astype(np.uint8),
            weights=res.weights[:cnt].cpu().numpy(),
            dimension="FINAL",
            pose=self.poses[-1] if self.poses else np.eye(4),
            timestamp_us=self.stamps_us[-1] if self.stamps_us else 0,
            frame_index=self._frame_idx,
            wall_time=_time.time(),
        )
        self.slices.append(sl)
        if self.slice_callback:
            self.slice_callback(sl)
        if cfg.incremental_mesh:
            self._take_mesh_patch(
                extract_mesh(dense, (0, 0, 0), (R, R, R), cfg.voxel_size,
                             cfg.mesh_vertex_capacity, cfg.mesh_face_capacity),
                sl.timestamp_us)
        return sl

    @property
    def global_pose(self) -> np.ndarray:
        self.flush()
        return self.poses[-1] if self.poses else np.eye(4)
