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
reads every 32 march steps whether a ray is still marching. The stages
run inside torch.profiler ranges (kt.preprocess, kt.odometry,
kt.shift, kt.integrate, kt.raycast) that a trace can sum.

The JAX package compiles the whole step into one program with the
state donated (its tracker.py:632); eager PyTorch would launch each of
a frame's thousands of small ops from Python. So `Tracker` runs the
fast step as `CapturedStep`: the same halves as `make_step_fast`
(`FastHalves`) on buffers whose storage is fixed for the tracker's
life, and on a card as CUDA graphs (tracking/graphs.py). A frame is a
front graph (preprocess, odometry, the new pose and the shift
decision; one per odometry or external delta), the shift read, and on
a frame without a shift a back graph (fusion, raycast, the state's
update). Eager are only each piece's first run (its warm-up) and a
shift frame's back half; in static mode the two halves are one graph.
On the CPU the same pieces run eagerly. `make_step_fast` stays the
eager step, which the captured one is held against. The dense step
runs eagerly.

Outputs are consumed one frame late, so downloading poses and slices
overlaps the next device work: each frame's scalars go to one of two
output slots, on a card with a pinned host copy that the host reads
once its event has passed. The JAX package's batched step (make_batched_step_fast)
scans a batch in one program with the shift decided on the device and
the batch's slices in a fixed-size pool; here a batch is the per-frame
step in a loop (`Tracker.process_batch_device`) and keeps every slice.
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
from kintinuous_tpu_torch.tracking.graphs import CAPTURED, EAGER, Pieces
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


class FrontOut(NamedTuple):
    """The fast step's front half: what its back half reads."""

    depth_m: torch.Tensor  # (H,W) filtered metres
    rgb: torch.Tensor  # (H,W,3) f32
    depth_half: torch.Tensor  # (h,w)
    color_w: torch.Tensor  # (H,W) colour fusion weight
    delta: torch.Tensor  # (4,4) odometry (or the external) delta
    pose: torch.Tensor  # (4,4) the new pose, before any shift
    icp_count: torch.Tensor  # ()
    icp_residual: torch.Tensor  # ()
    shift: torch.Tensor  # (3,) i32 the shift decision
    rgbd: Optional[RGBDFramePyramid]  # this frame's (RGB-D odometry)


class FastHalves:
    """The fast step (make_step_fast) in its parts around the step's one
    host read, the shift: `front` (preprocess, the pyramids, odometry,
    the new pose and the shift decision), `roll` (a shift frame's band
    extraction and the roll of the volume), `back` (fusion with the
    mirror refresh, and the raycast)."""

    def __init__(self, cfg: KintinuousConfig):
        self.cfg = cfg
        self.cam = cfg.camera
        self.cam_half = cfg.camera.at_level(1)
        self.levels = max(2, cfg.pyramid_levels - 1)
        # schedule shifted one level: fast schedule (0,10,5,0) -> (10,5,0)
        base_iters = cfg.icp_fast_iterations if cfg.fast_odometry else cfg.icp_iterations
        self.iters = tuple(base_iters[1:]) if len(base_iters) > 1 else (10, 5)
        S, OV = cfg.voxel_shift, cfg.shift_overlap
        self.slab_b = max(2, -(-(S + OV + 1) // 8))  # block-planes around a band
        self.use_rgbd = cfg.rgbd_odometry or cfg.icp_plus_rgbd
        # pallas=False: the JAX package's non-Pallas step, whose raycast is
        # the gather raycast (window 6, two Newton steps) and which keeps no
        # mirror; None or True run the kernels
        self.gather = cfg.pallas is False

    def extract_axis(self, vol, axis: int, s: int):
        """Points of the band leaving along `axis`, from a band-leading
        slab of the blocked volume, and with meshing on the band's mesh
        (else None)."""
        cfg, R, SLAB_B = self.cfg, self.cfg.volume_resolution, self.slab_b
        S, OV, vsz = cfg.voxel_shift, cfg.shift_overlap, cfg.voxel_size
        b0 = 0 if s > 0 else R // 8 - SLAB_B
        view = VolumeState(
            tsdf=slab_to_dense(vol.tsdf, axis, b0, SLAB_B, leading=True),
            cw=slab_to_dense(vol.cw, axis, b0, SLAB_B, leading=True),
            wrap=torch.zeros(3, dtype=torch.int32, device=vol.tsdf.device),
            origin=vol.origin[list(VIEW_AXES[axis])],
        )
        lo = (0, 0, 0 if s > 0 else SLAB_B * 8 - S - OV)
        pts = extract_points_packed(
            view, lo, (R, R, S + OV), vsz, cfg.extraction_capacity,
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

    def front(self, state: TrackerState, depth_raw, rgb_raw, ext_delta,
              use_odometry: bool) -> FrontOut:
        """Reads the state, writes nothing of it."""
        cfg, dev = self.cfg, depth_raw.device
        with record_function("kt.preprocess"):
            depth_m, rgb, depth_half, color_w = preprocess_frame(cfg, depth_raw, rgb_raw)
            curr_pyr = build_map_pyramid(self.cam_half, depth_half, self.levels)
            curr_rgbd = None
            if self.use_rgbd:
                intensity_half = pp.pyr_down_gauss(pp.rgb_to_intensity(rgb))
                curr_rgbd = build_rgbd_pyramid(intensity_half, depth_half, self.levels)

        with record_function("kt.odometry"):
            if use_odometry:
                delta, icp_count, icp_res = _odometry(
                    cfg, self.cam_half, self.levels, self.iters, state, curr_pyr,
                    curr_rgbd, reassoc_icp=cfg.icp_reassoc_every)
            else:
                delta = ext_delta
                icp_count = torch.zeros((), dtype=torch.float32, device=dev)
                icp_res = torch.zeros((), dtype=torch.float32, device=dev)
            pose = state.pose @ delta
        with record_function("kt.shift"):
            shift = (torch.zeros(3, dtype=torch.int32, device=dev) if cfg.static_mode
                     else _shift_of(cfg, pose, state.dc))
        return FrontOut(depth_m, rgb, depth_half, color_w, delta, pose, icp_count,
                        icp_res, shift, curr_rgbd)

    def roll(self, vol: BlockedVolume, pose, shift, shift_h):
        """A shift frame: the leaving bands' points (and meshes), then the
        volume rolled and cleared (new tensors) with its origin moved,
        and the pose moved back. Returns (vol, pose, slices, meshes)."""
        cfg = self.cfg
        per_axis = [self.extract_axis(vol, a, s) if s != 0 else (None, None)
                    for a, s in enumerate(shift_h)]
        t, c = shift_roll_clear(vol.tsdf, vol.cw, shift, cfg.voxel_shift,
                                cfg.volume_resolution)
        vol = vol._replace(tsdf=t, cw=c,
                           origin=vol.origin + shift.to(torch.float32) * cfg.voxel_size)
        pose = pose.clone()
        pose[:3, 3] -= shift.to(torch.float32) * cfg.voxel_size
        return (vol, pose, tuple(p for p, _ in per_axis),
                tuple(m for _, m in per_axis))

    def back(self, mirror, vol: BlockedVolume, fo: FrontOut, pose, shift_any: bool):
        """Fuse the frame into the volume and the mirror (in place) and
        cast the next prediction; returns the raycast's result."""
        cfg = self.cfg
        with record_function("kt.integrate"):
            integrate_cuda(
                vol, self.cam, fo.depth_m, fo.rgb, fo.color_w, pose, cfg.voxel_size,
                cfg.trunc_dist, float(cfg.max_weight), band_cap=cfg.band_cap,
                mirror=mirror, dirty_all=shift_any,
            )
        with record_function("kt.raycast"):
            # warm start from the measured depth only (as the JAX package)
            if self.gather:
                return raycast_fast(vol, self.cam_half, pose, None, fo.depth_half,
                                    cfg.voxel_size, cfg.volume_size, cfg.trunc_dist)
            return raycast_cuda(
                vol, self.cam_half, pose, fo.depth_half, cfg.voxel_size, cfg.volume_size,
                cfg.trunc_dist, mirror=mirror, newton=cfg.raycast_newton_iters,
            )

    def outputs(self, fo: FrontOut, pose, origin, rc, slices, meshes) -> StepOutputs:
        pose_global = pose.clone()
        pose_global[:3, 3] += origin
        return StepOutputs(
            pose_local=pose, pose_global=pose_global, shift=fo.shift,
            slices=slices, icp_count=fo.icp_count, icp_residual=fo.icp_residual,
            raycast_hits=(rc.depth > 0).sum().to(torch.float32),
            mesh_patches=meshes if self.cfg.incremental_mesh else (),
            raycast_fallback=rc.fallback_frac,
        )


def make_step_fast(cfg: KintinuousConfig, use_odometry: bool):
    """The per-frame step, eager: step(state, depth_raw, rgb_raw,
    ext_delta) -> (new_state, outputs). depth_raw (H,W) and rgb_raw
    (H,W,3) are tensors on the state's device; ext_delta (4,4) is used
    when use_odometry is False. The state's volume and mirror are updated
    in place. `Tracker` runs the same halves on fixed buffers
    (`CapturedStep`), captured on a card."""
    halves = FastHalves(cfg)

    def step(state: TrackerState, depth_raw, rgb_raw, ext_delta):
        fo = halves.front(state, depth_raw, rgb_raw, ext_delta, use_odometry)
        vol, pose = state.vol, fo.pose
        slices = meshes = (None, None, None)
        shift_any = False
        if not cfg.static_mode:
            with record_function("kt.shift"):
                # the step's one host synchronisation
                shift_h = [int(s) for s in fo.shift.cpu()]
                shift_any = any(shift_h)
                if shift_any:
                    vol, pose, slices, meshes = halves.roll(vol, pose, fo.shift, shift_h)
        rc = halves.back(state.logical, vol, fo, pose, shift_any)
        new_state = state._replace(
            vol=vol, pose=pose, pred_vmap=rc.vmap, pred_nmap=rc.nmap,
            pred_pose=pose, frame=state.frame + 1, prev_delta=fo.delta,
            rgbd=fo.rgbd,
        )
        return new_state, halves.outputs(fo, pose, vol.origin, rc, slices, meshes)

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


# a frame's scalars in one f32 vector, read on the host in one copy:
# [pose_global (16) | icp count, residual, raycast fallback | slice
# counts x,y,z | shift x,y,z | raycast hits]
N_SCALARS = 26
# Tracker.stats["step_mode"]: how each frame's step ran
STEP_MODES = ("warmup", "shift", "captured", "replayed", "eager")


def pack_scalars(out: StepOutputs) -> torch.Tensor:
    """A step's outputs -> its (N_SCALARS,) f32 vector, on the device."""
    dev = out.shift.device
    zero = torch.zeros_like(out.shift[0])
    counts = [s.count if s is not None else zero for s in out.slices]
    fb = out.raycast_fallback
    if not torch.is_tensor(fb):  # a constant (the gather raycast's 0.0)
        fb = torch.full((), float(fb), dtype=torch.float32, device=dev)
    return torch.cat([
        out.pose_global.reshape(-1),
        torch.stack([out.icp_count, out.icp_residual, fb]).float(),
        torch.stack(counts).float(), out.shift.float(),
        out.raycast_hits.reshape(1).float(),
    ])


class FrameResult(NamedTuple):
    """What the host reads of a frame, one frame late."""

    scalars: torch.Tensor  # (N_SCALARS,) f32, see pack_scalars
    slices: Tuple  # per axis: PackedExtract or None
    mesh_patches: Tuple  # per axis: MeshResult or None (meshing on), else ()
    mode: str  # one of STEP_MODES
    # on a card's captured step: (the scalars' pinned host copy, the
    # event after its copy), read without waiting for later frames' work
    host: Optional[Tuple] = None


def _own(state: TrackerState) -> TrackerState:
    """The state with fresh storage for every field but the volume's
    tsdf and cw and the mirror, which are kept: no two fields share
    storage (initial_state's zero RGB-D pyramid does), so each can be
    written in place."""
    def c(x):
        return None if x is None else x.clone()

    vol = state.vol
    return state._replace(
        vol=vol._replace(wrap=c(vol.wrap), origin=c(vol.origin)),
        pose=c(state.pose), pred_vmap=c(state.pred_vmap), pred_nmap=c(state.pred_nmap),
        pred_pose=c(state.pred_pose), frame=c(state.frame), dc=c(state.dc),
        prev_delta=c(state.prev_delta), pw=c(state.pw),
        rgbd=(None if state.rgbd is None else RGBDFramePyramid(
            *(tuple(c(x) for x in field) for field in state.rgbd))),
    )


class CapturedStep:
    """make_step_fast on buffers whose storage is fixed for the tracker's
    life, in pieces (tracking/graphs.Pieces) that a card runs as CUDA
    graphs: the front half (FastHalves.front, with the pyramid and the
    delta written into the state), one per (odometry | external delta);
    then the host reads the shift; then on a frame without a shift the
    back half (fusion, raycast and the state's update). A shift frame
    runs its roll and back half eagerly, writing into the same buffers.
    In static mode nothing is read: front and back are one piece.

    The inputs are copied into fixed buffers, the front half's results
    live in fixed buffers (`fo`), and every frame's scalars go to one of
    two output slots, so frame k's outlive frame k+1's step. Setting
    `state` adopts the given state's tensors as the buffers and drops
    the captures; a replay against buffers that moved raises."""

    def __init__(self, cfg: KintinuousConfig, state: TrackerState, device: torch.device):
        self.cfg = cfg
        self.halves = FastHalves(cfg)
        self.pieces = Pieces(device)
        cam = cfg.camera
        self.depth_in = torch.zeros((cam.height, cam.width), dtype=torch.float32,
                                    device=device)
        self.rgb_in = torch.zeros((cam.height, cam.width, 3), dtype=torch.uint8,
                                  device=device)
        self.delta_in = torch.eye(4, dtype=torch.float32, device=device)
        self.scratch = torch.zeros(N_SCALARS, dtype=torch.float32, device=device)
        self.slots = torch.zeros((2, N_SCALARS), dtype=torch.float32, device=device)
        # on a card each slot is also copied to pinned host memory, and an
        # event marks the copy's end: the host reads frame k's scalars
        # while the card still runs frame k+1's back half
        self.host_slots = self.ready = None
        if device.type == "cuda":
            self.host_slots = torch.zeros((2, N_SCALARS), dtype=torch.float32, pin_memory=True)
            self.ready = (torch.cuda.Event(), torch.cuda.Event())
        self.fo: Optional[FrontOut] = None  # made by the first front half
        self._n = 0  # frames stepped
        self.state = state

    @property
    def state(self) -> TrackerState:
        return self._state

    @state.setter
    def state(self, state: TrackerState) -> None:
        self._state = _own(state)
        self.pieces.drop()

    def buffers(self) -> list:
        """Every tensor a piece reads or writes."""
        st = self._state
        out = [st.vol.tsdf, st.vol.cw, st.vol.wrap, st.vol.origin, st.logical, st.pose,
               st.pred_vmap, st.pred_nmap, st.pred_pose, st.frame, st.dc,
               st.prev_delta, st.pw, self.depth_in, self.rgb_in, self.delta_in,
               self.scratch]
        for field in st.rgbd or ():
            out.extend(field)
        if self.fo is not None:
            out.extend(x for x in self.fo[:-1])
        return out

    def _front(self, use_odometry: bool) -> None:
        st = self._state
        fo = self.halves.front(st, self.depth_in, self.rgb_in,
                               None if use_odometry else self.delta_in, use_odometry)
        if self.fo is None:  # the first front half, eager: make the buffers
            self.fo = FrontOut(*(x.clone() for x in fo[:-1]), None)
        else:
            for dst, src in zip(self.fo[:-1], fo[:-1]):
                dst.copy_(src)
        st.prev_delta.copy_(fo.delta)
        if fo.rgbd is not None:  # the next frame's previous RGB-D frame
            for dst, src in zip(st.rgbd, fo.rgbd):
                for d, x in zip(dst, src):
                    d.copy_(x)

    def _finish(self, pose, rc, slices, meshes) -> None:
        """The state's update and the frame's scalars."""
        st = self._state
        st.pose.copy_(pose)
        st.pred_pose.copy_(pose)
        st.pred_vmap.copy_(rc.vmap)
        st.pred_nmap.copy_(rc.nmap)
        st.frame.add_(1)
        out = self.halves.outputs(self.fo, pose, st.vol.origin, rc, slices, meshes)
        self.scratch.copy_(pack_scalars(out))

    def _back(self) -> None:
        st = self._state
        rc = self.halves.back(st.logical, st.vol, self.fo, self.fo.pose, False)
        self._finish(self.fo.pose, rc, (None, None, None), (None, None, None))

    def _back_shift(self, shift_h):
        st, fo = self._state, self.fo
        with record_function("kt.shift"):
            vol, pose, slices, meshes = self.halves.roll(st.vol, fo.pose, fo.shift, shift_h)
            st.vol.tsdf.copy_(vol.tsdf)
            st.vol.cw.copy_(vol.cw)
            st.vol.origin.copy_(vol.origin)
            del vol
        rc = self.halves.back(st.logical, st.vol, fo, pose, True)
        self._finish(pose, rc, slices, meshes)
        return slices, meshes

    def __call__(self, depth_raw, rgb_raw, ext_delta,
                 use_odometry: bool) -> FrameResult:
        """One frame: depth_raw (H,W) and rgb_raw (H,W,3) u8 on the
        device, ext_delta (4,4) when use_odometry is False."""
        cfg, pieces = self.cfg, self.pieces
        slices = meshes = (None, None, None)
        shift = False
        with pieces.on_stream():
            self.depth_in.copy_(depth_raw)
            self.rgb_in.copy_(rgb_raw)
            if not use_odometry:
                self.delta_in.copy_(ext_delta)
            name = "odometry" if use_odometry else "ext_delta"
            if cfg.static_mode:
                modes = [pieces.run(f"{name}+back", lambda: (self._front(use_odometry),
                                                              self._back()), self.buffers)]
            else:
                modes = [pieces.run(name, lambda: self._front(use_odometry), self.buffers)]
                with record_function("kt.shift"):
                    # the step's one host synchronisation
                    shift_h = [int(s) for s in self.fo.shift.cpu()]
                shift = any(shift_h)
                if shift:
                    slices, meshes = self._back_shift(shift_h)
                else:
                    modes.append(pieces.run("back", self._back, self.buffers))
            k = self._n % 2
            slot = self.slots[k]
            slot.copy_(self.scratch)
            host = None
            if self.host_slots is not None:
                self.host_slots[k].copy_(slot, non_blocking=True)
                self.ready[k].record()
                host = (self.host_slots[k], self.ready[k])
        self._n += 1
        mode = ("shift" if shift else "warmup" if EAGER in modes
                else "captured" if CAPTURED in modes else "replayed")
        return FrameResult(slot, slices, meshes if cfg.incremental_mesh else (), mode, host)


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
        state = initial_state(cfg, self.device)
        # the fast step on fixed buffers, captured on a card; the dense
        # step eager
        self._captured = CapturedStep(cfg, state, self.device) if cfg.fast_mode else None
        if self._captured is None:
            self._step_odom = make_step(cfg, use_odometry=True)
            self._step_ext = make_step(cfg, use_odometry=False)
            self._state = state
        self._pending: deque = deque()  # (out, timestamp_us, frame_idx)
        self.slices: List[CloudSlice] = []
        self.mesh_patches: List[MeshPatch] = []  # band meshes (meshing on)
        self.poses: List[np.ndarray] = []
        self.stamps_us: List[int] = []
        self.slice_callback = slice_callback
        self.mesh_callback = mesh_callback
        self.pose_callback: Optional[Callable] = None
        self._frame_idx = 0
        # step_mode: each frame's STEP_MODES index
        self.stats = {"icp_count": [], "icp_residual": [], "raycast_fallback": [],
                      "step_mode": []}
        self.shift_log: List[np.ndarray] = []
        self.collect_slices: bool = True

    @property
    def state(self) -> TrackerState:
        return self._captured.state if self._captured is not None else self._state

    @state.setter
    def state(self, state: TrackerState) -> None:
        """Replace the state (a restore, a carried state): the fast step
        adopts its tensors as its buffers and captures again."""
        if self._captured is not None:
            self._captured.state = state
        else:
            self._state = state

    def step_counts(self) -> dict:
        """{mode: frames} over the frames consumed so far (STEP_MODES)."""
        modes = [STEP_MODES[int(m)] for m in self.stats["step_mode"]]
        return {m: modes.count(m) for m in STEP_MODES}

    def _step(self, d, c, delta, use_odometry: bool) -> FrameResult:
        if self._captured is not None:
            return self._captured(d, c, delta, use_odometry)
        step = self._step_odom if use_odometry else self._step_ext
        self._state, out = step(self._state, d, c, delta)
        return FrameResult(pack_scalars(out), out.slices, out.mesh_patches, "eager")

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
            res = self._step(d, c, self._upload(delta), use_odometry=False)
        else:
            res = self._step(d, c, None, use_odometry=True)
        self._push(res, timestamp_us)

    def _push(self, out: FrameResult, timestamp_us: int) -> None:
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
            self._push(self._step(d, c, None, use_odometry=True), ts)

    def warm_per_frame_step(self) -> None:
        """Build the CUDA kernels ahead of need, so the offline tail's
        first per-frame step does not pay for it inside the run (the JAX
        package compiles its per-frame program here; the step's graphs
        are captured by its own first frames, on the frame loop's
        thread). Safe to call from a background thread."""
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

    def _consume(self, out: FrameResult, timestamp_us: int, frame_idx: int) -> None:
        if out.host is not None:
            # the pinned copy: waits for this frame's scalars only, not
            # for the next frame's back half, which the card may still run
            host, ready = out.host
            ready.synchronize()
            scal = host.numpy().copy()
        else:
            scal = out.scalars.cpu().numpy()  # one read for every scalar
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
        self.stats["step_mode"].append(float(STEP_MODES.index(out.mode)))
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
