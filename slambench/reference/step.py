# Frozen copy of the fast step of kintinuous_tpu_torch/tracking/tracker.py
# (TrackerState, StepOutputs, keeps_mirror, preprocess_frame, _shift_of,
# _odometry, FrontOut, FastHalves, make_step_fast, initial_state), the
# benchmark's plain reference: its back half runs the plain versions of
# the kernels (integrate.integrate_blocked, mirror_raycast.raycast_mirror),
# the gather raycast of pallas=False is left out, a shift decision at its
# threshold can follow a hint (_tie_break), and it is never updated to
# follow the program, which it judges.
"""The fast step (make_step_fast) in plain PyTorch, eager, on any device:
step(state, depth_raw, rgb_raw, ext_delta) -> (new_state, outputs), the
volume and the mirror updated in place."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from slambench.reference import preprocess as pp
from slambench.reference import maps as map_ops
from slambench.reference import se3
from slambench.reference.blocked import (
    VIEW_AXES,
    VIEW_INV,
    BlockedVolume,
    make_blocked_volume,
    shift_roll_clear,
    slab_to_dense,
)
from slambench.reference.config import KintinuousConfig
from slambench.reference.extract import extract_points_packed
from slambench.reference.integrate import integrate_blocked
from slambench.reference.mirror_raycast import raycast_mirror
from slambench.reference.odometry import build_map_pyramid, icp_odometry, pyramid_from_maps
from slambench.reference.rgbd import RGBDFramePyramid, build_rgbd_pyramid, rgbd_icp_odometry
from slambench.reference.tsdf import VolumeState


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
        return pts, None  # no band meshes: the cells run without -m

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
            integrate_blocked(
                vol, self.cam, fo.depth_m, fo.rgb, fo.color_w, pose, cfg.voxel_size,
                cfg.trunc_dist, float(cfg.max_weight), band_cap=cfg.band_cap,
                mirror=mirror, dirty_all=shift_any,
            )
        with record_function("kt.raycast"):
            # warm start from the measured depth only (as the JAX package)
            return raycast_mirror(
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


# Within this distance of a shift threshold a sub-millimetre pose
# difference (the kernels' raycast differs from its plain version by up
# to 1 mm in depth) decides the side; there the reference takes the
# program's decision, which it is given as a hint. (Not in the program.)
SHIFT_TIE_M = 1e-3


def _tie_break(cfg: KintinuousConfig, fo: "FrontOut", dc, shift_h, hint):
    """(fo, shift_h) with the hint's shift where the two decisions
    differ only on axes whose anchor lies within SHIFT_TIE_M of the
    threshold; otherwise as they were. Returns also whether it did."""
    if hint is None or [int(x) for x in hint] == shift_h:
        return fo, shift_h, False
    thresh = cfg.voxel_shift * cfg.voxel_size
    off = (fo.pose[:3, 3] + fo.pose[:3, 2] * dc - cfg.volume_size / 2.0).double().cpu()
    for a in range(3):
        if int(hint[a]) != shift_h[a] and abs(abs(float(off[a])) - thresh) > SHIFT_TIE_M:
            return fo, shift_h, False
    h = [int(x) for x in hint]
    return fo._replace(shift=torch.tensor(h, dtype=torch.int32, device=fo.shift.device)), h, True


def make_step_fast(cfg: KintinuousConfig, use_odometry: bool):
    """The per-frame step, eager: step(state, depth_raw, rgb_raw,
    ext_delta, shift_hint=None) -> (new_state, outputs, tie_broken).
    depth_raw (H,W) and rgb_raw (H,W,3) are tensors on the state's
    device; ext_delta (4,4) is used when use_odometry is False;
    shift_hint is the program's shift of this frame (see _tie_break).
    The state's volume and mirror are updated in place."""
    halves = FastHalves(cfg)

    def step(state: TrackerState, depth_raw, rgb_raw, ext_delta, shift_hint=None):
        fo = halves.front(state, depth_raw, rgb_raw, ext_delta, use_odometry)
        vol, pose = state.vol, fo.pose
        slices = meshes = (None, None, None)
        shift_any = tied = False
        if not cfg.static_mode:
            with record_function("kt.shift"):
                # the step's one host synchronisation
                shift_h = [int(s) for s in fo.shift.cpu()]
                fo, shift_h, tied = _tie_break(cfg, fo, state.dc, shift_h, shift_hint)
                shift_any = any(shift_h)
                if shift_any:
                    vol, pose, slices, meshes = halves.roll(vol, pose, fo.shift, shift_h)
        rc = halves.back(state.logical, vol, fo, pose, shift_any)
        new_state = state._replace(
            vol=vol, pose=pose, pred_vmap=rc.vmap, pred_nmap=rc.nmap,
            pred_pose=pose, frame=state.frame + 1, prev_delta=fo.delta,
            rgbd=fo.rgbd,
        )
        return new_state, halves.outputs(fo, pose, vol.origin, rc, slices, meshes), tied

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
        vol=make_blocked_volume(R, device=device),
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


