# Frozen copy of kintinuous_tpu_torch/tracking/odometry.py, the benchmark's plain
# reference: imports point into this package, and it is never updated
# to follow the program, which it judges.
"""Coarse-to-fine ICP odometry and ground-truth replay (port of
kintinuous_tpu/tracking/odometry.py: build_map_pyramid,
pyramid_from_maps, icp_odometry, GroundTruthOdometry, icp_covariance).

Returns T_curr_to_prev: the transform taking current-frame camera
points into the previous camera frame; the tracker composes
pose_new = pose_prev @ T_curr_to_prev.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from slambench.reference.config import CameraIntrinsics
from slambench.reference import maps as map_ops
from slambench.reference import preprocess as pp
from slambench.reference.reduce import icp_solve_level, icp_step, pack_maps

MapPyramid = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # fine -> coarse


def build_map_pyramid(cam: CameraIntrinsics, depth_m: torch.Tensor,
                      levels: int) -> MapPyramid:
    """Filtered depth (metres) -> per-level (vmap, nmap)."""
    out = []
    d = depth_m
    for level in range(levels):
        vmap = map_ops.create_vmap(cam.at_level(level), d)
        out.append((vmap, map_ops.create_nmap(vmap)))
        if level + 1 < levels:
            d = pp.pyr_down_depth(d, sigma=0.09)
    return tuple(out)


def pyramid_from_maps(vmap: torch.Tensor, nmap: torch.Tensor,
                      levels: int) -> MapPyramid:
    """Downsample predicted maps into a pyramid."""
    out = [(vmap, nmap)]
    v, n = vmap, nmap
    for _ in range(levels - 1):
        v = map_ops.resize_vmap(v)
        n = map_ops.resize_nmap(n)
        out.append((v, n))
    return tuple(out)


def icp_odometry(cam: CameraIntrinsics, curr_pyr: MapPyramid,
                 pred_pyr: MapPyramid, iterations: Sequence[int],
                 dist_thresh: float = 0.10, angle_thresh_deg: float = 20.0,
                 T_init: Optional[torch.Tensor] = None, reassoc_every: int = 1,
                 T_prior: Optional[torch.Tensor] = None, prior_weight=0.0):
    """Frame-to-model point-to-plane ICP; iterations[l] GN steps at level
    l (0 = finest). Returns (T_curr_to_prev, inliers, residual) of the
    finest solved level, all on the device."""
    levels = len(curr_pyr)
    dev = curr_pyr[0][0].device
    T = (T_init if T_init is not None
         else torch.eye(4, dtype=torch.float32, device=dev))
    sin_t = math.sin(math.radians(angle_thresh_deg))
    count = torch.zeros((), dtype=torch.float32, device=dev)
    residual = torch.zeros((), dtype=torch.float32, device=dev)
    for level in range(levels - 1, -1, -1):
        iters = int(iterations[level]) if level < len(iterations) else 0
        if iters == 0:
            continue
        vc, nc = curr_pyr[level]
        vp, np_ = pred_pyr[level]
        T, count, residual = icp_solve_level(
            cam.at_level(level), T, vc, nc, pack_maps(vp, np_),
            tuple(vp.shape[1:]), iters, dist_thresh, sin_t,
            reassoc_every=reassoc_every if level == 0 else 1,
            T_prior=T_prior, prior_weight=prior_weight,
        )
    return T, count, residual


class GroundTruthOdometry:
    """Replays a loaded trajectory (host-side numpy): the inter-frame
    delta in the previous camera's frame, independent of the world
    basis. A frame without a pose within max_dt seconds gets identity."""

    def __init__(self, stamps_s: np.ndarray, poses: np.ndarray, max_dt: float = 0.02):
        self._stamps = np.asarray(stamps_s)
        self._poses = np.asarray(poses)
        self._max_dt = max_dt
        self._last: Optional[np.ndarray] = None

    def _lookup(self, timestamp_us: int) -> Optional[np.ndarray]:
        t = timestamp_us / 1e6
        i = int(np.argmin(np.abs(self._stamps - t)))
        if abs(self._stamps[i] - t) > self._max_dt:
            return None
        return self._poses[i]

    def delta(self, timestamp_us: int) -> np.ndarray:
        """T_curr_to_prev for this frame (identity if the pose is missing)."""
        T = self._lookup(timestamp_us)
        if T is None or self._last is None:
            if T is not None:
                self._last = T
            return np.eye(4, dtype=np.float32)
        d = np.linalg.inv(self._last) @ T
        self._last = T
        return d.astype(np.float32)

    def has_pose(self, timestamp_us: int) -> bool:
        return self._lookup(timestamp_us) is not None


def icp_covariance(cam: CameraIntrinsics, T: torch.Tensor, vmap_curr: torch.Tensor,
                   nmap_curr: torch.Tensor, vmap_prev: torch.Tensor,
                   nmap_prev: torch.Tensor, dist_thresh: float = 0.10,
                   angle_thresh_deg: float = 20.0) -> torch.Tensor:
    """6x6 odometry covariance, the inverse of the point-to-plane GN
    system at the converged pose T (twist order [w, v]), damped by 1e-6
    so that a degenerate scene gives a large but finite covariance."""
    sys_ = icp_step(cam, T, vmap_curr, nmap_curr, vmap_prev, nmap_prev, dist_thresh,
                    math.sin(math.radians(angle_thresh_deg)))
    return torch.linalg.inv(sys_.A + 1e-6 * torch.eye(6, dtype=sys_.A.dtype,
                                                       device=sys_.A.device))
