"""Map correction: the pose graph and the deformation graph (port of
kintinuous_tpu/backend/deform_runner.py).

The reference's Deformation thread:
  add_frame_pose  dense poses become pose-graph odometry factors
                  (subsampled to dense_sampling_rate with fast_loops)
  add_slice       processed slice points join the global pool with
                  their timestamps; slices that arrive after an accepted
                  loop are re-based onto the corrected trajectory; the
                  deformation graph grows along the trajectory
  add_loop        add the loop factor, optimise the pose graph, reject
                  when the chi2 the loop adds exceeds isam_thresh
                  (remove the factor, restore the poses); else constrain
                  the deformation graph with the nodes' moves and the
                  reprojected loop inliers, optimise it, and apply it to
                  the whole pool and the mesh patches
  saves           the deformed pool (`_opt.pcd`), the optimised
                  trajectory, the deformed mesh (`_opt.ply`)

The GN solves run on `device` (None: the card), in one process: the
engine refuses -od with several. One lock serialises the three threads
that call in: the frame loop (add_frame_pose), the slice
worker (add_slice, add_mesh_patch) and the place-recognition worker
(add_loop).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from kintinuous_tpu_torch.backend.deformation import DeformationGraph
from kintinuous_tpu_torch.backend.place_recognition import LoopConstraint
from kintinuous_tpu_torch.backend.pose_graph import PoseGraph
from kintinuous_tpu_torch.config import KintinuousConfig
from kintinuous_tpu_torch.device import resolve_device
from kintinuous_tpu_torch.io.pcd import save_pcd
from kintinuous_tpu_torch.tracking.tracker import CloudSlice


class MapDeformation:
    def __init__(self, cfg: KintinuousConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.graph = PoseGraph(device=self.device)
        self.dgraph = DeformationGraph(k=cfg.deformation_k, sample_dist=cfg.dense_sampling_rate,
                                       device=self.device)
        self.slices: List[CloudSlice] = []
        self.mesh_patches: List = []  # MeshPatch records (incremental mesh)
        self._last_time: Optional[int] = None
        self._last_pose: Optional[np.ndarray] = None
        self._last_node_pos: Optional[np.ndarray] = None
        # raw (frontend) pose per graph-node time: re-bases slices that
        # arrive after an accepted loop by isamPose * rawPose^-1
        self._raw_pose: Dict[int, np.ndarray] = {}
        self.n_loops_accepted = 0
        self.n_loops_rejected = 0
        # one record an attempt: times, chi2 after the gated optimise,
        # accepted, and the PR-measured relative pose (eval/loop_gate)
        self.loop_log: List[dict] = []
        self._lock = threading.RLock()

    # ------------------------------------------------------------ poses
    def add_frame_pose(self, time_us: int, T_global: np.ndarray) -> None:
        with self._lock:
            self._add_frame_pose(time_us, T_global)

    def _add_frame_pose(self, time_us: int, T_global: np.ndarray) -> None:
        T_global = np.asarray(T_global, np.float64)
        if self._last_time is None:
            self.graph.add_node(time_us, T_global)
        else:
            if self.cfg.fast_loops and self._last_node_pos is not None:
                if (np.linalg.norm(T_global[:3, 3] - self._last_node_pos)
                        < self.cfg.dense_sampling_rate):
                    return
            Z = np.linalg.inv(self._last_pose) @ T_global
            self.graph.add_odometry(self._last_time, time_us, Z)
        self._last_time = time_us
        self._last_pose = T_global
        self._last_node_pos = T_global[:3, 3]
        self._raw_pose[time_us] = T_global
        # grow the deformation graph along the graph's CURRENT estimate
        # (add_odometry chains new nodes from the optimised previous
        # node), so nodes created after an accepted loop land on the
        # corrected trajectory, consistent with the re-based slices
        est = self.graph.poses[self.graph.node_id(time_us)]
        self.dgraph.append_poses([time_us], [est[:3, 3]])

    # ----------------------------------------------------------- slices
    def _correction(self, timestamp_us: int) -> Optional[np.ndarray]:
        """isamPose * rawPose^-1 at the node nearest timestamp_us, once a
        loop has been accepted; else None."""
        if not self.n_loops_accepted:
            return None
        k = self._nearest_node(timestamp_us)
        raw = self._raw_pose.get(self.graph.times[k]) if k is not None else None
        if raw is None:
            return None
        return self.graph.poses[k] @ np.linalg.inv(raw)

    def add_slice(self, sl: CloudSlice) -> None:
        """Pool a processed slice, re-based onto the corrected trajectory
        when it arrives after an accepted loop (else the map forks on a
        run with several loops)."""
        assert sl.processed is not None, "run SliceProcessor first"
        with self._lock:
            corr = self._correction(sl.timestamp_us)
            if corr is not None:
                R, t = corr[:3, :3], corr[:3, 3]
                pts = sl.processed["points"]
                if len(pts):
                    sl.processed["points"] = (pts @ R.T + t).astype(np.float32)
                    if "normals" in sl.processed:
                        sl.processed["normals"] = (sl.processed["normals"] @ R.T).astype(
                            np.float32)
                sl.pose = (corr @ sl.pose).astype(np.float64)
            self.slices.append(sl)

    def add_mesh_patch(self, patch) -> None:
        """Pool a band mesh patch, re-based like a slice."""
        with self._lock:
            corr = self._correction(patch.timestamp_us) if len(patch.vertices) else None
            if corr is not None:
                patch.vertices = (patch.vertices @ corr[:3, :3].T + corr[:3, 3]).astype(
                    np.float32)
            self.mesh_patches.append(patch)

    # ------------------------------------------------------------ loops
    def add_loop(self, c: LoopConstraint) -> bool:
        """Returns True if the loop was accepted and the map deformed."""
        with self._lock:
            return self._add_loop(c)

    def _add_loop(self, c: LoopConstraint) -> bool:
        i = self._nearest_node(c.time1)
        j = self._nearest_node(c.time2)
        if i is None or j is None or i == j:
            return False
        t1, t2 = self.graph.times[i], self.graph.times[j]
        old_positions = {k: p.copy() for k, p in enumerate(self.graph.poses)}
        # gate on the chi2 the loop ADDS, not the absolute total: near 0
        # for a drift-consistent revisit, large for an aliased match, at
        # any level of baseline noise
        chi2_before = self.graph.chi2()
        fid = self.graph.add_loop(t1, t2, c.T_1_2)
        chi2_after = self.graph.optimise(iters=10)
        residual = chi2_after - chi2_before
        max_delta = max(
            float(np.linalg.norm(self.graph.poses[k][:3, 3] - old_positions[k][:3, 3]))
            for k in range(len(old_positions))
        )
        self.loop_log.append({
            "t1": int(t1), "t2": int(t2), "chi2": float(chi2_after),
            "chi2_before": float(chi2_before),
            "chi2_delta": float(residual),
            "max_node_delta_m": max_delta,
            "n_nodes": len(self.graph.poses),
            "accepted": residual <= self.cfg.isam_thresh,
            # keyframe times and the PR-measured relative pose, so that a
            # harness with ground truth can score the gate
            "kf_t1": int(c.time1), "kf_t2": int(c.time2),
            "T_1_2": np.asarray(c.T_1_2, np.float64).tolist(),
        })
        if residual > self.cfg.isam_thresh:
            self.graph.remove_factor(fid)
            for k, P in old_positions.items():
                self.graph.poses[k] = P
            self.graph.optimise(iters=5)
            self.n_loops_rejected += 1
            return False

        # deformation constraints: old node position -> new node position
        src = [old_positions[k][:3, 3] for k in range(len(self.graph.poses))]
        dst = [self.graph.poses[k][:3, 3] for k in range(len(self.graph.poses))]
        vt = list(self.graph.times)
        # reprojected loop inliers: where kf2 saw them (old pose) should
        # land where kf1's (optimised) pose puts them
        T1_new = self.graph.poses[i]
        T2_old = old_positions[j]
        q = (np.asarray(c.inliers1) @ T1_new[:3, :3].T) + T1_new[:3, 3]
        p = (np.asarray(c.inliers2) @ T2_old[:3, :3].T) + T2_old[:3, 3]
        n_in = min(len(p), 64)
        if n_in:
            sel = np.linspace(0, len(p) - 1, n_in).astype(int)
            src.extend(p[sel])
            dst.extend(q[sel])
            vt.extend([t2] * n_in)
        src = np.asarray(src, np.float64)
        dst = np.asarray(dst, np.float64)
        vt = np.asarray(vt)

        if self.dgraph.n_nodes >= 4:
            b = self.dgraph.bind(src, vt)
            self.dgraph.optimise(src, dst, b, iters=10)
            self._apply_to_slices()
            self._apply_to_mesh()
        self._rewrite_slice_poses()
        self.n_loops_accepted += 1
        return True

    def _nearest_node(self, time_us: int) -> Optional[int]:
        if not self.graph.times:
            return None
        times = np.asarray(self.graph.times)
        return int(np.argmin(np.abs(times - time_us)))

    # -------------------------------------------------------- map apply
    def _deformed(self, vertices: np.ndarray, timestamp_us: int) -> np.ndarray:
        vt = np.full(len(vertices), timestamp_us)
        b = self.dgraph.bind(vertices.astype(np.float64), vt)
        return self.dgraph.apply(vertices, b).astype(np.float32)

    def _apply_to_slices(self) -> None:
        """The deformation over the whole pool, one batched apply a slice."""
        for sl in self.slices:
            if len(sl.processed["points"]):
                sl.processed["points"] = self._deformed(sl.processed["points"], sl.timestamp_us)

    def _apply_to_mesh(self) -> None:
        """Move the mesh patches' vertices without retriangulating."""
        for p in self.mesh_patches:
            if len(p.vertices):
                p.vertices = self._deformed(p.vertices, p.timestamp_us)

    def _rewrite_slice_poses(self) -> None:
        """Slice poses refreshed from the optimised graph."""
        for sl in self.slices:
            k = self._nearest_node(sl.timestamp_us)
            if k is not None:
                sl.pose = self.graph.poses[k].copy()

    # ------------------------------------------------------------ saves
    def optimised_trajectory(self):
        with self._lock:
            ts = np.asarray(self.graph.times)
            order = np.argsort(ts)
            return ts[order], [self.graph.poses[k] for k in order]

    def save_mesh(self, path: str) -> int:
        """The merged deformed incremental mesh -> .ply."""
        from kintinuous_tpu_torch.backend.meshing import MeshCollector

        mc = MeshCollector()
        for p in self.mesh_patches:
            mc.add(p)
        return mc.save(path)

    def pool_points(self):
        """(points f32 (N,3), colors u8 (N,3)) of the deformed global
        pool, or None when empty."""
        parts = [s.processed for s in self.slices if s.processed is not None]
        if not parts:
            return None
        pts = np.concatenate([p["points"] for p in parts]).astype(np.float32)
        cols = np.concatenate([p["colors"] for p in parts]).astype(np.uint8)
        return pts, cols

    def save_cloud(self, path: str) -> int:
        parts = [s.processed for s in self.slices if s.processed is not None]
        if not parts:
            save_pcd(path, np.zeros((0, 3), np.float32))
            return 0
        pts = np.concatenate([p["points"] for p in parts])
        cols = np.concatenate([p["colors"] for p in parts])
        nrm = np.concatenate([p["normals"] for p in parts])
        save_pcd(path, pts, cols, nrm)
        return len(pts)
