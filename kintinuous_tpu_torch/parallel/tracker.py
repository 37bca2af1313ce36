"""Host wrapper around the sharded steps (port of
kintinuous_tpu/parallel/tracker.py: build_mesh and ShardedTracker).

ShardedTracker has tracking/tracker.Tracker's surface (process_frame,
process_frames, flush, finalise, poses, slices, stats, shift_log), so
runtime.engine.SlamEngine runs the whole pipeline (slices, backend,
saves) on a sharded volume. Each slab's extraction buffer is read on the
host and the valid prefixes are concatenated, slab by slab, into the
CloudSlice records the backend takes. Outputs are consumed one frame
late, as on one device.
"""

from __future__ import annotations

import time as _time
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from kintinuous_tpu_torch.backend.meshing import (
    MeshPatch, mesh_current_volume, patch_from_result)
from kintinuous_tpu_torch.config import KintinuousConfig
from kintinuous_tpu_torch.device import resolve_device
from kintinuous_tpu_torch.parallel.mesh import SlabMesh
from kintinuous_tpu_torch.tracking.tracker import _AXIS_DIM, CloudSlice, upload


def build_mesh(n_devices: int, device=None) -> SlabMesh:
    """A SlabMesh of n slabs: the first n CUDA devices (device None or a
    CUDA device), raising when fewer exist; n CPU slabs for
    device="cpu", the counterpart of the JAX tests' virtual devices."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        k = torch.cuda.device_count()
        if k < n_devices:
            raise RuntimeError(f"requested {n_devices} devices, only {k} available")
        return SlabMesh([torch.device("cuda", i) for i in range(n_devices)])
    return SlabMesh([dev] * n_devices)


class ShardedTracker:
    """Tracker-compatible host wrapper over the sharded steps. mesh: a
    SlabMesh (tests and chip_smoke.py put several slabs on one device);
    None builds cfg.devices slabs with build_mesh(device)."""

    def __init__(self, cfg: KintinuousConfig, mesh: Optional[SlabMesh] = None,
                 slice_callback: Optional[Callable[[CloudSlice], None]] = None,
                 mesh_callback: Optional[Callable[[MeshPatch], None]] = None,
                 device=None):
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else build_mesh(cfg.devices, device)
        self.n = self.mesh.n
        self.device = self.mesh.home
        if cfg.fast_mode:
            from kintinuous_tpu_torch.parallel.fast_sharded import (
                make_fast_sharded_extract, make_fast_sharded_state, make_fast_sharded_step)

            self._step_odom = make_fast_sharded_step(cfg, self.mesh, use_odometry=True)
            self._step_ext = make_fast_sharded_step(cfg, self.mesh, use_odometry=False)
            self._fetch_all = make_fast_sharded_extract(cfg, self.mesh)
            self.state = make_fast_sharded_state(cfg, self.mesh)
        else:
            from kintinuous_tpu_torch.parallel.sharded import (
                make_sharded_extract, make_sharded_state, make_sharded_step)

            self._step_odom = make_sharded_step(cfg, self.mesh, use_odometry=True)
            self._step_ext = make_sharded_step(cfg, self.mesh, use_odometry=False)
            self._fetch_all = make_sharded_extract(cfg, self.mesh)
            self.state = make_sharded_state(cfg, self.mesh)
        self._batched = None  # the batched step, built on first use
        self._pending_batches: deque = deque()
        self._pending: deque = deque()
        self.slices: List[CloudSlice] = []
        self.mesh_patches: List[MeshPatch] = []
        self.poses: List[np.ndarray] = []
        self.stamps_us: List[int] = []
        self.slice_callback = slice_callback
        self.pose_callback: Optional[Callable] = None
        self.mesh_callback = mesh_callback
        self._frame_idx = 0
        self.stats = {"icp_count": [], "icp_residual": [], "raycast_fallback": []}
        self.shift_log: List[np.ndarray] = []

    # ------------------------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return upload(arr, self.device)

    def process_frame(self, depth_mm, rgb, timestamp_us: int,
                      ext_delta: Optional[np.ndarray] = None) -> None:
        """Feed one frame (as Tracker.process_frame)."""
        dn = np.asarray(depth_mm)
        d = self._upload(dn if dn.dtype == np.uint16 else dn.astype(np.float32))
        if rgb is None:
            c = torch.zeros((*dn.shape, 3), dtype=torch.uint8, device=self.device)
        else:
            c = self._upload(np.asarray(rgb, dtype=np.uint8))
        first = self._frame_idx == 0
        if ext_delta is not None or first:
            delta = (np.eye(4, dtype=np.float32) if (first or ext_delta is None)
                     else np.asarray(ext_delta, dtype=np.float32))
            self.state, out = self._step_ext(self.state, d, c, self._upload(delta))
        else:
            self.state, out = self._step_odom(self.state, d, c, None)
        self._pending.append((out, timestamp_us, self._frame_idx))
        self._frame_idx += 1
        while len(self._pending) > 1:
            self._consume(*self._pending.popleft())

    def flush(self) -> None:
        while self._pending:
            self._consume(*self._pending.popleft())
        while self._pending_batches:
            self._consume_batch(*self._pending_batches.popleft())

    # ---------------------------------------------------- batched path
    def upload_batch(self, frames):
        """Host -> device upload of (depth, rgb, ts) frames for
        process_batch_device."""
        H, W = self.cfg.camera.height, self.cfg.camera.width
        depths = np.stack([np.asarray(f[0], np.uint16) for f in frames])
        rgbs = np.stack([np.asarray(f[1], np.uint8) if f[1] is not None
                         else np.zeros((H, W, 3), np.uint8) for f in frames])
        return self._upload(depths), self._upload(rgbs), [f[2] for f in frames]

    def process_batch_device(self, depths, rgbs, ts_list) -> None:
        """A batch of uploaded frames through the batched sharded step
        (fast mode), odometry on each; its outputs are consumed one batch
        late."""
        if not self.cfg.fast_mode:
            raise ValueError("the batched sharded path needs fast_mode")
        if self._frame_idx == 0:
            raise ValueError("the first frame must go through process_frame")
        from kintinuous_tpu_torch.parallel.fast_sharded import (
            make_batched_fast_sharded_step)

        self.flush()
        if self._batched is None:
            self._batched = make_batched_fast_sharded_step(self.cfg, self.mesh)
        self.state, outs = self._batched(self.state, depths, rgbs)
        self._pending_batches.append((outs, list(ts_list), self._frame_idx))
        self._frame_idx += len(outs)
        while len(self._pending_batches) > 1:
            self._consume_batch(*self._pending_batches.popleft())

    def process_frames(self, frames) -> None:
        """Batched offline path over pre-assembled (depth, rgb, ts)."""
        while frames and self._frame_idx == 0:
            self.process_frame(*frames[0])
            frames = frames[1:]
        if not frames:
            return
        self.process_batch_device(*self.upload_batch(frames))
        self.flush()

    def _consume_batch(self, outs, ts_list, first_idx: int) -> None:
        """Emit a batch's poses and slices, frame by frame."""
        for k, (out, ts) in enumerate(zip(outs, ts_list)):
            self._consume(out, ts, first_idx + k)

    # ------------------------------------------------------------ host
    def _concat_chips(self, res, counts) -> tuple:
        """Per-slab PackedExtracts -> (points, colors, weights): each
        slab's valid prefix, in slab order."""
        segs = [r.vals[:c].cpu().numpy() for r, c in zip(res, counts) if c]
        if not segs:
            return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                    np.zeros((0,), np.float32))
        v = np.concatenate(segs)
        return v[:, 0:3], v[:, 3:6], v[:, 6]

    def _counts(self, slices) -> List[List[int]]:
        """Every slab's count of every extracted axis, in one host read."""
        flat = [r.count for res in slices if res is not None for r in res]
        if not flat:
            return [None if res is None else [] for res in slices]
        h = torch.stack(self.mesh.to_home(flat)).cpu().tolist()
        out, k = [], 0
        for res in slices:
            if res is None:
                out.append(None)
                continue
            out.append([int(c) for c in h[k:k + len(res)]])
            k += len(res)
        return out

    def _consume(self, out, timestamp_us: int, frame_idx: int) -> None:
        scal = torch.cat([
            out.pose_global.reshape(-1),
            torch.stack([out.icp_count, out.icp_residual,
                         torch.as_tensor(out.raycast_fallback, device=out.shift.device)]).float(),
            out.shift.float(),
        ]).cpu().numpy()  # one read for every scalar
        pose_g = scal[:16].reshape(4, 4).astype(np.float32)
        shift = scal[19:22].astype(np.int32)
        self.poses.append(pose_g)
        self.stamps_us.append(timestamp_us)
        if self.pose_callback:
            self.pose_callback(timestamp_us, pose_g)
        self.stats["icp_count"].append(float(scal[16]))
        self.stats["icp_residual"].append(float(scal[17]))
        self.stats["raycast_fallback"].append(float(scal[18]))
        self.shift_log.append(shift)
        if not shift.any():
            return
        counts = self._counts(out.slices)
        for axis in range(3):
            s = int(shift[axis])
            if s == 0:
                continue
            p, c, w = self._concat_chips(out.slices[axis], counts[axis])
            if len(p) == 0:
                continue
            sl = CloudSlice(
                points=p, colors=np.clip(c, 0, 255).astype(np.uint8), weights=w,
                dimension=_AXIS_DIM[(axis, 1 if s > 0 else -1)], pose=pose_g,
                timestamp_us=timestamp_us, frame_index=frame_idx, wall_time=_time.time(),
            )
            self.slices.append(sl)
            if self.slice_callback:
                self.slice_callback(sl)
            if self.cfg.incremental_mesh and out.mesh_patches:
                self._take_mesh_patch(out.mesh_patches[axis], timestamp_us)

    def _take_mesh_patch(self, res, timestamp_us: int) -> None:
        patch = patch_from_result(res, timestamp_us)
        if len(patch.vertices) == 0 or len(patch.faces) == 0:
            return
        self.mesh_patches.append(patch)
        if self.mesh_callback:
            self.mesh_callback(patch)

    # ------------------------------------------------------------------
    def finalise(self) -> CloudSlice:
        """The whole remaining volume as the FINAL slice, extracted
        slab-locally; with meshing on, the live volume's mesh (the slabs
        gathered on the home device) as the last patch."""
        self.flush()
        res = self._fetch_all(self.state.vol)
        p, c, w = self._concat_chips(res, self._counts([res])[0])
        pose = self.poses[-1] if self.poses else np.eye(4)
        ts = self.stamps_us[-1] if self.stamps_us else 0
        sl = CloudSlice(points=p, colors=np.clip(c, 0, 255).astype(np.uint8), weights=w,
                        dimension="FINAL", pose=pose, timestamp_us=ts,
                        frame_index=self._frame_idx, wall_time=_time.time())
        self.slices.append(sl)
        if self.slice_callback:
            self.slice_callback(sl)
        if self.cfg.incremental_mesh:
            # the whole live volume's mesh, welded with the band patches
            # at save
            patch = mesh_current_volume(self, self.cfg)
            if len(patch.vertices):
                patch.timestamp_us = ts
                self.mesh_patches.append(patch)
                if self.mesh_callback:
                    self.mesh_callback(patch)
        return sl

    @property
    def global_pose(self) -> np.ndarray:
        self.flush()
        return self.poses[-1] if self.poses else np.eye(4)
