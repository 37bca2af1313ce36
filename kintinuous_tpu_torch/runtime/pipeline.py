"""Offline `.klg` processing without the threaded backend (port of
kintinuous_tpu/runtime/pipeline.py): log reading with background decode,
ground-truth replay when configured, per-frame tracking, a TUM pose
dump. The threaded engine (runtime/engine.py) builds on the same parts.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from kintinuous_tpu_torch.config import KintinuousConfig
from kintinuous_tpu_torch.io.klg import KlgLogReader
from kintinuous_tpu_torch.io.tum import TrajectoryWriter, load_trajectory
from kintinuous_tpu_torch.tracking.odometry import GroundTruthOdometry
from kintinuous_tpu_torch.tracking.tracker import CloudSlice, Tracker


@dataclass
class RunResult:
    poses: List[np.ndarray]
    stamps_us: List[int]
    slices: List[CloudSlice]
    n_frames: int
    elapsed_s: float
    stats: dict = field(default_factory=dict)

    @property
    def fps(self) -> float:
        return self.n_frames / self.elapsed_s if self.elapsed_s > 0 else 0.0


def run_slam(
    cfg: KintinuousConfig,
    poses_path: Optional[str] = None,
    slice_callback: Optional[Callable[[CloudSlice], None]] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    device=None,
) -> RunResult:
    """Process cfg.log_file end to end on `device` (None: the card) and
    return the trajectory and slices; poses_path gets a TUM pose file."""
    if not cfg.log_file:
        raise ValueError("run_slam needs cfg.log_file")
    cam = cfg.camera
    tracker = Tracker(cfg, device=device, slice_callback=slice_callback)
    gt: Optional[GroundTruthOdometry] = None
    if cfg.trajectory_file:
        gt = GroundTruthOdometry(*load_trajectory(cfg.trajectory_file))
    t0 = time.perf_counter()
    n = 0
    with KlgLogReader(cfg.log_file, width=cam.width, height=cam.height,
                      max_frames=cfg.total_num_frames) as reader:
        total = reader.total_num_frames
        frame_budget = 1.0 / cfg.frame_rate_limit if cfg.frame_rate_limit else None
        for frame in reader:
            t_frame = time.perf_counter()
            delta = gt.delta(frame.timestamp) if gt is not None else None
            tracker.process_frame(frame.depth, frame.rgb, frame.timestamp, ext_delta=delta)
            n += 1
            if progress:
                progress(n, total)
            if frame_budget:
                spare = frame_budget - (time.perf_counter() - t_frame)
                if spare > 0:
                    time.sleep(spare)
    tracker.flush()
    elapsed = time.perf_counter() - t0
    tracker.finalise()
    if poses_path:
        writer = TrajectoryWriter(poses_path)
        try:
            for ts, T in zip(tracker.stamps_us, tracker.poses):
                writer.write(ts, T)
        finally:
            writer.close()
    return RunResult(poses=tracker.poses, stamps_us=tracker.stamps_us,
                     slices=tracker.slices, n_frames=n, elapsed_s=elapsed,
                     stats=tracker.stats)
