"""The threaded SLAM engine (port of kintinuous_tpu/runtime/engine.py).

The frame loop runs on the caller's thread and feeds the Tracker; its
slices go through a queue to a SliceProcessor worker thread. At the end
of the log the tracker emits the FINAL slice, the worker drains its
queue, and `save` writes the map (`.pcd`), the trajectory (`.poses`,
TUM) and, with meshing on, the welded whole-map mesh (`.ply`). Offline
fast-mode runs take the batched path: an uploader thread decodes the log
and uploads full batches ahead of the step; the first frame runs alone,
then batches of cfg.offline_batch_size, then the partial tail frame by
frame. The dense path (fast_mode off) runs frame by frame, as the JAX
engine does.

With online deformation (-od) two more stages run: each tracked pose
joins the pose graph (MapDeformation.add_frame_pose, on the frame
loop), the slice worker pools each processed slice for deformation, and
a place-recognition worker takes the keyframes (frames whose motion
since the last keyframe passes place_rec_motion_thresh; a queue of 16
that drops keyframes, never frames), looks for a loop and hands an
accepted one to the deformation. Then `save` writes the deformed map
(`<base>_opt.pcd`), the optimised trajectory and, with -m, the deformed
mesh (`<base>_opt.ply`), once a loop was accepted. Each worker thread
runs its torch work on a CUDA stream of its own, beside the frame loop's.

Not ported yet, and raising NotImplementedError rather than running
something else: several devices or processes, live capture.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from kintinuous_tpu_torch.backend.deform_runner import MapDeformation
from kintinuous_tpu_torch.backend.meshing import MeshCollector, mesh_current_volume
from kintinuous_tpu_torch.backend.place_recognition import PlaceRecognition
from kintinuous_tpu_torch.backend.slice_proc import SliceProcessor
from kintinuous_tpu_torch.config import KintinuousConfig
from kintinuous_tpu_torch.device import resolve_device
from kintinuous_tpu_torch.geometry import se3
from kintinuous_tpu_torch.io.klg import KlgLogReader
from kintinuous_tpu_torch.io.tum import TrajectoryWriter, load_trajectory, save_trajectory
from kintinuous_tpu_torch.runtime.stopwatch import Stopwatch
from kintinuous_tpu_torch.tracking.odometry import GroundTruthOdometry
from kintinuous_tpu_torch.tracking.tracker import Tracker

_SENTINEL = object()


def check_engine_supported(cfg: KintinuousConfig) -> None:
    for name, unported in (
        ("devices > 1", cfg.devices > 1),
        ("num_processes > 1", cfg.num_processes > 1),
        ("live_source", bool(cfg.live_source)),
    ):
        if unported:
            raise NotImplementedError(f"{name}: not ported to kintinuous_tpu_torch yet")


class Worker(threading.Thread):
    """Loops process() until it returns False or halt is set, pulsing
    the stopwatch each lap; an exception ends the loop and is kept in
    `error` for the engine to raise. On a CUDA device the thread's torch
    work runs on a stream of its own."""

    def __init__(self, name: str, process: Callable[[], bool], sw: Stopwatch,
                 device: Optional[torch.device] = None):
        super().__init__(name=name, daemon=True)
        self._process = process
        self._sw = sw
        self._device = device
        self.halt = threading.Event()
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None

    def run(self):
        try:
            on_card = self._device is not None and self._device.type == "cuda"
            with (torch.cuda.stream(torch.cuda.Stream(self._device)) if on_card
                  else contextlib.nullcontext()):
                while not self.halt.is_set():
                    self._sw.pulse(self.name)
                    if not self._process():
                        break
        except Exception as e:  # the engine re-raises it on its own thread
            self.error = e
        finally:
            self.finished.set()


class SlamEngine:
    """Owns the tracker, the slice processor and their threads for one
    run. device=None means the CUDA card (and raises without one)."""

    def __init__(self, cfg: KintinuousConfig, device=None):
        check_engine_supported(cfg)
        self.cfg = cfg
        self.device = device
        self.sw = Stopwatch(port=cfg.telemetry_port)
        self._build()

    def _build(self):
        cfg = self.cfg
        dev = resolve_device(self.device)
        self.slice_q: "queue.Queue" = queue.Queue()
        self.kf_q: "queue.Queue" = queue.Queue(maxsize=16)
        self.slice_proc = SliceProcessor(cfg)
        od = cfg.online_deformation
        self.deformation = MapDeformation(cfg, device=dev) if od else None
        self.place_rec = PlaceRecognition(cfg, device=dev) if od else None
        self.tracker = Tracker(
            cfg, device=dev, slice_callback=self.slice_q.put,
            mesh_callback=(self.deformation.add_mesh_patch
                           if od and cfg.incremental_mesh else None))
        self._pose_writer = None
        if cfg.save_file and not od:
            # per-frame poses stream out as they land; under -od the
            # trajectory is final only at the end (the optimised one)
            self._pose_writer = TrajectoryWriter(f"{cfg.save_file}.poses")
            self.tracker.pose_callback = self._pose_writer.write
        # -od: frames waiting for their pose, and how many have one
        self._unposed: deque = deque()
        self._published = 0
        self._last_kf_pose: Optional[np.ndarray] = None
        self.keyframes_dropped = 0
        self._slice_idx = 0
        self.workers: List[Worker] = []
        self._end_of_log = threading.Event()
        self.stop_requested = threading.Event()
        self.paused = threading.Event()
        self._frames_done = 0
        self._t_start = 0.0

    # ----------------------------------------------------------- stages
    def _slice_stage(self) -> bool:
        try:
            sl = self.slice_q.get(timeout=0.1)
        except queue.Empty:
            return not (self._end_of_log.is_set() and self.slice_q.empty())
        if sl is _SENTINEL:
            return False
        self._slice_idx += 1
        with self.sw.span("SliceProcessor"):
            self.slice_proc.process(sl)
        if sl.wall_time:
            self.sw.gauge("lag.SliceProcessor", (time.time() - sl.wall_time) * 1e3)
        if self.deformation is not None:
            self.deformation.add_slice(sl)
            if sl.wall_time:
                self.sw.gauge("lag.Deformation", (time.time() - sl.wall_time) * 1e3)
        return True

    def _pr_stage(self) -> bool:
        try:
            item = self.kf_q.get(timeout=0.1)
        except queue.Empty:
            return not self._end_of_log.is_set()
        if item is _SENTINEL:
            return False
        rgb, depth_m, pose, ts, wall = item
        with self.sw.span("PlaceRecognition"):
            c = self.place_rec.add_keyframe(rgb, depth_m, pose, ts)
        self.sw.gauge("lag.PlaceRecognition", (time.time() - wall) * 1e3)
        if c is not None:
            with self.sw.span("Deformation"):
                self.deformation.add_loop(c)
        return True

    @property
    def backend_lag_ms(self) -> float:
        """The largest backend stage lag."""
        return self.sw.max_gauge("lag.")

    # ------------------------------------------------------- keyframes
    def _frame_done(self, depth, rgb, ts: int) -> None:
        """Under -od, hold a processed frame until its pose lands."""
        if self.deformation is not None:
            self._unposed.append((depth, rgb, int(ts)))

    def _keyframe_due(self, pose: np.ndarray) -> bool:
        """Motion since the last keyframe, (|rotation| + |translation|) / 2,
        at least place_rec_motion_thresh."""
        if self._last_kf_pose is None:
            return True
        d = np.linalg.inv(self._last_kf_pose) @ pose
        rot = se3.log_se3(torch.from_numpy(d.astype(np.float32)))[:3].numpy()
        return ((np.linalg.norm(rot) + np.linalg.norm(d[:3, 3])) / 2.0
                >= self.cfg.place_rec_motion_thresh)

    def _publish(self) -> None:
        """Pair held frames with their now-available poses: each pose
        joins the pose graph, and a frame with colour whose motion passes
        the gate goes to the place-recognition worker (dropped when its
        queue is full: keyframes, never frames)."""
        poses = self.tracker.poses
        while self._unposed and self._published < len(poses):
            depth, rgb, ts = self._unposed.popleft()
            pose = poses[self._published]
            self._published += 1
            self.deformation.add_frame_pose(ts, pose)
            if rgb is not None and self._keyframe_due(pose):
                self._last_kf_pose = pose
                try:
                    self.kf_q.put_nowait((rgb, depth.astype(np.float32) / 1000.0, pose,
                                          ts, time.time()))
                except queue.Full:
                    self.keyframes_dropped += 1

    # ---------------------------------------------------------- running
    def _wait_while_paused(self):
        while self.paused.is_set() and not self.stop_requested.is_set():
            time.sleep(0.05)

    def run(self, progress: Optional[Callable[[int, int], None]] = None) -> "SlamEngine":
        """Process cfg.log_file to its end (or to complete())."""
        cfg = self.cfg
        if not cfg.log_file:
            raise ValueError("SlamEngine.run needs cfg.log_file")
        dev = self.tracker.device
        self.workers = [Worker("SliceProcessor", self._slice_stage, self.sw, dev)]
        if self.place_rec is not None:
            self.workers.append(Worker("PlaceRecognition", self._pr_stage, self.sw, dev))
        for w in self.workers:
            w.start()
        # the poses already in the tracker (a resumed run) are published
        self._published = len(self.tracker.poses)
        gt = None
        if cfg.trajectory_file:
            gt = GroundTruthOdometry(*load_trajectory(cfg.trajectory_file))
        if (cfg.fast_mode and cfg.offline_batched and gt is None
                and not cfg.frame_rate_limit):
            self._run_batched(progress)
        else:
            self._run_per_frame(gt, progress)
        return self._finish()

    def _run_per_frame(self, gt, progress):
        cfg, cam = self.cfg, self.cfg.camera
        self._t_start = time.perf_counter()
        frame_budget = 1.0 / cfg.frame_rate_limit if cfg.frame_rate_limit else None
        with KlgLogReader(cfg.log_file, width=cam.width, height=cam.height,
                          max_frames=cfg.total_num_frames) as reader:
            for frame in reader:
                t0 = time.perf_counter()
                delta = gt.delta(frame.timestamp) if gt is not None else None
                rgb = frame.rgb
                if cfg.flip_colors and rgb is not None:
                    rgb = rgb[..., ::-1]  # BGR logs (-f)
                with self.sw.span("processFrame"):
                    self.tracker.process_frame(frame.depth, rgb, frame.timestamp,
                                               ext_delta=delta)
                self._frames_done += 1
                self._frame_done(frame.depth, rgb, frame.timestamp)
                self._publish()
                if progress:
                    progress(self._frames_done, reader.total_num_frames)
                if frame_budget:
                    spare = frame_budget - (time.perf_counter() - t0)
                    if spare > 0:
                        time.sleep(spare)
                if self.stop_requested.is_set():
                    break
                self._wait_while_paused()

    def _run_batched(self, progress):
        """The offline fast path: an uploader thread decodes the log and
        uploads full batches ahead of the step; the first frame runs
        alone, every later dispatch is one full batch, and the partial
        tail runs frame by frame."""
        cfg, cam = self.cfg, self.cfg.camera
        batch = cfg.offline_batch_size
        self._t_start = time.perf_counter()
        upload_q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    upload_q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def uploader():
            try:
                with KlgLogReader(cfg.log_file, width=cam.width, height=cam.height,
                                  max_frames=cfg.total_num_frames) as r:
                    total = r.total_num_frames
                    buf = []
                    for fr in r:
                        rgb = fr.rgb
                        if cfg.flip_colors and rgb is not None:
                            rgb = rgb[..., ::-1].copy()
                        buf.append((fr.depth, rgb, int(fr.timestamp)))
                        if fr.index == 0:
                            put(("first", [buf.pop(0)], total, None))
                        elif len(buf) == batch:
                            put(("batch", buf, total, self.tracker.upload_batch(buf)))
                            buf = []
                    if buf:
                        put(("tail", buf, total, None))
                put(None)
            except Exception as e:  # handed to the consumer, which raises it
                put(("error", e))

        def warm():
            try:
                self.tracker.warm_per_frame_step()
            except Exception as e:
                warm_err.append(e)

        warm_err: List[BaseException] = []
        threads = [threading.Thread(target=uploader, daemon=True),
                   threading.Thread(target=warm, daemon=True)]
        for t in threads:
            t.start()
        try:
            while True:
                item = upload_q.get()
                if item is None or self.stop_requested.is_set():
                    break
                if item[0] == "error":
                    raise item[1]
                self._wait_while_paused()
                kind, frames, total, up = item
                if kind == "batch":
                    with self.sw.span("processFrame"):
                        self.tracker.process_batch_device(*up)
                else:  # the first frame, or the partial tail: frame by frame
                    for fr in frames:
                        with self.sw.span("processFrame"):
                            self.tracker.process_frame(*fr)
                    if kind == "first":
                        self.tracker.flush()
                self._frames_done += len(frames)
                for fr in frames:
                    self._frame_done(*fr)
                self._publish()
                if progress:
                    progress(self._frames_done, total)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        if warm_err:
            raise warm_err[0]
        self.tracker.flush()

    def _finish(self) -> "SlamEngine":
        self.tracker.flush()
        if self.deformation is not None:
            self._publish()
        self.tracker.finalise()
        if self._pose_writer is not None:
            self._pose_writer.close()
            self._pose_writer = None
        self._end_of_log.set()
        self.slice_q.put(_SENTINEL)
        if self.place_rec is not None:
            self.kf_q.put(_SENTINEL)
        for w in self.workers:
            w.finished.wait(timeout=300)
        for w in self.workers:
            if w.error is not None:
                raise w.error
        return self

    # ------------------------------------------------------------ saves
    def save(self, basename: Optional[str] = None) -> dict:
        """Write the map (`<base>.pcd`), the trajectory (`<base>.poses`)
        and with meshing on the whole-map mesh (`<base>.ply`): every band
        patch emitted on the shifts welded with the live volume's mesh.
        Once -od accepted a loop: the deformed map (`<base>_opt.pcd`),
        the optimised trajectory, and with meshing the deformed band
        patches (`<base>_opt.ply`)."""
        base = basename or self.cfg.save_file
        md = self.deformation
        out = {"poses": f"{base}.poses"}
        if md is not None and md.n_loops_accepted:
            out["cloud"] = f"{base}_opt.pcd"
            md.save_cloud(out["cloud"])
            ts, poses = md.optimised_trajectory()
            save_trajectory(out["poses"], [t / 1e6 for t in ts], poses)
        else:
            out["cloud"] = f"{base}.pcd"
            self.slice_proc.save(out["cloud"], deoverlap=self.cfg.save_deoverlap)
            save_trajectory(out["poses"], [t / 1e6 for t in self.tracker.stamps_us],
                            self.tracker.poses)
        if (self.cfg.mesh and self.cfg.incremental_mesh and md is not None
                and md.n_loops_accepted and md.mesh_patches):
            out["mesh"] = f"{base}_opt.ply"
            md.save_mesh(out["mesh"])
        elif self.cfg.mesh:
            out["mesh"] = f"{base}.ply"
            mc = MeshCollector()
            for p in self.tracker.mesh_patches:
                mc.add(p)
            # cell welding removes the overlap with the FINAL patch
            mc.add(mesh_current_volume(self.tracker, self.cfg))
            mc.save(out["mesh"])
        return out

    def complete(self):
        """End the run cleanly: the frame loop stops at the next frame
        boundary and finalisation proceeds as at the end of the log."""
        self.stop_requested.set()
        self.paused.clear()

    def reset(self):
        """Stop the workers and start over with a fresh tracker."""
        self._end_of_log.set()
        self.slice_q.put(_SENTINEL)
        if self.place_rec is not None:
            self.kf_q.put(_SENTINEL)
        for w in self.workers:
            w.halt.set()
        for w in self.workers:
            w.finished.wait(timeout=30)
        if self._pose_writer is not None:
            self._pose_writer.close()
        self.sw.reset()
        self._build()

    @property
    def fps(self) -> float:
        el = time.perf_counter() - self._t_start
        return self._frames_done / el if el > 0 else 0.0
