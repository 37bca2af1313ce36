"""One run of a cell: the engine a user starts with `cli`, driven through
its batched offline path (a recorded `.klg` log) or its per-frame live
path (a 30 Hz sensor on a socket), with

- the set-up: the frames rendered and encoded, the sensor process
  started, the engine built, and its warm-up: the first frames, the
  captures of the front and back graphs and the first shift frame;
- the measured window of `seconds`, from a frame boundary, which ends on
  the clock: every pose that reaches the host in it is counted, then the
  engine is asked to stop; the final extraction and the workers' drain
  fall after it;
- the snapshots of the program's state that the correctness check
  follows from (compare.py), copied on the card between two frames, and
  taken out of the reported memory peak (PeakMeter);
- with `trace`, a profiled sub-window of a stated number of frames
  that starts when the window has closed, so that the window's frames
  run untraced.

Everything here reads the program from the outside: the engine's pose
callback, its stop event, its stopwatch's spans, its tracker's step
modes and shift log, and its tracker's state, which is only copied."""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from slambench import compare, frames as frames_mod
from slambench.spec import Cell
from slambench.trace import SubWindow, TraceSummary

WARM, WINDOW, TRACE, DONE = "warm", "window", "trace", "done"
MAX_POSE_SAMPLES = 32
WATCH_SLOTS = 4  # whole states the shift sample's watch holds at once, at most
IO_FIELDS = {"log_file", "live_source", "trajectory_file", "vocab_file", "save_file",
             "total_num_frames"}


def process_start_clock() -> float:
    """This process's start on time.monotonic()'s clock (Linux: both count
    from boot); the time of the first import of this module elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - age
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.monotonic()


def gpu_state() -> str:
    """The card's SM clock, power draw and limit, and temperature, as
    nvidia-smi reads them ("" where it does not run)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


class PeakMeter:
    """The program's memory peak on the card, with the benchmark's own
    snapshot buffers taken out: each change of those is a segment
    boundary, and a segment's peak less what the benchmark held in it is
    the program's."""

    def __init__(self, device):
        self.dev = device
        self.held = 0
        self.best = 0
        torch.cuda.reset_peak_memory_stats(device)

    def _close_segment(self) -> None:
        self.best = max(self.best, torch.cuda.max_memory_allocated(self.dev) - self.held)
        torch.cuda.reset_peak_memory_stats(self.dev)

    def alloc(self, nbytes: int) -> None:
        """Call before the benchmark allocates nbytes."""
        self._close_segment()
        self.held += nbytes

    def freed(self, nbytes: int) -> None:
        """Call after the benchmark freed nbytes."""
        self._close_segment()
        self.held -= nbytes

    def peak(self) -> int:
        return max(self.best, torch.cuda.max_memory_allocated(self.dev) - self.held)


class _NoMeter:
    def alloc(self, nbytes):
        pass

    def freed(self, nbytes):
        pass

    def peak(self):
        return 0


class Slots:
    """Snapshot buffers for the program's state, allocated once each and
    copied into between frames."""

    def __init__(self, meter):
        self.meter = meter
        self._free: List[Dict[str, torch.Tensor]] = []

    def take(self, state: Dict[str, torch.Tensor], fields) -> Dict[str, torch.Tensor]:
        names = [k for k in state if k in fields]
        for i, s in enumerate(self._free):
            if sorted(s) == sorted(names):
                slot = self._free.pop(i)
                break
        else:
            self.meter.alloc(sum(state[k].numel() * state[k].element_size() for k in names))
            slot = {k: torch.empty_like(state[k]) for k in names}
        for k in names:
            slot[k].copy_(state[k])
        return slot

    def give_back(self, slot) -> None:
        self._free.append(slot)

    def reserve(self, state: Dict[str, torch.Tensor], fields, n: int) -> None:
        """n more free slots for these fields, allocated now (in set-up)
        rather than inside the window."""
        names = [k for k in state if k in fields]
        for _ in range(n):
            self.meter.alloc(sum(state[k].numel() * state[k].element_size() for k in names))
            self._free.append({k: torch.empty_like(state[k]) for k in names})


class Ring:
    """The last `depth` states on the card, by state index, in reused
    snapshot buffers."""

    def __init__(self, slots: Slots, depth: int = 3):
        self.slots, self.depth = slots, depth
        self.states: Dict[int, Dict[str, torch.Tensor]] = {}

    def push(self, s: int, state: Dict[str, torch.Tensor]) -> None:
        if s in self.states:
            return
        if len(self.states) >= self.depth:
            self.slots.give_back(self.states.pop(min(self.states)))
        self.states[s] = self.slots.take(state, state.keys())

    def pop(self, s: int) -> Dict[str, torch.Tensor]:
        return self.states.pop(s)

    def clear(self) -> None:
        for v in self.states.values():
            self.slots.give_back(v)
        self.states.clear()


class ShiftWatch:
    """Which frames of the window may shift, told from the poses that
    have reached the host: the program's rule (a shift where the camera's
    anchor is voxel_shift voxels or more from the volume's centre on an
    axis) applied to a pose extrapolated at constant velocity, with
    `margin` metres of room; and which of them did shift with a slice
    that holds points."""

    def __init__(self, cfg, margin: float, start: int):
        self.vsz = cfg.voxel_size
        self.thresh = self.step = cfg.voxel_shift * cfg.voxel_size
        self.dc = 0.35 * cfg.volume_size if cfg.dynamic_cube else 0.0
        self.margin = margin
        self.start = start  # the first frame the sample may be
        self.candidates: List[int] = []  # frames whose states are being kept
        self.saved: Dict[int, Dict[str, torch.Tensor]] = {}  # state index -> copy
        self._with_points: set = set()
        self._seen = 0
        self._moved = np.zeros(3)  # voxel_size x the shifts of frames < self._summed
        self._summed = 0

    def may_shift(self, poses: List[np.ndarray], shift_log, k: int, m: int) -> bool:
        """Whether frame m may shift, from the poses of frames 0..k and
        the shifts of frames < len(shift_log) (the program's own)."""
        if k < 1 or m <= k:
            return False
        p0 = poses[0][:, 3]
        for v in shift_log[self._summed:k]:
            self._moved = self._moved + self.vsz * np.asarray(v, np.float64)
        self._summed = max(self._summed, min(k, len(shift_log)))
        moved = self._moved
        t, v = poses[k][:, 3] - p0, poses[k][:, 3] - poses[k - 1][:, 3]
        z = poses[k][:, 2]
        for i in range(k, m + 1):
            ti = t + (i - k) * v
            off = ti + z * self.dc - moved
            near = np.abs(off) >= self.thresh - self.margin
            if i == m:
                return bool(np.any(near))
            # frame i's own decision moves the volume for the next
            moved = moved + self.step * np.sign(off) * (np.abs(off) >= self.thresh)
        return False

    def note_slices(self, slices) -> None:
        for sl in slices[self._seen:]:
            if sl.dimension != "FINAL" and len(sl.points):
                self._with_points.add(sl.frame_index)
        self._seen = len(slices)

    def found(self, shift_log) -> Optional[int]:
        """The first candidate that shifted with points, both of its
        states kept."""
        for m in sorted(self.candidates):
            if m < len(shift_log) and np.any(shift_log[m]) and m in self._with_points \
                    and m - 1 in self.saved and m in self.saved:
                return m
        return None

    def unneeded(self, known: int) -> List[int]:
        """Kept states that no candidate still open can use (a candidate
        is settled once its shift is in the log)."""
        self.candidates = [m for m in self.candidates if m >= known]
        need = {i for m in self.candidates for i in (m - 1, m)}
        return [i for i in sorted(self.saved) if i not in need]


@dataclass
class RunRecord:
    """What a run measured and kept for the check and the readers."""

    setup_s: float = 0.0
    seconds: float = 0.0
    first: int = 0  # the first frame of the window
    last: int = -1  # the last frame whose pose reached the host in it
    arrival: List[float] = field(default_factory=list)  # host clock, a pose
    stamps: List[int] = field(default_factory=list)  # its timestamp_us
    poses: List[np.ndarray] = field(default_factory=list)
    start_frame: int = -1  # F: the start check's last frame
    start_state: Optional[Dict] = None
    full_frame: int = -1  # the window frame followed whole
    full_states: Dict[int, Dict] = field(default_factory=dict)  # index -> state
    shift_frame: int = -1  # the window's shift frame followed whole (with a slice)
    shift_states: Dict[int, Dict] = field(default_factory=dict)  # index -> state
    shift_search: int = 0  # states copied while the shift sample was looked for
    pose_states: Dict[int, Dict] = field(default_factory=dict)  # frame j -> small S_{j-1}
    step_modes: List[str] = field(default_factory=list)  # the window's frames'
    shift_frames: List[int] = field(default_factory=list)
    shift_log: List[np.ndarray] = field(default_factory=list)  # each frame's shift
    slices: Dict[int, np.ndarray] = field(default_factory=dict)  # frame -> points
    slice_frames: List[int] = field(default_factory=list)  # frames whose slice held points
    gpu: Dict[str, str] = field(default_factory=dict)  # nvidia-smi before and after
    setup_parts: Dict[str, float] = field(default_factory=dict)  # seconds, in order
    final_state: Optional[Dict] = None  # the volume when the run ended
    final_points: Optional[np.ndarray] = None  # the program's FINAL slice
    span_window: Dict[str, Dict[str, float]] = field(default_factory=dict)
    memory_peak: int = 0
    sensor: dict = field(default_factory=dict)
    trace: Optional[TraceSummary] = None
    failed: int = 0


def _stats(sw) -> Dict[str, tuple]:
    return {k: (v["count"], v["mean_ms"] * v["count"]) for k, v in sw.stats().items()}


class Session:
    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device="cuda"):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, float(seconds), trace
        self.dev = torch.device(device)
        self.traffic = cell.traffic
        self.live = self.traffic["loop"] == "live"
        self.rng = np.random.default_rng([seed, 0x5EB])
        self.rec = RunRecord()
        self.phase = WARM
        self._tmp = None
        self._sensor = None
        self._ring = None  # the last states, while the start frame is looked for
        self._p: List[np.ndarray] = []  # each frame's global pose, rows 0-2
        self.log_is_pipe = True

    # ---------------------------------------------------------- set-up
    def _start_sensor(self, fs: frames_mod.FrameSet, path: str) -> subprocess.Popen:
        t = self.traffic
        mode = "live" if self.live else "log"
        total = int(t["stream_frames"])
        if not self.live and self.log_is_pipe:
            os.mkfifo(path)
        env = {k: v for k, v in os.environ.items() if not k.startswith("CUDA")}
        env["CUDA_VISIBLE_DEVICES"] = ""  # the sensor never touches a card
        proc = subprocess.Popen(
            [sys.executable, "-m", "slambench.sensor", "--mode", mode, "--path", path,
             "--frames", str(total), "--rate", str(t.get("rate_hz", 30.0))],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=str(_root()), env=env)
        blob = [len(fs).to_bytes(8, "little", signed=True)]
        for d, c in fs.encoded:
            blob += [len(d).to_bytes(4, "little", signed=True),
                     len(c).to_bytes(4, "little", signed=True), d, c]
        proc.stdin.write(b"".join(blob))
        proc.stdin.close()
        proc.stdin = None  # communicate() must not flush it
        if self.live and proc.stdout.readline().strip() != b"listening":
            raise RuntimeError("the sensor process did not start listening")
        if not self.live and not self.log_is_pipe:
            proc.wait()  # the whole log is on disk before the reader opens it
        return proc

    def _config(self, source: str, live: bool):
        from kintinuous_tpu_torch.cli import build_config
        from kintinuous_tpu_torch.config import CameraIntrinsics

        conf = self.cell.config
        argv = (["-live", source] if live else ["-l", source]) + list(conf["argv"]) + ["-o", ""]
        cfg = build_config(argv)
        over = dict(conf.get("overrides", {}))
        if "camera" in over:
            over["camera"] = CameraIntrinsics(**over["camera"])
        cfg = cfg.replace(**over)
        # the program runs what the reference is told: every field but I/O
        want = dataclasses.asdict(compare.reference_config(conf))
        have = dataclasses.asdict(cfg)
        for k in sorted(set(want) - IO_FIELDS):
            if have.get(k) != want[k]:
                raise ValueError(f"config {conf['name']}: the program's {k} is {have.get(k)!r}, "
                                 f"the reference's {want[k]!r}")
        return cfg

    # --------------------------------------------------------- the run
    def run(self) -> RunRecord:
        from kintinuous_tpu_torch.runtime.engine import SlamEngine

        rec = self.rec
        t_proc = process_start_clock()
        rec.gpu["before"] = gpu_state()
        parts, t0 = rec.setup_parts, time.monotonic()
        parts["to_start"] = t0 - t_proc  # the interpreter, torch, the card
        cam = frames_mod.camera_of(self.cell.config)
        self.fs = frames_mod.make_frames(self.traffic, cam, self.seed, self.dev)
        parts["frames"] = time.monotonic() - t0
        gc.collect()
        on_card = self.dev.type == "cuda"
        if on_card:
            torch.cuda.empty_cache()
        self.meter = PeakMeter(self.dev) if on_card else _NoMeter()
        self.slots = Slots(self.meter)
        self._ring = Ring(self.slots)
        self._tmp = tempfile.mkdtemp(prefix="sb")
        if not self.live:
            from kintinuous_tpu_torch.io import klg_native

            # the program's native reader indexes the whole log at open,
            # so it needs a file; its Python reader reads a pipe, which
            # costs no disk (the card's machine lacks jpeglib.h, so there
            # the Python reader runs)
            self.log_is_pipe = not klg_native.available()
        # the slice processor's native library, built and loaded at its
        # first use: here in set-up, not at the first slice in the window
        from kintinuous_tpu_torch.backend import native_ops

        native_ops.available()
        path = os.path.join(self._tmp, "s.sock" if self.live else "log.klg")
        try:
            t0 = time.monotonic()
            self._sensor = self._start_sensor(self.fs, path)
            parts["sensor"] = time.monotonic() - t0
            t0 = time.monotonic()
            cfg = self._config(path, self.live)
            self.engine = SlamEngine(cfg, device=None if on_card else self.dev)
            parts["engine"] = time.monotonic() - t0
            self._t_run = time.monotonic()
            self.tracker = self.engine.tracker
            self.tracker.pose_callback = self._on_pose
            self._t_proc = t_proc
            self.sub = SubWindow(int(self.traffic["trace_frames"])) if self.trace else None
            self._span0 = None
            self.engine.run()
            rec.memory_peak = self.meter.peak()
            rec.gpu["after"] = gpu_state()
            self._collect()
        finally:
            self._stop_sensor()
            if self._tmp:
                for name in os.listdir(self._tmp):
                    os.unlink(os.path.join(self._tmp, name))
                os.rmdir(self._tmp)
        return rec

    def _stop_sensor(self) -> None:
        p = self._sensor
        if p is None:
            return
        if p.poll() is None:
            p.terminate()
        try:
            out, _ = p.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        lines = [ln for ln in out.decode(errors="replace").splitlines() if ln.startswith("{")]
        if lines:
            self.rec.sensor = json.loads(lines[-1])
        self._sensor = None

    # ------------------------------------------------- the pose callback
    def _on_pose(self, ts: int, pose: np.ndarray) -> None:
        now = time.monotonic()
        rec = self.rec
        k = len(rec.arrival)
        rec.arrival.append(now)
        rec.stamps.append(int(ts))
        self._p.append(np.asarray(pose, np.float64)[:3, :].copy())
        # the state now on the card is the one after frame s (one frame
        # ahead of the pose, except when the tracker flushed)
        s = self.tracker._frame_idx - 1
        if self.phase == WARM:
            self._warm(k, s)
        elif self.phase == WINDOW:
            # a live window closes once the engine has moved past the
            # frames due in it, so that each of those was taken or dropped
            if (ts / 1e6 if self.live else now) >= self.t_end:
                self._close(k)
            else:
                self._in_window(k, s, pose)
        elif self.phase == TRACE and k >= self._trace_until:
            self._stop_trace(k)
            self._finish()

    def _state(self) -> Dict[str, torch.Tensor]:
        return compare.flatten(self.tracker.state)

    def _warm(self, k: int, s: int) -> None:
        rec, t = self.rec, self.traffic["warmup"]
        log = self.tracker.shift_log  # frames < k
        if rec.start_frame < 0:
            shifted = [i for i, v in enumerate(log) if np.any(v)]
            if shifted:
                rec.start_frame = shifted[0]
            elif not t["shift"] and k >= t["min_frames"]:
                rec.start_frame = s
        # keep the last states until the start frame's is known
        if rec.start_state is None:
            ring = self._ring
            if rec.start_frame >= 0 and rec.start_frame in ring.states:
                rec.start_state = ring.pop(rec.start_frame)
                ring.clear()
            else:
                ring.push(s, self._state())
                if rec.start_frame >= 0 and rec.start_frame < min(ring.states):
                    raise RuntimeError(f"the state after the start frame {rec.start_frame} "
                                       "was never on the card between two frames")
        if rec.start_state is not None and k >= t["min_frames"] and k > rec.start_frame:
            self._open(k)

    def _open(self, k: int) -> None:
        rec, t = self.rec, self.traffic
        sh = t["samples"].get("shift")
        # every snapshot buffer the window can use, allocated before it
        st = self._state()
        self.slots.reserve(st, st.keys(), 2 + (WATCH_SLOTS if sh else 0))
        self.slots.reserve(st, [n for n in st if n not in compare.BIG], MAX_POSE_SAMPLES)
        now = time.monotonic()
        self.phase = WINDOW
        self.t_start, self.t_end = now, now + self.seconds
        rec.setup_s = now - self._t_proc
        rec.setup_parts["warm_up"] = now - self._t_run
        rec.seconds = self.seconds
        rec.first = k + 1
        lo, hi = t["samples"]["full_offset"]
        rec.full_frame = rec.first + int(self.rng.integers(lo, hi + 1))
        p = float(t["samples"]["pose_share"])
        self._pose_pick = lambda: self.rng.random() < p
        self._shift = ShiftWatch(compare.reference_config(self.cell.config), float(sh["margin_m"]),
                                 rec.first + int(self.rng.integers(sh["offset"][0],
                                                                   sh["offset"][1] + 1))
                                 ) if sh else None
        self._span0 = _stats(self.engine.sw)

    def _in_window(self, k: int, s: int, pose: np.ndarray) -> None:
        rec = self.rec
        j = s + 1  # the frame whose step starts from the state now on the card
        if s in (rec.full_frame - 1, rec.full_frame):
            st = self._state()
            rec.full_states[s] = self.slots.take(st, st.keys())
        elif (j > rec.first and len(rec.pose_states) < MAX_POSE_SAMPLES
              and j not in rec.pose_states and self._pose_pick()):
            st = self._state()
            rec.pose_states[j] = self.slots.take(st, [n for n in st if n not in compare.BIG])
        if self._shift is not None and rec.shift_frame < 0:
            self._watch_shift(k, s)

    def _watch_shift(self, k: int, s: int) -> None:
        """The shift sample: the states before and after the first shift
        frame from its start whose slice holds points. A state is copied
        only where the frame after it may shift (ShiftWatch), and let go
        once the frames it could serve are known not to do."""
        rec, tr, w = self.rec, self.tracker, self._shift
        w.note_slices(tr.slices)
        m = w.found(tr.shift_log)
        if m is not None:
            rec.shift_frame = m
            rec.shift_states = {i: w.saved.pop(i) for i in (m - 1, m)}
        for i in w.unneeded(len(tr.shift_log)):
            self.slots.give_back(w.saved.pop(i))
        if m is not None or s in w.saved:
            return
        after = s in w.candidates and s - 1 in w.saved  # a candidate's own state
        before = s + 1 >= w.start and w.may_shift(self._p, tr.shift_log, k, s + 1)
        if before and s + 1 not in w.candidates:
            w.candidates.append(s + 1)
        if after or before:
            st = self._state()
            w.saved[s] = self.slots.take(st, st.keys())
            rec.shift_search += 1

    def _close(self, k: int) -> None:
        rec = self.rec
        rec.last = k - 1
        span1 = _stats(self.engine.sw)
        for name, (n1, t1) in span1.items():
            n0, t0 = self._span0.get(name, (0, 0.0))
            if n1 > n0:
                rec.span_window[name] = {"count": n1 - n0, "mean_ms": (t1 - t0) / (n1 - n0)}
        if self._shift is not None:
            for slot in self._shift.saved.values():
                self.slots.give_back(slot)
            self._shift.saved.clear()
        if self.sub is not None:
            # the traced frames follow the window
            self.phase = TRACE
            self._trace_from, self._trace_until = k, k + self.sub.frames
            self.sub.start()
        else:
            self._finish()

    def _stop_trace(self, k: int) -> None:
        """Frames k_start + 2 .. k + 1 stepped inside the sub-window (one
        step runs ahead of the pose being read)."""
        self.sub.frames = k - self._trace_from
        self.sub.stop()

    def _finish(self) -> None:
        self.phase = DONE
        self.engine.complete()
        if not self.live and self._sensor.poll() is None:
            # the log ends here: the reader sees its end and the uploader
            # stops decoding
            self._sensor.terminate()

    def _collect(self) -> None:
        rec, tr = self.rec, self.tracker
        if self.phase == TRACE:  # the stream ended inside the traced frames
            self._stop_trace(len(rec.arrival) - 1)
            self.phase = DONE
        if self.phase != DONE:
            raise RuntimeError(f"the stream ended before the window closed (phase {self.phase}, "
                               f"{len(rec.arrival)} poses)")
        rec.poses = [np.asarray(p) for p in tr.poses]
        from kintinuous_tpu_torch.tracking.tracker import STEP_MODES

        rec.step_modes = [STEP_MODES[int(m)] for m in tr.stats["step_mode"][rec.first:rec.last + 1]]
        counts = tr.stats["icp_count"][rec.first:rec.last + 1]
        rec.failed = int(sum(1 for c in counts if c <= 0))
        rec.shift_log = [np.asarray(v).astype(np.int64) for v in tr.shift_log]
        rec.shift_frames = [i for i, v in enumerate(rec.shift_log) if np.any(v)]
        st = self._state()
        rec.final_state = self.slots.take(st, ["tsdf", "cw", "wrap", "origin"])
        rec.slice_frames = sorted({sl.frame_index for sl in tr.slices
                                   if sl.dimension != "FINAL" and len(sl.points)})
        for sl in tr.slices:
            if sl.dimension == "FINAL":
                rec.final_points = np.asarray(sl.points, np.float32)
            if sl.frame_index == rec.shift_frame and sl.dimension != "FINAL":
                prev = rec.slices.get(sl.frame_index)
                pts = np.asarray(sl.points, np.float32)
                rec.slices[sl.frame_index] = pts if prev is None else np.concatenate([prev, pts])
        if self.sub is not None and self.sub.frames > 0:
            rec.trace = self.sub.summary()

    def release(self) -> None:
        """Free the program (engine, tracker, graphs) before the check."""
        self.engine = None
        self.tracker = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()

    # ------------------------------------------------ source frames
    def source_index(self, k: int) -> int:
        """The stream frame that tracker frame k took."""
        if not self.live:
            return k  # the log's frames are taken in order, every one
        s = self.rec.sensor
        return int(round((self.rec.stamps[k] - s["t0_us"]) / s["period_us"]))


def _root():
    from slambench.spec import ROOT

    return ROOT
