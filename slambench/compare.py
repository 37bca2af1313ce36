"""The correctness check: the program's outputs against the plain
reference (reference/, a frozen plain-PyTorch copy of the fast step),
computed after the window has closed and the program's state is freed.

What is compared (all on the card, at the cell's own sizes):

- the start: the reference runs from its own empty state over the
  frames the program took, up to and including the first shift frame F,
  and is held against the program's poses of frames 0..F and its state after F (volume,
  weights, colours, raycast prediction, and the surface extracted from
  the volume);
- the window, followed step by step from the program's own state: at a
  frame drawn from the seed, the reference's whole step from the
  program's state before it, against the program's state after it; at
  up to 32 more frames drawn from the seed, the reference's front half
  (preprocess and odometry) against the program's pose.

- with traffic that samples one, a shift frame of the window whose
  slice holds points, likewise whole from the program's state before it:
  its state after it and the slice it extracted.

The numbers, each the worst over everything compared: `pose_m` and
`pose_rad` (translation and rotation gaps of a pose), `tsdf` (the mean
absolute tsdf gap over voxels observed on either side), `weight` (the
share of those voxels whose fusion weight differs), `color` (the mean
colour gap in levels over voxels observed on both sides), `vmap_m` (the
mean vertex gap over pixels predicted on both sides), `hits` (the share
of pixels predicted on one side only) and `map_m` (the mean distance of
a surface point to the nearest point of the other side, both ways: the
start's whole volumes extracted, the window's sampled slice, and the
program's FINAL slice against the reference's extraction of the volume
the run ended with).

The control puts the reference computed with TF32 matmuls in the
program's place (the configuration states float32 with TF32 off)."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from slambench.reference import step as ref_step
from slambench.reference.blocked import BlockedVolume, as_dense
from slambench.reference.config import CameraIntrinsics, KintinuousConfig
from slambench.reference.extract import extract_points
from slambench.reference.rgbd import RGBDFramePyramid

MAP_CAPACITY = 8_000_000  # surface points of a whole volume
BIG = ("tsdf", "cw", "logical")  # the fields a small snapshot leaves out


def reference_config(config: dict) -> KintinuousConfig:
    s = dict(config["settings"])
    cam = CameraIntrinsics(**s.pop("camera"))
    return KintinuousConfig(camera=cam, **s)


# ------------------------------------------------------------ snapshots
def flatten(state) -> Dict[str, torch.Tensor]:
    """A tracker state (the program's or the reference's TrackerState) as
    {field: tensor}: vol.* and rgbd.<field>.<level> flattened."""
    out = {}
    for k, v in state._asdict().items():
        if v is None:
            continue
        if k == "vol":
            for kk, vv in v._asdict().items():
                out[kk] = vv
        elif k == "rgbd":
            for kk, levels in v._asdict().items():
                for i, x in enumerate(levels):
                    out[f"rgbd.{kk}.{i}"] = x
        else:
            out[k] = v
    return out


def unflatten(d: Dict[str, torch.Tensor]) -> ref_step.TrackerState:
    """{field: tensor} -> the reference's TrackerState (a small snapshot
    gives vol=None)."""
    vol = None
    if "tsdf" in d:
        vol = BlockedVolume(d["tsdf"], d["cw"], d["wrap"], d["origin"])
    rgbd = None
    if any(k.startswith("rgbd.") for k in d):
        levels = 1 + max(int(k.rsplit(".", 1)[1]) for k in d if k.startswith("rgbd."))
        rgbd = RGBDFramePyramid(*(tuple(d[f"rgbd.{f}.{i}"] for i in range(levels))
                                  for f in RGBDFramePyramid._fields))
    return ref_step.TrackerState(
        vol=vol, pose=d["pose"], pred_vmap=d["pred_vmap"], pred_nmap=d["pred_nmap"],
        pred_pose=d["pred_pose"], frame=d["frame"], rgbd=rgbd, dc=d["dc"],
        prev_delta=d["prev_delta"], pw=d["pw"], logical=d.get("logical"))


# --------------------------------------------------------------- gaps
def pose_gap(a: np.ndarray, b: np.ndarray) -> Tuple[float, float]:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dt = float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
    # the angle between the rotations, from the chord ||Ra - Rb||_F =
    # 2 sqrt(2) sin(angle / 2): exact at 0, where arccos of the trace is not
    chord = float(np.linalg.norm(a[:3, :3] - b[:3, :3]))
    return dt, 2.0 * float(np.arcsin(min(1.0, chord / (2.0 * np.sqrt(2.0)))))


def volume_gap(p: Dict[str, torch.Tensor], r: Dict[str, torch.Tensor]) -> Tuple[float, float, float]:
    """(mean |tsdf gap|, share of differing weights, mean colour gap in
    levels) over the voxels observed (weight > 0) on either side; the
    colour over those observed on both."""
    wp = (p["cw"] >> 24) & 0xFF
    wr = (r["cw"] >> 24) & 0xFF
    seen = (wp > 0) | (wr > 0)
    both = (wp > 0) & (wr > 0)
    n = max(int(seen.sum()), 1)
    dt = torch.where(seen, (p["tsdf"] - r["tsdf"]).abs(), 0.0).sum(dtype=torch.float64)
    dw = (seen & (wp != wr)).sum()
    dc = torch.zeros((), dtype=torch.float64, device=wp.device)
    for s in (0, 8, 16):
        d = (((p["cw"] >> s) & 0xFF) - ((r["cw"] >> s) & 0xFF)).abs()
        dc += torch.where(both, d, 0).sum(dtype=torch.float64)
    return float(dt) / n, float(dw) / n, float(dc) / (3 * max(int(both.sum()), 1))


def prediction_gap(p: Dict[str, torch.Tensor], r: Dict[str, torch.Tensor]) -> Tuple[float, float]:
    """(mean vertex gap over pixels predicted on both sides, share of
    pixels predicted on one side only)."""
    vp, vr = p["pred_vmap"], r["pred_vmap"]
    ok_p = torch.isfinite(vp).all(dim=0)
    ok_r = torch.isfinite(vr).all(dim=0)
    both = ok_p & ok_r
    d = torch.linalg.vector_norm(torch.where(both[None], vp - vr, 0.0), dim=0)
    gap = float(d.sum(dtype=torch.float64)) / max(int(both.sum()), 1)
    return gap, float((ok_p != ok_r).float().mean())


def slice_gap(p: np.ndarray, r: np.ndarray) -> float:
    """Mean distance from each point of one slice to the nearest point of
    the other, both ways (inf when one side has none)."""
    if len(p) == 0 and len(r) == 0:
        return 0.0
    if len(p) == 0 or len(r) == 0:
        return float("inf")
    if len(p) == len(r) and np.array_equal(p, r):
        return 0.0
    from scipy.spatial import cKDTree

    d1, _ = cKDTree(r).query(p)
    d2, _ = cKDTree(p).query(r)
    return 0.5 * (float(np.mean(d1)) + float(np.mean(d2)))


@dataclass
class Gaps:
    """The worst gap of each number so far, and which comparison gave it."""

    values: Dict[str, float] = field(default_factory=dict)
    where: Dict[str, str] = field(default_factory=dict)
    at: str = ""  # the comparison being added

    def add(self, name: str, v: float) -> None:
        if not np.isfinite(v):
            v = float("inf")
        if name not in self.values or float(v) > self.values[name]:
            self.values[name] = float(v)
            self.where[name] = self.at

    def add_pose(self, a, b) -> None:
        dt, dr = pose_gap(a, b)
        self.add("pose_m", dt)
        self.add("pose_rad", dr)

    def add_state(self, p, r) -> None:
        t, w, c = volume_gap(p, r)
        self.add("tsdf", t)
        self.add("weight", w)
        self.add("color", c)
        v, h = prediction_gap(p, r)
        self.add("vmap_m", v)
        self.add("hits", h)


# ------------------------------------------------------------ the runs
@contextlib.contextmanager
def tf32(on: bool):
    """Matmuls (and convolutions) in TF32 inside, when `on`."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _global(pose_local: torch.Tensor, origin: torch.Tensor) -> np.ndarray:
    g = pose_local.detach().double().cpu().numpy().copy()
    g[:3, 3] += origin.detach().double().cpu().numpy()
    return g.astype(np.float32)


def _slice_points(slices) -> np.ndarray:
    pts = [s.vals[: int(s.count), 0:3].cpu().numpy() for s in slices if s is not None]
    return np.concatenate(pts) if pts else np.zeros((0, 3), np.float32)


class Reference:
    """The reference step on `device`, as the configuration states it;
    `tf32=True` is the control."""

    def __init__(self, cfg: KintinuousConfig, device, tf32: bool = False):
        self.cfg, self.dev, self.tf32 = cfg, torch.device(device), tf32
        self.odo = ref_step.make_step_fast(cfg, use_odometry=True)
        self.ext = ref_step.make_step_fast(cfg, use_odometry=False)
        self.halves = ref_step.FastHalves(cfg)
        self.ties = 0  # shift decisions taken from the program at the threshold

    def _inputs(self, frame):
        d, c = frame
        return (torch.from_numpy(np.require(d, requirements=["C", "W"])).to(self.dev),
                torch.from_numpy(np.require(c, requirements=["C", "W"])).to(self.dev))

    def from_scratch(self, frames: Sequence, hints: Sequence) -> Tuple[List[np.ndarray], Dict]:
        """Frames 0..n-1 from the empty state, with the program's shifts
        as hints: (global poses, the state after the last as
        {field: tensor})."""
        st = ref_step.initial_state(self.cfg, self.dev)
        poses = []
        eye = torch.eye(4, dtype=torch.float32, device=self.dev)
        with tf32(self.tf32):
            for i, (fr, hint) in enumerate(zip(frames, hints)):
                d, c = self._inputs(fr)
                st, out, tied = (self.ext if i == 0 else self.odo)(st, d, c, eye, hint)
                self.ties += tied
                poses.append(out.pose_global.cpu().numpy())
        return poses, flatten(st)

    def step(self, before: Dict[str, torch.Tensor], frame, hint) -> Tuple[np.ndarray, Dict, np.ndarray]:
        """The whole step of one frame from a state (the tensors are
        updated in place), with the program's shift as a hint: (global
        pose, the state after it, the slice points it extracted)."""
        st = unflatten(before)
        d, c = self._inputs(frame)
        with tf32(self.tf32):
            st, out, tied = self.odo(st, d, c, None, hint)
        self.ties += tied
        return out.pose_global.cpu().numpy(), flatten(st), _slice_points(out.slices)

    def front_pose(self, before: Dict[str, torch.Tensor], frame) -> np.ndarray:
        """The front half of one frame from a small snapshot: the global
        pose it reaches."""
        st = unflatten(before)
        d, c = self._inputs(frame)
        with tf32(self.tf32):
            fo = self.halves.front(st, d, c, None, True)
        return _global(fo.pose, before["origin"])


def map_points(state: Dict[str, torch.Tensor], cfg: KintinuousConfig,
               capacity: int = MAP_CAPACITY) -> np.ndarray:
    """The surface points of a whole volume (the reference's extraction,
    as the FINAL slice is extracted), global metres, on the host: the
    first `capacity` in voxel order."""
    vol = as_dense(BlockedVolume(state["tsdf"], state["cw"], state["wrap"], state["origin"]))
    R = cfg.volume_resolution
    res = extract_points(vol, (0, 0, 0), (R, R, R), cfg.voxel_size, capacity)
    n = int(res.count)
    if capacity == MAP_CAPACITY and n >= MAP_CAPACITY:
        raise RuntimeError(f"the map check's capacity of {MAP_CAPACITY} points is full")
    return res.points[:min(n, capacity)].cpu().numpy()


def clone(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in d.items()}
