"""Loop-closure detection (port of kintinuous_tpu/backend/place_recognition.py).

The reference's place-recognition thread, stage by stage:

  keyframe gating     motion threshold 0.15, handled by the caller
  detection           BoW query + nss-style relative score
  loop throttle       loop_throttle_s between accepted loops
  descriptor matching 2-NN ratio test
  >= 40 matches gate  loop_min_matches
  relative pose       3D-3D Umeyama RANSAC (depth on both sides, so the
                      minimal solver is a 3-point rigid fit)
  inlier ratio 0.35   inlier_ratio
  verification ICP    point-to-point Umeyama ICP on voxel-downsampled
                      clouds with a scipy KD-tree, score < 0.01
  dense refinement    the port's own stage, after every gate: the
                      tracker's coarse-to-fine point-to-plane ICP between
                      the two keyframes' filtered depth maps, started at
                      the verification ICP's pose (refine_loop)

The verification ICP's pose is its fixed point on 5 cm voxel centroids,
which two viewpoints sample differently: on bench C's lap it errs by a
median 21.5 mm, more than the tracker drifts over the whole lap, so a
loop closed on it makes the trajectory worse. The dense refinement takes
those loops to within 1 mm of the truth. With LOOP_REFINE_ITERS empty
the stages are the JAX package's and make its constraints.

Only the ORB detection (`features.detect_orb`, the port's own detector)
and the dense refinement run on the engine's device; the rest of the
geometry is numpy and scipy on the host, as in the JAX package.
Keyframes keep their depth as zlib uint16 mm and no colour
(`rgb_jpg = b""`): the port has no JPEG encoder on the card's machine,
and nothing on the path reads a keyframe's colour. A keyframe
restored from a JAX checkpoint keeps its JPEG bytes; `Keyframe.rgb`
decodes them through `io/klg.jpeg_codec()`, which raises where no codec
exists.

Emits LoopConstraint records for the deformation runner.
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy.spatial import cKDTree

from kintinuous_tpu_torch.backend.features import (
    BowDatabase,
    Vocabulary,
    detect_orb,
    match_ratio,
    rgb_to_gray,
)
from kintinuous_tpu_torch.backend.slice_proc import voxel_downsample
from kintinuous_tpu_torch.config import CameraIntrinsics, KintinuousConfig
from kintinuous_tpu_torch.device import resolve_device
from kintinuous_tpu_torch.eval.ate import align_umeyama
from kintinuous_tpu_torch.ops import preprocess as pp
from kintinuous_tpu_torch.tracking.odometry import build_map_pyramid, icp_odometry

PR_RING = 3000  # keyframe ring capacity
# GN steps a pyramid level (finest first) of the dense loop refinement:
# the reference ICPOdometry's schedule; () skips the refinement
LOOP_REFINE_ITERS = (10, 5, 4)


@dataclass
class Keyframe:
    """PR keyframe. Depth is stored zlib-compressed uint16 mm (~60 KB a
    keyframe instead of a 1.2 MB float map), decompressed only for the
    verification ICP."""

    kf_id: int
    timestamp_us: int
    pose: np.ndarray  # (4,4) global camera pose at capture
    keypoints: np.ndarray  # (N,2)
    descriptors: np.ndarray  # (N,32)
    points3d: np.ndarray  # (N,3) camera-frame backprojections (NaN invalid)
    depth_z: bytes  # zlib(uint16 depth mm)
    depth_shape: tuple
    # JPEG colour, for debugging only; empty when unavailable (the port's
    # own keyframes), or the bytes of a keyframe restored from a JAX
    # checkpoint
    rgb_jpg: bytes = b""

    @property
    def depth_mm(self) -> np.ndarray:
        return np.frombuffer(zlib.decompress(self.depth_z), np.uint16).reshape(self.depth_shape)

    @property
    def depth_m(self) -> np.ndarray:
        return self.depth_mm.astype(np.float32) / 1000.0

    @property
    def rgb(self) -> Optional[np.ndarray]:
        """(H,W,3) uint8 RGB, or None when not retained."""
        if not self.rgb_jpg:
            return None
        from kintinuous_tpu_torch.io import klg

        return klg._decode_rgb(self.rgb_jpg)


@dataclass
class LoopConstraint:
    time1: int
    time2: int
    T_1_2: np.ndarray  # (4,4): frame-2 camera expressed in frame-1's frame
    inliers1: np.ndarray  # (K,3) matched points, frame-1 camera coords
    inliers2: np.ndarray  # (K,3) matched points, frame-2 camera coords
    icp_score: float
    kf_id1: int = -1
    kf_id2: int = -1


def backproject(cam: CameraIntrinsics, depth_m: np.ndarray, uv: np.ndarray):
    """Per-keypoint 3D camera-frame points (NaN where depth is 0)."""
    u = np.clip(np.round(uv[:, 0]).astype(int), 0, cam.width - 1)
    v = np.clip(np.round(uv[:, 1]).astype(int), 0, cam.height - 1)
    z = depth_m[v, u]
    valid = z > 0
    x = (uv[:, 0] - cam.cx) / cam.fx * z
    y = (uv[:, 1] - cam.cy) / cam.fy * z
    pts = np.stack([x, y, z], axis=1)
    pts[~valid] = np.nan
    return pts


def umeyama_ransac(
    src: np.ndarray,
    dst: np.ndarray,
    iters: int = 500,
    thresh: float = 0.05,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """RANSAC rigid fit dst ~= R src + t with a 3-point Umeyama minimal
    solver, all hypotheses at once. Returns (T (4,4), inlier mask)."""
    n = len(src)
    rng = np.random.default_rng(seed)
    best_mask = np.zeros(n, bool)
    if n < 3:
        return np.eye(4), best_mask
    idx = rng.integers(0, n, size=(iters, 3))
    # vectorised 3-point Kabsch
    s = src[idx]  # (I,3,3)
    d = dst[idx]
    mu_s = s.mean(axis=1, keepdims=True)
    mu_d = d.mean(axis=1, keepdims=True)
    cov = np.einsum("iab,iac->ibc", d - mu_d, s - mu_s)
    U, _, Vt = np.linalg.svd(cov)
    det = np.linalg.det(np.einsum("iab,ibc->iac", U, Vt))
    S = np.tile(np.eye(3), (iters, 1, 1))
    S[:, 2, 2] = np.sign(det)
    R = np.einsum("iab,ibc,icd->iad", U, S, Vt)
    t = mu_d.squeeze(1) - np.einsum("iab,ib->ia", R, mu_s.squeeze(1))
    # score all hypotheses
    pred = np.einsum("iab,nb->ina", R, src) + t[:, None, :]
    err = np.linalg.norm(pred - dst[None], axis=2)
    inl = err < thresh
    counts = inl.sum(axis=1)
    best = int(np.argmax(counts))
    best_mask = inl[best]
    if best_mask.sum() >= 3:
        _, Rf, tf = align_umeyama(src[best_mask], dst[best_mask])
        T = np.eye(4)
        T[:3, :3] = Rf
        T[:3, 3] = tf
    else:
        T = np.eye(4)
    return T, best_mask


def verification_icp(
    cam: CameraIntrinsics,
    depth1: np.ndarray,
    depth2: np.ndarray,
    T_init: np.ndarray,
    leaf: float = 0.05,
    iters: int = 10,
) -> Tuple[np.ndarray, float]:
    """Point-to-point ICP of cloud2 onto cloud1 starting at T_init.
    Returns (refined T, mean squared distance score)."""

    def cloud(depth):
        H, W = depth.shape
        u, v = np.meshgrid(np.arange(W), np.arange(H))
        z = depth
        ok = z > 0
        pts = np.stack(
            [(u - cam.cx) / cam.fx * z, (v - cam.cy) / cam.fy * z, z], axis=-1
        )[ok]
        p, _, _ = voxel_downsample(pts, None, None, leaf)
        return p

    c1 = cloud(depth1)
    c2 = cloud(depth2)
    if len(c1) < 20 or len(c2) < 20:
        return T_init, np.inf
    tree = cKDTree(c1)
    T = T_init.copy()
    score = np.inf
    for _ in range(iters):
        moved = c2 @ T[:3, :3].T + T[:3, 3]
        dist, nn = tree.query(moved, workers=-1)
        keep = dist < 3 * leaf
        if keep.sum() < 10:
            break
        _, R, t = align_umeyama(moved[keep], c1[nn[keep]])
        dT = np.eye(4)
        dT[:3, :3] = R
        dT[:3, 3] = t
        T = dT @ T
        score = float(np.mean(dist[keep] ** 2))
    return T, score


def refine_loop(cfg: KintinuousConfig, depth1_mm: np.ndarray, depth2_mm: np.ndarray,
                T_init: np.ndarray, device, iters=LOOP_REFINE_ITERS) -> Tuple[np.ndarray, float]:
    """Dense refinement of a loop's relative pose T_1_2 (frame-2 camera
    points into frame 1): the tracker's coarse-to-fine point-to-plane ICP
    (projective association, the tracker's distance and angle gates)
    between the two depth maps, bilateral-filtered as the tracker
    filters a frame, on `device`. Returns (T_1_2, inliers at the finest
    level)."""

    def pyramid(depth_mm):
        d = torch.from_numpy(np.asarray(depth_mm, np.float32)).to(device)
        d = pp.bilateral_filter(d, cfg.bilateral_sigma_depth, cfg.bilateral_sigma_space,
                                cfg.bilateral_radius)
        return build_map_pyramid(cfg.camera, pp.depth_to_metres(d, cfg.max_depth), len(iters))

    T, count, _ = icp_odometry(
        cfg.camera, pyramid(depth2_mm), pyramid(depth1_mm), iters,
        dist_thresh=cfg.icp_dist_thresh, angle_thresh_deg=cfg.icp_angle_thresh_deg,
        T_init=torch.as_tensor(np.asarray(T_init, np.float32), device=device),
    )
    return T.cpu().numpy().astype(np.float64), float(count)


class PlaceRecognition:
    """Keyframe database and loop detection. The detector runs on
    `device` (None: the card)."""

    def __init__(self, cfg: KintinuousConfig, vocab: Optional[Vocabulary] = None,
                 device=None):
        self.cfg = cfg
        self.cam = cfg.camera
        self.device = resolve_device(device)
        if vocab is None and cfg.vocab_file and os.path.exists(cfg.vocab_file):
            # a pre-trained vocabulary (-v): trained on the port's
            # descriptors (features.train_vocab_from_klg)
            vocab = Vocabulary.load(cfg.vocab_file)
        self.vocab = vocab
        self.db: Optional[BowDatabase] = None
        # global kf id of db index 0: the db is built incrementally from
        # process start (base 0), but a db rebuilt from the keyframe ring
        # (checkpoint restore, _ensure_db) starts at the ring's base
        self._db_base = 0
        self.keyframes: List[Keyframe] = []
        self._next_kf_id = 0
        self.constraints: List[LoopConstraint] = []
        self._pending_desc: List[np.ndarray] = []
        self._last_loop_time_us = -int(1e18)
        self._recent_window = cfg.pr_recent_window
        # per-gate rejection counters
        self.gate_stats = {
            "keyframes": 0, "no_candidate": 0, "nss": 0, "throttle": 0,
            "ring": 0, "matches": 0, "inliers": 0, "icp": 0, "accepted": 0,
        }

    def _ensure_db(self):
        if self.db is None:
            if self.vocab is None:
                # bootstrap the vocabulary from early keyframes
                if len(self._pending_desc) < 5:
                    return False
                alld = np.concatenate(
                    [d for d in self._pending_desc if len(d)]
                    or [np.zeros((0, 32), np.uint8)]
                )
                if len(alld) < 64:
                    return False
                self.vocab = Vocabulary.train(alld, k=min(512, max(64, len(alld) // 4)))
            self.db = BowDatabase(self.vocab)
            for kf in self.keyframes:
                self.db.add(self.vocab.quantise(kf.descriptors))
            self._db_base = self._next_kf_id - len(self.keyframes)
        return True

    def detect(self, rgb: np.ndarray):
        """ORB keypoints and descriptors of an (H,W,3) uint8 RGB frame,
        detected on the device."""
        # a decoded log frame may be a read-only view: copied only then
        t = torch.from_numpy(np.require(rgb, np.uint8, ["C", "W"])).to(self.device)
        return detect_orb(rgb_to_gray(t))

    def add_keyframe(
        self,
        rgb: np.ndarray,  # (H,W,3) uint8
        depth_m: np.ndarray,
        pose: np.ndarray,
        timestamp_us: int,
    ) -> Optional[LoopConstraint]:
        """Add a PR keyframe; returns a verified LoopConstraint when a
        loop closure is detected and survives all gates."""
        kps, desc = self.detect(rgb)
        pts3d = backproject(self.cam, depth_m, kps) if len(kps) else np.zeros((0, 3))
        depth_mm = np.clip(depth_m * 1000.0, 0, 65535).astype(np.uint16)
        kf = Keyframe(
            kf_id=self._next_kf_id,
            timestamp_us=timestamp_us,
            pose=pose.copy(),
            keypoints=kps,
            descriptors=desc,
            points3d=pts3d,
            depth_z=zlib.compress(depth_mm.tobytes(), 1),
            depth_shape=depth_mm.shape,
        )
        self._next_kf_id += 1
        self.keyframes.append(kf)
        if len(self.keyframes) > PR_RING:  # ring semantics
            self.keyframes = self.keyframes[-PR_RING:]
        self._pending_desc.append(desc)

        self.gate_stats["keyframes"] += 1
        if not self._ensure_db():
            return None
        words = self.vocab.quantise(desc)
        # exclusion + candidate ids are GLOBAL kf ids shifted into the
        # db's index space by _db_base
        cand_id, score = self.db.query(
            words,
            exclude_after=self._next_kf_id - 1 - self._recent_window - self._db_base,
        )
        self.db.add(words)

        if cand_id < 0:
            self.gate_stats["no_candidate"] += 1
            return None
        cand_id += self._db_base
        # nss-style normalisation against the previous keyframe's score
        prev = self.keyframes[-2] if len(self.keyframes) >= 2 else None
        if prev is not None:
            s_prev = self.db.score(self.db.vectors[-1], self.db.vectors[-2])
            nss = score / max(s_prev, 1e-6)
        else:
            nss = 0.0
        if nss < self.cfg.pr_nss_alpha:
            self.gate_stats["nss"] += 1
            return None
        # loop throttle
        if timestamp_us - self._last_loop_time_us < self.cfg.loop_throttle_s * 1e6:
            self.gate_stats["throttle"] += 1
            return None
        base = self._next_kf_id - len(self.keyframes)
        if cand_id < base:  # candidate fell off the ring
            self.gate_stats["ring"] += 1
            return None
        constraint = self._verify(self.keyframes[cand_id - base], kf)
        if constraint is not None:
            self.gate_stats["accepted"] += 1
            self._last_loop_time_us = timestamp_us
            self.constraints.append(constraint)
        return constraint

    def _verify(self, kf1: Keyframe, kf2: Keyframe) -> Optional[LoopConstraint]:
        cfg = self.cfg
        pairs = match_ratio(kf1.descriptors, kf2.descriptors)
        if len(pairs) == 0:
            return None
        p1 = kf1.points3d[pairs[:, 0]]
        p2 = kf2.points3d[pairs[:, 1]]
        ok = np.isfinite(p1).all(axis=1) & np.isfinite(p2).all(axis=1)
        p1, p2 = p1[ok], p2[ok]
        if len(p1) < cfg.loop_min_matches:
            self.gate_stats["matches"] += 1
            return None
        # T maps frame-2 camera points into frame-1 camera frame
        T, inl = umeyama_ransac(p2, p1)
        if inl.sum() < 3 or inl.sum() / len(p1) < cfg.inlier_ratio:
            self.gate_stats["inliers"] += 1
            return None
        T_ref, score = verification_icp(self.cam, kf1.depth_m, kf2.depth_m, T)
        if score > cfg.loop_icp_score:
            self.gate_stats["icp"] += 1
            return None
        if LOOP_REFINE_ITERS:
            T_ref, _ = refine_loop(cfg, kf1.depth_mm, kf2.depth_mm, T_ref, self.device,
                                   LOOP_REFINE_ITERS)
        return LoopConstraint(
            time1=kf1.timestamp_us,
            time2=kf2.timestamp_us,
            T_1_2=T_ref,
            inliers1=p1[inl],
            inliers2=p2[inl],
            icp_score=score,
            kf_id1=kf1.kf_id,
            kf_id2=kf2.kf_id,
        )
