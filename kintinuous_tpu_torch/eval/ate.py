"""Absolute trajectory error (ATE RMSE), TUM-benchmark style (the port's
own numpy copy of kintinuous_tpu/eval/ate.py).

The reference emits TUM-format `.poses` files for external evaluation
(KintinuousTracker.cpp:199-218); this module brings the evaluator
in-repo: Horn/Umeyama SE(3) alignment of estimated vs. ground-truth
positions followed by RMSE, matching the semantics of the TUM
`evaluate_ate.py` tool (rigid alignment, no scale by default).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def associate(stamps_a: np.ndarray, stamps_b: np.ndarray, max_dt: float = 0.02):
    """Greedy nearest-timestamp association, one-to-one."""
    pairs = []
    used_b = set()
    for ia, ta in enumerate(stamps_a):
        ib = int(np.argmin(np.abs(stamps_b - ta)))
        if abs(stamps_b[ib] - ta) <= max_dt and ib not in used_b:
            pairs.append((ia, ib))
            used_b.add(ib)
    return pairs


def align_umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Find T (and scale) minimising ||dst - (s R src + t)||.

    src, dst: (N, 3). Returns (s, R, t).
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / var_s
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def absolute_trajectory_error(
    gt_stamps: np.ndarray,
    gt_poses: np.ndarray,
    est_stamps: np.ndarray,
    est_poses: np.ndarray,
    max_dt: float = 0.02,
    align: bool = True,
) -> Tuple[float, int]:
    """Returns (ATE RMSE in metres, number of associated pairs)."""
    pairs = associate(gt_stamps, est_stamps, max_dt)
    if not pairs:
        return float("inf"), 0
    gt_xyz = np.array([gt_poses[i][:3, 3] for i, _ in pairs])
    est_xyz = np.array([est_poses[j][:3, 3] for _, j in pairs])
    if align:
        s, R, t = align_umeyama(est_xyz, gt_xyz)
        est_xyz = (s * (R @ est_xyz.T)).T + t
    err = np.linalg.norm(gt_xyz - est_xyz, axis=1)
    return float(np.sqrt(np.mean(err ** 2))), len(pairs)


def ate_files(est_path: str, gt_path: str, max_dt: float = 0.02,
              align: bool = True) -> Tuple[float, int]:
    """(ATE RMSE in metres, associated pairs) between two trajectory
    files: TUM lines or the reference's comma-separated ground truth."""
    from kintinuous_tpu_torch.io.tum import load_trajectory

    gs, gp = load_trajectory(gt_path)
    es, ep = load_trajectory(est_path)
    return absolute_trajectory_error(gs, gp, es, ep, max_dt=max_dt, align=align)
