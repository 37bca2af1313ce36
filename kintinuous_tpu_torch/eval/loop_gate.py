"""Ground-truth classification of loop-closure candidates (the port's
numpy copy of kintinuous_tpu/eval/loop_gate.py).

The deformation runner's loop_log records, per candidate, the
PR-measured relative pose ``T_1_2`` (frame-2 camera in frame-1's frame,
backend/place_recognition.LoopConstraint) plus both keyframe
timestamps. When ground truth exists (synthetic benches; TUM sequences
with .gt files), each candidate can be tagged with its TRUE relative-
pose error, turning the delta-chi2 gate's accept/reject decisions into
a measurable precision/recall — the reference has no equivalent (its
iSAM residual gate, Deformation.cpp:256, is never scored against GT).

A candidate is *genuine* when the measured T_1_2 agrees with the GT
relative pose within ``genuine_tol_m`` translation — i.e. the match is
geometrically correct even if accepting it is separately judged by the
gate. Aliased matches (repetitive-structure false positives) show
metre-scale gt_error_m.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def _gt_pose_at(stamps_s: np.ndarray, poses: np.ndarray, t_s: float,
                max_dt: float = 0.02) -> Optional[np.ndarray]:
    i = int(np.argmin(np.abs(stamps_s - t_s)))
    if abs(float(stamps_s[i]) - t_s) > max_dt:
        return None
    return poses[i]


def tag_loop_log(
    loop_log: List[Dict],
    gt_stamps_s: np.ndarray,
    gt_poses: np.ndarray,
    genuine_tol_m: float = 0.35,
) -> Dict:
    """Tag each loop candidate with its true pose error; score the gate.

    Mutates each entry in ``loop_log`` (adds ``gt_error_m`` and
    ``gt_rot_err_deg`` when GT covers both keyframes) and returns
    summary stats::

        {"n_tagged", "n_genuine", "loop_gate_precision",
         "loop_gate_recall", "genuine_tol_m"}

    precision = accepted∧genuine / accepted (are accepted loops real?)
    recall    = accepted∧genuine / genuine  (are real loops kept?)

    ``genuine_tol_m`` defaults to 0.35 m: candidates come through
    RANSAC + verification ICP, so measurement error on a correct match
    is centimetres — while aliased matches in a repetitive scene are
    off by the structure period (metres). Anything between is genuinely
    ambiguous and counted by the stricter (non-genuine) side.
    """
    n_tag = n_gen = n_acc = n_acc_gen = 0
    for e in loop_log:
        if "kf_t1" not in e or "T_1_2" not in e:
            continue
        P1 = _gt_pose_at(gt_stamps_s, gt_poses, e["kf_t1"] / 1e6)
        P2 = _gt_pose_at(gt_stamps_s, gt_poses, e["kf_t2"] / 1e6)
        if P1 is None or P2 is None:
            continue
        T_gt = np.linalg.inv(P1) @ P2
        T_meas = np.asarray(e["T_1_2"], np.float64)
        E = np.linalg.inv(T_gt) @ T_meas
        err_t = float(np.linalg.norm(E[:3, 3]))
        cos = (np.trace(E[:3, :3]) - 1.0) / 2.0
        err_r = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
        e["gt_error_m"] = round(err_t, 4)
        e["gt_rot_err_deg"] = round(err_r, 2)
        genuine = err_t <= genuine_tol_m
        n_tag += 1
        n_gen += int(genuine)
        if e.get("accepted"):
            n_acc += 1
            n_acc_gen += int(genuine)
    return {
        "n_tagged": n_tag,
        "n_genuine": n_gen,
        "loop_gate_precision": round(n_acc_gen / n_acc, 4) if n_acc else None,
        "loop_gate_recall": round(n_acc_gen / n_gen, 4) if n_gen else None,
        "genuine_tol_m": genuine_tol_m,
    }
