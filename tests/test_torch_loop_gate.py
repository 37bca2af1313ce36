"""The port's eval/loop_gate.tag_loop_log against the JAX package's on
crafted loop logs: the same tags, the same precision and recall
(numpy copies: exact)."""

import copy

import numpy as np
import pytest
import torch

from kintinuous_tpu.eval.loop_gate import tag_loop_log as jax_tag
from kintinuous_tpu_torch.eval.loop_gate import tag_loop_log

torch.set_num_threads(2)


def _traj(n=20, dt=1.0 / 30.0):
    stamps = np.arange(n) * dt
    poses = []
    for i in range(n):
        T = np.eye(4)
        T[0, 3] = 0.1 * i
        T[2, 3] = 0.02 * i
        T[:3, :3] = np.array([[np.cos(0.03 * i), 0, np.sin(0.03 * i)], [0, 1, 0],
                              [-np.sin(0.03 * i), 0, np.cos(0.03 * i)]])
        poses.append(T)
    return stamps, np.stack(poses)


def _entry(stamps, i, j, T, accepted):
    return {"kf_t1": int(stamps[i] * 1e6), "kf_t2": int(stamps[j] * 1e6),
            "T_1_2": T.tolist(), "accepted": accepted}


def _logs():
    stamps, poses = _traj()
    rng = np.random.default_rng(4)
    out = {}
    log = []
    for k in range(12):
        i, j = sorted(rng.choice(20, 2, replace=False))
        T = np.linalg.inv(poses[i]) @ poses[j]
        T[:3, 3] += rng.normal(0, [0.02, 0.5, 1.0][k % 3], 3)  # genuine or aliased
        log.append(_entry(stamps, i, j, T, bool(k % 2)))
    out["mixed"] = log
    T_gt = np.linalg.inv(poses[2]) @ poses[10]
    T_bad = T_gt.copy()
    T_bad[0, 3] += 2.0
    out["gate_misses"] = [_entry(stamps, 2, 10, T_gt, False),
                          _entry(stamps, 2, 10, T_bad, True)]
    out["outside_coverage"] = [
        {"kf_t1": int(9.0e6), "kf_t2": int(9.5e6), "T_1_2": np.eye(4).tolist(),
         "accepted": True},
        {"chi2_delta": 1.0, "accepted": True}]
    edge = []
    for d in (0.349, 0.351):  # either side of the 0.35 m genuine tolerance
        T = np.linalg.inv(poses[1]) @ poses[5]
        T[0, 3] += d
        edge.append(_entry(stamps, 1, 5, T, True))
    out["tolerance_edge"] = edge
    return stamps, poses, out


@pytest.mark.parametrize("case", ["mixed", "gate_misses", "outside_coverage",
                                  "tolerance_edge"])
def test_tags_and_scores_match_jax(case):
    stamps, poses, logs = _logs()
    a, b = copy.deepcopy(logs[case]), copy.deepcopy(logs[case])
    sa, sb = tag_loop_log(a, stamps, poses), jax_tag(b, stamps, poses)
    assert sa == sb
    assert a == b


def test_genuine_and_aliased_are_told_apart():
    stamps, poses = _traj()
    T_gt = np.linalg.inv(poses[3]) @ poses[15]
    T_good, T_bad = T_gt.copy(), T_gt.copy()
    T_good[2, 3] += 0.02
    T_bad[0, 3] += 1.5
    log = [_entry(stamps, 3, 15, T_good, True), _entry(stamps, 3, 15, T_bad, False)]
    stats = tag_loop_log(log, stamps, poses)
    assert log[0]["gt_error_m"] < 0.05 and log[1]["gt_error_m"] > 1.0
    assert stats["n_tagged"] == 2 and stats["n_genuine"] == 1
    assert stats["loop_gate_precision"] == 1.0 and stats["loop_gate_recall"] == 1.0
