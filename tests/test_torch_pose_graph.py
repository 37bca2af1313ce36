"""The port's pose graph (backend/pose_graph.py, torch on the CPU)
against the JAX package's on the scenarios of tests/test_pose_graph.py:
the same graphs optimise to poses within atol 1e-4 (the JAX tests'
tolerance) and chi2 within 1e-3 relative (plus 1e-6); the delta-chi2 gate
makes the same decisions."""

import numpy as np
import pytest
import torch

from kintinuous_tpu.backend.pose_graph import PoseGraph as JPoseGraph
from kintinuous_tpu_torch.backend.pose_graph import PoseGraph, gn_core
from kintinuous_tpu_torch.geometry import se3

torch.set_num_threads(2)

POSE_ATOL = 1e-4


def exp(xi):
    return se3.exp_se3(torch.tensor(xi, dtype=torch.float32)).numpy().astype(np.float64)


def twist(rng, r, t):
    return np.concatenate([rng.normal(0, r, 3), rng.normal(0, t, 3)])


def chain(graphs, n, seed, drift, step=(0.02, 0.0, 0.03, 0.1, 0.0, 0.05)):
    rng = np.random.default_rng(seed)
    gt = [np.eye(4)]
    for k in range(n - 1):
        s = exp(step)
        gt.append(gt[-1] @ s)
        Z = s @ exp(twist(rng, drift, drift))
        for g in graphs:
            g.add_odometry(k, k + 1, Z)
    return gt


def both():
    return PoseGraph(device="cpu"), JPoseGraph()


def close(p, j, chi_p=None, chi_j=None):
    np.testing.assert_allclose(np.array(p.poses), np.array(j.poses), atol=POSE_ATOL)
    if chi_p is not None:
        assert abs(chi_p - chi_j) <= 1e-3 * abs(chi_j) + 1e-6, (chi_p, chi_j)


def test_chain_without_noise_is_exact():
    p, j = both()
    gt = chain((p, j), 20, 0, 0.0)
    cp, cj = p.optimise(iters=3), j.optimise(iters=3)
    assert cp < 1e-8
    close(p, j, cp, cj)
    for k in range(20):
        np.testing.assert_allclose(p.get_pose(k), gt[k], atol=POSE_ATOL)


def test_loop_closure_corrects_drift_like_jax():
    p, j = both()
    gt = chain((p, j), 40, 1, 0.004)
    for g in (p, j):
        g.optimise(iters=2)
        g.loop_weight = 1e5
        g.add_loop(0, 39, np.linalg.inv(gt[0]) @ gt[39])
    cp, cj = p.optimise(iters=10), j.optimise(iters=10)
    close(p, j, cp, cj)
    assert np.linalg.norm(p.get_pose(39)[:3, 3] - gt[39][:3, 3]) < 0.01
    assert p.n_loops == j.n_loops == 1


def test_bad_loop_raises_chi2_and_removal_restores():
    p, j = both()
    gt = chain((p, j), 25, 2, 0.0)
    bad = np.eye(4)
    bad[:3, 3] = [3.0, -2.0, 1.0]
    res = []
    for g in (p, j):
        clean = g.optimise(iters=5)
        fid = g.add_loop(0, 24, bad)
        chi_bad = g.optimise(iters=10)
        assert chi_bad > clean + 1e-3
        g.remove_factor(fid)
        res.append((chi_bad, g.optimise(iters=10)))
    assert abs(res[0][0] - res[1][0]) <= 1e-3 * res[1][0]
    assert res[0][1] < 1e-6
    close(p, j)
    for k in range(25):
        np.testing.assert_allclose(p.get_pose(k), gt[k], atol=1e-3)


@pytest.mark.parametrize("err_t,err_r,noise", [(0.0, 0.0, 0.002), (0.05, 5.0, 0.002),
                                               (1.0, 30.0, 0.002), (0.0, 0.0, 0.04),
                                               (1.0, 30.0, 0.04)],
                         ids=["good", "small", "gross", "good_noisy", "gross_noisy"])
def test_delta_chi2_gate_decides_like_jax(err_t, err_r, noise):
    """The 200-node corridor of test_isam_thresh_gate_calibrated_at_scale:
    the chi2 a loop adds, with the Huber kernel on the loop factor."""
    deltas = []
    for g in both():
        rng = np.random.default_rng(7)
        step = np.eye(4)
        step[0, 3] = 0.05
        gt = [np.eye(4)]
        g.add_node(0, np.eye(4))
        for i in range(1, 200):
            g.add_odometry(i - 1, i, step @ exp(twist(rng, 0.0005, noise)))
            gt.append(gt[-1] @ step)
        g.optimise(iters=5)
        before = g.chi2()
        pert = exp(np.r_[np.deg2rad(err_r) * np.array([0, 1.0, 0]), err_t * np.array([1.0, 0, 0])])
        g.add_loop(199, 0, np.linalg.inv(gt[199]) @ gt[0] @ pert)
        deltas.append(g.optimise(iters=10) - before)
    p_delta, j_delta = deltas
    assert abs(p_delta - j_delta) <= 1e-3 * abs(j_delta) + 1e-3, deltas
    assert (p_delta > 10.0) == (j_delta > 10.0)
    if noise < 0.01:  # the calibrated regime: only the gross loop fails the gate
        assert (p_delta > 10.0) == (err_t >= 1.0)


@pytest.mark.parametrize("huber", [0.0, 0.1])
def test_gn_core_matches_jax_with_and_without_huber(huber):
    """gn_core on a graph with two loops, one of them wrong by 0.5 m."""
    p, j = both()
    gt = chain((p, j), 60, 3, 0.003)
    wrong = np.linalg.inv(gt[10]) @ gt[50]
    wrong[:3, 3] += [0.5, 0.0, 0.0]
    for g in (p, j):
        g.huber_delta = huber
        g.add_loop(0, 59, np.linalg.inv(gt[0]) @ gt[59])
        g.add_loop(10, 50, wrong)
    cp, cj = p.optimise(iters=6), j.optimise(iters=6)
    close(p, j, cp, cj)
    assert p.chi2() == pytest.approx(j.chi2(), rel=1e-3, abs=1e-6)


def test_chi2_leaves_the_poses_and_gn_core_runs_on_the_input_device():
    p, _ = both()
    chain((p,), 10, 4, 0.01)
    before = [x.copy() for x in p.poses]
    p.chi2()
    assert all(np.array_equal(a, b) for a, b in zip(before, p.poses))
    poses, chi2 = p.solve(2)
    assert poses.device.type == "cpu" and poses.dtype == torch.float32
    assert chi2.dim() == 0
    assert PoseGraph(device="cpu").optimise() == 0.0 and PoseGraph(device="cpu").chi2() == 0.0
    # no graph at all: gn_core's shapes
    out, c = gn_core(poses[:1], torch.zeros(0, dtype=torch.int64),
                     torch.zeros(0, dtype=torch.int64), torch.zeros((0, 4, 4)),
                     torch.zeros(0), 1)
    assert out.shape == (1, 4, 4) and float(c) == 0.0


def test_the_graph_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PoseGraph()
    assert PoseGraph(device="cpu").device.type == "cpu"
