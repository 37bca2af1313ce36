"""The port's embedded deformation graph (backend/deformation.py,
torch on the CPU) against the JAX package's on the scenarios of
tests/test_deformation.py: node sampling, edges and bindings are numpy
copies (exact); where the constraints pin the graph, the optimised node
transforms agree within atol 1e-4, the applied vertices within 1e-4 m,
the constraint error within 1e-6 (plus 1e-3 relative). A graph pinned
only at its tail (shift_tail) leaves directions that 60 float32 CG steps
do not settle in either package: there the two agree within 2.5e-3
(measured: 1.7e-3 at the applied vertices, 7.3e-4 in the node
transforms)."""

import numpy as np
import pytest
import torch

from kintinuous_tpu.backend.deformation import DeformationGraph as JGraph
from kintinuous_tpu_torch.backend.deformation import DeformationGraph, deform

torch.set_num_threads(2)

PARAM_ATOL = 1e-4
VERTEX_ATOL = 1e-4
LOOSE_ATOL = 2.5e-3  # the graph pinned only at its tail


def make_pair(n_nodes=10, spacing=1.0, k=4):
    times = np.arange(n_nodes) * 1000
    pos = np.zeros((n_nodes, 3))
    pos[:, 0] = np.arange(n_nodes) * spacing
    pos[:, 1] = 0.2 * np.sin(np.arange(n_nodes))
    gs = (DeformationGraph(k=k, sample_dist=0.5, device="cpu"), JGraph(k=k, sample_dist=0.5))
    for g in gs:
        g.append_poses(times, pos)
    return gs, times, pos


def test_node_sampling_edges_and_binding_are_the_jax_ones():
    rng = np.random.default_rng(0)
    for k in (2, 4, 6):
        (p, j), times, pos = make_pair(14, 0.7, k)
        steps = rng.uniform(0, 0.6, (30, 3))
        more_t = 14000 + np.arange(30) * 500
        assert p.append_poses(more_t, pos[-1] + np.cumsum(steps, 0)) == \
            j.append_poses(more_t, pos[-1] + np.cumsum(steps, 0))
        np.testing.assert_array_equal(np.array(p.g), np.array(j.g))
        assert p.times == j.times
        for a, b in zip(p.edges(), j.edges()):
            np.testing.assert_array_equal(a, b)
        verts = rng.uniform(-1, 12, (200, 3))
        vt = rng.integers(0, 30000, 200)
        for window in (20, 5):
            bp, bj = p.bind(verts, vt, window), j.bind(verts, vt, window)
            np.testing.assert_array_equal(bp.ids, bj.ids)
            np.testing.assert_array_equal(bp.w, bj.w)


SCENARIOS = ["identity", "lift_end", "shift_tail", "many_constraints"]


def _constraints(name, times, pos, rng):
    if name == "identity":
        src = pos[:6] + np.array([0.1, 0.2, 0.0])
        return src, src.copy(), times[:6] + 1
    if name == "lift_end":
        src = np.concatenate([pos[:3], pos[9:]])
        dst = src.copy()
        dst[3:, 1] += 0.5
        return src, dst, np.concatenate([times[:3], times[9:]]) + 1
    if name == "shift_tail":
        src = pos[7:]
        return src, src + np.array([0.0, 0.3, 0.1]), times[7:] + 1
    src = pos[rng.integers(0, len(pos), 150)] + rng.normal(0, 0.3, (150, 3))
    vt = rng.integers(0, times[-1] + 1, 150)
    dst = src + np.c_[0.05 * src[:, 0], np.zeros(150), -0.03 * src[:, 0]]
    return src, dst, vt


@pytest.mark.parametrize("name", SCENARIOS)
def test_optimise_and_apply_match_jax(name):
    rng = np.random.default_rng(1)
    (p, j), times, pos = make_pair(12)
    src, dst, vt = _constraints(name, times, pos, rng)
    b = p.bind(src, vt)
    ep, ej = p.optimise(src, dst, b, iters=10), j.optimise(src, dst, b, iters=10)
    assert abs(ep - ej) <= 1e-6 + 1e-3 * abs(ej), (ep, ej)
    atol = LOOSE_ATOL if name == "shift_tail" else PARAM_ATOL
    np.testing.assert_allclose(p.A, j.A, atol=atol)
    np.testing.assert_allclose(p.t, j.t, atol=atol)
    verts = rng.uniform(-1, 12, (300, 3))
    bv = p.bind(verts, rng.integers(0, times[-1] + 1, 300))
    out = p.apply(verts, bv)
    assert out.dtype == np.float32 and out.shape == (300, 3)
    np.testing.assert_allclose(out, j.apply(verts, bv),
                               atol=LOOSE_ATOL if name == "shift_tail" else VERTEX_ATOL)
    if name == "identity":
        assert ep < 1e-6
        np.testing.assert_allclose(p.apply(src, b), src, atol=1e-3)
    if name == "lift_end":
        assert ep < 5e-3
        np.testing.assert_allclose(p.apply(src, b)[3:, 1], dst[3:, 1], atol=0.05)


def test_rotation_stays_near_orthonormal():
    (p, _), times, pos = make_pair(10)
    src = pos[7:]
    p.optimise(src, src + np.array([0.0, 0.3, 0.1]), p.bind(src, times[7:] + 1), iters=8)
    RtR = np.einsum("mji,mjk->mik", p.A, p.A)
    assert np.abs(RtR - np.eye(3)).max() < 0.15


def test_small_graphs_and_no_constraints():
    g = DeformationGraph(device="cpu")
    assert g.optimise(np.zeros((1, 3)), np.zeros((1, 3)), None) == 0.0
    (p, j), times, pos = make_pair(6)
    empty = p.bind(pos[:0], times[:0])
    assert p.optimise(pos[:0], pos[:0], empty, iters=2) == pytest.approx(
        j.optimise(pos[:0], pos[:0], empty, iters=2), abs=1e-9)
    np.testing.assert_allclose(p.A, np.tile(np.eye(3), (6, 1, 1)), atol=1e-6)


def test_deform_is_a_weighted_affine_blend():
    rng = np.random.default_rng(2)
    A = torch.from_numpy(rng.normal(0, 1, (5, 3, 3)).astype(np.float32))
    t = torch.from_numpy(rng.normal(0, 1, (5, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (5, 3)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (7, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 5, (7, 2)))
    w = torch.from_numpy(rng.uniform(0, 1, (7, 2)).astype(np.float32))
    out = deform(A, t, g, v, ids, w)
    ref = np.zeros((7, 3))
    for a in range(7):
        for k in range(2):
            m = ids[a, k]
            ref[a] += w[a, k].item() * ((A[m] @ (v[a] - g[m])).numpy() + g[m].numpy()
                                        + t[m].numpy())
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
