"""Port vs JAX, the slice end to end at an odd block count: R=72 is 9
blocks an edge, which the mirror refresh (K3, row-pairs) cannot take.
Both packages then keep no mirror and rebuild it from the volume in
every raycast (the JAX package's Tracker sets logical0 = None; the
port's state carries logical=None and its raycast runs K5's plain
version on the CPU)."""

import numpy as np
import pytest
import torch

from kintinuous_tpu.io.synth import orbit_trajectory, straight_trajectory
from kintinuous_tpu_torch.runtime import checkpoint as pck
from tests.test_fast_tracker import ate_of, fast_cfg, run
from tests.test_torch_tracker_gt import port_run

torch.set_num_threads(2)

R_ODD = 72


def odd_cfg(**kw):
    return fast_cfg(volume_resolution=R_ODD, **kw)


def test_tracked_orbit_at_an_odd_block_count_matches_the_pallas_tracker():
    """tests/test_torch_tracker_orbit.py's criteria at R=72: both under
    3 cm ATE, ICP holds, poses within 1e-3, the port's fallback no
    higher than the TPU kernel's; neither state has a mirror."""
    poses = orbit_trajectory(8, radius=0.12, angle_deg=6.0)
    a = run(odd_cfg(pallas=True), poses)
    b = port_run(odd_cfg(), poses, use_gt=False)
    assert a.state.logical is None and b.state.logical is None
    assert ate_of(a, poses) < 0.03
    assert ate_of(b, poses) < 0.03
    assert min(b.stats["icp_count"][3:]) > 500
    np.testing.assert_allclose(np.array(b.poses), np.array(a.poses), atol=1e-3)
    fb_a = np.mean(a.stats["raycast_fallback"])
    fb_b = np.mean(b.stats["raycast_fallback"])
    assert fb_b <= fb_a + 1e-3, (fb_b, fb_a)


@pytest.fixture(scope="module")
def walk():
    """1 m backwards along z: two shifts at R=72's 0.33 m threshold, and
    the far slabs that leave the volume cut the scene's objects."""
    return straight_trajectory(12, distance=-1.0, axis=2)


def test_gt_walk_at_an_odd_block_count_matches_the_pallas_tracker(walk):
    """tests/test_torch_tracker_gt.py's criteria at R=72: shifts on the
    same frames, poses within 2e-3, slices within 1 % and their points
    within a voxel."""
    a = run(odd_cfg(pallas=True), walk, use_gt=True)
    b = port_run(odd_cfg(), walk, use_gt=True)
    assert b.state.logical is None
    sa, sb = np.array(a.shift_log), np.array(b.shift_log)
    np.testing.assert_array_equal(sb, sa)
    assert (sa != 0).any(), "no shift fired"
    np.testing.assert_allclose(np.array(b.poses), np.array(a.poses), atol=2e-3)
    a.finalise()
    b.finalise()
    na = [(s.dimension, len(s.points)) for s in a.slices]
    nb = [(s.dimension, len(s.points)) for s in b.slices]
    assert [d for d, _ in na] == [d for d, _ in nb] and nb[-1][0] == "FINAL"
    for (_, x), (_, y) in zip(na, nb):
        assert abs(x - y) <= 0.01 * max(x, y)
    assert sum(n for _, n in nb) > 1000
    pa = np.concatenate([s.points for s in a.slices])
    pb = np.concatenate([s.points for s in b.slices])
    np.testing.assert_allclose(np.sort(pb, axis=0)[::50], np.sort(pa, axis=0)[::50],
                               atol=odd_cfg().voxel_size)


def test_checkpoint_round_trip_without_a_mirror(walk, tmp_path):
    """A port tracker at R=72 saved after six frames of the walk (a
    shift among them) and restored into a fresh one: the restore builds
    no mirror, and after the rest of the walk cw is bit-equal, the
    origin equal and the poses within 1e-5, as the even-count round trip
    of tests/test_torch_checkpoint.py. The state also crosses
    state_to_numpy / state_from_numpy with its mirror left out."""
    from kintinuous_tpu.io.synth import Scene, render_frame
    from kintinuous_tpu_torch.tracking.tracker import (
        Tracker, state_from_numpy, state_to_numpy)
    from tests.test_fast_tracker import CAM
    from tests.test_torch_package import port_cfg

    cfg = port_cfg(odd_cfg())
    frames = [render_frame(Scene.default(), CAM, T) for T in walk]

    def feed(tr, i0, i1):
        for i in range(i0, i1):
            delta = (np.linalg.inv(walk[i - 1]) @ walk[i] if i else np.eye(4))
            tr.process_frame(*frames[i], i * 33333, ext_delta=delta.astype(np.float32))
        tr.flush()
        return tr

    a = feed(Tracker(cfg, device="cpu"), 0, 8)
    assert (np.array(a.shift_log) != 0).any(), "no shift before the save"
    ck = str(tmp_path / "odd.npz")
    pck.save_checkpoint(ck, a)
    b = pck.load_checkpoint(ck, Tracker(cfg, device="cpu"))
    assert b.state.logical is None
    back = state_from_numpy(state_to_numpy(b.state), "cpu")
    assert back.logical is None and torch.equal(back.vol.cw, b.state.vol.cw)
    feed(a, 8, len(walk))
    feed(b, 8, len(walk))
    assert a.state.logical is None and b.state.logical is None
    np.testing.assert_allclose(np.array(b.poses), np.array(a.poses), atol=1e-5)
    assert torch.equal(b.state.vol.cw, a.state.vol.cw)
    assert torch.equal(b.state.vol.origin, a.state.vol.origin)
    assert np.array_equal(np.array(b.shift_log), np.array(a.shift_log))
