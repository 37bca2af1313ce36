"""The batched fast step: the port's process_frames against its own
per-frame loop (the scenarios of tests/test_fast_tracker.py) and
against the JAX package's process_frames."""

import numpy as np
import pytest
import torch

from kintinuous_tpu.io.synth import Scene, orbit_trajectory, render_frame, straight_trajectory
from kintinuous_tpu.tracking.tracker import Tracker as JTracker
from kintinuous_tpu_torch.tracking.tracker import Tracker as PTracker
from tests.test_fast_tracker import CAM, fast_cfg
from tests.test_torch_package import port_cfg

torch.set_num_threads(2)


def items_of(poses, cam=CAM):
    return [(d, c, int(i * 1e6 / 30)) for i, (d, c)
            in enumerate(render_frame(Scene.default(), cam, T) for T in poses)]


def per_frame(cfg, items):
    tr = PTracker(port_cfg(cfg), device="cpu")
    for it in items:
        tr.process_frame(*it)
    tr.flush()
    return tr


def test_batched_matches_the_per_frame_loop():
    """test_fast_tracker.py:89-107: the batch is the per-frame step in a
    loop, so the last pose agrees to 1e-5."""
    cfg = fast_cfg(static_mode=True)
    items = items_of(orbit_trajectory(9, radius=0.1, angle_deg=5.0))
    a = per_frame(cfg, items)
    b = PTracker(port_cfg(cfg), device="cpu")
    b.process_frames(items)
    assert len(b.poses) == len(a.poses) == 9
    np.testing.assert_allclose(b.poses[-1], a.poses[-1], atol=1e-5)
    np.testing.assert_allclose(b.state.pose.numpy(), a.state.pose.numpy(), atol=1e-5)


def test_batched_multi_shift_slices_match_per_frame():
    """test_fast_tracker.py:166-195: one batch spanning several shifts
    emits the same slices as the per-frame loop, in the same order, with
    the same timestamps and point counts; nothing is dropped."""
    cfg = fast_cfg()
    items = items_of(straight_trajectory(24, distance=1.2, axis=0))
    pf = per_frame(cfg, items)
    assert sum(1 for s in pf.shift_log if s[0] > 0) >= 3
    bt = PTracker(port_cfg(cfg), device="cpu")
    bt.process_frames(items)  # one 23-frame batch after frame 0
    assert "batch_slices_dropped" not in bt.stats
    assert [s.dimension for s in bt.slices] == [s.dimension for s in pf.slices]
    assert [s.timestamp_us for s in bt.slices] == [s.timestamp_us for s in pf.slices]
    assert [s.frame_index for s in bt.slices] == [s.frame_index for s in pf.slices]
    assert sum(len(s.points) for s in pf.slices) > 0
    for a, b in zip(pf.slices, bt.slices):
        assert len(a.points) == len(b.points)
        np.testing.assert_array_equal(a.points, b.points)


def test_tail_after_a_lagged_batch_keeps_frame_order():
    """test_fast_tracker.py:198-225: per-frame calls issued while the
    batch's last frame is still lagged append their poses after it."""
    cfg = fast_cfg(static_mode=True)
    items = items_of(orbit_trajectory(12, radius=0.1, angle_deg=5.0))
    tr = PTracker(port_cfg(cfg), device="cpu")
    tr.process_frame(*items[0])
    tr.flush()
    tr.process_batch_device(*tr.upload_batch(items[1:9]))  # last frame lagged
    assert len(tr._pending) == 1 and len(tr.poses) == 8
    for it in items[9:]:
        tr.process_frame(*it)
    tr.flush()
    assert tr.stamps_us == [it[2] for it in items], "frame order broken"
    pf = per_frame(cfg, items)
    np.testing.assert_allclose(tr.poses[-1], pf.poses[-1], atol=1e-5)


@pytest.mark.parametrize("pool", [None, 3000], ids=["default_pool", "tiny_pool"])
def test_batched_matches_jax_process_frames(pool):
    """A walk backwards along the optical axis, whose shift slices hold
    points, through both packages' process_frames (ICP on every frame).
    Poses within 1e-3, the tolerance the port's per-frame tracked orbit
    holds against the JAX tracker (the two ICPs sum in another order),
    and slice sizes within 1 %. The port keeps every slice: with the
    default pool the JAX package drops none either and the two lists
    match; with a pool of 3000 points it drops some, and the port's list
    is the JAX package's kept slices plus the dropped ones."""
    kw = {} if pool is None else {"batch_slice_pool": pool}
    cfg = fast_cfg(pallas=True, **kw)
    items = items_of(straight_trajectory(12, distance=-0.75, axis=2))
    a = JTracker(cfg)
    a.process_frames(items)
    b = PTracker(port_cfg(cfg), device="cpu")
    b.process_frames(items)
    np.testing.assert_array_equal(np.array(b.shift_log), np.array(a.shift_log))
    assert (np.array(a.shift_log) != 0).any()
    np.testing.assert_allclose(np.array(b.poses), np.array(a.poses), atol=1e-3)
    assert "batch_slices_dropped" not in b.stats
    dropped = sum(a.stats.get("batch_slices_dropped", []))
    assert (dropped > 0) == (pool is not None)
    na = [(s.dimension, s.frame_index, len(s.points)) for s in a.slices]
    nb = [(s.dimension, s.frame_index, len(s.points)) for s in b.slices]
    assert na and len(nb) == len(na) + dropped
    kept = iter(nb)  # the JAX package's slices, in order, among the port's
    for dim, fidx, x in na:
        y = next(y for d, f, y in kept if (d, f) == (dim, fidx))
        assert abs(x - y) <= 0.01 * max(x, y)
