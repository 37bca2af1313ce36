"""A whole run at a tiny size on the CPU (the program's and the
reference's plain versions): the result line's keys, and `correct`
coming out false when the timed path is broken underneath."""

import numpy as np
import pytest
import torch

import tiny
from slambench import run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(tmp_path, loop="offline", trace=False, seconds=3.0, seed=2**31 + 11):
    bench, base = tiny.make(tmp_path, loop)
    return run.run_cell(f"tiny.{loop}", seed, seconds, trace, device="cpu", bench=bench,
                        base=base)


@pytest.mark.parametrize("loop,trace", [("offline", False), ("offline", True), ("live", False)])
def test_result_line(tmp_path, loop, trace):
    out = _run(tmp_path, loop, trace)
    keys = list(out)
    assert keys[:5] == KEYS and keys[-1] == "compared"
    assert ("breakdown" in out) == trace
    assert out["correct"] is True, out["compared"]
    for name, c in out["compared"].items():
        assert c["value"] is not None and c["value"] <= c["limit"], name
    m = out["metrics"]
    if trace:
        assert "tracker.eager_pct" in m and "fps" not in m
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in out["device"] and "window_s" in out["device"]
    elif loop == "offline":
        assert set(m) == {"fps", "setup_s"} and m["fps"]["value"] > 0
    else:
        assert set(m) >= {"tracked_pct", "setup_s"}
        assert 0 < m["tracked_pct"]["value"] <= 100
    assert out["attempted"] > 0 and 0 <= out["failed"] <= out["attempted"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "icp.desk.offline", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def _unfused(monkeypatch):
    """A step that returns the volume unchanged: the fusion does nothing."""
    from kintinuous_tpu_torch.tracking import tracker

    monkeypatch.setattr(tracker, "integrate_cuda", lambda vol, *a, **k: vol)
    return ("tsdf", "weight")


def _pose_altered(monkeypatch):
    """An answer altered where it is produced: each frame's pose 5 mm off."""
    from kintinuous_tpu_torch.tracking import tracker

    orig = tracker.pack_scalars

    def pack(out):
        v = orig(out).clone()
        v[3] += 0.005  # pose_global[0, 3]
        return v

    monkeypatch.setattr(tracker, "pack_scalars", pack)
    return ("pose_m",)


def _half_batch(monkeypatch):
    """Half of each batch left out: the odd frames of a batch are skipped."""
    from kintinuous_tpu_torch.tracking.tracker import Tracker

    orig = Tracker.process_batch_device

    def half(self, depths, rgbs, ts_list):
        return orig(self, depths[::2], rgbs[::2], list(ts_list)[::2])

    monkeypatch.setattr(Tracker, "process_batch_device", half)
    return ("pose_m",)


@pytest.mark.parametrize("fault", [_unfused, _pose_altered, _half_batch])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    names = fault(monkeypatch)
    out = _run(tmp_path, "offline", seconds=3.0)
    assert out["correct"] is False
    c = out["compared"]
    assert any(not (c[n]["value"] <= c[n]["limit"]) for n in names), c


def test_slice_gap_is_symmetric_and_exact_at_zero():
    from slambench.compare import slice_gap

    a = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32)
    assert slice_gap(a, a.copy()) == 0.0
    b = a + np.float32(1e-3)
    assert slice_gap(a, b) == pytest.approx(slice_gap(b, a))
    assert slice_gap(a, a[:0]) == float("inf")


def test_shift_watch_keeps_the_states_around_a_shift_with_points():
    """The shift sample's watch flags the frames before a crossing of the
    shift threshold from poses alone, keeps a candidate's two states
    until its shift is in the log, and takes the first that shifted with
    a slice that holds points."""
    from types import SimpleNamespace

    from slambench.session import ShiftWatch

    cfg = SimpleNamespace(voxel_shift=16, voxel_size=6.0 / 512, volume_size=6.0,
                          dynamic_cube=False)
    thresh = 16 * 6.0 / 512
    w = ShiftWatch(cfg, 0.015, start=5)
    step = 0.007  # m a frame along +x
    poses = []
    for i in range(80):
        p = np.zeros((3, 4))
        p[:, :3] = np.eye(3)
        p[0, 3] = 3.0 + i * step
        poses.append(p)
    # the program's decisions: frame i shifts +16 on x where the camera is
    # the threshold or more from the centre, the centre moving with it
    log, moved = [], 0.0
    for i in range(80):
        s = 16 if poses[i][0, 3] - 3.0 - moved >= thresh else 0
        moved += s * cfg.voxel_size
        log.append(np.array([s, 0, 0]))
    shifts = [i for i, v in enumerate(log) if v[0]]
    assert len(shifts) >= 2
    flagged = [m for m in range(8, 80) if w.may_shift(poses, log, m - 2, m)]
    for m in shifts:
        assert m in flagged, (m, flagged)
    assert len(flagged) <= 4 * len(shifts)  # a few frames around each crossing
    # the first shift's slice is empty, the second's holds points
    slices = [SimpleNamespace(frame_index=shifts[0], dimension="POS_X", points=np.zeros((0, 3))),
              SimpleNamespace(frame_index=shifts[1], dimension="POS_X", points=np.ones((5, 3)))]
    for m in shifts[:2]:
        w.candidates.append(m)
        w.saved[m - 1], w.saved[m] = {"s": m - 1}, {"s": m}
    w.note_slices(slices)
    assert w.found(log[:shifts[0] + 1]) is None
    assert w.unneeded(shifts[0] + 1) == [shifts[0] - 1, shifts[0]]
    for i in (shifts[0] - 1, shifts[0]):
        w.saved.pop(i)
    assert w.found(log[:shifts[1] + 1]) == shifts[1]
