"""The benchmark's frozen PyTorch renderer against the program's numpy
one (kintinuous_tpu_torch/io/synth.py), noise off, at 160x120."""

import numpy as np
import pytest

from slambench.scenes import render, trajectories
from kintinuous_tpu_torch.config import CameraIntrinsics
from kintinuous_tpu_torch.io import synth


@pytest.mark.parametrize("scene,kind,n", [("desk", "handheld", 142),
                                          ("living_room", "living_room", 882)])
def test_frozen_renderer_matches_io_synth(scene, kind, n):
    poses = trajectories.TRAJECTORIES[kind](n_frames=n)
    ref_poses = getattr(synth, f"{'handheld' if kind == 'handheld' else 'living_room'}"
                               "_trajectory")(n_frames=n)
    assert all(np.array_equal(a, b) for a, b in zip(poses, ref_poses))
    cam = render.Camera(132.0, 132.0, 80.0, 60.0, 160, 120)
    quiet = dict(axial_a=0.0, axial_b=0.0, lateral_px=0.0)
    idx = [0, 1, n // 2, n - 1]  # n - 1 has no successor: a global-shutter frame
    got_d, got_c = [], []
    for i in idx:
        d, c = render.render_frames(render.load_scene(scene, "cpu"), cam, poses[i:i + 2],
                                    render.SensorModel(**quiet), None, "cpu")
        got_d.append(d[0])
        got_c.append(c[0])
    ref_scene = getattr(synth, f"{scene}_scene")()
    model = synth.SensorModel(**quiet)
    for i, d, c in zip(idx, got_d, got_c):
        nxt = poses[i + 1] if i + 1 < n else None
        rd, rc = synth.render_frame_sensor(ref_scene, CameraIntrinsics(132.0, 132.0, 80.0, 60.0,
                                                                       160, 120),
                                           poses[i], model, np.random.default_rng(0), nxt)
        assert (rd == d).mean() >= 0.999, i
        assert np.abs(rd.astype(int) - d).max() <= 1 or (rd != d).mean() < 1e-3
        assert (rc == c).all(axis=-1).mean() >= 0.99, i  # checker edges at the ulp


def test_noise_follows_the_seed():
    poses = trajectories.handheld_trajectory(n_frames=142)[:3]
    cam = render.Camera(132.0, 132.0, 80.0, 60.0, 160, 120)
    scene = render.load_scene("desk", "cpu")
    a = render.render_frames(scene, cam, poses, render.SensorModel(), 2**31 + 7, "cpu")
    b = render.render_frames(scene, cam, poses, render.SensorModel(), 2**31 + 7, "cpu")
    c = render.render_frames(scene, cam, poses, render.SensorModel(), 2**31 + 8, "cpu")
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
