"""The port's synthetic workloads (kintinuous_tpu_torch/io/synth.py)
against the JAX package's: the same arguments and seed give the same
scenes, poses, depth and colour, bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import kintinuous_tpu.io.synth as J
import kintinuous_tpu_torch.io.synth as P
from kintinuous_tpu.config import CameraIntrinsics as JCam
from kintinuous_tpu_torch.config import CameraIntrinsics as PCam
from kintinuous_tpu_torch.io.klg import KlgLogReader

torch.set_num_threads(2)

CAM = dict(fx=40.0, fy=40.0, cx=24.0, cy=18.0, width=48, height=36)


def same_scene(a, b):
    np.testing.assert_array_equal(a.box_min, b.box_min)
    np.testing.assert_array_equal(a.box_max, b.box_max)
    assert len(a.spheres) == len(b.spheres) and len(a.cuboids) == len(b.cuboids)
    for s, t in zip(a.spheres, b.spheres):
        np.testing.assert_array_equal(s.center, t.center)
        assert s.radius == t.radius
    for s, t in zip(a.cuboids, b.cuboids):
        np.testing.assert_array_equal(s.bmin, t.bmin)
        np.testing.assert_array_equal(s.bmax, t.bmax)


SCENES = {
    "corridor": ("corridor_scene", (), {}),
    "corridor_narrow": ("corridor_scene", (4.5,), {"half_width": 1.2}),
    "lap": ("lap_scene", (), {}),
    "lap_gauntlet": ("lap_scene", (), {"length": 2.4, "depth": 1.8}),
    "desk": ("desk_scene", (), {}),
    "living_room": ("living_room_scene", (), {}),
}


@pytest.mark.parametrize("name", SCENES)
def test_scenes_match(name):
    fn, args, kw = SCENES[name]
    same_scene(getattr(P, fn)(*args, **kw), getattr(J, fn)(*args, **kw))


TRAJECTORIES = {
    "walk_loop": ("walk_loop_trajectory", (180, 3.0), dict(turn_frames=40, hold_frames=6,
                                                            warmup_frames=12)),
    "lap_bench_c": ("lap_trajectory", (), dict(length=3.2, depth=2.4, step=0.055,
                                               turn_frames=26, warmup_frames=10,
                                               revisit_frac=0.35)),
    "lap_arc": ("lap_trajectory", (), dict(length=3.2, depth=2.4, step=0.055,
                                           turn_frames=26, revisit_frac=0.6,
                                           arc_radius=0.45)),
    "lap_gauntlet": ("lap_trajectory", (), dict(length=2.4, depth=1.8, step=0.06,
                                                turn_frames=18, warmup_frames=8)),
    "handheld": ("handheld_trajectory", (), {}),
    "living_room": ("living_room_trajectory", (), {}),
}


@pytest.mark.parametrize("name", TRAJECTORIES)
def test_trajectories_match(name):
    fn, args, kw = TRAJECTORIES[name]
    a, b = getattr(P, fn)(*args, **kw), getattr(J, fn)(*args, **kw)
    assert len(a) == len(b)
    np.testing.assert_array_equal(np.array(a), np.array(b))


def test_bench_c_lap_has_419_frames():
    assert len(P.lap_trajectory(length=3.2, depth=2.4, step=0.055, turn_frames=26,
                                warmup_frames=10, revisit_frac=0.35)) == 419


def test_se3_helpers_match():
    rng = np.random.default_rng(0)
    for _ in range(20):
        w = rng.normal(0, 0.5, 3)
        np.testing.assert_array_equal(P._se3_exp_rot(w), J._se3_exp_rot(w))
        T = np.eye(4)
        T[:3, :3] = J._se3_exp_rot(w)
        T[:3, 3] = rng.normal(0, 1, 3)
        np.testing.assert_array_equal(P._se3_log(T), J._se3_log(T))
    np.testing.assert_array_equal(P._se3_exp_rot(np.zeros(3)), np.eye(3))


@pytest.mark.parametrize("case", ["rolling", "global"])
def test_render_frame_sensor_matches(case):
    poses = P.lap_trajectory(length=2.4, depth=1.8, step=0.06, turn_frames=18)
    scene_p, scene_j = P.lap_scene(2.4, 1.8), J.lap_scene(2.4, 1.8)
    T, T_next = poses[40], (poses[41] if case == "rolling" else None)
    dp, cp = P.render_frame_sensor(scene_p, PCam(**CAM), T, P.SensorModel(),
                                   np.random.default_rng(11), T_next)
    dj, cj = J.render_frame_sensor(scene_j, JCam(**CAM), T, J.SensorModel(),
                                   np.random.default_rng(11), T_next)
    np.testing.assert_array_equal(dp, dj)
    np.testing.assert_array_equal(cp, cj)
    assert (dp > 0).mean() > 0.5
    assert dataclasses.asdict(P.SensorModel()) == dataclasses.asdict(J.SensorModel())


@pytest.mark.parametrize("scene", ["lap", "desk", "living_room"])
def test_noisy_renders_match(scene):
    """render_frame with depth noise on each workload's scene and pose."""
    sp = {"lap": P.lap_scene(), "desk": P.desk_scene(),
          "living_room": P.living_room_scene()}[scene]
    sj = {"lap": J.lap_scene(), "desk": J.desk_scene(),
          "living_room": J.living_room_scene()}[scene]
    T = {"lap": P.lap_trajectory()[60], "desk": P.handheld_trajectory()[100],
         "living_room": P.living_room_trajectory()[200]}[scene]
    dp, cp = P.render_frame(sp, PCam(**CAM), T, 6.0, np.random.default_rng(7))
    dj, cj = J.render_frame(sj, JCam(**CAM), T, 6.0, np.random.default_rng(7))
    np.testing.assert_array_equal(dp, dj)
    np.testing.assert_array_equal(cp, cj)


def test_generate_klg_sensor_writes_the_jax_depth(tmp_path):
    """The same sensor log from both packages: depth bit for bit, the
    same ground truth, colour within JPEG's rounding."""
    poses = P.handheld_trajectory(n_frames=6)
    for mod, cam, name in ((P, PCam(**CAM), "p"), (J, JCam(**CAM), "j")):
        mod.generate_klg_sensor(str(tmp_path / f"{name}.klg"), cam, poses, mod.desk_scene(),
                                mod.SensorModel(), gt_path=str(tmp_path / f"{name}.gt"))
    with KlgLogReader(str(tmp_path / "p.klg"), 48, 36) as a, \
            KlgLogReader(str(tmp_path / "j.klg"), 48, 36) as b:
        fa, fb = list(a), list(b)
    assert len(fa) == len(fb) == 6
    for x, y in zip(fa, fb):
        assert x.timestamp == y.timestamp
        np.testing.assert_array_equal(x.depth, y.depth)
        assert x.rgb is not None and y.rgb is not None
        assert np.abs(x.rgb.astype(int) - y.rgb.astype(int)).mean() < 3.0
    assert (tmp_path / "p.gt").read_text() == (tmp_path / "j.gt").read_text()


def test_render_frames_in_a_process_pool_give_the_jax_log(tmp_path):
    """render_frames through a process pool's imap (as chip_smoke.py's
    phase 11 renders bench C's lap) gives the frames of the JAX
    package's generate_klg: depth bit for bit against its log, colour
    bit for bit against its render_frame, and the same frames as the
    port's serial render_frames."""
    import multiprocessing

    poses = P.lap_trajectory(length=3.2, depth=2.4, step=0.055, turn_frames=26,
                             warmup_frames=10, revisit_frac=0.35)[::60][:4]
    J.generate_klg(str(tmp_path / "j.klg"), JCam(**CAM), poses, scene=J.lap_scene(3.2, 2.4),
                   depth_noise_mm=6.0)
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        pooled = list(P.render_frames(PCam(**CAM), poses, P.lap_scene(3.2, 2.4), 6.0,
                                      lambda f, it: pool.imap(f, it)))
    serial = list(P.render_frames(PCam(**CAM), poses, P.lap_scene(3.2, 2.4), 6.0))
    with KlgLogReader(str(tmp_path / "j.klg"), 48, 36) as r:
        logged = list(r)
    assert len(pooled) == len(serial) == len(logged) == len(poses)
    for (d, c), (ds, cs), fr, T in zip(pooled, serial, logged, poses):
        np.testing.assert_array_equal(d, fr.depth)
        np.testing.assert_array_equal(d, ds)
        np.testing.assert_array_equal(c, cs)
        np.testing.assert_array_equal(c, J.render_frame(J.lap_scene(3.2, 2.4), JCam(**CAM), T)[1])
