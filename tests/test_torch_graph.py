"""The fast step on fixed buffers (tracking/tracker.CapturedStep, which a
card runs as CUDA graphs) against the eager one-piece make_step_fast,
on the CPU: bit for bit, with every buffer kept across shift frames,
output slots that outlive the next step, and captures dropped on a
restore. And the repairs that make the step capturable keep their bits.

The helpers here import no JAX: tests/test_torch_cuda.py runs them on
the card."""

import numpy as np
import pytest
import torch

from kintinuous_tpu_torch.config import CameraIntrinsics, tiny_test_config
from kintinuous_tpu_torch.geometry import se3
from kintinuous_tpu_torch.io.synth import (
    Scene, orbit_trajectory, render_frame, straight_trajectory)
from kintinuous_tpu_torch.tracking.graphs import addresses
from kintinuous_tpu_torch.tracking.tracker import (
    STEP_MODES, Tracker, initial_state, make_step_fast)

torch.set_num_threads(2)

CAM = CameraIntrinsics(fx=140.0, fy=140.0, cx=80.0, cy=60.0, width=160, height=120)
# config A at a tiny size; B adds the fused ICP+RGB-D odometry
CONFIGS = {
    "A": {},
    "B": dict(icp_plus_rgbd=True),
    "gather": dict(pallas=False),
    "odd": dict(volume_resolution=72),  # 9 blocks an edge: no mirror
    "static": dict(static_mode=True),
    "mesh_dc": dict(mesh=True, dynamic_cube=True),
}


def graph_cfg(cam=CAM, resolution=64, **kw):
    base = dict(camera=cam, volume_size=3.0, volume_resolution=resolution,
                fast_mode=True, voxel_shift=8, pyramid_levels=4,
                icp_iterations=(0, 10, 5, 0), bilateral_radius=2,
                extraction_capacity=100_000, band_cap=2048)
    base.update(kw)
    return tiny_test_config(**base)


def path_frames(path: str, cam=CAM, n: int = 6):
    """(frames, deltas): an orbit tracked by odometry (deltas None), or a
    ground-truth walk 0.9 m backwards that shifts the volume."""
    if path == "orbit":
        poses = orbit_trajectory(n, radius=0.06, angle_deg=3.0)
    else:
        poses = straight_trajectory(n, distance=-0.9, axis=2)
    frames = [render_frame(Scene.default(), cam, T) for T in poses]
    if path == "orbit":
        return frames, [None] * n
    deltas = [np.eye(4, dtype=np.float32)] + [
        (np.linalg.inv(a) @ b).astype(np.float32) for a, b in zip(poses, poses[1:])]
    return frames, deltas


def tracker_run(cfg, frames, deltas, device="cpu") -> Tracker:
    tr = Tracker(cfg, device=device)
    for i, ((d, c), delta) in enumerate(zip(frames, deltas)):
        tr.process_frame(d, c, i * 33333, ext_delta=delta)
    tr.flush()
    return tr


def eager_run(cfg, frames, deltas, device="cpu"):
    """make_step_fast frame by frame, called as Tracker.process_frame
    calls its step: (global poses, shifts, slice rows, final state)."""
    dev = torch.device(device)
    state = initial_state(cfg, dev)
    odom, ext = make_step_fast(cfg, True), make_step_fast(cfg, False)
    poses, shifts, rows = [], [], []
    for i, ((d, c), delta) in enumerate(zip(frames, deltas)):
        dt = torch.from_numpy(np.array(d)).to(dev)
        ct = torch.from_numpy(np.array(c, dtype=np.uint8)).to(dev)
        if delta is not None or i == 0:
            delta = np.eye(4, dtype=np.float32) if delta is None else delta
            state, out = ext(state, dt, ct, torch.from_numpy(delta).to(dev))
        else:
            state, out = odom(state, dt, ct, None)
        poses.append(out.pose_global.cpu().numpy())
        shifts.append(out.shift.cpu().numpy())
        for s in out.slices:
            if s is not None and int(s.count):  # the tracker keeps no empty slice
                rows.append(s.vals[:int(s.count)].cpu().numpy())
    return poses, shifts, rows, state


def bits(x: torch.Tensor) -> np.ndarray:
    """A tensor's bit pattern on the host (NaNs compare by their bits)."""
    x = x.detach().cpu().contiguous()
    if x.dtype in (torch.float32, torch.int32):
        return x.view(torch.int32).numpy()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy()
    return x.numpy()


def assert_same_run(tr: Tracker, eager) -> None:
    """The tracker's run equals the eager one bit for bit: poses, shifts,
    slices and every field of the final state."""
    poses, shifts, rows, state = eager
    assert np.array_equal(np.array(tr.poses).view(np.int32),
                          np.array(poses, np.float32).view(np.int32))
    assert np.array_equal(np.array(tr.shift_log), np.array(shifts))
    got = [np.concatenate([s.points, s.colors, s.weights[:, None]], axis=1)
           for s in tr.slices if s.dimension != "FINAL"]
    assert len(got) == len(rows)
    for g, r in zip(got, rows):
        assert np.array_equal(g[:, :3], r[:, :3])
        assert np.array_equal(g[:, 3:6], np.clip(r[:, 3:6], 0, 255).astype(np.uint8))
        assert np.array_equal(g[:, 6], r[:, 6])
    a = tr.state
    for name in ("pose", "pred_vmap", "pred_nmap", "pred_pose", "frame", "prev_delta"):
        assert np.array_equal(bits(getattr(a, name)), bits(getattr(state, name))), name
    for name in ("tsdf", "cw", "wrap", "origin"):
        assert np.array_equal(bits(getattr(a.vol, name)), bits(getattr(state.vol, name))), name
    assert (a.logical is None) == (state.logical is None)
    if a.logical is not None:
        assert np.array_equal(bits(a.logical), bits(state.logical))
    if a.rgbd is not None:
        for fa, fb in zip(a.rgbd, state.rgbd):
            for x, y in zip(fa, fb):
                assert np.array_equal(bits(x), bits(y))


@pytest.mark.parametrize("path", ["orbit", "walk"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_halves_on_fixed_buffers_equal_make_step_fast(config, path):
    """Config A, B, pallas=False, an odd block count, static mode, and
    meshing with the dynamic cube; the orbit tracks by odometry, the walk
    replays ground-truth deltas and shifts (not in static mode)."""
    cfg = graph_cfg(**CONFIGS[config])
    frames, deltas = path_frames(path)
    tr = tracker_run(cfg, frames, deltas)
    assert_same_run(tr, eager_run(cfg, frames, deltas))
    n = tr.step_counts()
    shifted = sum(1 for s in tr.shift_log if np.any(s))
    assert n["shift"] == shifted and n["eager"] == 0
    if path == "walk" and config != "static":
        assert shifted > 0, "the walk did not shift"
    assert sum(n.values()) == len(frames) and n["replayed"] > 0


def test_modes_of_an_orbit():
    """Frame 0 warms the external-delta front and the back, frame 1 the
    odometry front (the back is captured); frame 2 captures the
    odometry front; every later frame replays both."""
    cfg = graph_cfg()
    frames, deltas = path_frames("orbit")
    tr = tracker_run(cfg, frames, deltas)
    modes = [STEP_MODES[int(m)] for m in tr.stats["step_mode"]]
    assert modes == ["warmup", "warmup", "captured"] + ["replayed"] * 3
    assert set(tr._captured.pieces.captured) == {"back", "odometry"}


def test_buffers_keep_their_storage_across_a_shift_frame():
    cfg = graph_cfg()
    frames, deltas = path_frames("walk")
    tr = Tracker(cfg, device="cpu")
    step = tr._captured
    tr.process_frame(*frames[0], 0, ext_delta=deltas[0])
    before = addresses(step.buffers())
    n_shift = 0
    for i in range(1, len(frames)):
        tr.process_frame(*frames[i], i * 33333, ext_delta=deltas[i])
        tr.flush()
        n_shift += int(np.any(tr.shift_log[-1]))
        assert addresses(step.buffers()) == before
    assert n_shift > 0


def test_output_slots_outlive_the_next_step():
    """Frame k's scalars are read after frame k+1's step is issued: its
    slot holds frame k's values, which the eager step gives."""
    cfg = graph_cfg()
    frames, deltas = path_frames("orbit")
    poses = eager_run(cfg, frames, deltas)[0]
    tr = Tracker(cfg, device="cpu")
    step = tr._captured
    results = []
    for i, ((d, c), delta) in enumerate(zip(frames, deltas)):
        dt, ct = torch.from_numpy(np.array(d)), torch.from_numpy(np.array(c))
        results.append(step(dt, ct, torch.eye(4) if i == 0 else None, use_odometry=i > 0))
        if i:
            prev = results[-2].scalars
            assert prev.data_ptr() != results[-1].scalars.data_ptr()
            assert np.array_equal(prev[:16].numpy().reshape(4, 4), poses[i - 1])


def test_a_restore_drops_the_captures_and_moved_buffers_raise():
    cfg = graph_cfg()
    frames, deltas = path_frames("orbit", n=8)
    tr = Tracker(cfg, device="cpu")
    for i in range(4):
        tr.process_frame(*frames[i], i * 33333)
    step = tr._captured
    assert set(step.pieces.captured) == {"back", "odometry"}
    # a restore (runtime/checkpoint, state_from_numpy) sets the state
    tr.state = tr.state._replace(pose=tr.state.pose.clone())
    assert step.pieces.captured == ()
    tr.process_frame(*frames[4], 4 * 33333)
    tr.process_frame(*frames[5], 5 * 33333)
    tr.flush()
    assert [STEP_MODES[int(m)] for m in tr.stats["step_mode"][4:]] == [
        "captured", "replayed"]  # captured again, with no second warm-up
    # buffers replaced behind the tracker's back: the replay refuses them
    step._state = step.state._replace(pose=step.state.pose.clone())
    with pytest.raises(RuntimeError, match="moved"):
        tr.process_frame(*frames[6], 6 * 33333)


@pytest.mark.parametrize("batch", [(), (5,), (2, 3)], ids=["one", "five", "2x3"])
def test_make_T_keeps_the_jax_packages_bits(batch):
    """The bottom row is made on the device (no host copy, which a
    capture refuses); make_T equals the JAX package's bit for bit."""
    import jax.numpy as jnp

    from kintinuous_tpu.geometry import se3 as jse3

    rng = np.random.default_rng(5)
    R = rng.standard_normal(batch + (3, 3)).astype(np.float32)
    t = rng.standard_normal(batch + (3,)).astype(np.float32)
    want = np.asarray(jse3.make_T(jnp.asarray(R), jnp.asarray(t)))
    got = se3.make_T(torch.from_numpy(R), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_device_constants_keep_their_bits():
    """div_f32 divides by a f32 made on the device, as it divided by one
    copied from the host: numpy's f32 division, bit for bit."""
    from kintinuous_tpu_torch.ops.tsdf import div_f32

    x = np.random.default_rng(6).uniform(-500, 500, 4096).astype(np.float32)
    for d in (140.0, 0.1, 3.0 / 7.0):
        got = div_f32(torch.from_numpy(x), d).numpy()
        assert np.array_equal(got.view(np.int32), (x / np.float32(d)).view(np.int32))
