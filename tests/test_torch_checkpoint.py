"""Port vs JAX: the full mirror rebuild (K5) and checkpoint resume.

On the CPU `build_mirror` runs its plain version, which must be bit-equal
to the TPU kernel (`build_logical_bf16` in interpret mode). The
checkpoint file is the JAX package's: either package reads what the
other wrote, and the restore rebuilds the mirror with K5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kintinuous_tpu.config import CameraIntrinsics, tiny_test_config
from kintinuous_tpu.io.synth import Scene, render_frame, straight_trajectory
from kintinuous_tpu.ops.blocked import make_blocked_volume as jmake
from kintinuous_tpu.ops.pallas_raycast import build_logical_bf16
from kintinuous_tpu.runtime import checkpoint as jck
from kintinuous_tpu.tracking.tracker import Tracker as JTracker
from kintinuous_tpu_torch.ops.cuda_raycast import build_mirror
from kintinuous_tpu_torch.runtime import checkpoint as pck
from kintinuous_tpu_torch.tracking.tracker import Tracker as PTracker
from tests.test_torch_package import port_cfg

torch.set_num_threads(2)

CAM = CameraIntrinsics(fx=70.0, fy=70.0, cx=40.0, cy=30.0, width=80, height=60)


def walk_cfg(**kw):
    return tiny_test_config(camera=CAM, fast_mode=True, voxel_shift=8,
                            volume_resolution=64, band_cap=512, **kw)


@pytest.fixture(scope="module")
def walk():
    """A 10-frame walk along x: two shifts (0.375 m threshold)."""
    poses = straight_trajectory(10, distance=0.9, axis=0)
    return poses, [render_frame(Scene.default(), CAM, T) for T in poses]


def feed(tracker, poses, frames, i0, i1, gt):
    for i in range(i0, i1):
        delta = None
        if gt:
            delta = (np.linalg.inv(poses[i - 1]) @ poses[i] if i else np.eye(4))
            delta = delta.astype(np.float32)
        tracker.process_frame(frames[i][0], frames[i][1], i * 33333, ext_delta=delta)
    tracker.flush()
    return tracker


def bits(m):
    return m.view(torch.int16).numpy() if isinstance(m, torch.Tensor) \
        else np.asarray(m).view(np.int16)


@pytest.mark.parametrize("R", [64, 128, 72], ids=["R64", "R128", "R72_odd_blocks"])
def test_mirror_rebuild_is_bit_equal_to_the_tpu_kernel(R):
    """Random tsdf with planted -0.0 and +0.0: every value is bf16_rn(v)
    and a zero is +0.0, as the TPU kernel's exact one-hot products and
    its f32 accumulation from +0 give. R=72 has an odd block count (9),
    which K3 cannot take and K5 must."""
    B = R // 8
    t = np.random.default_rng(R).standard_normal((B ** 3, 4, 128)).astype(np.float32)
    t[::3, 1, :7] = -0.0
    t[1::7, 0, :5] = 0.0
    want = build_logical_bf16(jmake(R)._replace(tsdf=jnp.asarray(t)), R, interpret=True)
    got = build_mirror(torch.from_numpy(t), R)
    assert got.dtype == torch.bfloat16 and got.shape == (R, R, R)
    assert np.array_equal(bits(got), bits(want))
    assert not (bits(got) == np.int16(-32768)).any()  # no -0.0 written
    out = torch.full((R, R, R), 7.0, dtype=torch.bfloat16)
    assert build_mirror(torch.from_numpy(t), R, out=out) is out
    assert np.array_equal(bits(out), bits(want))


def test_rebuild_equals_the_mirror_that_integration_kept(walk):
    """After integrated frames (two of them shift frames) the mirror that
    K3 refreshed frame by frame equals a full rebuild of the volume."""
    poses, frames = walk
    tr = feed(PTracker(port_cfg(walk_cfg()), device="cpu"), poses, frames, 0, 6, gt=True)
    assert (np.array(tr.shift_log) != 0).any()
    st = tr.state
    assert int((st.logical != 0).sum()) > 1000
    assert np.array_equal(bits(build_mirror(st.vol.tsdf, 64)), bits(st.logical))


def test_port_round_trip_on_a_shifting_walk_is_exact(walk, tmp_path):
    """tests/test_engine.py's fast shifting round trip, through the port
    (ICP tracking): the restored mirror is bit-equal to the live one at
    the moment of saving, and after four more frames cw is bit-equal, the
    origin equal and the poses within 1e-5 (the same operations on the
    same state: only the restore could make them differ)."""
    poses, frames = walk
    cfg = port_cfg(walk_cfg())
    a = feed(PTracker(cfg, device="cpu"), poses, frames, 0, 6, gt=False)
    assert (np.array(a.shift_log) != 0).any(), "no shift: lengthen the walk"
    ck = str(tmp_path / "ck.npz")
    pck.save_checkpoint(ck, a)
    live_mirror = a.state.logical.clone()
    feed(a, poses, frames, 6, 10, gt=False)
    b = pck.load_checkpoint(ck, PTracker(cfg, device="cpu"))
    assert np.array_equal(bits(b.state.logical), bits(live_mirror))
    assert len(b.slices) == len([s for s in a.slices if s.frame_index < 6])
    feed(b, poses, frames, 6, 10, gt=False)
    np.testing.assert_allclose(np.array(b.poses), np.array(a.poses), atol=1e-5)
    assert torch.equal(b.state.vol.cw, a.state.vol.cw)
    assert torch.equal(b.state.vol.origin, a.state.vol.origin)
    assert np.array_equal(np.array(b.shift_log), np.array(a.shift_log))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_between_the_packages(walk, tmp_path, direction):
    """One package replays five ground-truth frames and saves; the other
    loads the file (the port rebuilds its mirror with K5) and both
    continue the same five frames. shift_log equal, poses within 2e-3,
    the tolerance the port's ground-truth walks already hold against the
    JAX package (its TPU fusion kernel splits rays into bf16 limbs)."""
    poses, frames = walk
    jcfg = walk_cfg(pallas=True)  # a JAX tracker on the CPU keeps a mirror only so
    ck = str(tmp_path / "x.npz")
    if direction == "jax_to_port":
        src = feed(JTracker(jcfg), poses, frames, 0, 5, gt=True)
        jck.save_checkpoint(ck, src)
        dst = pck.load_checkpoint(ck, PTracker(port_cfg(jcfg), device="cpu"))
        assert np.array_equal(bits(dst.state.logical), bits(src.state.logical))
        assert np.array_equal(dst.state.vol.cw.numpy().view(np.uint32),
                              np.asarray(src.state.vol.cw))
    else:
        src = feed(PTracker(port_cfg(jcfg), device="cpu"), poses, frames, 0, 5, gt=True)
        pck.save_checkpoint(ck, src)
        dst = jck.load_checkpoint(ck, JTracker(jcfg))
        assert np.array_equal(bits(dst.state.logical), bits(src.state.logical))
        assert np.array_equal(np.asarray(dst.state.vol.cw),
                              src.state.vol.cw.numpy().view(np.uint32))
    assert dst._frame_idx == 5 and len(dst.poses) == 5
    feed(src, poses, frames, 5, 10, gt=True)
    feed(dst, poses, frames, 5, 10, gt=True)
    sa, sb = np.array(src.shift_log), np.array(dst.shift_log)
    np.testing.assert_array_equal(sb, sa)
    assert (sa != 0).any()
    np.testing.assert_allclose(np.array(dst.poses), np.array(src.poses), atol=2e-3)
