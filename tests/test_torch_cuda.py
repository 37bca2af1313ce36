"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without an NVIDIA card. This file imports
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from kintinuous_tpu_torch.config import CameraIntrinsics, tiny_test_config
from kintinuous_tpu_torch.io.synth import Scene, orbit_trajectory, render_frame
from kintinuous_tpu_torch.ops.blocked import blocked_to_dense
from kintinuous_tpu_torch.ops.cuda_integrate import (
    band_fusion, band_fusion_plain, dirty_pairs, free_carve, free_carve_plain,
    integrate_plan)
from kintinuous_tpu_torch.ops.cuda_raycast import (
    build_mirror, build_mirror_plain, mirror_refresh, mirror_refresh_plain, ray_setup,
    raycast_params, tile_raycast, tile_raycast_plain)
from kintinuous_tpu_torch.tracking.tracker import Tracker, preprocess_frame

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

CAM = CameraIntrinsics(fx=280.0, fy=280.0, cx=160.0, cy=120.0, width=320, height=240)


def cfg_small():
    return tiny_test_config(camera=CAM, volume_size=6.0, volume_resolution=256,
                            fast_mode=True, voxel_shift=8, pyramid_levels=4,
                            icp_iterations=(0, 10, 5, 0), bilateral_radius=2,
                            extraction_capacity=200_000, band_cap=4096)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def frame_on_card(card):
    """A tracker state after three ground-truth frames of the bare room,
    and the kernels' inputs for the fourth."""
    cfg = cfg_small()
    poses = orbit_trajectory(4, radius=0.06, angle_deg=3.0)
    frames = [render_frame(Scene(), CAM, T) for T in poses]
    tr = Tracker(cfg, device=card)
    last = None
    for i, T in enumerate(poses[:3]):
        delta = np.eye(4, dtype=np.float32) if last is None else \
            (np.linalg.inv(last) @ T).astype(np.float32)
        tr.process_frame(*frames[i], i * 33333, ext_delta=delta)
        last = T
    tr.flush()
    st = tr.state
    T = st.pose @ torch.from_numpy((np.linalg.inv(last) @ poses[3]).astype(np.float32)).to(card)
    d, c = (torch.from_numpy(np.asarray(x)).to(card) for x in frames[3])
    depth_m, rgb, depth_half, color_w = preprocess_frame(cfg, d, c)
    tables, lists, params = integrate_plan(st.vol, CAM, depth_m, rgb, color_w, T,
                                           cfg.voxel_size, cfg.trunc_dist, cfg.band_cap)
    return cfg, st, T, depth_half, tables, lists, params


@pytest.mark.parametrize("case", ["frame", "count0", "every_block"])
def test_band_fusion_matches_its_plain_version(frame_on_card, case):
    """Same formula, same order of operations, no contraction (-fmad=
    false): weights equal, tsdf within 1e-5, colour within one step. On
    the frame's list; with a count of 0, which leaves the volume
    bit-equal; and with every block of the volume listed, which walks
    the kernel's persistent grid many times over."""
    cfg, st, _, _, tables, lists, params = frame_on_card
    assert int(lists.n_band) > 0
    ids, n = lists.band_ids, lists.n_band
    if case == "count0":
        n = torch.zeros_like(n)
    elif case == "every_block":
        ids = torch.arange(st.vol.tsdf.shape[0], dtype=torch.int32, device=n.device)
        n = torch.full_like(n, ids.numel())
    out = []
    for fn in (band_fusion, band_fusion_plain):
        t, c = st.vol.tsdf.clone(), st.vol.cw.clone()
        fn(t, c, tables.img_rows, ids, n, params, CAM, cfg.voxel_size,
           cfg.trunc_dist, float(cfg.max_weight))
        out.append((t, c))
    torch.cuda.synchronize()
    (tk, ck), (tp, cp) = out
    if case == "count0":
        assert torch.equal(tk.view(torch.int32), st.vol.tsdf.view(torch.int32))
        assert torch.equal(ck, st.vol.cw)
    assert torch.equal((ck >> 24) & 0xFF, (cp >> 24) & 0xFF)
    assert float((tk - tp).abs().max()) <= 1e-5
    for s in (0, 8, 16):
        assert int((((ck >> s) & 0xFF) - ((cp >> s) & 0xFF)).abs().max()) <= 1


@pytest.mark.parametrize("case", ["frame", "count0", "count1", "odd", "full_cap"])
def test_free_carve_is_bit_exact(frame_on_card, case):
    """The frame's list; counts 0 (the volume bit-equal) and 1 of it; an
    odd count (301) of distinct blocks in a random order; and every slot
    of the 12,288-slot cap filled with distinct blocks, which walks the
    persistent grid many times over."""
    cfg, st, _, _, _, lists, _ = frame_on_card
    assert int(lists.n_free) > 0
    ids, n = lists.free_ids, lists.n_free
    if case in ("count0", "count1"):
        n = torch.full_like(n, int(case[-1]))
    elif case in ("odd", "full_cap"):
        order = np.random.RandomState(4).permutation(st.vol.tsdf.shape[0])
        ids = torch.from_numpy(order[:ids.numel()].astype(np.int32)).to(ids.device)
        n = torch.full_like(n, 301 if case == "odd" else ids.numel())
    out = []
    for fn in (free_carve, free_carve_plain):
        t, c = st.vol.tsdf.clone(), st.vol.cw.clone()
        fn(t, c, ids, n, float(cfg.max_weight))
        out.append((t, c))
    torch.cuda.synchronize()
    (tk, ck), (tp, cp) = out
    assert torch.equal(tk.view(torch.int32), tp.view(torch.int32)) and torch.equal(ck, cp)
    if case == "count0":
        assert torch.equal(tk.view(torch.int32), st.vol.tsdf.view(torch.int32))
        assert torch.equal(ck, st.vol.cw)


def test_free_carve_refuses_a_volume_off_16_byte_words(frame_on_card):
    cfg, st, _, _, _, lists, _ = frame_on_card
    shifted = torch.empty(st.vol.tsdf.numel() + 1, device=st.vol.tsdf.device)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        free_carve(shifted.view(st.vol.tsdf.shape), st.vol.cw, lists.free_ids,
                   lists.n_free, float(cfg.max_weight))


@pytest.mark.parametrize("case", ["partial", "dirty_all", "count0", "count1", "odd"])
def test_mirror_refresh_is_bit_exact(frame_on_card, case):
    """The frame's dirty pairs; every pair (the grid-stride loop walks
    the persistent grid many times); counts 0 and 1 of every pair; and
    an odd count (301) of the pairs in a random order."""
    cfg, st, _, _, _, lists, _ = frame_on_card
    R = cfg.volume_resolution
    B = R // 8
    gen = torch.Generator(device=st.vol.tsdf.device).manual_seed(1)
    garbage = torch.randn((R, R, R), generator=gen, device=st.vol.tsdf.device)
    garbage = garbage.to(torch.bfloat16)
    pairs, count = dirty_pairs(lists, B, dirty_all=case != "partial")
    if case in ("count0", "count1"):
        count = torch.full_like(count, int(case[-1]))
    elif case == "odd":
        order = np.random.RandomState(3).permutation(B * B // 2).astype(np.int32)
        pairs = torch.from_numpy(order).to(pairs.device)
        count = torch.full_like(count, 301)
    got, want = garbage.clone(), garbage.clone()
    mirror_refresh(st.vol.tsdf, got, pairs, count)
    mirror_refresh_plain(st.vol.tsdf, want, pairs, count)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    if case == "count0":
        assert torch.equal(got.view(torch.int16), garbage.view(torch.int16))
    if case == "dirty_all":
        assert torch.equal(got, blocked_to_dense(st.vol.tsdf).to(torch.bfloat16))


@pytest.mark.parametrize("R", [256, 72], ids=["tracker_volume", "odd_blocks"])
def test_build_mirror_is_bit_exact(frame_on_card, R):
    """The full rebuild equals its plain version bit for bit, and on the
    tracker's volume the mirror that the refreshes kept; R=72 has an
    odd block count."""
    _, st, _, _, _, _, _ = frame_on_card
    if R == 256:
        tsdf = st.vol.tsdf
    else:
        gen = torch.Generator(device=st.vol.tsdf.device).manual_seed(2)
        tsdf = torch.randn(((R // 8) ** 3, 4, 128), generator=gen, device=st.vol.tsdf.device)
        tsdf[::3, 1, :7] = -0.0
    got = build_mirror(tsdf, R)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), build_mirror_plain(tsdf, R).view(torch.int16))
    if R == 256:
        assert torch.equal(got.view(torch.int16), st.logical.view(torch.int16))


@pytest.mark.parametrize("case", ["5,1", "5,0", "5,2", "all_miss", "ragged",
                                  "5,3", "3,1", "7,2"])
def test_tile_raycast_matches_its_plain_version(frame_on_card, case):
    """At each unrolled (window, newton) pair, and at (5,3), (3,1) and
    (7,2), which run the kernel's run-time loops: where both hit, depth
    within 1e-3 m and gradient within 1e-3; at most 0.1 % of pixels may
    disagree on a hit. With no warm start (t_warm all 0) nothing is
    found and t is 0 everywhere; a 117x157 crop masks the edge of the
    kernel's 32x4 tiles."""
    cfg, st, T, depth_half, _, _, _ = frame_on_card
    cam_half = CAM.at_level(1)
    _, _, t_warm = ray_setup(cam_half, T, depth_half)
    pair = (5, cfg.raycast_newton_iters)
    if case == "all_miss":
        t_warm = torch.zeros_like(t_warm)
    elif case == "ragged":
        t_warm = t_warm[:117, :157].contiguous()
    elif "," in case:
        pair = tuple(int(x) for x in case.split(","))
    args = (st.logical, t_warm, raycast_params(T), cam_half, cfg.voxel_size,
            cfg.trunc_dist, *pair)
    a, b = tile_raycast(*args), tile_raycast_plain(*args)
    assert all(x.shape == t_warm.shape for x in a)
    fa, fb = a[1] > 0.5, b[1] > 0.5
    if case == "all_miss":
        assert not fa.any() and not fb.any()
        assert not a[0].any() and not b[0].any()
    else:
        assert int(fa.sum()) > 0.5 * int((t_warm > 0).sum())
    assert float((fa != fb).float().mean()) <= 1e-3
    # where both hit; with no hit, the gradients of the Newton tap at t = 0
    where = torch.ones_like(fa) if case == "all_miss" else fa & fb
    for x, y in zip(a[0:1] + a[2:], b[0:1] + b[2:]):
        assert float((x - y)[where].abs().max()) <= 1e-3


@pytest.mark.parametrize("pair", [(0, 1), (5, -1)])
def test_tile_raycast_refuses_no_window_or_a_negative_newton_count(frame_on_card, pair):
    """window < 1 or newton < 0 raises ValueError and launches nothing;
    the C entry refuses the same pairs."""
    from kintinuous_tpu_torch.ops import kernels as K
    from kintinuous_tpu_torch.ops.cuda_raycast import (
        _SIGNATURES_RAYCAST, _raycast_constants)

    cfg, st, T, depth_half, _, _, _ = frame_on_card
    cam_half = CAM.at_level(1)
    _, _, t_warm = ray_setup(cam_half, T, depth_half)
    before = tile_raycast.launches
    with pytest.raises(ValueError, match="window >= 1 and newton >= 0"):
        tile_raycast(st.logical, t_warm, raycast_params(T), cam_half, cfg.voxel_size,
                     cfg.trunc_dist, *pair)
    assert tile_raycast.launches == before
    h, w = t_warm.shape
    out = torch.empty((5, h, w), dtype=torch.float32, device=t_warm.device)
    err = K.library("raycast", _SIGNATURES_RAYCAST).kt_tile_raycast(
        st.logical.data_ptr(), t_warm.data_ptr(), raycast_params(T).data_ptr(),
        *(x.data_ptr() for x in out), h, w, st.logical.shape[0],
        *_raycast_constants(cam_half, cfg.voxel_size, cfg.trunc_dist), *pair,
        K.stream_of(t_warm))
    assert err == 1  # cudaErrorInvalidValue


def test_tracker_on_the_card_follows_the_cpu(card):
    """Six tracked frames on the card and on the CPU (plain versions):
    poses within 1e-4, the same shifts, the launch counters moved."""
    cfg = cfg_small()
    poses = orbit_trajectory(6, radius=0.06, angle_deg=3.0)
    frames = [render_frame(Scene.default(), CAM, T) for T in poses]
    before = band_fusion.launches
    runs = []
    for dev in (card, "cpu"):
        tr = Tracker(cfg, device=dev)
        for i, f in enumerate(frames):
            tr.process_frame(*f, i * 33333)
        tr.flush()
        runs.append(tr)
    assert band_fusion.launches >= before + len(frames)
    np.testing.assert_allclose(np.array(runs[0].poses), np.array(runs[1].poses), atol=1e-4)
    assert np.array_equal(np.array(runs[0].shift_log), np.array(runs[1].shift_log))


def test_batched_step_on_the_card_follows_the_cpu(card):
    """process_frames on the card and on the CPU: poses within 1e-4 (as
    the per-frame test above), the same shifts and slices."""
    from kintinuous_tpu_torch.io.synth import straight_trajectory

    cfg = cfg_small()
    poses = straight_trajectory(10, distance=-0.6, axis=2)
    items = [(*render_frame(Scene.default(), CAM, T), i * 33333) for i, T in enumerate(poses)]
    runs = []
    for dev in (card, "cpu"):
        tr = Tracker(cfg, device=dev)
        tr.process_frames(items)
        runs.append(tr)
    np.testing.assert_allclose(np.array(runs[0].poses), np.array(runs[1].poses), atol=1e-4)
    assert np.array_equal(np.array(runs[0].shift_log), np.array(runs[1].shift_log))
    # K1's tsdf may differ from the plain version's by 1e-7: a zero
    # crossing can move, so slice sizes agree to 1 %
    na, nb = ([len(s.points) for s in r.slices] for r in runs)
    assert len(na) == len(nb) and all(abs(a - b) <= 0.01 * max(a, b) for a, b in zip(na, nb))


@pytest.mark.parametrize("probe", ["rows", "dma", "full", "dyn", "rows_0", "rows_1",
                                   "rows_301", "dma_0", "dma_1", "dma_301", "dma_cx1",
                                   "full_0", "full_1", "full_301", "dyn_n0",
                                   "dyn_nk", "dyn_nk5"])
def test_probe_kernels_are_bit_exact(card, probe):
    """P1-P4 at the probe tool's shapes: bit-equal to their plain
    versions, each call counted. P1, P2 and P3 also over 0, 1 and 301
    rows (301 is no multiple of a block's warps), P2 with every corner
    one column right (cx % 4 == 1: 2-byte loads), P4 with n = 0, k and
    k + 5 (the count clamped to [0, k])."""
    from kintinuous_tpu_torch.tools import proto_integrate as P

    x = P.make_inputs(card)
    name, _, edge = probe.partition("_")
    m = P.N_K
    if name in ("rows", "dma", "full") and edge.isdigit():
        m = int(edge)
    n_dyn = {"": P.N_DYN, "n0": 0, "nk": P.N_K, "nk5": P.N_K + 5}[edge if name == "dyn" else ""]
    n = torch.tensor(n_dyn, dtype=torch.int32, device=card)
    ids, corners = x.ids[:m], (x.cy[:m], x.cx[:m] + (1 if edge == "cx1" else 0))
    kernel, plain, args = {
        "rows": (P.run_rows, P.run_rows_plain, (ids,)),
        "dma": (P.run_dma, P.run_dma_plain, (ids, corners, x.img, x.img2)),
        "full": (P.run_full, P.run_full_plain, (ids, corners, x.img, x.img2)),
        "dyn": (lambda v, i: P.run_dyn(n, v, i),
                lambda v, i: P.run_dyn_plain(n, v, i), (ids,)),
    }[name]
    wrapper = getattr(P, f"run_{name}")
    before = wrapper.launches
    got, want = x.tsdf.clone(), x.tsdf.clone()
    kernel(got, *args)
    plain(want, *args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + (1 if m > 0 else 0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    changed = min(max(n_dyn, 0), m) if name == "dyn" else m
    assert int((got != x.tsdf).any(dim=(1, 2)).sum()) == changed


def test_odd_block_tracker_on_the_card_follows_the_cpu(card):
    """A 72^3 volume (9 blocks an edge) over 3 m: no mirror on either
    device, the card's raycast rebuilds it with K5 every frame and K3 is
    never launched; six tracked frames agree with the CPU's within 1e-4,
    as the even-count tracker above."""
    cfg = cfg_small().replace(volume_size=3.0, volume_resolution=72)
    poses = orbit_trajectory(6, radius=0.06, angle_deg=3.0)
    frames = [render_frame(Scene.default(), CAM, T) for T in poses]
    refresh, rebuild = mirror_refresh.launches, build_mirror.launches
    runs = []
    for dev in (card, "cpu"):
        tr = Tracker(cfg, device=dev)
        for i, f in enumerate(frames):
            tr.process_frame(*f, i * 33333)
        tr.flush()
        assert tr.state.logical is None
        runs.append(tr)
    assert mirror_refresh.launches == refresh
    assert build_mirror.launches == rebuild + len(frames)
    np.testing.assert_allclose(np.array(runs[0].poses), np.array(runs[1].poses), atol=1e-4)
    assert np.array_equal(np.array(runs[0].shift_log), np.array(runs[1].shift_log))


def test_config_b_tracker_on_the_card_follows_the_cpu(card):
    """Fused ICP+RGB-D (config B) on the card and on the CPU: poses
    within 1e-4 (as the ICP tracker above), the same RGB inlier counts
    within 1 %."""
    cfg = cfg_small().replace(icp_plus_rgbd=True)
    poses = orbit_trajectory(6, radius=0.06, angle_deg=3.0)
    frames = [render_frame(Scene.default(), CAM, T) for T in poses]
    runs = []
    for dev in (card, "cpu"):
        tr = Tracker(cfg, device=dev)
        for i, f in enumerate(frames):
            tr.process_frame(*f, i * 33333)
        tr.flush()
        runs.append(tr)
    np.testing.assert_allclose(np.array(runs[0].poses), np.array(runs[1].poses), atol=1e-4)
    ca, cb = (np.array(r.stats["icp_count"][1:]) for r in runs)
    assert (cb > 0).all() and (np.abs(ca - cb) <= 0.01 * cb).all()


def test_meshing_tracker_on_the_card_follows_the_cpu(card):
    """A ground-truth walk with meshing on the card and on the CPU: the
    same band patches (cells equal, vertices within 1e-4, face counts
    within 1 %: K1's tsdf may differ from the plain version's by 1e-7)."""
    from kintinuous_tpu_torch.io.synth import straight_trajectory

    cfg = cfg_small().replace(mesh=True, mesh_vertex_capacity=100_000,
                              mesh_face_capacity=200_000)
    # 1.5 m backwards: the far bands that leave the volume cut the scene
    poses = straight_trajectory(20, distance=-1.5, axis=2)
    frames = [render_frame(Scene.default(), CAM, T) for T in poses]
    runs = []
    for dev in (card, "cpu"):
        tr = Tracker(cfg, device=dev)
        last = None
        for i, T in enumerate(poses):
            delta = np.eye(4, dtype=np.float32) if last is None else \
                (np.linalg.inv(last) @ T).astype(np.float32)
            tr.process_frame(*frames[i], i * 33333, ext_delta=delta)
            last = T
        tr.finalise()
        runs.append(tr)
    pa, pb = (r.mesh_patches for r in runs)
    assert len(pa) == len(pb) >= 3  # two band patches and the FINAL one
    for a, b in zip(pa, pb):
        ka = {tuple(c) for c in a.cells}
        kb = {tuple(c) for c in b.cells}
        assert len(ka ^ kb) <= 0.01 * len(kb)
        assert abs(len(a.faces) - len(b.faces)) <= 0.01 * len(b.faces)
        common = np.array(sorted(ka & kb))
        va = dict(zip(map(tuple, a.cells), a.vertices))
        vb = dict(zip(map(tuple, b.cells), b.vertices))
        d = max(np.abs(va[tuple(c)] - vb[tuple(c)]).max() for c in common)
        assert d <= 1e-4, d


def test_dense_frame_on_the_card_follows_the_cpu(card):
    """The dense path (no fast_mode) at R=64: three ground-truth frames on
    the card, then one frame's integrate and raycast on the card and on
    the CPU from the same state: tsdf within 2e-5, weights equal, colour
    within 1, hit flips at most 0.1 %, depth within 1e-4 and normals
    within 1e-3 where both hit (the CPU tests' tolerances against JAX);
    none of the kernels launched."""
    from kintinuous_tpu_torch.ops.raycast import raycast
    from kintinuous_tpu_torch.ops.tsdf import VolumeState, integrate

    cfg = cfg_small().replace(fast_mode=False, volume_size=3.0, volume_resolution=64)
    poses = orbit_trajectory(4, radius=0.06, angle_deg=3.0)
    frames = [render_frame(Scene.default(), CAM, T) for T in poses]
    counts = [w.launches for w in (band_fusion, free_carve, mirror_refresh, build_mirror,
                                   tile_raycast)]
    tr = Tracker(cfg, device=card)
    for i in range(3):
        delta = np.eye(4) if i == 0 else np.linalg.inv(poses[i - 1]) @ poses[i]
        tr.process_frame(*frames[i], i * 33333, ext_delta=delta.astype(np.float32))
    tr.flush()
    st = tr.state
    T = st.pose @ torch.from_numpy(
        (np.linalg.inv(poses[2]) @ poses[3]).astype(np.float32)).to(card)
    d, c = (torch.from_numpy(np.asarray(x)).to(card) for x in frames[3])
    depth_m, rgb, _, color_w = preprocess_frame(cfg, d, c, half=False)
    res = []
    for dev in (card, torch.device("cpu")):
        vol = VolumeState(*(x.to(dev, copy=True) for x in st.vol))
        dm, cc, cw, Tw = (x.to(dev) for x in (depth_m, rgb, color_w, T))
        integrate(vol, CAM, dm, cc, cw, Tw, cfg.voxel_size, cfg.trunc_dist)
        res.append((vol, raycast(vol, CAM, Tw, cfg.voxel_size, cfg.volume_size,
                                 cfg.trunc_dist)))
    (vk, rk), (vc, rc) = res
    ck = vk.cw.cpu()
    assert (vk.tsdf.cpu() - vc.tsdf).abs().max() <= 2e-5
    assert torch.equal((ck >> 24) & 0xFF, (vc.cw >> 24) & 0xFF)
    for s in (0, 8, 16):
        assert (((ck >> s) & 0xFF) - ((vc.cw >> s) & 0xFF)).abs().max() <= 1
    hk, hc = rk.depth.cpu() > 0, rc.depth > 0
    both = hk & hc
    assert int(hc.sum()) > 0.5 * hc.numel()
    assert float((hk != hc).float().mean()) <= 1e-3
    assert (rk.depth.cpu() - rc.depth)[both].abs().max() <= 1e-4
    assert (rk.nmap.cpu() - rc.nmap)[:, both].abs().max() <= 1e-3
    assert counts == [w.launches for w in (band_fusion, free_carve, mirror_refresh,
                                           build_mirror, tile_raycast)]


# ------------------------------------------------------------ -od backend

def _lap_rgb(w=320, h=240, i=60):
    from kintinuous_tpu_torch.io.synth import lap_scene, lap_trajectory

    f = 528.0 * w / 640
    cam = CameraIntrinsics(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h)
    return render_frame(lap_scene(), cam, lap_trajectory()[i], 6.0, np.random.default_rng(7))[1]


def test_orb_on_the_card_follows_the_cpu(card):
    """The detector on the card and on the CPU: the same keypoints, in
    the same order, angles within 1e-3 degrees, and descriptors equal on
    at least 99 % of their bits (the pyramid and the blur are integer
    arithmetic; only the steering's cos/sin may round differently)."""
    from kintinuous_tpu_torch.backend.features import orb_keypoints, rgb_to_gray

    rgb = torch.from_numpy(_lap_rgb(640, 480))
    gk = rgb_to_gray(rgb.to(card))
    assert gk.device.type == "cuda"
    k, c = orb_keypoints(gk), orb_keypoints(rgb_to_gray(rgb))
    assert k["desc"].device.type == "cuda" and len(c["pts"]) > 100
    assert torch.equal(k["pts"].cpu(), c["pts"]) and torch.equal(k["octave"].cpu(), c["octave"])
    assert (k["angle"].cpu() - c["angle"]).abs().max() <= 1e-3
    bits = np.unpackbits(k["desc"].cpu().numpy() ^ c["desc"].numpy())
    assert bits.mean() <= 0.01


def _chain_graph(device, n=200, seed=7):
    from kintinuous_tpu_torch.backend.pose_graph import PoseGraph
    from kintinuous_tpu_torch.geometry import se3

    def exp(xi):
        return se3.exp_se3(torch.tensor(xi, dtype=torch.float32)).numpy().astype(np.float64)

    rng = np.random.default_rng(seed)
    g = PoseGraph(device=device)
    step = exp([0.02, 0.0, 0.03, 0.1, 0.0, 0.05])
    for k in range(n - 1):
        g.add_odometry(k, k + 1, step @ exp(np.r_[rng.normal(0, 0.004, 3),
                                               rng.normal(0, 0.004, 3)]))
    g.add_loop(0, n - 1, exp([0.1, 0.2, -0.1, 0.5, 0.2, 0.1]))
    g.add_loop(20, 150, exp([0.0, 0.1, 0.0, 0.2, 0.0, 0.0]))
    return g


def test_pose_graph_on_the_card_follows_the_cpu(card):
    """PoseGraph.optimise on the card against the CPU (float atomics in
    index_add_ on the card): poses within 1e-4, chi2 within 1e-3
    relative."""
    gk, gc = _chain_graph(card), _chain_graph("cpu")
    poses, chi2 = gk.solve(3)
    assert poses.device.type == "cuda" and chi2.device.type == "cuda"
    ck, cc = gk.optimise(10), gc.optimise(10)
    np.testing.assert_allclose(np.array(gk.poses), np.array(gc.poses), atol=1e-4)
    assert ck == pytest.approx(cc, rel=1e-3)


def test_deformation_on_the_card_follows_the_cpu(card):
    """DeformationGraph.optimise and apply on the card against the CPU:
    the card's float32 solve lies no farther from the CPU's than the
    CPU's float32 solve lies from its float64 one, plus 1e-4 m (60 CG
    steps leave the weakly constrained directions where rounding puts
    them); the apply of one graph within 1e-5 m."""
    from kintinuous_tpu_torch.backend import deformation as dgmod
    from kintinuous_tpu_torch.backend.deformation import DeformationGraph

    rng = np.random.default_rng(3)
    n = 40
    times = np.arange(n) * 1000
    pos = np.c_[np.linspace(0, 12, n), 0.3 * np.sin(np.linspace(0, 4, n)), np.zeros(n)]
    graphs = [DeformationGraph(k=4, sample_dist=0.25, device=d) for d in (card, "cpu")]
    src = pos[rng.integers(0, n, 300)] + rng.normal(0, 0.3, (300, 3))
    vt = rng.integers(0, times[-1] + 1, 300)
    dst = src + np.c_[0.02 * src[:, 0], np.zeros(300), -0.01 * src[:, 0]]
    verts = rng.uniform(-1, 13, (2000, 3))
    vtimes = rng.integers(0, times[-1] + 1, 2000)
    out = []
    for g in graphs:
        g.append_poses(times, pos)
        A, _, _ = g.solve(src, dst, g.bind(src, vt), iters=2)
        assert A.device.type == torch.device(g.device).type
        g.optimise(src, dst, g.bind(src, vt), iters=10)
        applied = g.apply_tensor(verts, g.bind(verts, vtimes))
        assert applied.device.type == torch.device(g.device).type
        out.append(applied.cpu().numpy())
    # the CPU's float64 solve of the same system
    g = graphs[1]
    e_j, e_k = g.edges()
    b = g.bind(src, vt)

    def t64(a):
        return torch.from_numpy(np.asarray(a, np.float64))

    A0 = torch.eye(3, dtype=torch.float64).repeat(g.n_nodes, 1, 1)
    A, t, _ = dgmod.gn_core(A0, torch.zeros(g.n_nodes, 3, dtype=torch.float64),
                            t64(np.array(g.g)), torch.from_numpy(e_j).long(),
                            torch.from_numpy(e_k).long(), t64(src), t64(dst),
                            torch.from_numpy(b.ids).long(), t64(b.w),
                            torch.ones(len(src), dtype=torch.float64), 10)
    bv = g.bind(verts, vtimes)
    ref = dgmod.deform(A, t, t64(np.array(g.g)), t64(verts), torch.from_numpy(bv.ids).long(),
                       t64(bv.w)).numpy()
    spread = np.abs(out[1] - ref).max()
    assert np.abs(out[0] - out[1]).max() <= spread + 1e-4, (np.abs(out[0] - out[1]).max(), spread)
    # one graph's apply on both devices
    graphs[1].device = card
    again = graphs[1].apply(verts, graphs[1].bind(verts, vtimes))
    np.testing.assert_allclose(again, out[1], atol=1e-5)


def test_loop_refinement_on_the_card_follows_the_cpu(card):
    """place_recognition.refine_loop on the card against the CPU, on two
    lap frames 0.2 m apart started 2 cm off: the same pose within 1e-4 m
    and 1e-3 degrees (float32 reductions in another order), and both
    within 1.5 mm of the truth (the CPU measured 0.84 mm)."""
    from kintinuous_tpu_torch.backend.place_recognition import refine_loop
    from kintinuous_tpu_torch.config import KintinuousConfig
    from kintinuous_tpu_torch.io.synth import lap_scene, lap_trajectory

    cfg = KintinuousConfig()
    poses = lap_trajectory()
    d1, d2 = (render_frame(lap_scene(), cfg.camera, poses[i], 6.0,
                           np.random.default_rng(i))[0] for i in (60, 64))
    T_gt = np.linalg.inv(poses[60]) @ poses[64]
    off = np.eye(4)
    off[:3, 3] = [0.012, -0.01, 0.012]
    out = [refine_loop(cfg, d1, d2, T_gt @ off, d)[0] for d in (card, "cpu")]

    def gap(A, B):
        E = np.linalg.inv(A) @ B
        cos = np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)
        return np.linalg.norm(E[:3, 3]), np.degrees(np.arccos(cos))

    m, deg = gap(*out)
    assert m <= 1e-4 and deg <= 1e-3, (m, deg)
    assert all(gap(T, T_gt)[0] < 1.5e-3 for T in out)
