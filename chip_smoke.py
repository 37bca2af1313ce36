#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (kintinuous_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--trace FRAMES]

Builds the CUDA kernels from kintinuous_tpu_torch/csrc/, then, at the
headline configuration (512^3 voxels over 6 m, 640x480 input, 320x240
prediction, 16-voxel shifts, ICP odometry):

  1. holds each kernel (band fusion, free carve, mirror refresh, mirror
     rebuild, raycast) against its plain PyTorch version on the card, on
     a volume fused from rendered views of a bare room (band fusion and
     the free carve also with a count of 0, the carve and the mirror
     refresh with a count of 1, the raycast at each unrolled (window,
     newton) pair and, through its run-time loops, at (5,3), (3,1) and
     (7,2)), and times both with CUDA events from a cold L2 (the
     kernel also warm, and on the host's clock with its launch work),
     each row with its share of its bound; beside them the floor of a
     launch (the carve at count 0) and the raycast wrapper's host time
     by part; the rebuilt mirror must equal the tracker's live one bit
     for bit;
  2. tracks a 96-frame orbit with ICP odometry: ATE < 1 cm and more than
     2000 ICP inliers on each of the last 10 frames;
  3. replays a 40-frame ground-truth walk 1.5 m backwards that shifts
     the volume: shifts fire, their slices hold points, ATE < 1 mm;
  4. runs the CLI (`--fast -fod -t 16`) in process on a depth-only .klg
     of a 48-frame walk 1.2 m backwards, the batched offline engine, and
     the same engine frame by frame (offline_batched=False), twice each
     in the order A B B A: 48 poses, ATE < 1 cm, shifts, a .pcd with
     points, and each run's fps;
  5. resumes phase 3's walk from a checkpoint saved after 20 frames (the
     restore rebuilds the mirror): the mirror, tsdf, cw, wrap, origin
     and poses continue exactly;
  6. tracks phase 2's orbit at config B (config A plus fused ICP+RGB-D
     odometry, icp_plus_rgbd=True) with the rendered colour: ATE < 1 cm
     and RGB inliers on every tracked frame;
  7. runs the CLI once more on phase 4's log with meshing (`-m`): 48
     poses, ATE < 1 cm, band mesh patches from the shifts, and a .ply
     with faces that io/ply.load_ply reads back;
  8. runs the probe tool (kintinuous_tpu_torch.tools.proto_integrate,
     the port of tools/proto_integrate_pallas.py) at its shapes, then
     holds each probe kernel (P1-P4) against its plain version bit for
     bit (P1, P2 and P3 also over 0, 1 and 301 rows, P2 also with its
     corners off an 8-byte boundary, P4 with n = 0, k and k + 5) and
     times it beside its bound, its plain version and, for P1 and P4,
     PyTorch's index_add_;
  9. at an odd block count, config A with a 504^3 volume (63 blocks an
     edge), where the step keeps no mirror and the raycast rebuilds it
     (K5) every frame: phase 2's orbit for 24 frames (ATE < 1 cm, ICP
     inliers > 2000) and phase 3's walk (ATE < 1 mm, slices hold
     points);
 10. the dense path (a run without --fast, the JAX CLI's default:
     KintinuousConfig() with fast_mode off, 512^3 over 6 m, 640x480,
     plain PyTorch): (a) one frame's integrate and raycast on the card
     against the CPU at 256^3, within the CPU tests' tolerances; (b)
     phase 2's orbit for 24 frames (ATE < 1 cm, ICP inliers > 2000; fps,
     peak device memory) and 2 more under the profiler (launches a
     frame, device busy ms); (c) phase 3's walk (ATE < 1 mm, slices hold
     points); (d) the CLI with `-m` and no --fast on phase 4's log (ATE <
     1 cm, a .pcd with points, a .ply with faces); (e) phase 5's resume
     (tsdf, cw, wrap and origin bit-equal, poses within 1e-5);
 11. online deformation (-od) on bench C's pivot lap (bench.py:164-209,
     274-340): `lap_scene(3.2, 2.4)` and its 419-frame `lap_trajectory`
     with 6 mm depth noise, rendered at 640x480 on every core before
     phase 1 (io/synth.render_frames), its colour written uncompressed
     (the card's machine has no JPEG codec: io/klg._decode_rgb is
     replaced in this process by a reshape of the raw bytes), through
     the CLI in process, batched, at config A with its dynamic cube:
     `--fast -fod -t 16 -d -dc -ri -od -m -lt 0 --prior 0.01`. 419
     poses, shifts, at least one loop accepted, every accepted loop
     genuine (eval/loop_gate), a `_opt.pcd` with points and a `_opt.ply`
     with faces; the ORB, the dense loop refinement, the pose graph's
     and the deformation graph's GN ran on the card; the card against
     the CPU on the ORB of one lap frame (the same keypoints,
     descriptors equal on >= 99 % of bits), the run's last loop
     refinement (within 1e-4 m and 1e-3 degrees), the final pose graph
     (poses within 1e-4), the final deformation
     graph's apply (1e-4 m) and its last solve (no farther from the
     CPU's than the CPU's float32 solve from its float64 one, plus 1e-4
     m); an -od engine checkpoint restored into a fresh engine equal in
     its graphs, keyframe ring and vocabulary; then the run's pose graph
     rebuilt with its accepted loops' relative poses taken from the
     ground truth must end below the pre-loop ATE, and the final ATE
     (the `.poses` after deformation) must too. Prints the ATEs, the
     rebuilt graph's ATE with the measured and with exact loops, each
     loop attempt's error against the ground truth, loops, the
     place-recognition gates, the gate's precision and recall against
     the ground truth (eval/loop_gate), keyframes taken and dropped, the
     PlaceRecognition and Deformation span means, the ORB's ms for each
     keyframe and the refinement's for each loop, fps and peak device
     memory;

and checks that each run of phases 2-4, 6, 7 and 11 launched K1-K4,
phase 5 the rebuild, phase 8 the four probes, phase 9 K1, K2, K4 and K5
once a frame and K3 never, and phase 10 no kernel, with the counts set
to 0 before each path.
`--trace FRAMES`
then profiles that many further orbit frames (where a frame's time
goes: host ms untraced and traced, device busy ms and idle share, host
ms per step stage, kernel launches, the kernels with the most device
time). Prints one JSON line per kernel, the card's name and power
limit, one {"kernels": [...]} line, and last {"ok": true, "device":
{...}}. A failed check raises, except phase 11's two ATE checks, which
are reported after the kernel line; either way the exit code is
non-zero and the last line is not printed. Without a CUDA card, or
outside the repository, the script exits non-zero before printing any
result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np

# Peak rates of one H100 SXM (NVIDIA data sheet, at the 700 W limit).
MEM_BYTES_PER_S = 3.35e12  # HBM3
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores

# f32 operations per unit of work, counted from the kernels' sources
# (csrc/*.cu): per band voxel, per carved voxel, per refreshed voxel, per
# raycast pixel and per raycast tap.
OPS_BAND_VOXEL = 64
OPS_FREE_VOXEL = 6
OPS_MIRROR_VOXEL = 1
OPS_RAY_PIXEL = 30
OPS_RAY_TAP = 70

ORBIT_FRAMES = 96
WALK_FRAMES = 40
ODD_RESOLUTION = 504  # phase 9: 63 blocks an edge
ODD_ORBIT_FRAMES = 24
ENGINE_FRAMES = 48
# phase 4's engine runs: (path, batched), batched and per frame as A B B A
ENGINE_RUNS = (("engine", True), ("engine_per_frame", False),
               ("engine_per_frame_2", False), ("engine_2", True))
RESUME_AT = 20  # phases 5 and 10e save after this many frames of the walk
DENSE_CHECK_RESOLUTION = 256  # phase 10a: card against CPU
DENSE_ORBIT_FRAMES = 24  # phase 10b
DENSE_TRACE_FRAMES = 2  # phase 10b's profiled frames
DENSE_PATHS = ("dense_check", "dense_orbit", "dense_profile", "dense_walk", "dense_cli",
               "dense_resume")
# the step's torch.profiler ranges (tracking/tracker.py)
STAGES = ("kt.preprocess", "kt.odometry", "kt.shift", "kt.integrate", "kt.raycast")


ORBIT_RGBD_FRAMES = 96  # phase 6, config B
# phase 11: bench C's pivot lap (bench.py:184-198)
LAP_KW = dict(length=3.2, depth=2.4, step=0.055, turn_frames=26, warmup_frames=10,
              revisit_frac=0.35)
LAP_FRAMES = 419
LAP_NOISE_MM = 6.0
ORB_CHECK_FRAME = 100  # the lap frame of phase 11's ORB check
# checks that failed in a phase whose later checks and readings still
# run; main prints the kernel line, then exits non-zero
FAILED: list = []


def check(ok: bool, msg: str) -> None:
    if not ok:
        print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
        FAILED.append(msg)


# (window, newton) pairs outside ops/cuda_raycast.RAYCAST_PAIRS: the
# raycast kernel's run-time loops (phase 1)
RUNTIME_PAIRS = ((5, 3), (3, 1), (7, 2))


def probe_bytes(x, n_dyn: int) -> dict:
    """The bytes each probe (P1-P4, tools/proto_integrate_pallas.py) must
    move on these inputs: each selected row read and written once, the
    ids (and corners) it reads (P4: the first n, since blocks past n
    return first), and each distinct image value it reads once. Each
    only copies rows and gathers a few image values a float (P3's one-hot
    matmuls are the TPU's way of doing that gather, not work the function
    needs), so each is bound by its bytes."""
    import torch

    from kintinuous_tpu_torch.tools.proto_integrate import PH, PW

    k = x.ids.shape[0]
    row = 4 * 128 * 4  # one (4,128) f32 row
    rows = k * 2 * row + k * 4
    cy, cx = (c.long()[:, None, None] for c in (x.cy, x.cx))
    H, W = x.img.shape[1:]
    H2, W2 = x.img2.shape[1:]
    s = torch.arange(4, device=cy.device)[None, :, None]
    lane = torch.arange(128, device=cy.device)[None, None, :]
    p2 = torch.unique((cy + s) * W + cx + lane).numel()  # img[0] corners
    a = x.tsdf[x.ids.long()].abs()
    u = torch.clamp(a * 100.0, 0, PW - 1).long()
    v = torch.clamp(a * 70.0, 0, PH - 1).long()
    p3 = 2 * torch.unique((cy + v) * W + cx + u).numel()
    p3_2 = 3 * torch.unique((cy // 2 + v // 2) * W2 + u // 2).numel()
    return {"probe_rows": rows, "probe_dma": rows + 2 * k * 4 + p2 * 2,
            "probe_full": rows + 2 * k * 4 + (p3 + p3_2) * 2,
            "probe_dyn": n_dyn * (2 * row + 4) + 4}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def windows() -> dict:
    """The card's timers by name: device ms from a cold L2 ("cold"),
    device ms without the flush ("warm"), and host ms of the call until
    the card has run it, launch work included ("host")."""
    from kintinuous_tpu_torch.ops import kernels

    return {"cold": kernels.cuda_window_ms,
            "warm": lambda fn: kernels.cuda_window_ms(fn, cold=False),
            "host": kernels.host_window_ms}


def time_ms(fn, reps: int = 10, mode: str = "cold") -> float:
    """Median of `reps` timed calls after one warm-up, on the card by the
    timer `mode` of windows(), on the CPU by the host clock (rehearsals
    only)."""
    import torch

    fn()
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    times = []
    for _ in range(reps):
        if cuda:
            times.append(windows()[mode](fn))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def raycast_host_splits(call, mirror, t_warm, params, cam, vsz, trunc, window,
                        newton) -> dict:
    """Host us a call of K4's wrapper and of its parts take, each the
    median of 5 runs of 50 calls in a row (no synchronisation inside a
    run, so the card's time is not in them): the whole call; the C call
    alone (ctypes and the launch); the output's allocation; its five
    views; the stream query; the argument checks; the f32 constants;
    and five (h,w) allocations and the stream object's query, as the
    wrapper made them before."""
    import torch

    from kintinuous_tpu_torch.ops import kernels as K
    from kintinuous_tpu_torch.ops.cuda_raycast import (
        _SIGNATURES_RAYCAST, _raycast_constants)

    h, w = t_warm.shape
    dev = t_warm.device
    out = torch.empty((5, h, w), dtype=torch.float32, device=dev)
    lib = K.library("raycast", _SIGNATURES_RAYCAST)
    args = (mirror.data_ptr(), t_warm.data_ptr(), params.data_ptr(),
            *(x.data_ptr() for x in out), h, w, mirror.shape[0],
            *_raycast_constants(cam, vsz, trunc), window, newton, K.stream_of(t_warm))
    parts = {
        "call": call,
        "c_call": lambda: lib.kt_tile_raycast(*args),
        "alloc": lambda: torch.empty((5, h, w), dtype=torch.float32, device=dev),
        "views": lambda: out.unbind(0),
        "stream": lambda: K.stream_of(t_warm),
        "checks": lambda: K.require_cuda("tile_raycast", mirror, t_warm, params),
        "constants": lambda: _raycast_constants(cam, vsz, trunc),
        "alloc_five": lambda: [torch.empty((h, w), dtype=torch.float32, device=dev)
                               for _ in range(5)],
        "stream_object": lambda: torch.cuda.current_stream(dev).cuda_stream,
    }
    res = {}
    for name, fn in parts.items():
        runs = []
        for _ in range(6):  # the first run warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            runs.append((time.perf_counter() - t0) / 50 * 1e6)
        res[name] = statistics.median(runs[1:])
    torch.cuda.synchronize()
    return res


def bound(n_bytes: float, n_ops: float) -> tuple:
    t_mem = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def pingpong(i: int, n: int) -> int:
    period = 2 * (n - 1)
    k = i % period
    return k if k < n else period - k


def gt_delta(prev, T) -> np.ndarray:
    if prev is None:
        return np.eye(4, dtype=np.float32)
    return (np.linalg.inv(prev) @ T).astype(np.float32)


def check_kernels(cfg, dev, frames, poses, card: str) -> dict:
    """Phase 1: each kernel against its plain version, on the inputs the
    main path gives it for the fifth frame of a ground-truth replay."""
    import torch

    from kintinuous_tpu_torch.ops.blocked import BLOCK, blocked_to_dense
    from kintinuous_tpu_torch.ops.cuda_integrate import (
        band_fusion, band_fusion_plain, dirty_pairs, free_carve,
        free_carve_plain, integrate_plan,
    )
    from kintinuous_tpu_torch.ops.cuda_raycast import (
        RAYCAST_PAIRS, _f32, build_mirror, build_mirror_plain, mirror_refresh,
        mirror_refresh_plain, ray_setup, raycast_params, tile_raycast, tile_raycast_plain,
    )
    from kintinuous_tpu_torch.tracking.tracker import Tracker, preprocess_frame

    cam, cam_half = cfg.camera, cfg.camera.at_level(1)
    R, B = cfg.volume_resolution, cfg.volume_resolution // BLOCK
    vsz, trunc, mw = cfg.voxel_size, cfg.trunc_dist, float(cfg.max_weight)
    tr = Tracker(cfg, device=dev)
    for i in range(4):
        tr.process_frame(*frames[i], i * 33333,
                         ext_delta=gt_delta(poses[i - 1] if i else None, poses[i]))
    tr.flush()
    st = tr.state
    d, c = (torch.from_numpy(np.asarray(x)).to(dev) for x in frames[4])
    T = st.pose @ torch.from_numpy(gt_delta(poses[3], poses[4])).to(dev)
    depth_m, rgb, depth_half, color_w = preprocess_frame(cfg, d, c)
    tables, lists, params = integrate_plan(
        st.vol, cam, depth_m, rgb, color_w, T, vsz, trunc, cfg.band_cap)
    nb, nf = int(lists.n_band), int(lists.n_free)
    assert nb > 0 and nf > 0, f"frame has {nb} band and {nf} free blocks"
    rows = {}

    def report(name, source, replaces, err, kernel, plain, n_bytes, n_ops,
               library=None, **extra):
        """One kernel's row: kernel, plain and library are the calls
        timed from a cold L2, the kernel also warm, and the kernel and
        library on the host's clock (host_ms)."""
        b_ms, b_by = bound(n_bytes, n_ops)
        ms = time_ms(kernel)
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   max_abs_err=err, ms=ms, plain_ms=time_ms(plain),
                   bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
                   library_ms=time_ms(library) if library else None, card=card,
                   ms_warm_l2=time_ms(kernel, mode="warm"),
                   host_ms=time_ms(kernel, mode="host"),
                   library_host_ms=time_ms(library, mode="host") if library else None,
                   **extra)
        rows[name] = row
        print(json.dumps(row), flush=True)

    # K1 band fusion: same volume, same lists, kernel against plain
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def k1_args(t, cw, n=lists.n_band):
        return (t, cw, tables.img_rows, lists.band_ids, n, params, cam, vsz,
                trunc, mw)

    tk, ck = st.vol.tsdf.clone(), st.vol.cw.clone()
    tp, cp = st.vol.tsdf.clone(), st.vol.cw.clone()
    band_fusion(*k1_args(tk, ck, zero))  # a count of 0 changes nothing
    assert torch.equal(tk.view(torch.int32), st.vol.tsdf.view(torch.int32)) and \
        torch.equal(ck, st.vol.cw), "band fusion with a count of 0 changed the volume"
    band_fusion(*k1_args(tk, ck))
    band_fusion_plain(*k1_args(tp, cp))
    w_mis = int((((ck >> 24) & 0xFF) != ((cp >> 24) & 0xFF)).sum()) / (nb * 512)
    t_err = float((tk - tp).abs().max())
    c_err = max(int((((ck >> s) & 0xFF) - ((cp >> s) & 0xFF)).abs().max())
                for s in (0, 8, 16))
    # tolerances: what the kernel gives on these inputs, weights equal and
    # colour exact, and for tsdf the port's CPU bound against
    # integrate_fast (1e-5; the two versions here differ by 1.2e-7)
    assert w_mis == 0 and t_err <= 1e-5 and c_err == 0, (w_mis, t_err, c_err)
    report(
        "band_fusion", "kintinuous_tpu_torch/csrc/integrate.cu",
        "kintinuous_tpu/ops/pallas_integrate.py:68", t_err,
        lambda: band_fusion(*k1_args(tk, ck)),
        lambda: band_fusion_plain(*k1_args(tp, cp)),
        nb * 512 * 16 + tables.img_rows.numel() * 4 + nb * 4,
        nb * 512 * OPS_BAND_VOXEL,
        weight_mismatch=w_mis, colour_err=c_err, blocks=nb,
    )
    del tk, ck, tp, cp

    # K2 free carve: bit-exact over the whole volume, with counts 0 (the
    # volume unchanged) and 1, then the frame's count
    for n in (zero, torch.ones_like(zero), lists.n_free):
        tk, ck = st.vol.tsdf.clone(), st.vol.cw.clone()
        tp, cp = st.vol.tsdf.clone(), st.vol.cw.clone()
        free_carve(tk, ck, lists.free_ids, n, mw)
        free_carve_plain(tp, cp, lists.free_ids, n, mw)
        exact = torch.equal(tk.view(torch.int32), tp.view(torch.int32)) and \
            torch.equal(ck, cp)
        assert exact, f"free carve with a count of {int(n)} differs from its plain version"
        if n is zero:
            assert torch.equal(tk.view(torch.int32), st.vol.tsdf.view(torch.int32)) and \
                torch.equal(ck, st.vol.cw), "free carve with a count of 0 changed the volume"
    # the floor of a launch on this card: K2 at count 0, an empty
    # persistent grid that reads the count and leaves
    floor = {"launch_floor_ms": time_ms(lambda: free_carve(tk, ck, lists.free_ids, zero, mw)),
             "launch_floor_ms_warm_l2": time_ms(
                 lambda: free_carve(tk, ck, lists.free_ids, zero, mw), mode="warm"),
             "launch_floor_host_ms": time_ms(
                 lambda: free_carve(tk, ck, lists.free_ids, zero, mw), mode="host")}
    print(json.dumps({"name": "launch_floor", "kernel": "free_carve, count 0",
                      "card": card, **floor}), flush=True)
    report(
        "free_carve", "kintinuous_tpu_torch/csrc/integrate.cu",
        "kintinuous_tpu/ops/pallas_integrate.py:247", 0.0,
        lambda: free_carve(tk, ck, lists.free_ids, lists.n_free, mw),
        lambda: free_carve_plain(tp, cp, lists.free_ids, lists.n_free, mw),
        nf * 512 * 16 + nf * 4, nf * 512 * OPS_FREE_VOXEL, blocks=nf,
        launch_floor_ms=floor["launch_floor_ms"],
    )
    del tp, cp

    # K3 mirror refresh on the fused volume (tk): the frame's dirty pairs,
    # every pair (shift frames) from a garbage mirror, count == 0 and 1
    gen = torch.Generator(device=dev).manual_seed(0)
    garbage = torch.randn((R, R, R), generator=gen, device=dev).to(torch.bfloat16)
    pairs, count = dirty_pairs(lists, B, dirty_all=False)
    all_pairs, n_all = dirty_pairs(lists, B, dirty_all=True)
    n_dirty = int(count)
    for name, (p, n, start) in {
        "partial": (pairs, count, st.logical),
        "dirty_all": (all_pairs, n_all, garbage),
        "count0": (all_pairs, zero, garbage),
        "count1": (all_pairs, torch.ones_like(zero), garbage),
    }.items():
        mk, mp = start.clone(), start.clone()
        mirror_refresh(tk, mk, p, n)
        mirror_refresh_plain(tk, mp, p, n)
        assert torch.equal(mk.view(torch.int16), mp.view(torch.int16)), \
            f"mirror refresh ({name}) differs from its plain version"
        if name == "count0":
            assert torch.equal(mk.view(torch.int16), garbage.view(torch.int16))
    mk = garbage.clone()
    mp = garbage.clone()

    def library_rebuild():
        return tk.view(B, B, B, 8, 8, 8).permute(0, 3, 1, 4, 2, 5).reshape(
            R, R, R).to(torch.bfloat16)

    mirror_refresh(tk, mk, all_pairs, n_all)
    assert torch.equal(mk, library_rebuild()), "mirror differs from a full rebuild"
    assert torch.equal(mk, blocked_to_dense(tk).to(torch.bfloat16))
    pair_vox = 2 * B * 512
    def partial():
        mirror_refresh(tk, mk, pairs, count)

    ms_partial = time_ms(partial)
    bound_partial = bound(n_dirty * pair_vox * 6 + n_dirty * 4,
                          n_dirty * pair_vox * OPS_MIRROR_VOXEL)[0]
    report(
        "mirror_refresh", "kintinuous_tpu_torch/csrc/logical.cu",
        "kintinuous_tpu/ops/pallas_raycast.py:170", 0.0,
        lambda: mirror_refresh(tk, mk, all_pairs, n_all),
        lambda: mirror_refresh_plain(tk, mp, all_pairs, n_all),
        R ** 3 * 6 + (B * B // 2) * 4, R ** 3 * OPS_MIRROR_VOXEL,
        library=library_rebuild,
        case="dirty_all (shift frame: every row-pair)",
        ms_partial=ms_partial,
        ms_warm_l2_partial=time_ms(partial, mode="warm"),
        host_ms_partial=time_ms(partial, mode="host"),
        bound_ms_partial=bound_partial, bound_share_partial=bound_partial / ms_partial,
        pairs_partial=n_dirty,
    )
    del mk, mp, garbage

    # K5 full mirror rebuild of the tracker's volume: bit-equal to its
    # plain version and to the live mirror that K3 kept current
    m5 = build_mirror(st.vol.tsdf, R)
    assert torch.equal(m5.view(torch.int16),
                       build_mirror_plain(st.vol.tsdf, R).view(torch.int16)), \
        "mirror rebuild differs from its plain version"
    assert torch.equal(m5.view(torch.int16), st.logical.view(torch.int16)), \
        "mirror rebuild differs from the tracker's live mirror"
    report(
        "build_mirror", "kintinuous_tpu_torch/csrc/logical.cu",
        "kintinuous_tpu/ops/pallas_raycast.py:86", 0.0,
        lambda: build_mirror(st.vol.tsdf, R, out=m5),
        lambda: build_mirror_plain(st.vol.tsdf, R),
        R ** 3 * 6, R ** 3 * OPS_MIRROR_VOXEL,
        library=lambda: st.vol.tsdf.view(B, B, B, 8, 8, 8).permute(
            0, 3, 1, 4, 2, 5).reshape(R, R, R).to(torch.bfloat16),
    )
    del m5

    # K4 raycast of the tracker's mirror around the measured depth, at each
    # unrolled (window, newton) pair, the tracker's among them, and at
    # pairs that run the kernel's run-time loops
    window, newton = 5, cfg.raycast_newton_iters
    dn, _, t_warm = ray_setup(cam_half, T, depth_half)
    rp = raycast_params(T)

    def k4(fn, pair=(window, newton)):
        return fn(st.logical, t_warm, rp, cam_half, vsz, trunc, *pair)

    pairs_err = {}
    for pair in RAYCAST_PAIRS + RUNTIME_PAIRS:
        ok_k, ok_p = k4(tile_raycast, pair), k4(tile_raycast_plain, pair)
        fk, fp = ok_k[1] > 0.5, ok_p[1] > 0.5
        both = fk & fp
        assert int(fk.sum()) > 0.5 * int((t_warm > 0).sum()), "raycast found few hits"
        pairs_err[f"{pair[0]},{pair[1]}"] = dict(
            found_mismatch=float((fk != fp).float().mean()),
            depth_err=float((ok_k[0] - ok_p[0])[both].abs().max()),
            grad_err=max(float((a - b)[both].abs().max())
                         for a, b in zip(ok_k[2:], ok_p[2:])),
            hits=int(fk.sum()))
        # tolerances: 0.1 % of pixels may flip found (none at the tracker's
        # pair); where both hit, depth within 1 mm (a tenth of a voxel) and
        # gradient within 1e-3
        found_mis, d_err, g_err, _ = pairs_err[f"{pair[0]},{pair[1]}"].values()
        assert found_mis <= 1e-3 and d_err <= 1e-3 and g_err <= 1e-3, \
            (pair, found_mis, d_err, g_err)
    found_mis, d_err, g_err, hits = pairs_err[f"{window},{newton}"].values()
    assert found_mis == 0.0, f"{found_mis} of the pixels flip their hit"
    # least bytes: each pixel's t_warm in and 5 outputs out, plus every
    # distinct mirror voxel that the window's taps read (Newton taps not
    # counted, so this stays a lower bound)
    step = _f32(0.8 * trunc)
    live = t_warm > 0
    idx = []
    o = T[:3, 3]
    for k in range(window):
        t = (t_warm - (window // 2) * step + k * step)[live]
        pos = (o[:, None] + t[None] * dn[:, live]) / vsz - 0.5
        pos = torch.clamp(pos, 0, R - 1.002).floor().long()
        base = (pos[2] * R + pos[1]) * R + pos[0]
        for off in (0, 1, R, R + 1, R * R, R * R + 1, R * R + R, R * R + R + 1):
            idx.append(base + off)
    n_vox = int(torch.unique(torch.cat(idx)).numel())
    n_px = t_warm.numel()
    report(
        "tile_raycast", "kintinuous_tpu_torch/csrc/raycast.cu",
        "kintinuous_tpu/ops/pallas_raycast.py:314", max(d_err, g_err),
        lambda: k4(tile_raycast), lambda: k4(tile_raycast_plain),
        n_px * 24 + n_vox * 2, n_px * (OPS_RAY_PIXEL + OPS_RAY_TAP * (window + newton)),
        found_mismatch=found_mis, depth_err=d_err, grad_err=g_err,
        hits=hits, pixels=n_px, pairs=pairs_err,
        launch_floor_ms=floor["launch_floor_ms"],
        ms_5_3=time_ms(lambda: k4(tile_raycast, (5, 3))),
        ms_warm_l2_5_3=time_ms(lambda: k4(tile_raycast, (5, 3)), mode="warm"),
        host_splits_us=raycast_host_splits(
            lambda: k4(tile_raycast), st.logical, t_warm, rp, cam_half, vsz, trunc,
            window, newton),
    )
    return rows


def track_orbit(cfg, dev, frames, poses, card: str, n_frames: int = ORBIT_FRAMES,
                phase: str = "orbit") -> dict:
    """Phase 2: the tracked orbit, ICP odometry on every frame after the
    first, ping-ponged over the rendered views."""
    import torch

    from kintinuous_tpu_torch.eval.ate import absolute_trajectory_error
    from kintinuous_tpu_torch.tracking.tracker import Tracker

    tr = Tracker(cfg, device=dev)
    gt = []
    t0 = time.perf_counter()
    for i in range(n_frames):
        k = pingpong(i, len(frames))
        tr.process_frame(*frames[k], i * 33333)
        gt.append(poses[k])
    tr.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    stamps = np.arange(len(gt)) * 33333 / 1e6
    ate, n = absolute_trajectory_error(stamps, np.array(gt),
                                       np.array(tr.stamps_us) / 1e6, np.array(tr.poses))
    icp_min = min(tr.stats["icp_count"][-10:])
    res = dict(phase=phase, card=card, frames=n_frames, seconds=elapsed,
               fps=n_frames / elapsed, ate_m=ate, matched=n,
               icp_count_min_last10=icp_min,
               raycast_fallback_mean=float(np.mean(tr.stats["raycast_fallback"])),
               volume_resolution=cfg.volume_resolution,
               keeps_mirror=tr.state.logical is not None)
    print(json.dumps(res), flush=True)
    assert n == n_frames and icp_min > 2000, "ICP lost tracking"
    assert ate < 0.01, f"{phase} ATE {ate * 100:.2f} cm"
    return res


def walk_gt(cfg, dev, card: str, phase: str = "walk") -> tuple:
    """Phase 3: a ground-truth walk of 1.5 m backwards along the optical
    axis. The volume shifts, and the far slabs that leave it cut through
    the objects and the room's back wall, so the slices hold points; the
    objects recede far enough for free space to be carved."""
    import torch

    from kintinuous_tpu_torch.eval.ate import absolute_trajectory_error
    from kintinuous_tpu_torch.io.synth import Scene, render_frame, straight_trajectory
    from kintinuous_tpu_torch.tracking.tracker import Tracker

    poses = straight_trajectory(WALK_FRAMES, distance=-1.5, axis=2)
    frames = [render_frame(Scene.default(), cfg.camera, T) for T in poses]
    tr = Tracker(cfg, device=dev)
    t0 = time.perf_counter()
    for i, T in enumerate(poses):
        tr.process_frame(*frames[i], i * 33333,
                         ext_delta=gt_delta(poses[i - 1] if i else None, T))
    tr.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    stamps = np.arange(WALK_FRAMES) * 33333 / 1e6
    ate, n = absolute_trajectory_error(stamps, np.array(poses),
                                       np.array(tr.stamps_us) / 1e6, np.array(tr.poses))
    n_shifts = sum(1 for s in tr.shift_log if np.any(s != 0))
    points = [len(s.points) for s in tr.slices]
    res = dict(phase=phase, card=card, frames=WALK_FRAMES, seconds=elapsed,
               fps=WALK_FRAMES / elapsed, ate_m=ate, matched=n,
               shift_frames=n_shifts, slice_points=points,
               volume_resolution=cfg.volume_resolution,
               keeps_mirror=tr.state.logical is not None)
    print(json.dumps(res), flush=True)
    assert n_shifts >= 1 and points and min(points) > 0, "no shift or empty slice"
    assert n == WALK_FRAMES and ate < 1e-3, f"{phase} ATE {ate * 1e3:.3f} mm"
    return poses, frames


def engine_cli(cfg, dev, card: str, log_dir: str, batched: bool) -> dict:
    """Phase 4: the port's CLI in process on a depth-only .klg of a walk
    1.2 m backwards (2.5 cm a frame), at config A through its flags
    (--fast -fod -t 16; the camera, volume size and resolution are
    cfg's, 640x480 and 512^3 over 6 m). batched: `cli.main`, the batched
    offline path (one first frame, batches of 8, and the tail); else
    the same configuration with offline_batched=False through
    SlamEngine, the per-frame loop. ICP tracks the walk; its poses are
    held against the ground truth."""
    from kintinuous_tpu_torch import cli
    from kintinuous_tpu_torch.eval.ate import absolute_trajectory_error
    from kintinuous_tpu_torch.io.pcd import load_pcd
    from kintinuous_tpu_torch.io.tum import load_trajectory
    from kintinuous_tpu_torch.runtime.engine import SlamEngine
    from kintinuous_tpu_torch.tracking.tracker import Tracker

    seen = {"batches": 0, "engine": None, "fps": None}
    run, batch = SlamEngine.run, Tracker.process_batch_device

    def run_and_clock(self, *a, **k):
        out = run(self, *a, **k)
        seen["engine"], seen["fps"] = self, self.fps  # the engine's own clock
        return out

    def counted(self, *a, **k):
        seen["batches"] += 1
        return batch(self, *a, **k)

    log, gt = f"{log_dir}/walk.klg", f"{log_dir}/walk.gt"
    base = f"{log_dir}/map_{'batched' if batched else 'per_frame'}"
    argv = ["-l", log, "--fast", "-fod", "-t", "16", "-o", base,
            "-c", f"{log_dir}/calib.txt", "-s", str(cfg.volume_size),
            "--resolution", str(cfg.volume_resolution), "--device", str(dev)]
    SlamEngine.run, Tracker.process_batch_device = run_and_clock, counted
    try:
        t0 = time.perf_counter()
        # the CLI's own lines (progress, stage means) go into this
        # phase's JSON line, beside the card
        with contextlib.redirect_stdout(io.StringIO()) as out:
            if batched:
                rc = cli.main(argv)
            else:
                engine = SlamEngine(cli.build_config(argv).replace(offline_batched=False),
                                    device=dev)
                engine.run()
                engine.save()
                rc = 0
        seconds = time.perf_counter() - t0
    finally:
        SlamEngine.run, Tracker.process_batch_device = run, batch
    est_s, est_p = load_trajectory(f"{base}.poses")
    gt_s, gt_p = load_trajectory(gt)
    ate, n = absolute_trajectory_error(gt_s, gt_p, est_s, est_p)
    n_points = len(load_pcd(f"{base}.pcd")["points"])
    tracker = seen["engine"].tracker
    n_shifts = sum(1 for s in tracker.shift_log if np.any(s != 0))
    stats = seen["engine"].sw.stats()
    res = dict(phase="engine", batched=batched, card=card, frames=ENGINE_FRAMES,
               rc=rc, seconds_with_save=seconds, fps=seen["fps"], poses=len(est_s),
               ate_m=ate, matched=n, shift_frames=n_shifts, pcd_points=n_points,
               batches=seen["batches"],
               span_mean_ms={k: stats[k]["mean_ms"] for k in
                             ("processFrame", "SliceProcessor") if k in stats},
               cli_output=[ln.strip() for ln in out.getvalue().replace("\r", "\n")
                           .splitlines() if ln.strip()][-5:])
    print(json.dumps(res), flush=True)
    assert rc == 0 and len(est_s) == ENGINE_FRAMES and n == ENGINE_FRAMES
    assert ate < 0.01, f"engine ATE {ate * 100:.2f} cm"
    assert n_shifts >= 1 and n_points > 0, "no shift or an empty map"
    if batched:
        assert seen["batches"] > 0, "the batched step was not called"
    else:
        assert seen["batches"] == 0, "the per-frame loop called the batched step"
    return res


def write_engine_log(cfg, log_dir: str) -> None:
    """Phase 4's input: the walk's depth-only .klg, its ground truth and
    a calibration file for the CLI's -c."""
    from kintinuous_tpu_torch.io.synth import generate_klg, straight_trajectory

    poses = straight_trajectory(ENGINE_FRAMES, distance=-1.2, axis=2)
    generate_klg(f"{log_dir}/walk.klg", cfg.camera, poses, gt_path=f"{log_dir}/walk.gt")
    cam = cfg.camera
    with open(f"{log_dir}/calib.txt", "w") as f:
        f.write(f"{cam.fx} {cam.fy} {cam.cx} {cam.cy} {cam.width} {cam.height}\n")


def resume(cfg, dev, poses, frames, card: str, phase: str = "resume") -> dict:
    """Phase 5: replay the walk for RESUME_AT frames, save a checkpoint,
    restore it into a fresh Tracker (the mirror is rebuilt by K5), and
    continue both trackers over the rest of the walk: the restored mirror
    is bit-equal to the live one, and after the rest tsdf and cw are
    bit-equal, wrap and origin equal and the poses within 1e-5. Phase
    10e: the same on the dense path (no mirror)."""
    import tempfile

    import torch

    from kintinuous_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
    from kintinuous_tpu_torch.tracking.tracker import Tracker

    def feed(tr, i0, i1):
        for i in range(i0, i1):
            tr.process_frame(*frames[i], i * 33333,
                             ext_delta=gt_delta(poses[i - 1] if i else None, poses[i]))
        tr.flush()

    a = Tracker(cfg, device=dev)
    feed(a, 0, RESUME_AT)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/resume.npz"
        t0 = time.perf_counter()
        save_checkpoint(path, a)
        t_save = time.perf_counter() - t0
        mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        b = load_checkpoint(path, Tracker(cfg, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_load = time.perf_counter() - t0
    mirror_equal = None
    if a.state.logical is not None:
        mirror_equal = torch.equal(a.state.logical.view(torch.int16),
                                   b.state.logical.view(torch.int16))
        assert mirror_equal, "the restored mirror differs from the live one"
    feed(a, RESUME_AT, len(poses))
    feed(b, RESUME_AT, len(poses))
    va, vb = a.state.vol, b.state.vol
    cw_equal = torch.equal(va.cw, vb.cw)
    origin_equal = torch.equal(va.origin, vb.origin)
    tsdf_equal = torch.equal(va.tsdf.view(torch.int32), vb.tsdf.view(torch.int32))
    wrap_equal = torch.equal(va.wrap, vb.wrap)
    pose_err = float(np.abs(np.array(a.poses) - np.array(b.poses)).max())
    res = dict(phase=phase, card=card, frames=len(poses), resumed_at=RESUME_AT,
               save_s=t_save, load_s=t_load, checkpoint_mb=mb,
               mirror_bit_equal=mirror_equal, cw_bit_equal=cw_equal,
               tsdf_bit_equal=tsdf_equal, wrap_equal=wrap_equal,
               wrap=va.wrap.tolist(), origin_equal=origin_equal,
               pose_max_abs_err=pose_err,
               shift_frames=sum(1 for s in a.shift_log if np.any(s != 0)))
    print(json.dumps(res), flush=True)
    assert tsdf_equal and cw_equal and wrap_equal and origin_equal and pose_err <= 1e-5, \
        "resume is not exact"
    return res


def track_orbit_rgbd(cfg, dev, frames, poses, card: str) -> dict:
    """Phase 6: config B, phase 2's orbit tracked with fused ICP+RGB-D
    odometry on the rendered colour, through Tracker.process_frame (the
    colour goes in directly: a .klg would carry it as JPEG, and the card's
    machine has no JPEG codec). In this mode icp_count is the RGB inlier
    count."""
    import torch

    from kintinuous_tpu_torch.eval.ate import absolute_trajectory_error
    from kintinuous_tpu_torch.tracking.tracker import Tracker

    tr = Tracker(cfg, device=dev)
    gt = []
    t0 = time.perf_counter()
    for i in range(ORBIT_RGBD_FRAMES):
        k = pingpong(i, len(frames))
        tr.process_frame(*frames[k], i * 33333)
        gt.append(poses[k])
    tr.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    stamps = np.arange(len(gt)) * 33333 / 1e6
    ate, n = absolute_trajectory_error(stamps, np.array(gt),
                                       np.array(tr.stamps_us) / 1e6, np.array(tr.poses))
    inliers = tr.stats["icp_count"][1:]  # frame 0 is placed, not tracked
    res = dict(phase="orbit_rgbd", card=card, config="B (A + icp_plus_rgbd)",
               frames=ORBIT_RGBD_FRAMES, seconds=elapsed,
               fps=ORBIT_RGBD_FRAMES / elapsed, ate_m=ate, matched=n,
               rgb_inliers_min=min(inliers),
               rgb_inliers_min_last10=min(inliers[-10:]),
               raycast_fallback_mean=float(np.mean(tr.stats["raycast_fallback"])))
    print(json.dumps(res), flush=True)
    assert n == ORBIT_RGBD_FRAMES and min(inliers) > 0, "RGB-D lost its inliers"
    assert ate < 0.01, f"config B orbit ATE {ate * 100:.2f} cm"
    return res


def engine_mesh(cfg, dev, card: str, log_dir: str) -> dict:
    """Phase 7: the CLI on phase 4's log with meshing (`--fast -fod -t
    16 -m`): band mesh patches on the shifts, and the welded whole-map
    mesh (every patch and the live volume's mesh) in <base>.ply."""
    from kintinuous_tpu_torch import cli
    from kintinuous_tpu_torch.eval.ate import absolute_trajectory_error
    from kintinuous_tpu_torch.io.ply import load_ply
    from kintinuous_tpu_torch.io.tum import load_trajectory
    from kintinuous_tpu_torch.runtime.engine import SlamEngine

    from kintinuous_tpu_torch.tracking.tracker import Tracker

    seen = {}
    run, finalise = SlamEngine.run, Tracker.finalise

    def run_and_clock(self, *a, **k):
        out = run(self, *a, **k)
        seen["engine"], seen["fps"] = self, self.fps
        return out

    def finalise_after_bands(self):
        seen["bands"] = len(self.mesh_patches)  # the patches of the shifts
        return finalise(self)

    base = f"{log_dir}/map_mesh"
    argv = ["-l", f"{log_dir}/walk.klg", "--fast", "-fod", "-t", "16", "-m", "-o", base,
            "-c", f"{log_dir}/calib.txt", "-s", str(cfg.volume_size),
            "--resolution", str(cfg.volume_resolution), "--device", str(dev)]
    SlamEngine.run, Tracker.finalise = run_and_clock, finalise_after_bands
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(argv)
        seconds = time.perf_counter() - t0
    finally:
        SlamEngine.run, Tracker.finalise = run, finalise
    est_s, est_p = load_trajectory(f"{base}.poses")
    gt_s, gt_p = load_trajectory(f"{log_dir}/walk.gt")
    ate, n = absolute_trajectory_error(gt_s, gt_p, est_s, est_p)
    mesh = load_ply(f"{base}.ply")
    tracker = seen["engine"].tracker
    bands = tracker.mesh_patches[:seen["bands"]]
    res = dict(phase="engine_mesh", card=card, frames=ENGINE_FRAMES, rc=rc,
               seconds_with_save=seconds, fps=seen["fps"], poses=len(est_s),
               ate_m=ate, matched=n,
               shift_frames=sum(1 for s in tracker.shift_log if np.any(s != 0)),
               band_patches=len(bands),
               band_faces=[len(p.faces) for p in bands],
               ply_vertices=len(mesh["vertices"]), ply_faces=len(mesh.get("faces", ())))
    print(json.dumps(res), flush=True)
    assert rc == 0 and len(est_s) == ENGINE_FRAMES and n == ENGINE_FRAMES
    assert ate < 0.01, f"meshing engine ATE {ate * 100:.2f} cm"
    assert bands and all(len(p.faces) > 0 for p in bands), "no band mesh patch"
    assert res["ply_faces"] > 0 and np.isfinite(mesh["vertices"]).all(), "empty .ply"
    return res


def check_probes(dev, card: str) -> dict:
    """Phase 8: each probe kernel (P1-P4) against its plain version on
    the tool's inputs, bit for bit, timed (volume cloned outside the
    timed window) beside its bound, its plain version and, where one
    PyTorch call computes the same function (P1, and P4 with n on the
    host), that call. Device times start from a cold L2; the kernel's
    is also taken warm (ms_warm_l2: the clone just written, no flush),
    and host_ms holds the launch work too."""
    import torch

    from kintinuous_tpu_torch.tools import proto_integrate as P

    timer = windows()

    x = P.make_inputs(dev)
    corners = (x.cy, x.cx)
    k = x.ids.shape[0]
    # the redesigned walks at their edges: 0 and 1 rows, 301 (not a
    # multiple of a block's 8 warps), and P4's count clamped to [0, k]
    edges = {}
    for m in (0, 1, 301):
        part = (x.ids[:m], (x.cy[:m], x.cx[:m]), x.img, x.img2)
        edges[f"probe_rows,{m}"] = (P.run_rows, P.run_rows_plain, part[:1])
        edges[f"probe_dma,{m}"] = (P.run_dma, P.run_dma_plain, part)
        edges[f"probe_full,{m}"] = (P.run_full, P.run_full_plain, part)
    # P2's corner off an 8-byte boundary (its 2-byte loads): every row,
    # and rows mixed with aligned ones
    for case, shift in (("cx+1", 1), ("cx+i%5", torch.arange(k, device=dev) % 5)):
        cx = (x.cx + shift).to(torch.int32)
        edges[f"probe_dma,{case}"] = (P.run_dma, P.run_dma_plain,
                                      (x.ids, (x.cy, cx), x.img, x.img2))
    for m in (0, k, k + 5, -3):
        n_m = torch.tensor(m, dtype=torch.int32, device=dev)
        edges[f"probe_dyn,n={m}"] = (
            lambda vol, ids, n_m=n_m: P.run_dyn(n_m, vol, ids),
            lambda vol, ids, n_m=n_m: P.run_dyn_plain(n_m, vol, ids), (x.ids,))
    for case, (kernel, plain, args) in edges.items():
        got, want = x.tsdf.clone(), x.tsdf.clone()
        kernel(got, *args)
        plain(want, *args)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            f"{case} differs from its plain version"
    print(json.dumps({"phase": "probe_edges", "card": card, "bit_exact": list(edges)}),
          flush=True)
    n = torch.tensor(P.N_DYN, dtype=torch.int32, device=dev)
    ones = torch.ones((k, 4, 128), dtype=torch.float32, device=dev)
    ids_l = x.ids.long()
    n_bytes = probe_bytes(x, P.N_DYN)
    rows = {}
    for name, src, kernel, plain, args, library in (
        ("probe_rows", 61, P.run_rows, P.run_rows_plain, (x.ids,),
         lambda vol, ids: vol.index_add_(0, ids_l, ones)),
        ("probe_dma", 118, P.run_dma, P.run_dma_plain,
         (x.ids, corners, x.img, x.img2), None),
        ("probe_full", 180, P.run_full, P.run_full_plain,
         (x.ids, corners, x.img, x.img2), None),
        ("probe_dyn", 200, lambda vol, ids: P.run_dyn(n, vol, ids),
         lambda vol, ids: P.run_dyn_plain(n, vol, ids), (x.ids,),
         lambda vol, ids: vol.index_add_(0, ids_l[:P.N_DYN], ones[:P.N_DYN])),
    ):
        got, want = x.tsdf.clone(), x.tsdf.clone()
        kernel(got, *args)
        plain(want, *args)
        exact = torch.equal(got.view(torch.int32), want.view(torch.int32))
        changed = int((got != x.tsdf).any(dim=(1, 2)).sum())
        err = float((got - want).abs().max())
        assert exact, f"{name} differs from its plain version (max {err})"
        if library is not None:
            lib = x.tsdf.clone()
            library(lib, *args)
            assert torch.equal(lib.view(torch.int32), want.view(torch.int32)), \
                f"{name}: index_add_ differs"
        b_ms, b_by = bound(n_bytes[name], 0)
        ms = P.time_in_place(kernel, x.tsdf, *args)
        row = dict(name=name, route="cuda", source="kintinuous_tpu_torch/csrc/probes.cu",
                   replaces=f"tools/proto_integrate_pallas.py:{src}", max_abs_err=err,
                   ms=ms, plain_ms=P.time_in_place(plain, x.tsdf, *args),
                   bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
                   library_ms=(P.time_in_place(library, x.tsdf, *args)
                               if library is not None else None),
                   card=card, bytes=n_bytes[name], rows_changed=changed,
                   ms_warm_l2=P.time_in_place(kernel, x.tsdf, *args, timer=timer["warm"]),
                   host_ms=P.time_in_place(kernel, x.tsdf, *args, timer=timer["host"]),
                   library_host_ms=(P.time_in_place(library, x.tsdf, *args,
                                                    timer=timer["host"])
                                    if library is not None else None))
        if name == "probe_dma":  # its 2-byte path: every corner off 8 bytes
            row["ms_cx_plus_1"] = P.time_in_place(
                kernel, x.tsdf, x.ids, (x.cy, x.cx + 1), x.img, x.img2)
        rows[name] = row
        print(json.dumps(row), flush=True)
    return rows


def dense_card_vs_cpu(dev, frames, poses, card: str) -> dict:
    """Phase 10a: the dense path's integrate and raycast, one frame on the
    card and on the CPU from the same inputs, at DENSE_CHECK_RESOLUTION
    (6 m, 640x480): a volume fused from three ground-truth views on the
    card, copied to the CPU, then the fourth view fused and raycast on
    both. Held to the CPU tests' tolerances against the JAX package
    (tests/test_torch_dense_ops.py): tsdf within 2e-5, weight bytes
    equal, colour bytes within 1; hit flips at most 0.1 % of pixels,
    depth and vmap within 1e-4 m and normals within 1e-3 where both hit."""
    import torch

    from kintinuous_tpu_torch.config import KintinuousConfig
    from kintinuous_tpu_torch.ops.raycast import raycast
    from kintinuous_tpu_torch.ops.tsdf import VolumeState, integrate
    from kintinuous_tpu_torch.tracking.tracker import Tracker, preprocess_frame

    cfg = KintinuousConfig(volume_resolution=DENSE_CHECK_RESOLUTION)
    tr = Tracker(cfg, device=dev)
    for i in range(3):
        tr.process_frame(*frames[i], i * 33333,
                         ext_delta=gt_delta(poses[i - 1] if i else None, poses[i]))
    tr.flush()
    st = tr.state
    T = st.pose @ torch.from_numpy(gt_delta(poses[2], poses[3])).to(dev)
    d, c = (torch.from_numpy(np.asarray(x)).to(dev) for x in frames[3])
    depth_m, rgb, _, color_w = preprocess_frame(cfg, d, c, half=False)
    inputs = (depth_m, rgb, color_w, T)
    out = []  # the card's, then the CPU's
    for where in (dev, torch.device("cpu")):
        vol = VolumeState(*(x.to(where, copy=True) for x in st.vol))
        dm, rgb, cw, Tw = (x.to(where) for x in inputs)
        t0 = time.perf_counter()
        integrate(vol, cfg.camera, dm, rgb, cw, Tw, cfg.voxel_size, cfg.trunc_dist,
                  float(cfg.max_weight))
        rc = raycast(vol, cfg.camera, Tw, cfg.voxel_size, cfg.volume_size,
                     cfg.trunc_dist, cfg.raycast_step_factor, cfg.raycast_min_range,
                     cfg.raycast_max_range)
        if where.type == "cuda":
            torch.cuda.synchronize(where)
        out.append((vol, rc, time.perf_counter() - t0))
    (vk, rk, sk), (vc, rc_, sc) = out
    t_err = float((vk.tsdf.cpu() - vc.tsdf).abs().max())
    ck = vk.cw.cpu()
    w_mis = int((((ck >> 24) & 0xFF) != ((vc.cw >> 24) & 0xFF)).sum())
    c_err = max(int((((ck >> s) & 0xFF) - ((vc.cw >> s) & 0xFF)).abs().max())
                for s in (0, 8, 16))
    hk, hc = rk.depth.cpu() > 0, rc_.depth > 0
    both = hk & hc
    flips = float((hk != hc).float().mean())
    d_err = float((rk.depth.cpu() - rc_.depth)[both].abs().max())
    v_err = float((rk.vmap.cpu() - rc_.vmap)[:, both].abs().max())
    n_err = float((rk.nmap.cpu() - rc_.nmap)[:, both].abs().max())
    res = dict(phase="dense_card_vs_cpu", card=card, resolution=DENSE_CHECK_RESOLUTION,
               tsdf_max_abs_err=t_err, weight_mismatch=w_mis, colour_max_err=c_err,
               hits=int(hk.sum()), hit_flip_share=flips, depth_max_abs_err=d_err,
               vmap_max_abs_err=v_err, nmap_max_abs_err=n_err,
               card_seconds=sk, cpu_seconds=sc)
    print(json.dumps(res), flush=True)
    assert int(hk.sum()) > 0.5 * hk.numel(), "the dense raycast found few hits"
    assert t_err <= 2e-5 and w_mis == 0 and c_err <= 1, (t_err, w_mis, c_err)
    assert flips <= 1e-3 and d_err <= 1e-4 and v_err <= 1e-4 and n_err <= 1e-3, \
        (flips, d_err, v_err, n_err)
    return res


def dense_orbit(cfg, dev, frames, poses, card: str) -> dict:
    """Phase 10b: phase 2's orbit through the dense step for
    DENSE_ORBIT_FRAMES frames (ICP at full resolution): ATE < 1 cm, ICP
    inliers > 2000; fps and the peak device memory of the run, above
    what was allocated before it (earlier phases' trackers collected
    first: an engine's worker threads hold it in a reference cycle)."""
    import gc

    import torch

    cuda = dev.type == "cuda"
    base = None
    if cuda:
        gc.collect()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    res = track_orbit(cfg, dev, frames, poses, card, DENSE_ORBIT_FRAMES, "dense_orbit")
    if cuda:
        peak = torch.cuda.max_memory_allocated(dev) - base
        print(json.dumps({"phase": "dense_orbit_memory", "card": card,
                          "allocated_before_bytes": base, "peak_above_bytes": peak,
                          "peak_above_gib": peak / 2 ** 30}), flush=True)
        res["peak_memory_bytes"] = peak
    return res


def dense_cli(cfg, dev, card: str, log_dir: str) -> dict:
    """Phase 10d: the CLI without --fast on phase 4's log with meshing
    (`-m`, the README's headline run less -od), the dense path frame by
    frame: 48 poses with ATE < 1 cm, a .pcd with points and a .ply with
    faces."""
    from kintinuous_tpu_torch import cli
    from kintinuous_tpu_torch.eval.ate import absolute_trajectory_error
    from kintinuous_tpu_torch.io.pcd import load_pcd
    from kintinuous_tpu_torch.io.ply import load_ply
    from kintinuous_tpu_torch.io.tum import load_trajectory

    base = f"{log_dir}/map_dense"
    argv = ["-l", f"{log_dir}/walk.klg", "-m", "-o", base, "-c", f"{log_dir}/calib.txt",
            "-s", str(cfg.volume_size), "--resolution", str(cfg.volume_resolution),
            "--device", str(dev)]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    est_s, est_p = load_trajectory(f"{base}.poses")
    ate, n = absolute_trajectory_error(*load_trajectory(f"{log_dir}/walk.gt"), est_s, est_p)
    mesh = load_ply(f"{base}.ply")
    res = dict(phase="dense_cli", card=card, argv=" ".join(argv[:3]) + " ...", rc=rc,
               frames=ENGINE_FRAMES, seconds_with_save=seconds, poses=len(est_s),
               ate_m=ate, matched=n, pcd_points=len(load_pcd(f"{base}.pcd")["points"]),
               ply_vertices=len(mesh["vertices"]), ply_faces=len(mesh.get("faces", ())),
               cli_output=[ln.strip() for ln in out.getvalue().replace("\r", "\n")
                           .splitlines() if ln.strip()][-4:])
    print(json.dumps(res), flush=True)
    assert rc == 0 and len(est_s) == ENGINE_FRAMES and n == ENGINE_FRAMES
    assert ate < 0.01, f"dense CLI ATE {ate * 100:.2f} cm"
    assert res["pcd_points"] > 0 and res["ply_faces"] > 0, "empty map or mesh"
    return res


def profile_orbit(cfg, dev, frames, card: str, n: int, phase: str = "profile",
                  warm: int = 8) -> dict:
    """Where a tracked orbit frame's time goes: `warm` warm-up frames, `n`
    frames timed on the host clock, then `n` more under torch.profiler."""
    import torch

    from kintinuous_tpu_torch.tracking.tracker import Tracker

    tr = Tracker(cfg, device=dev)

    def frames_through(i0, i1):
        for i in range(i0, i1):
            tr.process_frame(*frames[pingpong(i, len(frames))], i * 33333)
        tr.flush()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    frames_through(0, warm)
    t0 = time.perf_counter()
    frames_through(warm, warm + n)
    plain_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        frames_through(warm + n, warm + 2 * n)
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = defaultdict(lambda: [0, 0.0])  # name -> [count, us]
    spans = []
    stage_us = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in STAGES:
            # device-side events: kernels, copies and fills (a range's own
            # annotation on the device timeline carries its stage name)
            kernels[e.name][0] += 1
            kernels[e.name][1] += e.time_range.elapsed_us()
            spans.append((e.time_range.start, e.time_range.end))
        elif e.name in STAGES and e.device_type == torch.autograd.DeviceType.CPU:
            stage_us[e.name] += e.time_range.elapsed_us()
    busy_us = 0.0
    end = -np.inf
    for s, t in sorted(spans):  # union of kernel intervals
        if t > end:
            busy_us += t - max(s, end)
            end = t
    busy = busy_us / 1e3 if spans else None
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    res = dict(
        phase=phase, card=card, frames=n,
        host_ms_per_frame=plain_ms / n,
        traced_host_ms_per_frame=wall_ms / n,
        device_busy_ms_per_frame=busy / n if spans else None,
        # device work per frame does not change under the profiler, the
        # host's does: the idle share of an untraced frame, and of the
        # traced window itself
        device_idle_share=1.0 - busy / plain_ms if spans else None,
        device_idle_share_traced=1.0 - busy / wall_ms if spans else None,
        kernel_launches_per_frame=sum(c for c, _ in kernels.values()) / n,
        stage_host_ms_per_frame={k: stage_us[k] / 1e3 / n for k in STAGES},
        top_kernels=[{"name": k[:80], "per_frame": c / n, "ms_per_frame": us / 1e3 / n}
                     for k, (c, us) in top],
    )
    print(json.dumps(res), flush=True)
    return res


# ------------------------------------------------------------- phase 11

class LapLog:
    """Phase 11's input: bench C's lap (`lap_scene(3.2, 2.4)`,
    `lap_trajectory(**LAP_KW)`, 6 mm depth noise) at the camera's width,
    rendered by io/synth.render_frames over a pool of one process a core
    into a .klg, before any timed phase runs. The card's machine has no
    JPEG codec, so the colour is written uncompressed
    (io/klg._encode_rgb is replaced by the raw bytes while the log is
    written; phase 11 reads them back with a reshape in place of
    io/klg._decode_rgb)."""

    def __init__(self, cam, log_dir: str):
        import multiprocessing

        from kintinuous_tpu_torch.io import klg
        from kintinuous_tpu_torch.io.synth import lap_scene, lap_trajectory, render_frames
        from kintinuous_tpu_torch.io.tum import save_trajectory

        self.path, self.gt = f"{log_dir}/lap.klg", f"{log_dir}/lap.gt"
        self.poses = lap_trajectory(**LAP_KW)
        t0 = time.perf_counter()
        encode = klg._encode_rgb
        klg._encode_rgb = lambda rgb, quality=90: np.ascontiguousarray(rgb).tobytes()
        try:
            with multiprocessing.get_context("spawn").Pool(os.cpu_count()) as pool, \
                    klg.KlgLogWriter(self.path) as w:
                frames = render_frames(cam, self.poses,
                                       lap_scene(LAP_KW["length"], LAP_KW["depth"]),
                                       LAP_NOISE_MM, lambda f, it: pool.imap(f, it, chunksize=2))
                for i, (depth, rgb) in enumerate(frames):
                    w.write(int(i * 1e6 / 30.0), depth, rgb)
        finally:
            klg._encode_rgb = encode
        save_trajectory(self.gt, [i / 30.0 for i in range(len(self.poses))], self.poses)
        self.seconds = time.perf_counter() - t0


def _same_backend(a, b) -> dict:
    """Which -od fields of two engines are equal: pose graph, deformation
    graph, map-deformation bookkeeping, keyframe ring, vocabulary."""
    ga, gb, da, db = a.deformation.graph, b.deformation.graph, a.deformation.dgraph, \
        b.deformation.dgraph
    pa, pb = a.place_rec, b.place_rec
    return {
        "pose_graph": (ga.times == gb.times and ga._fi == gb._fi and ga._fj == gb._fj
                       and ga._fw == gb._fw and ga._floop == gb._floop
                       and np.array_equal(np.array(ga.poses), np.array(gb.poses))
                       and np.array_equal(np.array(ga._fZ), np.array(gb._fZ))),
        "deformation_graph": (da.times == db.times
                              and np.array_equal(np.array(da.g), np.array(db.g))
                              and np.array_equal(da.A, db.A) and np.array_equal(da.t, db.t)),
        "map_deformation": ((a.deformation.n_loops_accepted, a.deformation.n_loops_rejected,
                             len(a.deformation.slices), len(a.deformation.mesh_patches),
                             sorted(a.deformation._raw_pose))
                            == (b.deformation.n_loops_accepted, b.deformation.n_loops_rejected,
                                len(b.deformation.slices), len(b.deformation.mesh_patches),
                                sorted(b.deformation._raw_pose))),
        "keyframes": (len(pa.keyframes) == len(pb.keyframes) and all(
            (x.kf_id, x.timestamp_us, x.depth_z, x.rgb_jpg) == (y.kf_id, y.timestamp_us,
                                                                 y.depth_z, y.rgb_jpg)
            and np.array_equal(x.descriptors, y.descriptors)
            and np.array_equal(x.keypoints, y.keypoints)
            and np.array_equal(x.points3d, y.points3d, equal_nan=True)
            and np.array_equal(x.pose, y.pose)
            for x, y in zip(pa.keyframes, pb.keyframes))
            and (pa._next_kf_id, pa._last_loop_time_us) == (pb._next_kf_id,
                                                            pb._last_loop_time_us)),
        "vocabulary": np.array_equal(pa.vocab.centroids, pb.vocab.centroids),
    }


def od_card_vs_cpu(engine, seen: dict, dev, frame_rgb) -> dict:
    """The -od backend on the card against the CPU: the ORB on one lap
    frame (the same keypoints; descriptors equal on >= 99 % of bits), the
    run's last dense loop refinement redone on both (within 1e-4 m and
    1e-3 degrees), the run's final pose graph optimised 10 more iterations (poses within
    1e-4), the final deformation graph applied to the deformed map
    (within 1e-4 m), and the run's last deformation solve redone from
    its inputs: the card's float32 answer may lie no farther from the
    CPU's than the CPU's float32 answer lies from its float64 one, plus
    1e-4 m (the solve's CG leaves weakly constrained directions where
    rounding puts them)."""
    import copy

    import torch

    from kintinuous_tpu_torch.backend import deformation as dgmod
    from kintinuous_tpu_torch.backend import place_recognition as prmod
    from kintinuous_tpu_torch.backend.features import orb_keypoints, rgb_to_gray

    cpu = torch.device("cpu")
    rgb = torch.from_numpy(frame_rgb)
    k, c = orb_keypoints(rgb_to_gray(rgb.to(dev))), orb_keypoints(rgb_to_gray(rgb))
    same_kp = torch.equal(k["pts"].cpu(), c["pts"]) and torch.equal(k["octave"].cpu(),
                                                                      c["octave"])
    bits_equal = 1.0 - float(np.unpackbits(k["desc"].cpu().numpy() ^ c["desc"].numpy()).mean()) \
        if same_kp else 0.0
    refine_m = refine_deg = float("inf")  # no loop reached the refinement
    if seen["refine_last"] is not None:
        cfg_, d1, d2, T0, a = seen["refine_last"]
        E = np.linalg.inv(prmod.refine_loop(cfg_, d1, d2, T0, dev, *a)[0]) \
            @ prmod.refine_loop(cfg_, d1, d2, T0, cpu, *a)[0]
        refine_m = float(np.linalg.norm(E[:3, 3]))
        refine_deg = float(np.degrees(np.arccos(np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1))))
    md = engine.deformation
    pg_cpu = copy.copy(md.graph)
    pg_cpu.device = cpu
    pk, ck = md.graph.solve(10)
    pc, cc = pg_cpu.solve(10)
    pg_diff = float((pk.cpu() - pc).abs().max())
    dg = md.dgraph
    pts = np.concatenate([s.processed["points"] for s in md.slices])[::7].astype(np.float64)
    ts = np.concatenate([np.full(len(s.processed["points"]), s.timestamp_us)
                         for s in md.slices])[::7]
    bind = dg.bind(pts, ts)
    applied_k = dg.apply(pts, bind)
    dg_cpu = copy.copy(dg)
    dg_cpu.device = cpu
    apply_diff = float(np.abs(applied_k - dg_cpu.apply(pts, bind)).max())
    # the last solve, redone from its inputs; each answer applied to its
    # constraints' source points
    *inputs, iters = seen["dg_last"]
    sols = {}
    for name, d, dt in (("card", dev, torch.float32), ("cpu", cpu, torch.float32),
                        ("cpu_f64", cpu, torch.float64)):
        A, t, g, e_j, e_k, c_v, c_q, c_ids, c_w, c_on = (
            x.to(d, dt) if x.is_floating_point() else x.to(d) for x in inputs)
        Ai, ti, _ = dgmod.gn_core(A, t, g, e_j, e_k, c_v, c_q, c_ids, c_w, c_on, iters)
        sols[name] = dgmod.deform(Ai, ti, g, c_v, c_ids, c_w).double().cpu().numpy()
    solve_diff = float(np.abs(sols["card"] - sols["cpu"]).max())
    f32_spread = float(np.abs(sols["cpu"] - sols["cpu_f64"]).max())
    return dict(orb_keypoints=len(c["pts"]), orb_same_keypoints=same_kp,
                orb_descriptor_bits_equal=bits_equal, refine_max_diff_m=refine_m,
                refine_max_diff_deg=refine_deg, pose_graph_nodes=len(md.graph.poses),
                pose_graph_max_diff=pg_diff, pose_graph_chi2=(float(ck), float(cc)),
                deform_apply_points=len(pts), deform_apply_max_diff_m=apply_diff,
                deform_solve_constraints=len(sols["cpu"]), deform_solve_max_diff_m=solve_diff, deform_solve_f32_vs_f64_cpu_m=f32_spread)


def _true_relative(gs, gp, e) -> np.ndarray:
    """The ground truth's pose of a loop's second keyframe in its first's."""
    P1, P2 = (gp[int(np.argmin(np.abs(np.asarray(gs) - e[k] / 1e6)))]
              for k in ("kf_t1", "kf_t2"))
    return np.linalg.inv(P1) @ P2


def replay_loops(tr, md, gs, gp, dev, exact: bool) -> float:
    """The run's pose graph rebuilt from the tracker's poses, each loop
    attempt added after as many nodes as the run had then, optimised as
    the run optimised it (10 iterations; a rejected loop removed, the
    poses restored, 5 more), with the accepted loops' relative poses as
    place recognition measured them or, `exact`, the ground truth's.
    Returns the ATE of the rebuilt graph's poses."""
    from kintinuous_tpu_torch.backend.pose_graph import PoseGraph
    from kintinuous_tpu_torch.eval.ate import absolute_trajectory_error

    g = PoseGraph(device=dev)
    stamps, poses = list(tr.stamps_us), [np.asarray(T, np.float64) for T in tr.poses]
    added = 0

    def grow(n):
        nonlocal added
        for k in range(added, n):
            if k == 0:
                g.add_node(stamps[0], poses[0])
            else:
                g.add_odometry(stamps[k - 1], stamps[k], np.linalg.inv(poses[k - 1]) @ poses[k])
        added = max(added, n)

    for e in md.loop_log:
        grow(e["n_nodes"])
        T = np.asarray(e["T_1_2"], np.float64)
        if exact and e["accepted"]:
            T = _true_relative(gs, gp, e)
        old = [P.copy() for P in g.poses]
        fid = g.add_loop(e["t1"], e["t2"], T)
        g.optimise(iters=10)
        if not e["accepted"]:
            g.remove_factor(fid)
            g.poses[:] = old
            g.optimise(iters=5)
    grow(len(poses))
    return absolute_trajectory_error(gs, gp, np.asarray(g.times) / 1e6, np.array(g.poses))[0]


def od_lap(cfg, dev, card: str, lap: LapLog, log_dir: str) -> dict:
    """Phase 11: online deformation on bench C's lap (bench.py:164-209,
    274-340) at config A with its dynamic cube, 640x480, 512^3 over 6 m:
    the CLI in process, batched, `--fast -fod -t 16 -d -dc -ri -od -m -lt
    0 --prior 0.01`, fed the lap's uncompressed colour (io/klg._decode_rgb
    replaced by a reshape of the raw bytes, standing in for the JPEG
    codec the card's machine lacks; without it the reader raises). Then
    the -od backend on the card against the CPU (od_card_vs_cpu) and an
    -od engine checkpoint restored into a fresh engine."""
    import gc

    import torch

    from kintinuous_tpu_torch import cli
    from kintinuous_tpu_torch.backend import deformation as dgmod
    from kintinuous_tpu_torch.backend import place_recognition as prmod
    from kintinuous_tpu_torch.backend import pose_graph as pgmod
    from kintinuous_tpu_torch.eval.ate import absolute_trajectory_error
    from kintinuous_tpu_torch.eval.loop_gate import tag_loop_log
    from kintinuous_tpu_torch.io import klg
    from kintinuous_tpu_torch.io.pcd import load_pcd
    from kintinuous_tpu_torch.io.ply import load_ply
    from kintinuous_tpu_torch.io.synth import lap_scene, render_frame
    from kintinuous_tpu_torch.io.tum import load_trajectory
    from kintinuous_tpu_torch.runtime import checkpoint as pck
    from kintinuous_tpu_torch.runtime.engine import SlamEngine

    cam = cfg.camera
    seen = {"orb_ms": [], "refine_ms": [], "orb": set(), "refine": set(), "pg": set(),
            "dg": set(), "dg_last": None, "refine_last": None}
    detect, refine, pg_core, dg_core, decode, save = (
        prmod.detect_orb, prmod.refine_loop, pgmod.gn_core, dgmod.gn_core, klg._decode_rgb,
        SlamEngine.save)

    def orb(gray, *a, **k):
        seen["orb"].add(gray.device.type)
        t0 = time.perf_counter()
        out = detect(gray, *a, **k)  # returns host arrays: the time is the detector's
        seen["orb_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def dense(cfg_, d1, d2, T, device, *a):
        seen["refine"].add(torch.device(device).type)
        seen["refine_last"] = (cfg_, d1, d2, T, a)
        t0 = time.perf_counter()
        out = refine(cfg_, d1, d2, T, device, *a)  # returns a host array: the time is the ICP's
        seen["refine_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def pg(poses, *a, **k):
        seen["pg"].add(poses.device.type)
        return pg_core(poses, *a, **k)

    def dg(*a):
        seen["dg"].add(a[0].device.type)
        seen["dg_last"] = [x.clone() if torch.is_tensor(x) else x for x in a]
        return dg_core(*a)

    def raw(buf):
        return np.frombuffer(buf, np.uint8).reshape(cam.height, cam.width, 3)

    def keep(self, *a, **k):
        seen["engine"], seen["fps"] = self, self.fps
        return save(self, *a, **k)

    base = f"{log_dir}/od_lap"
    argv = ["-l", lap.path, "--fast", "-fod", "-t", "16", "-d", "-dc", "-ri", "-od", "-m",
            "-lt", "0", "--prior", "0.01", "-o", base, "-c", f"{log_dir}/calib.txt",
            "-s", str(cfg.volume_size), "--resolution", str(cfg.volume_resolution),
            "--device", str(dev)]
    cuda = dev.type == "cuda"
    gc.collect()
    mem0 = torch.cuda.memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prmod.detect_orb, prmod.refine_loop, pgmod.gn_core, dgmod.gn_core = orb, dense, pg, dg
    klg._decode_rgb, SlamEngine.save = raw, keep
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = cli.main(argv)
        seconds = time.perf_counter() - t0
    finally:
        prmod.detect_orb, prmod.refine_loop, pgmod.gn_core, dgmod.gn_core = (
            detect, refine, pg_core, dg_core)
        klg._decode_rgb, SlamEngine.save = decode, save
    peak = torch.cuda.max_memory_allocated(dev) - mem0 if cuda else None
    engine = seen["engine"]
    tr, md, pr = engine.tracker, engine.deformation, engine.place_rec
    gs, gp = load_trajectory(lap.gt)
    ate_pre, _ = absolute_trajectory_error(gs, gp, np.array(tr.stamps_us) / 1e6,
                                           np.array(tr.poses))
    es, ep = load_trajectory(f"{base}.poses")
    ate_final, n = absolute_trajectory_error(gs, gp, es, ep)
    gate = tag_loop_log(md.loop_log, gs, gp)
    n_points = len(load_pcd(f"{base}_opt.pcd")["points"])
    mesh = load_ply(f"{base}_opt.ply")
    stats = engine.sw.stats()
    orb_ms, refine_ms = seen["orb_ms"], seen["refine_ms"]
    res = dict(phase="od_lap", card=card, frames=len(lap.poses), rc=rc,
               render_seconds=lap.seconds, seconds_with_save=seconds, fps=seen["fps"],
               poses=len(es), matched=n, ate_preloop_m=ate_pre, ate_final_m=ate_final,
               shift_frames=sum(1 for s in tr.shift_log if np.any(s != 0)),
               loops_accepted=md.n_loops_accepted, loops_rejected=md.n_loops_rejected,
               pr_gates=dict(pr.gate_stats), loop_gate=gate,
               loop_error_median_m=statistics.median(
                   [e["gt_error_m"] for e in md.loop_log
                    if e["accepted"] and e.get("gt_error_m") is not None] or [0.0]),
               keyframes_taken=pr.gate_stats["keyframes"],
               keyframes_dropped=engine.keyframes_dropped,
               span_mean_ms={k: stats[k]["mean_ms"] for k in
                             ("processFrame", "SliceProcessor", "PlaceRecognition",
                              "Deformation") if k in stats},
               span_count={k: stats[k]["count"] for k in ("PlaceRecognition", "Deformation")
                           if k in stats},
               orb_ms_mean=statistics.mean(orb_ms) if orb_ms else None,
               orb_ms_median=statistics.median(orb_ms) if orb_ms else None,
               orb_ms_max=max(orb_ms) if orb_ms else None,
               refine_ms=refine_ms,
               backend_devices={k: sorted(seen[k]) for k in ("orb", "refine", "pg", "dg")},
               peak_memory_above_bytes=peak,
               peak_memory_above_gib=peak / 2 ** 30 if cuda else None,
               opt_pcd_points=n_points, opt_ply_vertices=len(mesh["vertices"]),
               opt_ply_faces=len(mesh.get("faces", ())),
               cli_output=[ln.strip() for ln in out.getvalue().replace("\r", "\n")
                           .splitlines() if ln.strip()][-6:])
    print(json.dumps({"phase": "od_lap_orb_ms", "card": card, "per_keyframe": orb_ms}),
          flush=True)
    # each loop attempt: the gate's delta-chi2, the correction, the
    # decision and the candidate's error against the ground truth
    print(json.dumps({"phase": "od_lap_loops", "card": card, "attempts": [
        {k: e.get(k) for k in ("kf_t1", "kf_t2", "chi2_delta", "max_node_delta_m", "accepted",
                               "gt_error_m", "gt_rot_err_deg")} for e in md.loop_log]}),
          flush=True)
    # the run's graph rebuilt with the measured loops and with exact ones
    res.update(ate_final_replayed_m=replay_loops(tr, md, gs, gp, dev, exact=False),
               ate_final_exact_loops_m=replay_loops(tr, md, gs, gp, dev, exact=True))
    frame = render_frame(lap_scene(LAP_KW["length"], LAP_KW["depth"]), cam,
                         lap.poses[ORB_CHECK_FRAME])[1]
    res["card_vs_cpu"] = od_card_vs_cpu(engine, seen, dev, frame)
    # an -od engine checkpoint, restored into a fresh engine
    ck = f"{log_dir}/od_lap.npz"
    t0 = time.perf_counter()
    pck.save_engine_checkpoint(ck, engine)
    t1 = time.perf_counter()
    fresh = SlamEngine(engine.cfg, device=dev)
    pck.load_engine_checkpoint(ck, fresh)
    t2 = time.perf_counter()
    res["checkpoint"] = dict(bytes=os.path.getsize(ck), save_s=t1 - t0, load_s=t2 - t1,
                             equal=_same_backend(engine, fresh))
    del fresh
    os.remove(ck)
    print(json.dumps(res), flush=True)
    cv = res["card_vs_cpu"]
    assert rc == 0 and len(es) == len(lap.poses) == LAP_FRAMES and n == LAP_FRAMES
    assert res["shift_frames"] > 0, "the lap never shifted the volume"
    assert md.n_loops_accepted >= 1, f"no loop accepted: {pr.gate_stats}"
    # every accepted loop is genuine (within 0.35 m of the ground truth)
    assert gate["loop_gate_precision"] == 1.0, gate
    assert n_points > 0 and res["opt_ply_faces"] > 0, "empty _opt.pcd or _opt.ply"
    assert all(v == [dev.type] for v in res["backend_devices"].values()), res["backend_devices"]
    assert cv["orb_same_keypoints"] and cv["orb_descriptor_bits_equal"] >= 0.99, cv
    assert cv["refine_max_diff_m"] <= 1e-4 and cv["refine_max_diff_deg"] <= 1e-3, cv
    assert cv["pose_graph_max_diff"] <= 1e-4, cv
    assert cv["deform_apply_max_diff_m"] <= 1e-4, cv
    assert cv["deform_solve_max_diff_m"] <= cv["deform_solve_f32_vs_f64_cpu_m"] + 1e-4, cv
    assert all(res["checkpoint"]["equal"].values()), res["checkpoint"]
    # the same graph, its accepted loops given the truth's relative poses
    check(res["ate_final_exact_loops_m"] < ate_pre,
          f"exact loops did not pay: {ate_pre} -> {res['ate_final_exact_loops_m']} m")
    # the correction pays: the deformed trajectory is nearer the truth
    check(ate_final < ate_pre, f"deformation did not pay: {ate_pre} -> {ate_final} m")
    return res


def run(cfg, dev, card: str = "", trace_frames: int = 0) -> list:
    """All phases on `dev`; returns the kernel rows with the launch
    counts of the paths phases 2-11 drive (each engine run is a path)."""
    import tempfile

    from kintinuous_tpu_torch.io.synth import Scene, orbit_trajectory, render_frame
    from kintinuous_tpu_torch.ops.cuda_integrate import band_fusion, free_carve
    from kintinuous_tpu_torch.ops.cuda_raycast import (
        build_mirror, mirror_refresh, tile_raycast)
    from kintinuous_tpu_torch.tools import proto_integrate as P

    wrappers = {"band_fusion": band_fusion, "free_carve": free_carve,
                "mirror_refresh": mirror_refresh, "build_mirror": build_mirror,
                "tile_raycast": tile_raycast, "probe_rows": P.run_rows,
                "probe_dma": P.run_dma, "probe_full": P.run_full,
                "probe_dyn": P.run_dyn}
    log_dir = tempfile.TemporaryDirectory()
    d = log_dir.name
    try:
        # phase 11's lap, rendered on every core before any timed phase
        lap = LapLog(cfg.camera, d)
        poses = orbit_trajectory(12, radius=0.06, angle_deg=3.0)
        # the bare room leaves free space in front of its walls: the carve
        # gets blocks to work on (the default scene's objects sit too close
        # to the camera for any block to classify as free)
        room = [render_frame(Scene(), cfg.camera, T) for T in poses[:5]]
        rows = check_kernels(cfg, dev, room, poses, card)
        frames = [render_frame(Scene.default(), cfg.camera, T) for T in poses]
        return run_paths(cfg, dev, card, trace_frames, wrappers, rows, frames, poses, lap,
                         d)
    finally:
        log_dir.cleanup()


def run_paths(cfg, dev, card, trace_frames, wrappers, rows, frames, poses, lap, d) -> list:
    """Phases 2-11, each path with the launch counts set to 0 just before
    it and read just after."""
    from kintinuous_tpu_torch.backend import native_ops
    from kintinuous_tpu_torch.config import KintinuousConfig
    from kintinuous_tpu_torch.tools import proto_integrate as P
    from kintinuous_tpu_torch.tracking.tracker import keeps_mirror


    # each path runs with the counts set to 0 just before it, read just after
    by_path = {}

    def counted(path, fn, *args):
        for w in wrappers.values():
            w.launches = 0
        out = fn(*args)
        by_path[path] = {name: w.launches for name, w in wrappers.items()}
        return out

    counted("orbit", track_orbit, cfg, dev, frames, poses, card)
    walk_poses, walk_frames = counted("walk", walk_gt, cfg, dev, card)
    # the slice processor's native library is built before the engine
    # runs, so none of them pays for the build
    native_ops.available()
    write_engine_log(cfg, d)
    # batched and per frame, in the order A B B A, so that a drift of
    # the host's speed during the phase falls on both alike
    for path, batched in ENGINE_RUNS:
        counted(path, engine_cli, cfg, dev, card, d, batched)
    counted("resume", resume, cfg, dev, walk_poses, walk_frames, card)
    counted("orbit_rgbd", track_orbit_rgbd, cfg.replace(icp_plus_rgbd=True), dev,
            frames, poses, card)
    counted("engine_mesh", engine_mesh, cfg, dev, card, d)
    # the probe tool's own entry point at its shapes
    with contextlib.redirect_stdout(io.StringIO()) as out:
        counted("probe_tool", P.main, ["--device", str(dev)])
    print(json.dumps({"phase": "probe_tool", "card": card,
                      "output": out.getvalue().splitlines()}), flush=True)
    rows.update(check_probes(dev, card))
    # an odd block count: no mirror, K5 in every raycast
    odd = cfg.replace(volume_resolution=ODD_RESOLUTION)
    assert not keeps_mirror(odd)
    counted("odd_orbit", track_orbit, odd, dev, frames, poses, card, ODD_ORBIT_FRAMES,
            "odd_orbit")
    counted("odd_walk", walk_gt, odd, dev, card, "odd_walk")
    # the dense path (no --fast): plain PyTorch, none of the kernels
    dense = KintinuousConfig()
    assert not dense.fast_mode
    counted("dense_check", dense_card_vs_cpu, dev, frames, poses, card)
    counted("dense_orbit", dense_orbit, dense, dev, frames, poses, card)
    counted("dense_profile", profile_orbit, dense, dev, frames, card, DENSE_TRACE_FRAMES,
            "dense_profile", 2)
    counted("dense_walk", walk_gt, dense, dev, card, "dense_walk")
    counted("dense_cli", dense_cli, dense, dev, card, d)
    counted("dense_resume", resume, dense, dev, walk_poses, walk_frames, card,
            "dense_resume")
    # online deformation on bench C's lap
    counted("od_lap", od_lap, cfg, dev, card, lap, d)
    for path in DENSE_PATHS:
        launched = {k: n for k, n in by_path[path].items() if n}
        assert not launched, f"the {path} path launched {launched}"
    for path in ("orbit", "walk", "orbit_rgbd", "engine_mesh", "od_lap") + tuple(
            p for p, _ in ENGINE_RUNS):
        # K1-K4 run on every frame
        for name in ("band_fusion", "free_carve", "mirror_refresh", "tile_raycast"):
            assert by_path[path][name] > 0, f"{name} was not launched on the {path} path"
    assert by_path["resume"]["build_mirror"] > 0, "restore did not launch the rebuild"
    for path, n_frames in (("odd_orbit", ODD_ORBIT_FRAMES), ("odd_walk", WALK_FRAMES)):
        # one launch a frame of K1, K2, K4 and the rebuild (K5), none of K3
        for name in ("band_fusion", "free_carve", "tile_raycast", "build_mirror"):
            assert by_path[path][name] == n_frames, \
                f"{name} launched {by_path[path][name]} times in {n_frames} {path} frames"
        assert by_path[path]["mirror_refresh"] == 0, f"the {path} path refreshed a mirror"
    for name in ("probe_rows", "probe_dma", "probe_full", "probe_dyn"):
        assert by_path["probe_tool"][name] > 0, f"the probe tool did not launch {name}"
    for name in wrappers:
        rows[name]["launches"] = sum(p[name] for p in by_path.values())
        rows[name]["launches_by_path"] = {k: p[name] for k, p in by_path.items()}
    if trace_frames:
        profile_orbit(cfg, dev, frames, card, trace_frames)
    return [rows[name] for name in wrappers]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", type=int, default=0, metavar="FRAMES",
                    help="profile this many tracked orbit frames after the checks")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from kintinuous_tpu_torch.config import KintinuousConfig
        from kintinuous_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: run from the repository's root ({e})", file=sys.stderr)
        return 2

    card = card_line()
    t0 = time.perf_counter()
    took = kernels.build()
    print(json.dumps({"build_seconds": time.perf_counter() - t0,
                      "per_source": took, "card": card}), flush=True)
    cfg = KintinuousConfig(fast_mode=True, voxel_shift=16, fast_odometry=True,
                           extraction_capacity=500_000)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rows = run(cfg, dev, card, args.trace)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    if FAILED:
        print(f"chip_smoke: {len(FAILED)} check(s) failed: {FAILED}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
