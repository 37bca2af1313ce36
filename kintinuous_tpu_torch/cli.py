"""Command-line interface of the PyTorch/CUDA port, flag for flag the
JAX package's (kintinuous_tpu/cli.py):

    -l  <log.klg>      input log
    -live <addr>       live capture                       (not ported)
    -p  <traj>         ground-truth trajectory replay
    -v  <vocab.npy>    BoW vocabulary (used only with -od; one trained by the
                       port's detector, features.train_vocab_from_klg)
    -c  <calib>        calibration: "fx fy cx cy [w h]" text file
    -s  <m>            volume size (default 6)
    -t  <voxels>       shift threshold in voxels (default 14, clamp 1-16)
    -n  <frames>       frame limit
    -cw <n>            extracted-point weight cull (default 8)
    -lt <s>            loop throttle seconds (default 30)
    -dg <m>            deformation-graph sampling rate
    -il <ratio>        registration inlier-ratio gate (default 0.35)
    -it <thresh>       pose-graph residual gate (default 10)
    -f                 flip RGB/BGR colours at ingest
    -sm                static mode (no shifting)
    -m                 mesh output (<basename>.ply; <basename>_opt.ply with -od)
    -od                online deformation (loop closure)
    -no                disable shift-overlap extraction
    -nos               disable overlap removal on save
    -r                 RGB-D odometry
    -ri                fused ICP + RGB-D odometry
    -ftf               frame-to-frame RGB-D
    -fod               fast odometry
    -fl                fast loops
    -d                 dynamic cube positioning
    -dc                disable colour view-angle weighting
    -o  <basename>     output basename (default "output")

and --fast (the blocked fast path with the CUDA kernels and batched
offline dispatch; without it the dense path runs, frame by frame, as
the JAX CLI's default), --resolution, --trunc, --frame-limit, --prior,
--profile-dir (a torch.profiler chrome trace), --dump-tsdf, --devices
(1 only), --num-processes (1 only), --viz-port (not ported), and
--device (cpu to run the kernels' plain PyTorch versions; default the
CUDA card).

Usage: python -m kintinuous_tpu_torch.cli -l seq.klg [--fast] [-m] -o map
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np

from kintinuous_tpu_torch.config import CameraIntrinsics, KintinuousConfig


def load_calibration(path: str, width=640, height=480) -> CameraIntrinsics:
    """Parses the text calibration `fx fy cx cy [w h]`."""
    with open(path) as f:
        vals = [float(v) for v in f.read().replace(",", " ").split()]
    if len(vals) >= 6:
        width, height = int(vals[4]), int(vals[5])
    return CameraIntrinsics(fx=vals[0], fy=vals[1], cx=vals[2], cy=vals[3],
                            width=width, height=height)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kintinuous_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("-l", dest="log_file")
    p.add_argument("-live", dest="live_source")
    p.add_argument("-p", dest="trajectory_file")
    p.add_argument("-v", dest="vocab_file")
    p.add_argument("-c", dest="calibration")
    p.add_argument("-s", dest="volume_size", type=float, default=6.0)
    p.add_argument("-t", dest="voxel_shift", type=int, default=14)
    p.add_argument("-n", dest="total_num_frames", type=int, default=-1)
    p.add_argument("-cw", dest="weight_cull", type=int, default=8)
    p.add_argument("-lt", dest="loop_throttle", type=float, default=30.0)
    p.add_argument("-dg", dest="dense_sampling", type=float, default=0.8)
    p.add_argument("-il", dest="inlier_ratio", type=float, default=0.35)
    p.add_argument("-it", dest="isam_thresh", type=float, default=10.0)
    p.add_argument("-f", dest="flip_colors", action="store_true")
    p.add_argument("-sm", dest="static_mode", action="store_true")
    p.add_argument("-m", dest="mesh", action="store_true")
    p.add_argument("-od", dest="online_deformation", action="store_true")
    p.add_argument("-no", dest="no_overlap", action="store_true")
    p.add_argument("-nos", dest="no_save_overlap", action="store_true")
    p.add_argument("-r", dest="rgbd", action="store_true")
    p.add_argument("-ri", dest="rgbd_icp", action="store_true")
    p.add_argument("-ftf", dest="ftf", action="store_true")
    p.add_argument("-fod", dest="fast_odometry", action="store_true")
    p.add_argument("-fl", dest="fast_loops", action="store_true")
    p.add_argument("-d", dest="dynamic_cube", action="store_true")
    p.add_argument("-dc", dest="no_color_angle", action="store_true")
    p.add_argument("-o", dest="save_file", default="output")
    p.add_argument("--trunc", dest="trunc_dist", type=float, default=0.03)
    p.add_argument("--frame-limit", dest="frame_limit", action="store_true")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--viz-port", dest="viz_port", type=int, default=None,
                   help="live web viewer (not ported)")
    p.add_argument("--fast", dest="fast_mode", action="store_true",
                   help="blocked fast path: sparse TSDF updates, warm raycast, "
                        "batched dispatch")
    p.add_argument("--prior", dest="odom_prior_weight", type=float, default=0.0,
                   help="constant-velocity odometry prior weight (0 = off)")
    p.add_argument("--profile-dir", dest="profile_dir", default=None,
                   help="write a torch.profiler chrome trace of the run here")
    p.add_argument("--dump-tsdf", dest="dump_tsdf", default=None,
                   help="save the raw blocked TSDF volume to this .npz at exit")
    p.add_argument("--devices", dest="devices", type=int, default=1)
    p.add_argument("--num-processes", dest="num_processes", type=int, default=1)
    p.add_argument("--process-id", dest="process_id", type=int, default=0)
    p.add_argument("--coordinator", dest="coordinator", default=None)
    p.add_argument("--device", dest="device", default=None,
                   help="torch device (default: the CUDA card; cpu runs the "
                        "kernels' plain PyTorch versions)")
    return p


_UNPORTED = (  # (flag, argparse dest, is-set test)
    ("-live", "live_source", bool),
    ("--viz-port", "viz_port", lambda v: v is not None),
    ("--devices > 1", "devices", lambda v: v > 1),
    ("--num-processes > 1", "num_processes", lambda v: v > 1),
)


def _parse(argv):
    p = _parser()
    a = p.parse_args(argv)
    if not a.log_file and not a.live_source:
        p.error("one of -l <log.klg> or -live <address> is required")
    for flag, dest, is_set in _UNPORTED:
        if is_set(getattr(a, dest)):
            raise NotImplementedError(f"{flag}: not ported to kintinuous_tpu_torch yet")
    return a


def _config(a) -> KintinuousConfig:
    cam = load_calibration(a.calibration) if a.calibration else CameraIntrinsics()
    return KintinuousConfig(
        log_file=a.log_file, live_source=a.live_source,
        trajectory_file=a.trajectory_file, vocab_file=a.vocab_file, camera=cam,
        volume_size=a.volume_size, volume_resolution=a.resolution,
        voxel_shift=a.voxel_shift, total_num_frames=a.total_num_frames,
        trunc_dist=a.trunc_dist, weight_cull=a.weight_cull,
        loop_throttle_s=a.loop_throttle, dense_sampling_rate=a.dense_sampling,
        inlier_ratio=a.inlier_ratio, isam_thresh=a.isam_thresh,
        flip_colors=a.flip_colors, color_angle_weight=not a.no_color_angle,
        shift_overlap=0 if a.no_overlap else 3,
        save_deoverlap=not a.no_save_overlap,
        frame_rate_limit=30.0 if a.frame_limit else None,
        static_mode=a.static_mode, mesh=a.mesh,
        online_deformation=a.online_deformation, rgbd_odometry=a.rgbd,
        icp_plus_rgbd=a.rgbd_icp, odom_prior_weight=a.odom_prior_weight,
        frame_to_frame_rgbd=a.ftf, fast_odometry=a.fast_odometry,
        fast_loops=a.fast_loops, dynamic_cube=a.dynamic_cube,
        save_file=a.save_file, fast_mode=a.fast_mode, devices=a.devices,
        num_processes=a.num_processes, process_id=a.process_id,
        coordinator=a.coordinator,
    )


def build_config(argv) -> KintinuousConfig:
    """The configuration the flags ask for; a flag whose feature is not
    ported raises NotImplementedError naming it."""
    return _config(_parse(argv))


def main(argv=None) -> int:
    a = _parse(sys.argv[1:] if argv is None else argv)
    cfg = _config(a)
    from kintinuous_tpu_torch.runtime.engine import SlamEngine

    engine = SlamEngine(cfg, device=a.device)
    prof = contextlib.nullcontext()
    if a.profile_dir:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if engine.tracker.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)

    def progress(done, total):
        if done % 30 == 0 or done == total:
            print(f"\rframe {done}/{total}  {engine.fps:.1f} fps", end="", flush=True)

    with prof:
        engine.run(progress=progress)
    print()
    outputs = engine.save()
    if a.profile_dir:
        os.makedirs(a.profile_dir, exist_ok=True)
        trace = os.path.join(a.profile_dir, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"profiler trace: {trace}")
    if a.dump_tsdf:
        vol = engine.tracker.state.vol
        np.savez_compressed(
            a.dump_tsdf, tsdf=vol.tsdf.cpu().numpy(),
            cw=vol.cw.cpu().numpy().view(np.uint32), wrap=vol.wrap.cpu().numpy(),
            origin=vol.origin.cpu().numpy(), blocked=np.asarray(cfg.fast_mode),
        )
        print(f"saved tsdf dump: {a.dump_tsdf}")
    for kind, path in outputs.items():
        print(f"saved {kind}: {path}")
    stats = engine.sw.stats()
    for name in ("processFrame", "SliceProcessor", "PlaceRecognition", "Deformation"):
        if name in stats:
            s = stats[name]
            print(f"{name}: mean {s['mean_ms']:.1f} ms over {s['count']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
