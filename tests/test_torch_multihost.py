"""Several processes (parallel/multihost.py): two gloo processes, each
this file run as a worker, against one process. The distributed pose
graph against PoseGraph (and the JAX package's), the CLI with
--num-processes 2 against the same flags in one process, and -od with
two processes refused.

Worker use (the chip smoke test runs it on the card too):

    python tests/test_torch_multihost.py graph PID NPROC PORT OUTDIR DEVICE

joins the group at 127.0.0.1:PORT, optimises build_graph's 40-node
graph with a DistributedPoseGraph on DEVICE, checks the host partition
and allgather_points, and (process 0) writes OUTDIR/graph.npz;

    python tests/test_torch_multihost.py od PID NPROC PORT OUTDIR

runs the CLI with -od on OUTDIR's lap as process PID of NPROC.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from kintinuous_tpu_torch.geometry import se3  # noqa: E402

N_NODES = 40


def build_graph(g):
    """tests/multihost_worker.py's graph with the port's SE(3): a noisy
    circle of 40 nodes (the same on every process) and one loop from
    the last node to the first."""
    rng = np.random.default_rng(42)
    step = np.eye(4)
    step[:3, 3] = [0.1, 0.0, 0.02]
    c, s = np.cos(2 * np.pi / N_NODES), np.sin(2 * np.pi / N_NODES)
    step[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    g.add_node(0, np.eye(4))
    for i in range(1, N_NODES):
        xi = torch.from_numpy((0.004 * rng.standard_normal(6)).astype(np.float32))
        g.add_odometry(i - 1, i, step @ se3.exp_se3(xi).numpy())
    Tn = np.eye(4)
    for _ in range(N_NODES - 1):
        Tn = Tn @ step
    g.add_loop(N_NODES - 1, 0, np.linalg.inv(Tn))
    return g


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(argvs, timeout=240):
    """Start one process per argv (all at once), wait for all; a worker
    that fails fails the caller."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, *a], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for a in argvs]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, (
            f"worker rc={p.returncode}\n{so.decode()[-2000:]}\n{se.decode()[-3000:]}")
    return [so.decode() for so, _ in outs]


def graph_worker(pid: int, nproc: int, port: int, outdir: str, device: str) -> None:
    from kintinuous_tpu_torch.parallel.multihost import (
        DistributedPoseGraph, HostPartition, allgather_points, init_distributed,
        shutdown_distributed)

    init_distributed(f"127.0.0.1:{port}", nproc, pid)
    g = build_graph(DistributedPoseGraph(device=device))
    chi2 = g.optimise(10)
    part = HostPartition()
    assert (part.num, part.pid) == (nproc, pid)
    items = [np.full((i + 1, 3), float(i), np.float32) for i in range(7)]
    mine = [p for i, p in enumerate(items) if part.owns(i)]
    merged = allgather_points(np.concatenate(mine) if mine else np.zeros((0, 3), np.float32))
    if pid == 0:
        np.savez(os.path.join(outdir, "graph.npz"), poses=np.array(g.poses), chi2=chi2,
                 merged=merged)
    shutdown_distributed()


# ------------------------------------------------------------------ tests
def test_od_with_two_processes_fails_at_once_with_a_clear_error(tmp_path):
    """The CLI with -od and --num-processes 2 on a short lap with colour
    (tests/test_torch_engine_od.py's) is refused in each process before
    it joins a group. Run, it failed in gloo: each process's
    place-recognition worker starts the distributed solve on its own
    schedule, and the two solves' all_reduce sizes differed ("Received
    data size doesn't match expected size", the other process reset);
    a solve that one process never starts would wait out the group."""
    from kintinuous_tpu_torch.config import CameraIntrinsics
    from kintinuous_tpu_torch.io.synth import generate_klg, lap_scene, lap_trajectory
    from kintinuous_tpu_torch.io.tum import save_trajectory
    from tests.test_torch_engine_od import drifted

    poses = lap_trajectory(length=2.0, depth=1.6, step=0.1, turn_frames=10, warmup_frames=4,
                           revisit_frac=0.25)
    generate_klg(str(tmp_path / "lap.klg"), CameraIntrinsics(**OD_CAM), poses,
                 scene=lap_scene(length=2.0, depth=1.6), depth_noise_mm=3.0, color=True)
    save_trajectory(str(tmp_path / "drift.txt"), [i / 30.0 for i in range(len(poses))],
                    drifted(poses))
    (tmp_path / "calib.txt").write_text("90 90 80 64 160 128\n")
    port = free_port()
    with pytest.raises(AssertionError) as failed:
        run_workers([[__file__, "od", str(pid), "2", str(port), str(tmp_path)]
                     for pid in range(2)], timeout=110)
    assert "online deformation (-od) runs in one process" in str(failed.value)
    assert not (tmp_path / "od2_0.poses").exists()


def test_the_engine_refuses_od_with_several_processes_before_joining_a_group():
    """In process: SlamEngine with -od and num_processes 2 raises at
    construction, before it joins a group (the coordinator named here
    is never contacted)."""
    import torch.distributed as dist

    from kintinuous_tpu_torch.config import tiny_test_config
    from kintinuous_tpu_torch.runtime.engine import SlamEngine

    cfg = tiny_test_config(online_deformation=True, num_processes=2, process_id=1,
                           coordinator=f"127.0.0.1:{free_port()}")
    with pytest.raises(ValueError, match=r"online deformation \(-od\) runs in one process"):
        SlamEngine(cfg, device="cpu")
    assert not dist.is_initialized()


def test_distributed_pose_graph_matches_one_process(tmp_path):
    """Two processes, the factors split between them and every reduction
    summed over the group: the optimised poses within 1e-5 of PoseGraph's
    in one process, chi2 within 1e-4 relative; the JAX package's
    PoseGraph on the same graph within 1e-4 (its own test's bound); the
    partitioned payloads come back whole, in process order."""
    from kintinuous_tpu.backend.pose_graph import PoseGraph as JPoseGraph
    from kintinuous_tpu_torch.backend.pose_graph import PoseGraph

    port = free_port()
    run_workers([[__file__, "graph", str(pid), "2", str(port), str(tmp_path), "cpu"]
                 for pid in range(2)])
    res = np.load(tmp_path / "graph.npz")
    ref = build_graph(PoseGraph(device="cpu"))
    ref_chi2 = ref.optimise(10)
    np.testing.assert_allclose(res["poses"], np.array(ref.poses), atol=1e-5)
    assert abs(float(res["chi2"]) - ref_chi2) <= 1e-4 * max(1.0, abs(ref_chi2))
    jref = build_graph(JPoseGraph())
    jref.optimise(10)
    np.testing.assert_allclose(res["poses"], np.array(jref.poses), atol=1e-4)
    items = [np.full((i + 1, 3), float(i), np.float32) for i in range(7)]
    want = np.concatenate([items[i] for i in (0, 2, 4, 6)] + [items[i] for i in (1, 3, 5)])
    np.testing.assert_array_equal(res["merged"], want)


def _sorted_rows(a):
    return a[np.lexsort((a[:, 2], a[:, 1], a[:, 0]))]


def test_the_group_of_one_is_a_no_op():
    from kintinuous_tpu_torch.parallel.multihost import (
        HostPartition, allgather_points, init_distributed)

    init_distributed(None, 1, 0)  # one process: nothing to join
    a = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(allgather_points(a), a)
    part = HostPartition(3, 1)
    assert [part.owns(i) for i in range(4)] == [False, True, False, False]
    assert part.owner(5) == 2


@pytest.mark.parametrize("mode", ["dense", "fast"])
def test_cli_two_processes_match_one(tmp_path, mode):
    """The CLI with --num-processes 2 (each process tracks the whole log;
    each processes its own slices; process 0 merges and writes the map)
    against the same flags in one process: process 0's .poses within
    1e-5, the .pcd's points the same (count within 2, sorted rows within
    1e-4 m: the merged union is downsampled in another order)."""
    from kintinuous_tpu_torch import cli
    from kintinuous_tpu_torch.config import CameraIntrinsics
    from kintinuous_tpu_torch.io.pcd import load_pcd
    from kintinuous_tpu_torch.io.synth import generate_klg, straight_trajectory
    from kintinuous_tpu_torch.io.tum import load_trajectory

    cam = CameraIntrinsics(fx=70.0, fy=70.0, cx=32.0, cy=24.0, width=64, height=48)
    log, gt = str(tmp_path / "walk.klg"), str(tmp_path / "walk.gt")
    generate_klg(log, cam, straight_trajectory(25, distance=1.0, axis=0), gt_path=gt)
    (tmp_path / "calib.txt").write_text("70 70 32 24 64 48\n")
    flags = ["-l", log, "-c", str(tmp_path / "calib.txt"), "-s", "3.0", "--resolution", "64",
             "--device", "cpu"]
    flags += ["--fast", "-t", "8"] if mode == "fast" else ["-p", gt, "-t", "4"]
    assert cli.main(flags + ["-o", str(tmp_path / "one")]) == 0
    port = free_port()
    run_workers([["-m", "kintinuous_tpu_torch.cli", *flags, "-o", str(tmp_path / f"p{pid}"),
                  "--num-processes", "2", "--process-id", str(pid),
                  "--coordinator", f"127.0.0.1:{port}"] for pid in range(2)])
    s1, p1 = load_trajectory(str(tmp_path / "one.poses"))
    s2, p2 = load_trajectory(str(tmp_path / "p0.poses"))
    np.testing.assert_allclose(s2, s1, atol=1e-9)
    np.testing.assert_allclose(np.array(p2), np.array(p1), atol=1e-5)
    assert not (tmp_path / "p1.pcd").exists(), "process 1 wrote a map"
    c1, c2 = load_pcd(str(tmp_path / "one.pcd")), load_pcd(str(tmp_path / "p0.pcd"))
    assert len(c1["points"]) > 100
    assert abs(len(c2["points"]) - len(c1["points"])) <= 2
    np.testing.assert_allclose(_sorted_rows(c2["points"]), _sorted_rows(c1["points"]),
                               atol=1e-4)


# the -od lap of tests/test_torch_engine_od.py, and the configuration
# fields its test sets that the CLI's flags do not reach
OD_CAM = dict(fx=90.0, fy=90.0, cx=80.0, cy=64.0, width=160, height=128)
OD_SCALE = dict(pyramid_levels=4, icp_iterations=(0, 10, 5, 0), bilateral_radius=2,
                extraction_capacity=300_000, band_cap=2048, pallas=False,
                loop_min_matches=20, place_rec_motion_thresh=0.3)


def od_worker(pid: int, nproc: int, port: int, outdir: str) -> None:
    """The CLI with -od on OUTDIR's lap, as process PID of NPROC: the
    lap's colour through the port's ORB, the poses replayed through -p."""
    from kintinuous_tpu_torch import cli

    argv = ["-l", os.path.join(outdir, "lap.klg"), "-p", os.path.join(outdir, "drift.txt"),
            "--fast", "-dc", "-od", "-lt", "0", "--device", "cpu",
            "-c", os.path.join(outdir, "calib.txt"), "-s", "4", "--resolution", "64",
            "-t", "8", "-d", "-o", os.path.join(outdir, f"od{nproc}_{pid}"),
            "--num-processes", str(nproc), "--process-id", str(pid),
            "--coordinator", f"127.0.0.1:{port}"]
    config = cli._config
    cli._config = lambda a: config(a).replace(**OD_SCALE)
    assert cli.main(argv) == 0


if __name__ == "__main__":
    kind, pid, nproc, port, outdir = sys.argv[1:6]
    if kind == "graph":
        graph_worker(int(pid), int(nproc), int(port), outdir, sys.argv[6])
    else:
        assert kind == "od", kind
        od_worker(int(pid), int(nproc), int(port), outdir)
