"""Port vs JAX: the CLI's fused ICP+RGB-D (-ri) and meshing (-m)
modes end to end, each against the JAX CLI's configuration through the
JAX engine. Kept apart from tests/test_torch_rgbd.py and
tests/test_torch_mesh.py so that each file stays short for the
parallel test run."""

import numpy as np
import torch

from kintinuous_tpu import cli as jcli
from kintinuous_tpu.config import CameraIntrinsics
from kintinuous_tpu.io.synth import generate_klg, orbit_trajectory, straight_trajectory
from kintinuous_tpu.io.tum import load_trajectory
from kintinuous_tpu.runtime.engine import SlamEngine as JEngine
from kintinuous_tpu_torch import cli

torch.set_num_threads(2)

CAM80 = CameraIntrinsics(fx=70.0, fy=70.0, cx=40.0, cy=30.0, width=80, height=60)


def test_cli_ri_on_a_colour_log_follows_jax(tmp_path):
    """`-ri` through the port's CLI on a colour .klg (JPEG frames) and the
    JAX CLI's configuration through the JAX engine (the TPU kernels in
    interpret mode): poses within 1e-3. At 128^3 over 3 m; at 64^3 (47
    mm voxels) the last frame's fused solve amplifies the two packages'
    summation order to 4e-3."""
    log = str(tmp_path / "c.klg")
    generate_klg(log, CAM80, orbit_trajectory(8, radius=0.1, angle_deg=5.0))
    calib = tmp_path / "calib.txt"
    calib.write_text("70 70 40 30 80 60\n")
    argv = ["-l", log, "-c", str(calib), "-sm", "-s", "3.0", "--resolution", "128",
            "--fast", "-ri"]
    jcfg = jcli.build_config(argv + ["-o", str(tmp_path / "j")]).replace(pallas=True)
    assert jcfg.icp_plus_rgbd
    want = JEngine(jcfg).run().save()["poses"]
    assert cli.main(argv + ["-o", str(tmp_path / "p"), "--device", "cpu"]) == 0
    ws, wp = load_trajectory(want)
    gs, gp = load_trajectory(str(tmp_path / "p.poses"))
    assert len(gs) == 8
    np.testing.assert_allclose(gs, ws, atol=1e-6)
    np.testing.assert_allclose(gp, wp, atol=1e-3)


def test_cli_mesh_face_count_follows_jax(tmp_path):
    """`-m` without -od on a .klg walk with ground-truth replay (-p): the
    port's CLI writes <base>.ply, the welded band patches and the live
    volume's mesh, whose face count is within 1 % of the JAX CLI
    configuration's through the JAX engine."""
    from kintinuous_tpu.io.ply import load_ply as jload_ply
    from kintinuous_tpu_torch.io.ply import load_ply

    log, gt = str(tmp_path / "walk.klg"), str(tmp_path / "walk.gt")
    generate_klg(log, CAM80, straight_trajectory(12, distance=1.0, axis=0), gt_path=gt)
    calib = tmp_path / "calib.txt"
    calib.write_text("70 70 40 30 80 60\n")
    argv = ["-l", log, "-p", gt, "-c", str(calib), "-s", "3.0", "--resolution", "128",
            "-t", "8", "--fast", "-m"]
    jout = JEngine(jcli.build_config(argv + ["-o", str(tmp_path / "j")])).run().save()
    assert cli.main(argv + ["-o", str(tmp_path / "p"), "--device", "cpu"]) == 0
    mj, mp = jload_ply(jout["mesh"]), load_ply(str(tmp_path / "p.ply"))
    nj, n = len(mj["faces"]), len(mp["faces"])
    assert n > 100 and abs(n - nj) <= 0.01 * nj, (n, nj)
    assert abs(len(mp["vertices"]) - len(mj["vertices"])) <= 0.01 * len(mj["vertices"])
