"""The engine on several devices (the counterpart of
tests/test_multichip.py's test_engine_multichip_end_to_end): the whole
pipeline (log, sharded tracker, slice processor, saves) with devices=4
on 4 CPU slabs against devices=1, on the dense path and the fast path;
and the JAX engine's devices=4 run against the port's."""

import numpy as np
import pytest
import torch

from kintinuous_tpu.runtime.engine import SlamEngine as JEngine
from kintinuous_tpu_torch import cli
from kintinuous_tpu_torch.io.pcd import load_pcd
from kintinuous_tpu_torch.io.synth import generate_klg, straight_trajectory
from kintinuous_tpu_torch.io.tum import load_trajectory
from kintinuous_tpu_torch.parallel.tracker import ShardedTracker
from kintinuous_tpu_torch.runtime.engine import SlamEngine
from tests.test_multichip import CFG, _sorted_rows
from tests.test_torch_package import port_cam, port_cfg

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    d = tmp_path_factory.mktemp("walk")
    log, gt = str(d / "walk.klg"), str(d / "walk.gt")
    generate_klg(log, port_cam(CFG.camera), straight_trajectory(25, distance=1.0, axis=0),
                 gt_path=gt)
    return log, gt


@pytest.mark.parametrize("fast", [False, True], ids=["dense", "fast"])
def test_engine_devices_4_matches_devices_1(walk, tmp_path, fast):
    """The saved .poses agree within 1e-4 and the .pcd holds the same
    points (count within 2, sorted rows within 1e-4 m) on 4 slabs as on
    one device; the JAX engine on 4 virtual devices saves the same
    trajectory."""
    log, gt = walk
    outs = {}
    for n in (1, 4):
        cfg = port_cfg(CFG).replace(log_file=log, trajectory_file=gt, devices=n,
                                    fast_mode=fast, save_file=str(tmp_path / f"out{n}"))
        engine = SlamEngine(cfg, device="cpu")
        assert isinstance(engine.tracker, ShardedTracker) == (n > 1)
        outs[n] = engine.run().save()
    s1, p1 = load_trajectory(outs[1]["poses"])
    s4, p4 = load_trajectory(outs[4]["poses"])
    np.testing.assert_allclose(s4, s1, atol=1e-9)
    np.testing.assert_allclose(np.array(p4), np.array(p1), atol=1e-4)
    c1, c4 = load_pcd(outs[1]["cloud"]), load_pcd(outs[4]["cloud"])
    assert len(c1["points"]) > 100
    assert abs(len(c4["points"]) - len(c1["points"])) <= 2
    np.testing.assert_allclose(_sorted_rows(c4["points"]), _sorted_rows(c1["points"]),
                               atol=1e-4)
    jcfg = CFG.replace(log_file=log, trajectory_file=gt, devices=4, fast_mode=fast,
                       save_file=str(tmp_path / "jax4"))
    sj, pj = load_trajectory(JEngine(jcfg).run().save()["poses"])
    np.testing.assert_allclose(np.array(p4), np.array(pj), atol=1e-4)


def test_cli_devices_build_and_route(walk, tmp_path):
    """--devices 2 --device cpu runs the CLI on 2 CPU slabs; the mesh is
    the JAX package's contract (a card count that is not there raises
    its error, checked in tests/test_torch_package.py)."""
    log, _ = walk
    (tmp_path / "calib.txt").write_text("70 70 32 24 64 48\n")
    rc = cli.main(["-l", log, "-c", str(tmp_path / "calib.txt"), "-s", "3.0",
                   "--resolution", "64", "-n", "4", "--devices", "2", "--device", "cpu",
                   "-o", str(tmp_path / "two")])
    assert rc == 0
    stamps, _ = load_trajectory(str(tmp_path / "two.poses"))
    assert len(stamps) == 4
