"""The control (the reference with TF32 matmuls in the program's place)
fails the check, at each cell's own size on the card. Card only: run
with `python -m pytest slambench/tests -m cuda` on a machine with one."""

import pytest
import torch

from slambench import run, spec


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["icp.desk.offline", "icp_rgbd.lr_kt2.offline",
                                      "icp.desk.live30"])
def test_control_fails_and_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = run.run_cell(workload, 2**31 + 101, 10.0, trace=False, control=True)
    limits = spec.load_cell(workload).limits
    assert out["correct"] is True, out["compared"]
    ctrl = out["control"]
    assert any(ctrl[n] > limits[n] for n in limits), (ctrl, limits)
