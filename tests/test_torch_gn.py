"""The GN step's tail (ops/reduce.gn_update) on the CPU: its plain
version, gn_update_plain, reaches each of its branches on random
systems, and the wrapper takes it for CPU tensors without counting a
launch. The odometry through it is held against the JAX package's by
tests/test_torch_odometry.py and tests/test_torch_rgbd.py.

The helpers here import no JAX: tests/test_torch_cuda.py draws its
systems from them on the card."""

import math

import numpy as np
import pytest
import torch

from kintinuous_tpu_torch.geometry import se3
from kintinuous_tpu_torch.ops.reduce import (
    GNSystem, add_motion_prior, gn_update, gn_update_plain, solve_gn)

torch.set_num_threads(2)

# each kind reaches one branch of the tail: the accept test failing on a
# non-finite system or on too few inliers; exp_se3's Taylor and sin
# branches, and the edge between them; the prior with a () tensor weight
# (some 0, as the tracker's default) and with a float; the RGB-D fusion
# with and without a prior; a rank-deficient system (the clamp in the
# Cholesky)
KINDS = ("nonfinite", "few_inliers", "taylor", "sin", "edge", "prior_tensor",
         "prior_float", "fused", "fused_prior", "degenerate")


def _rigid(twist: torch.Tensor) -> torch.Tensor:
    return se3.exp_se3(twist).contiguous()


def random_systems(n: int, kind: str, seed: int) -> dict:
    """n random systems of one kind, stacked on the CPU: A (n,6,6), b
    (n,6), count (n,), T (n,4,4), and as the kind has them T_prior
    (n,4,4), weight (n,) or a float, icp_A (n,6,6), icp_b (n,6), w2.
    b is A times a twist whose rotation is sized for the kind's branch."""
    g = torch.Generator().manual_seed(seed)

    def randn(*s):
        return torch.randn(*s, generator=g)

    def rand(*s):
        return torch.rand(*s, generator=g)

    def system(unit, cols=24):
        J = randn(n, 6, cols) * (10.0 ** (rand(n, 6, 1) * 2.0 - 1.0)) * unit
        return J @ J.transpose(1, 2)

    A = system(1.0, cols=3 if kind == "degenerate" else 24)
    axis = randn(n, 3)
    axis = axis / axis.norm(dim=1, keepdim=True)
    if kind == "taylor":
        rot = 10.0 ** (rand(n, 1) * 3.0 - 5.5)  # theta^2 below 1e-5
    elif kind == "edge":
        rot = 1e-2 * (1.0 + (rand(n, 1) - 0.5) * 1e-3)  # theta^2 at 1e-4
    else:
        rot = 10.0 ** (rand(n, 1) * 2.0 - 1.8)
    xi = torch.cat([axis * rot, randn(n, 3) * 0.05], dim=1)
    out = dict(A=A, b=(A @ xi[..., None])[..., 0],
               count=30.0 + rand(n) * 5000.0,
               T=_rigid(torch.cat([randn(n, 3) * 0.8, randn(n, 3)], dim=1)))
    if kind == "nonfinite":
        bad = torch.tensor([math.nan, math.inf, -math.inf])[torch.randint(0, 3, (n,), generator=g)]
        r, c = torch.randint(0, 6, (2, n), generator=g)
        out["A"][torch.arange(n), r, c] = bad
        out["A"][torch.arange(n), c, r] = bad
    if kind == "few_inliers":
        out["count"] = rand(n) * 29.99
    if kind in ("prior_tensor", "prior_float", "fused_prior"):
        out["T_prior"] = _rigid(torch.cat([randn(n, 3) * 0.02, randn(n, 3) * 0.03], dim=1))
        out["weight"] = (0.05 if kind == "prior_float"
                         else torch.where(rand(n) < 0.5, 0.0, rand(n) * 0.2))
    if kind in ("fused", "fused_prior"):
        out["icp_A"] = system(1e-2)
        out["icp_b"] = (out["icp_A"] @ (xi * (1.0 + 0.1 * randn(n, 6)))[..., None])[..., 0]
        out["w2"] = 100.0
    return out


def system_args(sys: dict, i: int, device="cpu") -> tuple:
    """System i as gn_update's (args, kwargs), in fresh tensors on
    `device`."""
    def t(name):
        return sys[name][i].clone().contiguous().to(device)

    kw = {}
    if "T_prior" in sys:
        w = sys["weight"]
        kw.update(T_prior=t("T_prior"), prior_weight=t("weight") if torch.is_tensor(w) else w)
    if "icp_A" in sys:
        kw.update(icp=GNSystem(A=t("icp_A"), b=t("icp_b"), count=None, residual=None),
                  w2=sys["w2"])
    return (t("A"), t("b"), t("count"), t("T")), kw


def bits(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().contiguous().view(torch.int32).numpy()


def solved_theta2(args, kw) -> float:
    """theta^2 of the solve's twist, by the unfused steps."""
    A, b, _, T = args
    if kw.get("icp") is not None:
        icp = kw["icp"]
        s_rgb = 1.0 / (torch.trace(A) + 1e-12)
        s_icp = 1.0 / (torch.trace(icp.A) + 1e-12)
        A, b = s_rgb * A + kw["w2"] * s_icp * icp.A, s_rgb * b + kw["w2"] * s_icp * icp.b
    if kw.get("T_prior") is not None:
        A, b = add_motion_prior(A, b, T, kw["T_prior"], kw["prior_weight"])
    xi, _ = solve_gn(A, b)
    return float(torch.sum(xi[:3] * xi[:3]))


@pytest.mark.parametrize("kind", KINDS)
def test_gn_update_plain_reaches_each_branch(kind):
    """Each kind reaches its branch of gn_update_plain: the pose kept
    where the accept test fails and moved where it passes, exp_se3's
    Taylor branch below theta^2 = 1e-4 and its sin branch above."""
    sys = random_systems(40, kind, seed=KINDS.index(kind))
    kept, theta2 = 0, []
    for i in range(40):
        args, kw = system_args(sys, i)
        got = gn_update_plain(*args, **kw)
        kept += int(np.array_equal(bits(got), bits(args[3])))
        theta2.append(solved_theta2(args, kw))
    theta2 = np.array(theta2)
    if kind in ("nonfinite", "few_inliers"):
        assert kept == 40
    else:
        assert kept == 0
    if kind == "taylor":
        assert (theta2 < 1e-4).all()
    if kind in ("sin", "prior_float", "fused", "fused_prior"):
        assert (theta2 >= 1e-4).mean() > 0.9
    if kind == "edge":
        assert 0 < (theta2 < 1e-4).sum() < 40


def test_gn_update_plain_takes_the_cpu_and_counts_no_launch():
    sys = random_systems(1, "sin", seed=99)
    args, kw = system_args(sys, 0)
    before = gn_update.launches
    assert np.array_equal(bits(gn_update(*args, **kw)), bits(gn_update_plain(*args, **kw)))
    assert gn_update.launches == before

