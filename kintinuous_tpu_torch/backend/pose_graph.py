"""SE(3) pose-graph optimisation (port of kintinuous_tpu/backend/pose_graph.py).

The role of the reference's iSAM pose graph: odometry factors between
consecutive cameras (information 1e3), loop factors, a batch optimise
that returns chi2, and disabling a rejected loop's factor.

Gauss-Newton with matrix-free, block-Jacobi preconditioned conjugate
gradient on the normal equations, over the factor arrays, in float32 on
the graph's device (the card unless asked for the CPU). Per-node sums
are `index_add_`; the JAX package's `fori_loop` and `scan` are Python
loops with the same fixed counts (GN iterations given by the caller, 50
CG steps each) and no early exit. chi2 is read on the host once an
optimise. On the card `index_add_` adds with float atomics, so the card
and the CPU agree within a tolerance, not bit for bit.

Conventions: node poses T_i map camera to world. A factor (i, j, Z)
states Z ~= T_i^-1 T_j (j expressed in i's frame). Right-perturbation
Jacobians with the Jr^-1 ~= I + ad(r)/2 approximation. Loop factors can
carry a Huber kernel (IRLS): a loop residual above huber_delta is
re-weighted by delta/|r| each GN round, and its chi2 grows linearly.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from kintinuous_tpu_torch.device import resolve_device
from kintinuous_tpu_torch.geometry import se3

CG_STEPS = 50


def _ad(xi):
    """adjoint of a twist [w,v]: [[w^,0],[v^,w^]] (6,6)."""
    w = se3.hat(xi[..., :3])
    v = se3.hat(xi[..., 3:])
    top = torch.cat([w, torch.zeros_like(w)], dim=-1)
    bot = torch.cat([v, w], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _Ad(T):
    """Adjoint of a pose for twist order [w,v]: [[R,0],[t^R,R]]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = se3.hat(t) @ R
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([tR, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _factor_system(poses, fi, fj, fZinv):
    """Per-factor residual r and Jacobians (Ji, Jj) wrt right increments.
    poses: (N,4,4); fi/fj: (F,) node ids; fZinv: (F,4,4) = Z^-1."""
    Tij = se3.inverse(poses[fi]) @ poses[fj]
    r = se3.log_se3(fZinv @ Tij)  # (F,6)
    Jrinv = torch.eye(6, dtype=poses.dtype, device=poses.device) + 0.5 * _ad(r)
    Ji = -Jrinv @ _Ad(se3.inverse(Tij))
    return r, Ji, Jrinv


def _scatter(n: int, idx, vals):
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx, vals)


def gn_core(poses, fi, fj, fZinv, fw, iters: int, fl=None, huber_delta: float = 0.0,
            reduce=None):
    """Gauss-Newton with block-Jacobi preconditioned CG on the normal
    equations, matrix-free over the factor arrays; returns (poses, chi2)
    with chi2 a 0-dim tensor on the poses' device. fl (the loop-factor
    mask) with huber_delta > 0 puts the Huber kernel on loop factors;
    odometry factors stay quadratic.

    reduce (the JAX package's axis_name): the factor arrays hold only
    this process's share, and reduce(x) returns the sum of x over the
    processes (parallel/multihost.DistributedPoseGraph): the gradient,
    each CG product, the preconditioner's diagonal and chi2 are summed,
    and the small replicated CG state then steps alike everywhere."""
    N = poses.shape[0]

    def _psum(x):
        return reduce(x) if reduce is not None else x

    dev, dt = poses.device, poses.dtype
    robust = fl is not None and huber_delta > 0.0
    eye6 = torch.eye(6, dtype=dt, device=dev)
    tiny = torch.tensor(1e-20, dtype=dt, device=dev)

    def eff_weight(r):
        """IRLS weights and robust chi2 contributions per factor."""
        rn2 = torch.sum(r * r, dim=-1)
        if not robust:
            return fw, fw * rn2
        rn = torch.sqrt(torch.clamp_min(rn2, 1e-24))
        tail = (fl > 0) & (rn > huber_delta)
        w_eff = torch.where(tail, fw * huber_delta / rn, fw)
        cost = torch.where(tail, fw * huber_delta * (2.0 * rn - huber_delta), fw * rn2)
        return w_eff, cost

    def step(poses):
        r, Ji, Jj = _factor_system(poses, fi, fj, fZinv)
        fw_eff, cost = eff_weight(r)
        JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)

        def matvec(x):
            # x: (N,6) -> (J^T W J + lam D) x, with the gauge prior on node 0
            u = (Ji @ x[fi][..., None] + Jj @ x[fj][..., None])[..., 0] * fw_eff[:, None]
            out = _scatter(N, fi, (JiT @ u[..., None])[..., 0])
            out.index_add_(0, fj, (JjT @ u[..., None])[..., 0])
            out = _psum(out)
            # gauge prior on node 0, applied once after the sum
            out[0] += 1e6 * x[0]
            return out + 1e-6 * x

        # gradient b = -J^T W r
        wr = (r * fw_eff[:, None])[..., None]
        b = -_scatter(N, fi, (JiT @ wr)[..., 0])
        b.index_add_(0, fj, -(JjT @ wr)[..., 0])
        b = _psum(b)

        # block-Jacobi preconditioner
        w3 = fw_eff[:, None, None]
        diag = _scatter(N, fi, JiT @ (w3 * Ji))
        diag.index_add_(0, fj, JjT @ (w3 * Jj))
        diag = _psum(diag)
        diag[0] += 1e6 * eye6
        diag = diag + 1e-6 * eye6
        Minv, _ = torch.linalg.inv_ex(diag)

        def precond(x):
            return (Minv @ x[..., None])[..., 0]

        x = torch.zeros((N, 6), dtype=dt, device=dev)
        rr = b
        z = precond(b)
        p = z
        rz = torch.sum(b * z)
        for _ in range(CG_STEPS):
            Ap = matvec(p)
            alpha = rz / torch.maximum(torch.sum(p * Ap), tiny)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = torch.sum(rr * z)
            beta = rz_new / torch.maximum(rz, tiny)
            p = z + beta * p
            rz = rz_new
        return x

    for _ in range(iters):
        poses = poses @ se3.exp_se3(step(poses))
    # final chi2 after the last update (the robust cost when enabled, so
    # the delta-chi2 gate sees the growth the solver optimised)
    r, _, _ = _factor_system(poses, fi, fj, fZinv)
    _, cost = eff_weight(r)
    return poses, _psum(torch.sum(cost))


class PoseGraph:
    """Host-facing pose graph; the GN solve runs on `device` (None: the
    card)."""

    def __init__(
        self,
        odo_weight: float = 1.0 / 1e-3,  # information ~ 1/cov
        loop_weight: float = 1.0 / 1e-3,
        prior_weight: float = 1e6,
        huber_delta: float = 0.1,  # Huber kernel on LOOP factors (m); 0 = off
        device=None,
    ):
        self.device = resolve_device(device)
        self.huber_delta = float(huber_delta)
        self.times: List[int] = []
        self.poses: List[np.ndarray] = []  # (4,4) camera->world
        self._fi: List[int] = []
        self._fj: List[int] = []
        self._fZ: List[np.ndarray] = []
        self._fw: List[float] = []
        self._floop: List[bool] = []
        self.odo_weight = odo_weight
        self.loop_weight = loop_weight
        self.prior_weight = prior_weight
        self._time_to_id = {}

    # ------------------------------------------------------------- build
    def add_node(self, time: int, pose: np.ndarray) -> int:
        nid = len(self.poses)
        self.times.append(int(time))
        self.poses.append(np.asarray(pose, np.float64).copy())
        self._time_to_id[int(time)] = nid
        return nid

    def node_id(self, time: int) -> Optional[int]:
        return self._time_to_id.get(int(time))

    def add_odometry(self, time1: int, time2: int, T12: np.ndarray):
        """Consecutive-camera factor; creates missing nodes by chaining."""
        i = self.node_id(time1)
        if i is None:
            i = self.add_node(time1, np.eye(4))
        j = self.node_id(time2)
        if j is None:
            j = self.add_node(time2, self.poses[i] @ T12)
        self._fi.append(i)
        self._fj.append(j)
        self._fZ.append(np.asarray(T12, np.float64))
        self._fw.append(self.odo_weight)
        self._floop.append(False)
        return i, j

    def add_loop(self, time1: int, time2: int, T12: np.ndarray) -> int:
        i = self.node_id(time1)
        j = self.node_id(time2)
        assert i is not None and j is not None, "loop endpoints must exist"
        self._fi.append(i)
        self._fj.append(j)
        self._fZ.append(np.asarray(T12, np.float64))
        self._fw.append(self.loop_weight)
        self._floop.append(True)
        return len(self._fw) - 1

    def remove_factor(self, fid: int):
        """Disable a factor (weight 0)."""
        self._fw[fid] = 0.0

    # ---------------------------------------------------------- optimise
    def _packed(self):
        """The graph as float32 tensors on the device: poses, fi, fj,
        Z^-1, weights and the loop mask."""
        dev = self.device

        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        fZ = np.array(self._fZ, np.float32).reshape(-1, 4, 4)
        return (t(np.array(self.poses, np.float32), np.float32),
                t(self._fi, np.int64), t(self._fj, np.int64),
                t(np.linalg.inv(fZ), np.float32), t(self._fw, np.float32),
                t(np.array(self._floop, np.float32), np.float32))

    def solve(self, iters: int):
        """gn_core on the packed graph: (poses (N,4,4) tensor, chi2 0-dim
        tensor), both on the device; the graph is unchanged."""
        poses, fi, fj, fZinv, fw, fl = self._packed()
        return gn_core(poses, fi, fj, fZinv, fw, iters, fl=fl,
                       huber_delta=self.huber_delta)

    def chi2(self) -> float:
        """Total chi2 at the current poses, no optimisation: the baseline
        of the delta-chi2 loop gate. The poses are untouched."""
        if not self._fw:
            return 0.0
        return float(self.solve(0)[1])

    def optimise(self, iters: int = 10) -> float:
        """Batch GN; updates the node poses in place; returns the TOTAL
        chi2 (the reference's isam chi2, gated at isam_thresh)."""
        if not self._fw:
            return 0.0
        out, chi2 = self.solve(iters)
        out = out.cpu().numpy().astype(np.float64)
        for k in range(len(self.poses)):
            self.poses[k] = out[k]
        return float(chi2)

    def get_pose(self, time: int) -> np.ndarray:
        return self.poses[self._time_to_id[int(time)]]

    @property
    def n_loops(self) -> int:
        return sum(1 for l, w in zip(self._floop, self._fw) if l and w > 0)
