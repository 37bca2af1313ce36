"""Embedded deformation graph over the pose trajectory (port of
kintinuous_tpu/backend/deformation.py).

The role of the reference's DeformationGraph: poses at least
sample_dist apart become nodes, each node is tied to its k/2 temporal
neighbours on either side, vertices bind to their k nearest nodes in a
back-in-time window with (1 - d/dmax)^2 weights, and Gauss-Newton
minimises wRot ||A^T A - I|| + wReg * 10 reg + wCon * 100 con. Each GN
iteration solves its normal equations matrix-free with 60 steps of
conjugate gradient.

Node sampling, the edges and the binding are numpy on the host, as in
the JAX package; `optimise` and `apply` run in float32 on the graph's
device (the card unless asked for the CPU), with Python loops of the
JAX package's fixed counts in place of `fori_loop` and `scan`, and
`index_add_` for its scatter-adds (float atomics on the card, so the
card and the CPU agree within a tolerance).

Parameters per node: affine A (3,3, initialised I, not constrained to
SO(3)) and translation t (3,). deform(v) = sum_m w_m [A_m (v - g_m) + g_m + t_m].
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from kintinuous_tpu_torch.device import resolve_device

W_ROT = 1.0
W_REG = 10.0
W_CON = 100.0
CG_STEPS = 60


class Binding(NamedTuple):
    ids: np.ndarray  # (V,k) node indices
    w: np.ndarray  # (V,k) normalised weights


# ----------------------------------------------------------------- core

def deform(A, t, g, v, ids, w):
    """v: (V,3) -> deformed (V,3). A (M,3,3), t/g (M,3), ids/w (V,k)."""
    gm = g[ids]  # (V,k,3)
    local = v[:, None, :] - gm
    moved = (A[ids] @ local[..., None])[..., 0] + gm + t[ids]
    return torch.sum(w[..., None] * moved, dim=1)


def gn_core(A, t, g, e_j, e_k, c_v, c_q, c_ids, c_w, c_on, iters: int):
    """GN over the node transforms; returns (A, t, mean constraint
    error) as tensors on the inputs' device."""
    dev, dt = A.device, A.dtype
    sqw_rot, sqw_reg, sqw_con = math.sqrt(W_ROT), math.sqrt(W_REG), math.sqrt(W_CON)
    tiny = torch.tensor(1e-20, dtype=dt, device=dev)
    con_scale = (sqw_con * c_on)[:, None]
    gk_gj = g[e_k] - g[e_j]
    c_local = c_v[:, None, :] - g[c_ids]  # (C,k,3)
    flat_ids = c_ids.reshape(-1)

    def residuals(A, t):
        c1, c2, c3 = A[:, :, 0], A[:, :, 1], A[:, :, 2]
        r_rot = torch.stack([
            torch.sum(c1 * c2, -1), torch.sum(c1 * c3, -1), torch.sum(c2 * c3, -1),
            torch.sum(c1 * c1, -1) - 1.0, torch.sum(c2 * c2, -1) - 1.0,
            torch.sum(c3 * c3, -1) - 1.0,
        ], dim=-1) * sqw_rot
        gj, gk = g[e_j], g[e_k]
        r_reg = ((A[e_j] @ (gk - gj)[..., None])[..., 0] + gj + t[e_j] - gk - t[e_k]) * sqw_reg
        r_con = (deform(A, t, g, c_v, c_ids, c_w) - c_q) * con_scale
        return r_rot, r_reg, r_con

    def products(A):
        """J x and J^T u at the linearisation point A."""
        c1, c2, c3 = A[:, :, 0], A[:, :, 1], A[:, :, 2]

        def Jx(xA, xt):
            x1, x2, x3 = xA[:, :, 0], xA[:, :, 1], xA[:, :, 2]
            u_rot = torch.stack([
                torch.sum(x1 * c2 + c1 * x2, -1), torch.sum(x1 * c3 + c1 * x3, -1),
                torch.sum(x2 * c3 + c2 * x3, -1), 2 * torch.sum(c1 * x1, -1),
                2 * torch.sum(c2 * x2, -1), 2 * torch.sum(c3 * x3, -1),
            ], dim=-1) * sqw_rot
            u_reg = ((xA[e_j] @ gk_gj[..., None])[..., 0] + xt[e_j] - xt[e_k]) * sqw_reg
            u_con = (torch.sum(c_w[..., None] * (xA[c_ids] @ c_local[..., None])[..., 0], 1)
                     + torch.sum(c_w[..., None] * xt[c_ids], 1)) * con_scale
            return u_rot, u_reg, u_con

        def JTu(u_rot, u_reg, u_con):
            u = u_rot * sqw_rot
            g1 = u[:, 0:1] * c2 + u[:, 1:2] * c3 + 2 * u[:, 3:4] * c1
            g2 = u[:, 0:1] * c1 + u[:, 2:3] * c3 + 2 * u[:, 4:5] * c2
            g3 = u[:, 1:2] * c1 + u[:, 2:3] * c2 + 2 * u[:, 5:6] * c3
            yA = torch.stack([g1, g2, g3], dim=-1)
            ur = u_reg * sqw_reg
            yA = yA.index_add(0, e_j, ur[:, :, None] * gk_gj[:, None, :])
            yt = torch.zeros_like(t).index_add_(0, e_j, ur).index_add_(0, e_k, -ur)
            uc = u_con * con_scale
            yA = yA.index_add(0, flat_ids, (c_w[..., None, None] * uc[:, None, :, None]
                                            * c_local[:, :, None, :]).reshape(-1, 3, 3))
            yt = yt.index_add(0, flat_ids, (c_w[..., None] * uc[:, None, :]).reshape(-1, 3))
            return yA, yt

        return Jx, JTu

    lam = 1e-4
    for _ in range(iters):
        r_rot, r_reg, r_con = residuals(A, t)
        Jx, JTu = products(A)
        bA, bt = JTu(-r_rot, -r_reg, -r_con)
        xA, xt = torch.zeros_like(A), torch.zeros_like(t)
        rA, rt, pA, pt = bA, bt, bA, bt
        rz = torch.sum(bA * bA) + torch.sum(bt * bt)
        for _ in range(CG_STEPS):
            yA, yt = JTu(*Jx(pA, pt))
            ApA, Apt = yA + lam * pA, yt + lam * pt
            alpha = rz / torch.maximum(torch.sum(pA * ApA) + torch.sum(pt * Apt), tiny)
            xA = xA + alpha * pA
            xt = xt + alpha * pt
            rA = rA - alpha * ApA
            rt = rt - alpha * Apt
            rz_new = torch.sum(rA * rA) + torch.sum(rt * rt)
            beta = rz_new / torch.maximum(rz, tiny)
            pA = rA + beta * pA
            pt = rt + beta * pt
            rz = rz_new
        A, t = A + xA, t + xt
    _, _, r_con = residuals(A, t)
    con_err = torch.sum(r_con * r_con) / torch.clamp_min(c_on.sum(), 1.0) / W_CON
    return A, t, con_err


# ----------------------------------------------------------------- host

class DeformationGraph:
    """Host-facing embedded deformation graph; optimise and apply run on
    `device` (None: the card)."""

    def __init__(self, k: int = 4, sample_dist: float = 0.8, device=None):
        self.device = resolve_device(device)
        self.k = k
        self.sample_dist = sample_dist
        self.g: List[np.ndarray] = []  # node positions
        self.times: List[int] = []  # node timestamps
        self.A: Optional[np.ndarray] = None  # (M,3,3)
        self.t: Optional[np.ndarray] = None  # (M,3)

    @property
    def n_nodes(self) -> int:
        return len(self.g)

    # ---- node sampling ----
    def append_poses(self, times, positions) -> int:
        """Add nodes from new trajectory samples >= sample_dist apart.
        Returns the number added."""
        added = 0
        last = self.g[-1] if self.g else None
        for ts, p in zip(times, positions):
            p = np.asarray(p, np.float64)
            if last is None or np.linalg.norm(p - last) >= self.sample_dist:
                self.g.append(p)
                self.times.append(int(ts))
                last = p
                added += 1
        if added:
            M = self.n_nodes
            newA = np.tile(np.eye(3), (M, 1, 1))
            newt = np.zeros((M, 3))
            if self.A is not None:
                newA[: len(self.A)] = self.A
                newt[: len(self.t)] = self.t
            self.A, self.t = newA, newt
        return added

    def edges(self) -> Tuple[np.ndarray, np.ndarray]:
        """Sequential temporal connectivity, +-k/2 neighbours."""
        M = self.n_nodes
        ejs, eks = [], []
        half = max(1, self.k // 2)
        for j in range(M):
            for d in range(1, half + 1):
                if j + d < M:
                    ejs.append(j)
                    eks.append(j + d)
        if not ejs:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        return np.array(ejs, np.int32), np.array(eks, np.int32)

    # ---- vertex binding ----
    def bind(self, vertices: np.ndarray, vertex_times: np.ndarray,
             window: int = 20) -> Binding:
        M = self.n_nodes
        k = min(self.k, M)
        node_times = np.asarray(self.times)
        g = np.asarray(self.g)
        # last node at-or-before each vertex time (back-in-time anchor)
        anchor = np.searchsorted(node_times, vertex_times, side="right") - 1
        anchor = np.clip(anchor, 0, M - 1)
        lo = np.maximum(anchor - window + 1, 0)
        # candidate window indices (V, window)
        cand = lo[:, None] + np.arange(window)[None, :]
        cand = np.minimum(cand, anchor[:, None])
        d = np.linalg.norm(vertices[:, None, :] - g[cand], axis=-1)
        # k nearest within the window
        sel = np.argsort(d, axis=1)[:, :k]
        ids = np.take_along_axis(cand, sel, axis=1)
        dk = np.take_along_axis(d, sel, axis=1)
        dmax = dk.max(axis=1, keepdims=True) * 1.1 + 1e-12
        w = (1.0 - dk / dmax) ** 2
        w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
        return Binding(ids=ids.astype(np.int32), w=w.astype(np.float32))

    # ---- device ----
    def _t(self, a, dtype=np.float32) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(self.device)

    def nodes(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(A, t, g) as float32 tensors on the device."""
        return self._t(self.A), self._t(self.t), self._t(np.asarray(self.g))

    def solve(self, con_src: np.ndarray, con_dst: np.ndarray, con_binding: Binding,
              iters: int = 10):
        """gn_core on the graph and these constraints: (A, t, err) tensors
        on the device; the graph is unchanged."""
        e_j, e_k = self.edges()
        C = len(con_src)
        k = con_binding.ids.shape[1] if C else min(self.k, self.n_nodes)
        c_ids = con_binding.ids if C else np.zeros((0, k), np.int32)
        c_w = con_binding.w if C else np.zeros((0, k), np.float32)
        return gn_core(*self.nodes(), self._t(e_j, np.int64), self._t(e_k, np.int64),
                       self._t(np.reshape(con_src, (-1, 3))),
                       self._t(np.reshape(con_dst, (-1, 3))),
                       self._t(c_ids, np.int64), self._t(c_w), self._t(np.ones(C)),
                       iters)

    def optimise(self, con_src: np.ndarray, con_dst: np.ndarray, con_binding: Binding,
                 iters: int = 10) -> float:
        """Gauss-Newton; updates the node transforms; returns the mean
        constraint error (the JAX package pads the constraints to a
        power of two against recompiles; the port solves at their own
        count)."""
        if self.n_nodes < 2:
            return 0.0
        A, t, err = self.solve(con_src, con_dst, con_binding, iters)
        self.A = A.cpu().numpy().astype(np.float64)
        self.t = t.cpu().numpy().astype(np.float64)
        return float(err)

    def apply_tensor(self, vertices: np.ndarray, binding: Binding) -> torch.Tensor:
        """The deformed vertices (V,3) float32 on the device."""
        return deform(*self.nodes(), self._t(vertices), self._t(binding.ids, np.int64),
                      self._t(binding.w))

    def apply(self, vertices: np.ndarray, binding: Binding) -> np.ndarray:
        return self.apply_tensor(vertices, binding).cpu().numpy()
