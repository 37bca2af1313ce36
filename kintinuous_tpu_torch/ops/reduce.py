"""Point-to-plane ICP systems and the 6x6 solve (port of
kintinuous_tpu/ops/reduce.py: icp_associate, icp_build_from_assoc,
icp_step, _cholesky_solve6, solve_gn, add_motion_prior, icp_solve_level).

Every GN step stays on the device: the association and the system build
(two matmuls) are tensor ops, and the step's tail (the optional RGB-D
fusion, the motion prior, the unrolled Cholesky solve, the accept test
and the pose update) is `gn_update`, one launch of csrc/gn.cu on a card
and its plain version, `gn_update_plain`, on the CPU. Nothing reads the
device on the host. Twist convention: xi = [omega, v]; updates compose
as T <- exp(xi) @ T.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from kintinuous_tpu_torch.config import CameraIntrinsics
from kintinuous_tpu_torch.geometry import se3
from kintinuous_tpu_torch.ops import kernels as K

# |coordinate| bound before a float -> int cast: out-of-image values
# stay out of the image and the cast stays defined
_INT_CLAMP = float(1 << 30)


def round_to_int(x: torch.Tensor) -> torch.Tensor:
    """jnp.round(x).astype(int32): round half to even, then int32."""
    return torch.round(torch.clamp(x, -_INT_CLAMP, _INT_CLAMP)).to(torch.int32)


class GNSystem(NamedTuple):
    A: torch.Tensor  # (6,6) JtJ
    b: torch.Tensor  # (6,) Jtr
    count: torch.Tensor  # () f32 inliers
    residual: torch.Tensor  # () f32 sum of squared residuals


def pack_maps(vmap: torch.Tensor, nmap: torch.Tensor) -> torch.Tensor:
    """(3,H,W) vertex + normal maps -> (H*W, 8) rows [v, n, 0, 0]."""
    HW = vmap.shape[1] * vmap.shape[2]
    return torch.cat(
        [vmap.reshape(3, -1), nmap.reshape(3, -1),
         torch.zeros((2, HW), dtype=vmap.dtype, device=vmap.device)],
        dim=0,
    ).T.contiguous()


def _rotate(R, m):
    return torch.einsum("ij,jhw->ihw", R, m)


def icp_associate(cam: CameraIntrinsics, T_curr_to_prev, vmap_curr,
                  packed_prev, target_hw):
    """Projective data association: frozen targets (d, n) as (3,h,w)
    plus the in-image mask."""
    H, W = target_hw
    R = T_curr_to_prev[:3, :3]
    t = T_curr_to_prev[:3, 3]
    s = _rotate(R, vmap_curr) + t[:, None, None]
    z = torch.clamp(s[2], min=1e-6)
    ui = round_to_int(s[0] / z * cam.fx + cam.cx)
    vi = round_to_int(s[1] / z * cam.fy + cam.cy)
    in_img = (s[2] > 0) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    idx = torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)
    rows = packed_prev[idx.reshape(-1).long()]
    d = rows[:, 0:3].T.reshape(3, *idx.shape)
    n = rows[:, 3:6].T.reshape(3, *idx.shape)
    return d, n, in_img


def icp_build_from_assoc(T_curr_to_prev, vmap_curr, nmap_curr, d, n, in_img,
                         dist_thresh: float, angle_thresh_sin: float) -> GNSystem:
    """GN normal equations on frozen correspondences."""
    R = T_curr_to_prev[:3, :3]
    t = T_curr_to_prev[:3, 3]
    s = _rotate(R, vmap_curr) + t[:, None, None]
    n_rot = _rotate(R, nmap_curr)
    finite = (
        torch.isfinite(vmap_curr).all(dim=0)
        & torch.isfinite(d).all(dim=0)
        & torch.isfinite(n).all(dim=0)
        & torch.isfinite(n_rot).all(dim=0)
    )
    diff = d - s
    dist2 = torch.sum(torch.where(finite, diff * diff, 0.0), dim=0)
    cross = torch.stack(
        [
            n_rot[1] * n[2] - n_rot[2] * n[1],
            n_rot[2] * n[0] - n_rot[0] * n[2],
            n_rot[0] * n[1] - n_rot[1] * n[0],
        ],
        dim=0,
    )
    sine = torch.sqrt(torch.sum(torch.where(finite, cross * cross, 0.0), dim=0))
    mask = (
        in_img & finite
        & (dist2 < dist_thresh * dist_thresh)
        & (sine < angle_thresh_sin)
    )
    sxn = torch.stack(
        [
            s[1] * n[2] - s[2] * n[1],
            s[2] * n[0] - s[0] * n[2],
            s[0] * n[1] - s[1] * n[0],
        ],
        dim=0,
    )
    a = torch.cat([sxn, n], dim=0)
    r = torch.sum(n * diff, dim=0)
    # NaN-poisoned rows must be zeroed with where (NaN * 0 == NaN)
    a = torch.where(mask[None], a, 0.0).reshape(6, -1)
    r = torch.where(mask, r, 0.0).reshape(-1)
    A = a @ a.T
    b = a @ r
    return GNSystem(A=A, b=b, count=mask.sum().to(torch.float32),
                    residual=torch.sum(r * r))


def icp_step(cam: CameraIntrinsics, T_curr_to_prev, vmap_curr, nmap_curr,
             vmap_prev, nmap_prev, dist_thresh: float = 0.10,
             angle_thresh_sin: float = math.sin(math.radians(20.0)),
             packed_prev=None) -> GNSystem:
    """One point-to-plane build at one level with its own projective
    association (the same arithmetic as associate + build)."""
    if packed_prev is None:
        packed_prev = pack_maps(vmap_prev, nmap_prev)
    d, n, in_img = icp_associate(cam, T_curr_to_prev, vmap_curr, packed_prev,
                                 tuple(vmap_prev.shape[1:]))
    return icp_build_from_assoc(T_curr_to_prev, vmap_curr, nmap_curr, d, n, in_img,
                                dist_thresh, angle_thresh_sin)


def _cholesky_solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled 6x6 Cholesky solve, as written in the JAX package."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        s = A[i, i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = torch.sqrt(torch.clamp(s, min=1e-30))
        inv = 1.0 / L[i][i]
        for j in range(i + 1, n):
            s = A[j, i]
            for k in range(i):
                s = s - L[j][k] * L[i][k]
            L[j][i] = s * inv
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x)


def solve_gn(A: torch.Tensor, b: torch.Tensor, damping: float = 1e-6):
    """Damped 6x6 solve; returns (xi, ok) without leaving the device."""
    scale = torch.clamp(torch.max(torch.abs(torch.diagonal(A))), min=1e-12)
    Ad = A + damping * scale * torch.eye(6, dtype=A.dtype, device=A.device)
    xi = _cholesky_solve6(Ad, b)
    ok = torch.isfinite(xi).all()
    return torch.where(ok, xi, 0.0), ok


def prior_increment(T: torch.Tensor, T_prior: torch.Tensor) -> torch.Tensor:
    """First-order se3 increment log(T_prior @ T^-1), [omega, v]."""
    E = T_prior @ se3.inverse(T)
    w = 0.5 * torch.stack(
        [E[2, 1] - E[1, 2], E[0, 2] - E[2, 0], E[1, 0] - E[0, 1]]
    )
    return torch.cat([w, E[:3, 3]])


def add_motion_prior(A, b, T, T_prior, weight):
    """Per-block relative Tikhonov prior toward T_prior."""
    lam_r = weight * (A[0, 0] + A[1, 1] + A[2, 2]) / 3.0
    lam_t = weight * (A[3, 3] + A[4, 4] + A[5, 5]) / 3.0
    w6 = torch.stack([lam_r] * 3 + [lam_t] * 3).to(A.dtype)
    xi_p = prior_increment(T, T_prior)
    return A + torch.diag(w6), b + w6 * xi_p


def gn_update_plain(A, b, count, T, T_prior=None, prior_weight=0.0,
                    min_inliers: float = 30.0, icp=None, w2: float = 0.0):
    """Plain version of the GN-update kernel: the step's tail as tensor
    ops (see gn_update)."""
    if icp is not None:
        # intensity-gradient units dwarf metric ICP units by ~1e4:
        # trace-normalise each system so w2 sets the balance
        s_rgb = 1.0 / (torch.trace(A) + 1e-12)
        s_icp = 1.0 / (torch.trace(icp.A) + 1e-12)
        A = s_rgb * A + w2 * s_icp * icp.A
        b = s_rgb * b + w2 * s_icp * icp.b
    if T_prior is not None:
        A, b = add_motion_prior(A, b, T, T_prior, prior_weight)
    xi, ok = solve_gn(A, b)
    ok = ok & (count >= min_inliers)
    return torch.where(ok, se3.exp_se3(xi) @ T, T)


_SIGNATURES = {"kt_gn_update": (K.P,) * 8 + (K.F,) * 3 + (K.P,) * 2}


def gn_update(A, b, count, T, T_prior=None, prior_weight=0.0,
              min_inliers: float = 30.0, icp=None, w2: float = 0.0):
    """One GN step's tail: the new pose (4,4), on T's device. With `icp`
    (a system with fields A and b), A and b are the photometric system
    and the two are fused, each divided by its trace and the ICP one
    weighted by w2; with T_prior, the relative motion prior of weight
    prior_weight (a float or a () tensor) is added; then the damped
    Cholesky solve, and exp(xi) @ T if xi is finite and count >=
    min_inliers, else T.

    For CUDA tensors one launch of kt_gn_update (csrc/gn.cu), which
    repeats the plain version's operations and their rounding, so the
    two give the same bits; for CPU tensors the plain version. Counts
    its launches in `gn_update.launches`."""
    if T.device.type == "cpu":
        return gn_update_plain(A, b, count, T, T_prior, prior_weight, min_inliers, icp, w2)
    pw = prior_weight if isinstance(prior_weight, torch.Tensor) else None
    optional = (T_prior, pw) + ((None, None) if icp is None else (icp.A, icp.b))
    K.require_cuda("gn_update", T, A, b, count, *(t for t in optional if t is not None))
    out = torch.empty((4, 4), dtype=torch.float32, device=T.device)
    lib = K.library("gn", _SIGNATURES)
    with K.on_device(T):
        err = lib.kt_gn_update(
            A.data_ptr(), b.data_ptr(), count.data_ptr(), T.data_ptr(),
            *(None if t is None else t.data_ptr() for t in optional),
            0.0 if pw is not None else float(prior_weight), float(w2), float(min_inliers),
            out.data_ptr(), K.stream_of(T))
    K.check(err, "kt_gn_update")
    _COUNTED.launches += 1
    return out


gn_update.launches = 0
# the wrapper counts through this name, which a test that patches the
# module's `gn_update` (to record its calls) leaves in place
_COUNTED = gn_update


def one_part(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The reduction over a single device: its one tensor (the default
    `reduce` of the solvers, whose single case is a list of one)."""
    (x,) = parts
    return x


def sum_systems(systems: Sequence[GNSystem], reduce) -> GNSystem:
    """One GNSystem from per-slab ones: `reduce` (a list of per-slab
    tensors -> their sum, parallel/mesh.SlabMesh.psum_home) field by
    field."""
    return GNSystem(*(reduce(list(f)) for f in zip(*systems)))


def icp_solve_level(cam: CameraIntrinsics, T_init, vmap_curr, nmap_curr,
                    packed_prev, target_hw, iterations: int,
                    dist_thresh: float = 0.10,
                    angle_thresh_sin: float = math.sin(math.radians(20.0)),
                    min_inliers: float = 30.0, reassoc_every: int = 1,
                    T_prior=None, prior_weight=0.0, reduce=None):
    """GN steps at one level. reassoc_every <= 1: `iterations` steps,
    each re-associating (the reference's schedule). Otherwise
    ceil(iterations / reassoc_every) groups of `reassoc_every` steps
    share one association, as in the JAX package. A step is accepted
    only if the solve is finite with at least `min_inliers` inliers,
    decided on the device.

    reduce (the JAX package's axis_name): vmap_curr, nmap_curr and
    packed_prev are then sequences, one entry per slab: that slab's
    pixel-row block of the current maps and its copy of the whole
    prediction, on the slab's device. Each slab builds the system of its
    rows, `reduce` sums the slabs' fields onto T_init's device, and the
    one solve runs there."""
    zero = torch.zeros((), dtype=torch.float32, device=T_init.device)
    if iterations == 0:
        return T_init, zero, zero
    if reduce is None:
        vmap_curr, nmap_curr, packed_prev = [vmap_curr], [nmap_curr], [packed_prev]
        reduce = one_part
    per_group = max(reassoc_every, 1)
    n_groups = -(-iterations // per_group)
    T, cnt, res = T_init, zero, zero
    for _ in range(n_groups):
        Ts = [T.to(v.device, non_blocking=True) for v in vmap_curr]
        assoc = [icp_associate(cam, Tk, v, p, target_hw)
                 for Tk, v, p in zip(Ts, vmap_curr, packed_prev)]
        for it in range(per_group):
            if it:
                Ts = [T.to(v.device, non_blocking=True) for v in vmap_curr]
            parts = [
                icp_build_from_assoc(Tk, v, nm, d, n, in_img,
                                     dist_thresh, angle_thresh_sin)
                for Tk, v, nm, (d, n, in_img) in zip(Ts, vmap_curr, nmap_curr, assoc)
            ]
            sys_ = sum_systems(parts, reduce)
            T = gn_update(sys_.A, sys_.b, sys_.count, T, T_prior, prior_weight, min_inliers)
            cnt, res = sys_.count, sys_.residual
    return T, cnt, res
