"""Photometric (RGB-D) odometry (port of kintinuous_tpu/ops/rgbd.py).

rgb_system builds one sigma-weighted photometric normal-equation system
at a pyramid level: the residual pass computes sigma on the device, and
the weighted system falls out of two matmuls. rgbd_icp_odometry runs the
coarse-to-fine fused solve: each level's photometric system, plus the
trace-normalised point-to-plane system when a prediction is given
(A = A_rgb / tr A_rgb + w^2 A_icp / tr A_icp, w = 10), and rejects a
solution that jumps more than 0.3 m. Every accept test is a torch.where:
nothing here reads the device on the host.

Residual convention: r0 = I_prev(pi(T x)) - I_curr(x); linearised
r(xi) = r0 + a . xi with a = [p x g, g]; the solve returns
xi = A^-1 (-sum w a r0) and composes T <- exp(xi) T, as the ICP does.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from kintinuous_tpu_torch.config import CameraIntrinsics
from kintinuous_tpu_torch.ops import preprocess as pp
from kintinuous_tpu_torch.ops.reduce import (
    GNSystem,
    gn_update,
    icp_associate,
    icp_build_from_assoc,
    icp_step,
    one_part,
    pack_maps,
    sum_systems,
)

# squared minimum gradient magnitudes per level, finest first
MIN_GRAD2 = (12.0 ** 2, 5.0 ** 2, 3.0 ** 2, 1.0 ** 2)
MAX_DEPTH_DELTA = 0.07  # metres


def pack_prev_texture(int_prev, gradx_prev, grady_prev, depth_prev) -> torch.Tensor:
    """(H,W) x4 channels -> (H*W, 4) rows [intensity, gx, gy, depth]:
    one row gather fetches all four channels of a corner."""
    return torch.stack([int_prev, gradx_prev, grady_prev, depth_prev],
                       dim=-1).reshape(-1, 4)


def _rows(tex, W: int, vv, uu):
    return tex[(vv * W + uu).reshape(-1).long()].reshape(*uu.shape, tex.shape[-1])


def _nearest_rows(tex, H: int, W: int, uv):
    """Nearest-neighbour sample of an (H*W, C) row texture (round half
    to even, as jnp.round)."""
    u = torch.clamp(torch.round(uv[..., 0]), 0.0, W - 1.0).to(torch.int32)
    v = torch.clamp(torch.round(uv[..., 1]), 0.0, H - 1.0).to(torch.int32)
    return _rows(tex, W, v, u)


def _bilinear_rows(tex, H: int, W: int, uv):
    """Bilinear sample of an (H*W, C) row texture at uv (...,2)."""
    u = torch.clamp(uv[..., 0], 0.0, W - 1.000001)
    v = torch.clamp(uv[..., 1], 0.0, H - 1.000001)
    u0 = torch.floor(u).to(torch.int32)
    v0 = torch.floor(v).to(torch.int32)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]
    u1 = torch.clamp(u0 + 1, max=W - 1)
    v1 = torch.clamp(v0 + 1, max=H - 1)
    return (
        _rows(tex, W, v0, u0) * (1 - du) * (1 - dv)
        + _rows(tex, W, v0, u1) * du * (1 - dv)
        + _rows(tex, W, v1, u0) * (1 - du) * dv
        + _rows(tex, W, v1, u1) * du * dv
    )


def _rgb_residuals(cam: CameraIntrinsics, T_curr_to_prev, vmap_curr, int_curr,
                   tex_prev, prev_hw, min_grad2: float, max_depth_delta: float,
                   bilinear: bool):
    """The residual pass of rgb_system: warped points p, previous-frame
    gradients, the gate mask and the intensity differences."""
    R = T_curr_to_prev[:3, :3]
    t = T_curr_to_prev[:3, 3]
    p = torch.einsum("ij,jhw->ihw", R, vmap_curr) + t[:, None, None]
    px, py, pz = p[0], p[1], p[2]
    zs = torch.clamp(pz, min=1e-6)
    u = px / zs * cam.fx + cam.cx
    v = py / zs * cam.fy + cam.cy
    H, W = prev_hw
    in_img = (pz > 0) & (u >= 1) & (u <= W - 2) & (v >= 1) & (v <= H - 2)
    uv = torch.where(in_img[..., None], torch.stack([u, v], dim=-1), 1.0)
    samp = (_bilinear_rows if bilinear else _nearest_rows)(tex_prev, H, W, uv)
    i_prev, gx, gy, d_prev = (samp[..., c] for c in range(4))

    finite = torch.isfinite(vmap_curr).all(dim=0)
    mask = (
        in_img & finite & (d_prev > 0)
        & (torch.abs(d_prev - pz) < max_depth_delta)  # occlusion gate
        & (gx * gx + gy * gy > min_grad2)  # texture gate
    )
    diff = i_prev - int_curr
    return p, zs, gx, gy, mask, diff


def _rgb_build(cam: CameraIntrinsics, p, zs, gx, gy, mask, diff, sigma, count) -> GNSystem:
    """The weighted system of one residual pass at the given sigma."""
    px, py, pz = p[0], p[1], p[2]
    w = torch.where(mask, 1.0 / (sigma + torch.abs(diff) + 1e-3), 0.0)
    # chain rule g = dI/dp
    g0 = gx * cam.fx / zs
    g1 = gy * cam.fy / zs
    g2 = -(g0 * px + g1 * py) / zs
    a = torch.stack([py * g2 - pz * g1, pz * g0 - px * g2, px * g1 - py * g0,
                     g0, g1, g2], dim=0)
    a = torch.where(mask[None], a, 0.0).reshape(6, -1)
    wr = torch.where(mask, -w * diff, 0.0).reshape(-1)
    aw = a * torch.sqrt(w).reshape(-1)[None]
    return GNSystem(A=aw @ aw.T, b=a @ wr, count=count, residual=sigma)


def rgb_system(cam: CameraIntrinsics, T_curr_to_prev, vmap_curr, int_curr,
               tex_prev, prev_hw: Tuple[int, int], min_grad2: float,
               max_depth_delta: float = MAX_DEPTH_DELTA,
               bilinear: bool = True, reduce=None) -> GNSystem:
    """One weighted photometric normal-equation build at one level.
    vmap_curr (3,h,w) current camera-frame vertices, int_curr (h,w) the
    current intensity, tex_prev the previous frame's packed texture.

    reduce (the JAX package's axis_name): vmap_curr, int_curr and
    tex_prev are then sequences, one entry per slab (its pixel-row block
    and its copy of the whole texture, on its device). `reduce` sums the
    slabs' sigma statistics, so that the robust weights are the whole
    image's, and then their systems; the residual is the whole image's
    sigma, on the reduction's device."""
    if reduce is None:
        vmap_curr, int_curr, tex_prev = [vmap_curr], [int_curr], [tex_prev]
        reduce = one_part
    parts = [_rgb_residuals(cam, T_curr_to_prev.to(v.device, non_blocking=True), v, i,
                            tex, prev_hw, min_grad2, max_depth_delta, bilinear)
             for v, i, tex in zip(vmap_curr, int_curr, tex_prev)]
    counts = [r[4].to(torch.float32).sum() for r in parts]
    ssum = reduce([torch.sum(torch.where(r[4], r[5] * r[5], 0.0)) for r in parts])
    sigma = torch.sqrt(ssum / torch.clamp(reduce(counts), min=1.0))
    systems = [_rgb_build(cam, *r, sigma.to(r[0].device, non_blocking=True), c)
               for r, c in zip(parts, counts)]
    return sum_systems(systems, reduce)._replace(residual=sigma)


class RGBDFramePyramid(NamedTuple):
    """Per-level previous-frame photometric data carried in the tracker
    state, finest first."""

    intensity: Tuple[torch.Tensor, ...]
    gradx: Tuple[torch.Tensor, ...]
    grady: Tuple[torch.Tensor, ...]
    depth: Tuple[torch.Tensor, ...]


def build_rgbd_pyramid(intensity, depth_m, levels: int) -> RGBDFramePyramid:
    """Intensity, Sobel gradient and depth pyramids."""
    ints, gxs, gys, ds = [], [], [], []
    i, d = intensity, depth_m
    for level in range(levels):
        gx, gy = pp.sobel_gradients(i)
        ints.append(i)
        gxs.append(gx)
        gys.append(gy)
        ds.append(d)
        if level + 1 < levels:
            i = pp.pyr_down_gauss(i)
            d = pp.pyr_down_depth(d, sigma=0.09)
    return RGBDFramePyramid(tuple(ints), tuple(gxs), tuple(gys), tuple(ds))


def rgbd_icp_odometry(
    cam: CameraIntrinsics,
    curr_pyr,  # MapPyramid of the current frame
    curr_rgbd: RGBDFramePyramid,
    prev_rgbd: RGBDFramePyramid,
    pred_pyr,  # MapPyramid of the raycast prediction for the ICP term, or None
    iterations: Sequence[int],
    icp_weight: float = 10.0,
    dist_thresh: float = 0.10,
    angle_thresh_deg: float = 20.0,
    jump_reject_m: float = 0.3,
    min_inliers: float = 30.0,
    reassoc_every: int = 1,
    T_init: Optional[torch.Tensor] = None,
    T_prior: Optional[torch.Tensor] = None,
    prior_weight=0.0,
    reduce=None,
):
    """Fused dense RGB-D (+ optional ICP) coarse-to-fine odometry.
    Returns (T_curr_to_prev, rgb_inliers, sigma), all on the device.

    At each level all but the last GN iteration sample the previous
    texture nearest-neighbour on every other pixel row; the last samples
    bilinearly on every row. reassoc_every > 1 freezes the ICP
    association for groups of that many steps (whole groups, so a phase
    may run a few more steps than asked, as in the JAX package).

    reduce (as in ops/reduce.icp_solve_level): curr_pyr's maps and
    curr_rgbd's intensity are then, at each level, sequences of per-slab
    pixel-row blocks (an even number of rows each, so that the coarse
    phase's every other row is the whole image's); the previous texture
    and the prediction are copied to each slab's device. `reduce` sums
    the sigma statistics and both systems over the slabs, and the solve
    runs on T's device."""
    levels = len(curr_pyr)
    if reduce is None:
        curr_pyr = [([v], [n]) for v, n in curr_pyr]
        curr_int = [[i] for i in curr_rgbd.intensity]
        reduce = one_part
    else:
        curr_int = curr_rgbd.intensity
    dev = curr_pyr[0][0][0].device
    sin_t = math.sin(math.radians(angle_thresh_deg))
    T0 = T_init if T_init is not None else torch.eye(4, dtype=torch.float32, device=dev)
    T = T0
    count = torch.zeros((), dtype=torch.float32, device=dev)
    sigma = torch.zeros((), dtype=torch.float32, device=dev)
    w2 = icp_weight * icp_weight

    def per_slab(x, like):
        """x copied to the device of each slab block in `like`."""
        return [x.to(v.device, non_blocking=True) for v in like]

    for level in range(levels - 1, -1, -1):
        iters = int(iterations[level]) if level < len(iterations) else 0
        if iters == 0:
            continue
        cam_l = cam.at_level(level)
        vcs, ncs = (list(x) for x in curr_pyr[level])
        ints = list(curr_int[level])
        mg2 = MIN_GRAD2[min(level, len(MIN_GRAD2) - 1)]
        tex_prev = pack_prev_texture(prev_rgbd.intensity[level], prev_rgbd.gradx[level],
                                     prev_rgbd.grady[level], prev_rgbd.depth[level])
        texs = per_slab(tex_prev, vcs)
        prev_hw = tuple(prev_rgbd.intensity[level].shape)
        if pred_pyr is not None:
            vp, np_ = pred_pyr[level]
            packeds = per_slab(pack_maps(vp, np_), vcs)
            icp_hw = tuple(vp.shape[1:])

        def fused_solve(T, rgb, icp):
            T = gn_update(rgb.A, rgb.b, rgb.count, T, T_prior, prior_weight,
                          min_inliers, icp=icp, w2=w2)
            return T, rgb.count, rgb.residual

        n_coarse = max(iters - 1, 0)
        phases = ((n_coarse, False), (iters - n_coarse, True))
        for n_iters, bilinear in phases:
            if n_iters == 0:
                continue
            vc_l = vcs if bilinear else [v[:, ::2, :] for v in vcs]
            int_l = ints if bilinear else [i[::2, :] for i in ints]

            def rgb_at(T):
                return rgb_system(cam_l, T, vc_l, int_l, texs, prev_hw, mg2,
                                  bilinear=bilinear, reduce=reduce)

            def icp_at(T):
                if pred_pyr is None:
                    return None
                return sum_systems([icp_step(cam_l, Tk, v, n_, vp, np_, dist_thresh,
                                             sin_t, packed_prev=pk)
                                    for Tk, v, n_, pk in zip(per_slab(T, vcs), vcs, ncs,
                                                             packeds)], reduce)

            if pred_pyr is None or reassoc_every <= 1:
                for _ in range(n_iters):
                    T, count, sigma = fused_solve(T, rgb_at(T), icp_at(T))
                continue
            for _ in range(-(-n_iters // reassoc_every)):
                assoc = [icp_associate(cam_l, Tk, v, pk, icp_hw)
                         for Tk, v, pk in zip(per_slab(T, vcs), vcs, packeds)]
                for _ in range(reassoc_every):
                    icp = sum_systems([icp_build_from_assoc(Tk, v, n_, d, n_t, in_img,
                                                            dist_thresh, sin_t)
                                       for Tk, v, n_, (d, n_t, in_img)
                                       in zip(per_slab(T, vcs), vcs, ncs, assoc)], reduce)
                    T, count, sigma = fused_solve(T, rgb_at(T), icp)
    # tracking-failure guard: a jump beyond jump_reject_m falls back to the
    # start (identity, or the constant-velocity warm start)
    T = torch.where(torch.linalg.norm(T[:3, 3]) < jump_reject_m, T, T0)
    return T, count, sigma
