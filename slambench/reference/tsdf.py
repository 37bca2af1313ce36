# Frozen copy of kintinuous_tpu_torch/ops/tsdf.py, the benchmark's plain
# reference: imports point into this package, and it is never updated
# to follow the program, which it judges.
"""TSDF volume state, packed colour/weight words, ray-length scaling and
the dense volume's fusion, band clear and trilinear sampling (port of
kintinuous_tpu/ops/tsdf.py).

The dense functions are plain PyTorch on any device: the JAX package
computes them with XLA, outside any Pallas kernel. `integrate` and
`clear_band` update the volume in place (the JAX package's are pure
functions over a donated state): a 512^3 state is 1 GiB, and a fresh
copy each frame would double it. `integrate` sweeps physical z-chunks
with the separable projection of the JAX package (no (...,3) voxel
tensor). On the card PyTorch divides a tensor by a Python float as a
product with its reciprocal, which rounds apart from the CPU's division;
where the JAX code divides by a constant, the port divides by a 0-dim
tensor on the data's device, so both devices divide.

Conventions, shared with the rest of the port:
- volumes are indexed [z, y, x]; coordinate and wrap vectors are [x, y, z];
- logical voxel g has local-world centre (g + 0.5) * voxel;
- the packed word is weight<<24 | r<<16 | g<<8 | b, stored as int32
  BITS (torch has no uint32 shift on the CPU). max_weight=128 sets bit
  31, so a stored word can be negative: always unpack with
  ``(x >> s) & 0xFF``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from slambench.reference.config import CameraIntrinsics


class VolumeState(NamedTuple):
    tsdf: torch.Tensor  # [z,y,x] f32 (or a band slab of the blocked volume)
    cw: torch.Tensor  # [z,y,x] int32 bits of the packed u32 word
    wrap: torch.Tensor  # (3,) i32 [x,y,z]
    origin: torch.Tensor  # (3,) f32 [x,y,z] global metres of the local corner


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """Float channel -> int32 byte, clip then truncate (jnp astype)."""
    return torch.clamp(x, 0, 255).to(torch.int32)


def pack_cw(weight, r, g, b) -> torch.Tensor:
    """weight and colour channels (0..255) -> int32 bits of the u32 word."""
    return (to_u8(weight) << 24) | (to_u8(r) << 16) | (to_u8(g) << 8) | to_u8(b)


def unpack_cw(cw: torch.Tensor):
    """int32 packed words -> (weight, r, g, b) float32."""
    w = ((cw >> 24) & 0xFF).to(torch.float32)
    r = ((cw >> 16) & 0xFF).to(torch.float32)
    g = ((cw >> 8) & 0xFF).to(torch.float32)
    b = (cw & 0xFF).to(torch.float32)
    return w, r, g, b


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as XLA's and CUDA's sqrtf.

    torch.sqrt on the CPU calls MKL's vector sqrt, whose AVX-512 path is
    one ulp off for about 0.7 % of f32 inputs (its AVX2 path is exact), so
    which values are off depends on the host. The f64 root rounded to f32
    is the correctly rounded f32 root. On the card torch.sqrt is exact."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def scale_depth(cam: CameraIntrinsics, depth_m: torch.Tensor) -> torch.Tensor:
    """z-depth map -> per-pixel ray length; 0 stays 0 (invalid)."""
    H, W = depth_m.shape
    u = torch.arange(W, dtype=torch.float32, device=depth_m.device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=depth_m.device)[:, None]
    xl = (u - cam.cx) / cam.fx
    yl = (v - cam.cy) / cam.fy
    lam = sqrt_rn(xl * xl + yl * yl + 1.0)
    return torch.where(depth_m > 0, depth_m * lam, 0.0)


def div_f32(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as a division on every device (d as a 0-dim f32 tensor on
    x's device; see the module docstring)."""
    return x / torch.full((), d, dtype=torch.float32, device=x.device)


def make_volume(resolution: int, device=None) -> VolumeState:
    R = resolution
    return VolumeState(
        tsdf=torch.zeros((R, R, R), dtype=torch.float32, device=device),
        cw=torch.zeros((R, R, R), dtype=torch.int32, device=device),
        wrap=torch.zeros(3, dtype=torch.int32, device=device),
        origin=torch.zeros(3, dtype=torch.float32, device=device),
    )


def integrate(vol: VolumeState, cam: CameraIntrinsics, depth_m: torch.Tensor,
              rgb: torch.Tensor, color_w: torch.Tensor, T_cam_to_local: torch.Tensor,
              voxel_size: float, trunc_dist: float, max_weight: float = 128.0,
              z_chunk: int = 64, z_phys_offset: int = 0) -> VolumeState:
    """Fuse one frame into the dense volume, in place (JAX integrate,
    ops/tsdf.py:92-214): each voxel is projected to its nearest pixel
    (round half to even), the running-average tsdf is fused where the
    measured ray length is at most trunc_dist short of the voxel's
    (weight capped at max_weight), and colour mixes by the pixel's
    weight q/127.5 where it has one or the voxel is still black.
    depth_m (H,W) metres (0 invalid), rgb (H,W,3) f32, color_w (H,W) in
    [0,2] (a bool mask means where(mask, 0, 2)). vol.tsdf may be a
    z-slab (Rz,R,R) of the R^3 volume whose first physical plane is
    z_phys_offset (the sharded dense step's). Returns vol."""
    from slambench.reference.maps import quantize_color_w
    from slambench.reference.reduce import round_to_int

    Rz, R = vol.tsdf.shape[0], vol.tsdf.shape[1]
    z_chunk = min(z_chunk, Rz)
    assert Rz % z_chunk == 0
    H, W = depth_m.shape
    dev = depth_m.device
    if color_w.dtype == torch.bool:
        color_w = torch.where(color_w, 0.0, 2.0)
    flat_q = quantize_color_w(color_w).reshape(-1)
    flat_ray = scale_depth(cam, depth_m).reshape(-1)
    rgb_u32 = pack_cw(torch.zeros(rgb.shape[:2], device=dev), rgb[..., 0],
                      rgb[..., 1], rgb[..., 2]).reshape(-1)
    trunc_t = torch.full((), trunc_dist, dtype=torch.float32, device=dev)
    q_scale = torch.full((), 127.5, dtype=torch.float32, device=dev)

    # inv_ex: no host check of the result (jnp.linalg.inv makes none)
    Tinv = torch.linalg.inv_ex(T_cam_to_local)[0]
    Rcl, tcl = Tinv[:3, :3], Tinv[:3, 3]
    wrap = vol.wrap
    p_idx = torch.arange(R, dtype=torch.int32, device=dev)
    wx = (((p_idx - wrap[0]) % R).to(torch.float32) + 0.5) * voxel_size
    wy = (((p_idx - wrap[1]) % R).to(torch.float32) + 0.5) * voxel_size
    # camera coordinates are affine in (wx, wy, wz): separable pieces,
    # broadcast-added a chunk at a time
    cx_x, cy_x, cz_x = Rcl[0, 0] * wx, Rcl[1, 0] * wx, Rcl[2, 0] * wx
    cx_y, cy_y, cz_y = Rcl[0, 1] * wy, Rcl[1, 1] * wy, Rcl[2, 1] * wy

    def bc(vx, vy, vz, t):  # (R,)x, (R,)y, (C,)z -> (C,R,R)
        return vx[None, None, :] + vy[None, :, None] + vz[:, None, None] + t

    for z0 in range(0, Rz, z_chunk):
        pz = z_phys_offset + z0 + torch.arange(z_chunk, dtype=torch.int32, device=dev)
        wz = (((pz - wrap[2]) % R).to(torch.float32) + 0.5) * voxel_size
        x = bc(cx_x, cx_y, Rcl[0, 2] * wz, tcl[0])
        y = bc(cy_x, cy_y, Rcl[1, 2] * wz, tcl[1])
        z = bc(cz_x, cz_y, Rcl[2, 2] * wz, tcl[2])
        zs = torch.clamp(z, min=1e-6)
        ui = round_to_int(x / zs * cam.fx + cam.cx)
        vi = round_to_int(y / zs * cam.fy + cam.cy)
        del zs
        in_img = (z > 0) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        idx = torch.clamp(vi, 0, H - 1) * W + torch.clamp(ui, 0, W - 1)
        del ui, vi
        samp_ray = flat_ray[idx]
        valid = in_img & (samp_ray > 0)
        del in_img
        sdf = samp_ray - sqrt_rn(x * x + y * y + z * z)
        del x, y, z, samp_ray
        fuse = valid & (sdf >= -trunc_dist)
        del valid
        tsdf_new = torch.clamp(sdf / trunc_t, max=1.0)
        del sdf

        t_old = vol.tsdf[z0:z0 + z_chunk]
        cw_old = vol.cw[z0:z0 + z_chunk]
        w_old, r_old, g_old, b_old = unpack_cw(cw_old)
        t_upd = torch.where(
            fuse, (t_old * w_old + tsdf_new) / torch.clamp(w_old + 1.0, min=1.0), t_old)
        del tsdf_new
        w_upd = torch.where(fuse, torch.clamp(w_old + 1.0, max=max_weight), w_old)
        samp_q = flat_q[idx].to(torch.float32)
        w_c = samp_q / q_scale
        _, r_new, g_new, b_new = unpack_cw(rgb_u32[idx])
        del idx
        black = (r_old + g_old + b_old) == 0
        cfuse = fuse & ((samp_q > 0) | black)
        del fuse, samp_q, black
        inv_w = 1.0 / torch.clamp(w_old + w_c, min=1e-6)

        def mix(old, new):
            return torch.where(cfuse, (old * w_old + w_c * new) * inv_w, old)

        cw_upd = pack_cw(w_upd, mix(r_old, r_new), mix(g_old, g_new), mix(b_old, b_new))
        t_old.copy_(t_upd)
        cw_old.copy_(cw_upd)
    return vol


def clear_band(vol: VolumeState, axis: int, lo: int, hi: int) -> VolumeState:
    """Zero tsdf, weight and colour, in place, where the logical
    coordinate along `axis` (0=x, 1=y, 2=z) lies in [lo, hi) mod R (JAX
    clear_band, ops/tsdf.py:217-245): one masked pass. The band wraps;
    lo == hi clears nothing. Returns vol."""
    R = vol.tsdf.shape[0]
    logical = (torch.arange(R, dtype=torch.int32, device=vol.tsdf.device)
               - vol.wrap[axis]) % R
    lo, hi = lo % R, hi % R
    if lo <= hi:
        in_band = (logical >= lo) & (logical < hi)
    else:
        in_band = (logical >= lo) | (logical < hi)
    shape = [1, 1, 1]
    shape[2 - axis] = R  # x is the last array dimension
    keep = torch.logical_not(in_band).reshape(shape)
    vol.tsdf.mul_(keep)  # tsdf * keep, as the JAX package (-0.0 kept)
    vol.cw.masked_fill_(torch.logical_not(keep), 0)
    return vol


def _corners(flat: torch.Tensor, R: int, wrap: torch.Tensor, pos: torch.Tensor):
    """The 8 corner values around fractional logical voxel coordinates
    pos (3, ...) [x,y,z], wrapped, in one gather: (..., 2, 2, 2) indexed
    [cz, cy, cx]; and the fractions (3, ...). The three axes go through
    each operation together, so a call launches a dozen kernels, not
    three dozen."""
    base = torch.floor(pos).to(torch.int64)  # the gather's index type
    frac = pos - base.to(torch.float32)
    one = torch.arange(2, dtype=torch.int64, device=flat.device)
    w = wrap.reshape(3, *([1] * pos.dim()))
    ix, iy, iz = (base[..., None] + one + w) % R  # (3, ..., 2)
    idx = (iz[..., :, None, None] * R + iy[..., None, :, None]) * R + ix[..., None, None, :]
    return flat[idx], frac


def _lerp3(c: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """Trilinear value from the corners (..., 2, 2, 2) [cz, cy, cx] and
    the fractions (3, ...): x, then y, then z, each lerp as the JAX
    package writes it, a * (1 - f) + b * f, on all pairs of a level at
    once."""
    g = 1 - frac
    cx = c[..., 0] * g[0][..., None, None] + c[..., 1] * frac[0][..., None, None]
    cy = cx[..., 0] * g[1][..., None] + cx[..., 1] * frac[1][..., None]
    return cy[..., 0] * g[2] + cy[..., 1] * frac[2]


_CORNER_ORDER = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
                 (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))  # [cz, cy, cx]


def trilinear_sample(tsdf: torch.Tensor, wrap: torch.Tensor,
                     pos_vox: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                     torch.Tensor]:
    """Trilinear sample of the wrapped volume at fractional logical voxel
    coordinates pos_vox (...,3) [x,y,z] in voxel-centre units (JAX
    trilinear_sample, ops/tsdf.py:248-287). Returns (value, the corners
    (...,8) in the order c000, c100, c010, c110, c001, c101, c011, c111
    (x fastest), the fractions (...,3))."""
    c, frac = _corners(tsdf.reshape(-1), tsdf.shape[0], wrap, torch.movedim(pos_vox, -1, 0))
    corners = torch.stack([c[..., z, y, x] for z, y, x in _CORNER_ORDER], dim=-1)
    return _lerp3(c, frac), corners, torch.movedim(frac, 0, -1)


def _gradient(c: torch.Tensor, frac: torch.Tensor):
    """Analytic gradient (dx, dy, dz) of the trilinear cell, from the
    corners (..., 2, 2, 2) [cz, cy, cx] and the fractions (3, ...); the
    terms in JAX trilinear_gradient's order."""
    fx, fy, fz = frac
    gx, gy, gz = 1 - frac

    def k(z, y, x):
        return c[..., z, y, x]

    dx = ((k(0, 0, 1) - k(0, 0, 0)) * gy * gz + (k(0, 1, 1) - k(0, 1, 0)) * fy * gz
          + (k(1, 0, 1) - k(1, 0, 0)) * gy * fz + (k(1, 1, 1) - k(1, 1, 0)) * fy * fz)
    dy = ((k(0, 1, 0) - k(0, 0, 0)) * gx * gz + (k(0, 1, 1) - k(0, 0, 1)) * fx * gz
          + (k(1, 1, 0) - k(1, 0, 0)) * gx * fz + (k(1, 1, 1) - k(1, 0, 1)) * fx * fz)
    dz = ((k(1, 0, 0) - k(0, 0, 0)) * gx * gy + (k(1, 0, 1) - k(0, 0, 1)) * fx * gy
          + (k(1, 1, 0) - k(0, 1, 0)) * gx * fy + (k(1, 1, 1) - k(0, 1, 1)) * fx * fy)
    return dx, dy, dz


def trilinear_gradient(corners: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """Gradient of the trilinear interpolant in voxel units (...,3), from
    trilinear_sample's corners (...,8) and fractions (...,3) (JAX
    trilinear_gradient, ops/tsdf.py:290-317)."""
    c = torch.empty((*corners.shape[:-1], 2, 2, 2), dtype=corners.dtype,
                    device=corners.device)
    for i, (z, y, x) in enumerate(_CORNER_ORDER):
        c[..., z, y, x] = corners[..., i]
    return torch.stack(_gradient(c, torch.movedim(frac, -1, 0)), dim=-1)
