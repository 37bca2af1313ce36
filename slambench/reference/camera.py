# Frozen copy of kintinuous_tpu_torch/geometry/camera.py, the benchmark's plain
# reference: imports point into this package, and it is never updated
# to follow the program, which it judges.
"""Pinhole camera projection helpers (port of kintinuous_tpu/geometry/camera.py)."""

from __future__ import annotations

import torch

from slambench.reference.config import CameraIntrinsics


def intrinsics_matrix(cam: CameraIntrinsics, dtype=torch.float32, device=None):
    return torch.tensor(
        [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
        dtype=dtype, device=device,
    )


def unproject(cam: CameraIntrinsics, depth):
    """Depth map (H,W) in metres -> vertex map (3,H,W) in camera frame.

    Invalid depth (<=0 or nan) produces nan vertices (the reference's
    NaN-poisoned vmap convention)."""
    H, W = depth.shape
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :]
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    valid = torch.isfinite(depth) & (depth > 0)
    z = torch.where(valid, depth, torch.nan)
    x = (u - cam.cx) / cam.fx * z
    y = (v - cam.cy) / cam.fy * z
    return torch.stack([x, y, z], dim=0)


def project(cam: CameraIntrinsics, pts):
    """Points (...,3) in camera frame -> pixel coords (...,2) (u,v) + valid
    mask (z > 0 and the projected pixel inside the image)."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    zsafe = torch.where(z > 1e-6, z, 1.0)
    u = x / zsafe * cam.fx + cam.cx
    v = y / zsafe * cam.fy + cam.cy
    valid = (
        (z > 1e-6)
        & (u >= 0)
        & (u <= cam.width - 1)
        & (v >= 0)
        & (v <= cam.height - 1)
        & torch.isfinite(u)
        & torch.isfinite(v)
    )
    return torch.stack([u, v], dim=-1), valid


def bilinear_sample(img, uv, valid=None):
    """Sample an (..., H, W) image bilinearly at float pixel coordinates uv
    (..., 2). Coordinates are clamped into the image; where `valid` (from
    project) is False the sample is NaN. NaN-safe only for a NaN-free image."""
    H, W = img.shape[-2], img.shape[-1]
    u = torch.clamp(uv[..., 0], 0.0, W - 1.000001)
    v = torch.clamp(uv[..., 1], 0.0, H - 1.000001)
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    du = u - u0
    dv = v - v0
    u1 = torch.clamp(u0 + 1, max=W - 1)
    v1 = torch.clamp(v0 + 1, max=H - 1)
    flat = img.reshape(img.shape[:-2] + (H * W,))

    def take(vv, uu):
        return flat[..., vv * W + uu]

    s = (take(v0, u0) * (1 - du) * (1 - dv) + take(v0, u1) * du * (1 - dv)
         + take(v1, u0) * (1 - du) * dv + take(v1, u1) * du * dv)
    if valid is not None:
        s = torch.where(valid, s, torch.nan)
    return s


def nearest_sample(img, uv):
    """Nearest-neighbour sample of an (..., H, W) image at uv (..., 2),
    clamped into the image (halves round to even, as jnp.round does)."""
    H, W = img.shape[-2], img.shape[-1]
    u = torch.clamp(torch.round(uv[..., 0]).to(torch.int64), 0, W - 1)
    v = torch.clamp(torch.round(uv[..., 1]).to(torch.int64), 0, H - 1)
    flat = img.reshape(img.shape[:-2] + (H * W,))
    return flat[..., v * W + u]
