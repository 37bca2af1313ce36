# Frozen copy of kintinuous_tpu_torch/ops/maps.py, the benchmark's plain
# reference: imports point into this package, and it is never updated
# to follow the program, which it judges.
"""Vertex and normal maps (port of kintinuous_tpu/ops/maps.py).

Maps are (3,H,W) float32, NaN marking invalid entries.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from slambench.reference.config import CameraIntrinsics
from slambench.reference.camera import unproject


def create_vmap(cam: CameraIntrinsics, depth_m: torch.Tensor) -> torch.Tensor:
    """(H,W) metres (0=invalid) -> (3,H,W) camera-frame vertices."""
    return unproject(cam, torch.where(depth_m > 0, depth_m, torch.nan))


def create_nmap(vmap: torch.Tensor) -> torch.Tensor:
    """Cross-product normals from right/down neighbours, normalised; NaN
    on the last row/col and wherever an operand is invalid."""
    v = vmap
    right = F.pad(v[:, :, 1:], (0, 1), value=float("nan"))
    down = F.pad(v[:, 1:, :], (0, 0, 0, 1), value=float("nan"))
    a = right - v
    b = down - v
    n = torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ],
        dim=0,
    )
    norm = torch.sqrt(torch.sum(n * n, dim=0, keepdim=True))
    return torch.where(norm > 1e-12, n / norm, torch.nan)


def transform_maps(vmap: torch.Tensor, nmap: torch.Tensor, T: torch.Tensor):
    """Both maps (3,H,W) under the rigid transform T (4,4): R v + t and R n."""
    R, t = T[:3, :3], T[:3, 3]
    v = torch.einsum("ij,jhw->ihw", R, vmap) + t[:, None, None]
    n = torch.einsum("ij,jhw->ihw", R, nmap)
    return v, n


def _avg_pool2(m: torch.Tensor) -> torch.Tensor:
    """2x2 NaN-aware average downsample of (3,H,W)."""
    C, H, W = m.shape
    He, We = (H // 2) * 2, (W // 2) * 2
    q = m[:, :He, :We].reshape(C, He // 2, 2, We // 2, 2)
    valid = torch.isfinite(q).all(dim=0, keepdim=True)
    s = torch.where(valid, q, 0.0).sum(dim=(2, 4))
    cnt = valid.to(m.dtype).sum(dim=(2, 4))
    return torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), torch.nan)


def resize_vmap(vmap: torch.Tensor) -> torch.Tensor:
    return _avg_pool2(vmap)


def resize_nmap(nmap: torch.Tensor) -> torch.Tensor:
    n = _avg_pool2(nmap)
    norm = torch.sqrt(torch.sum(n * n, dim=0, keepdim=True))
    return torch.where(norm > 1e-12, n / norm, torch.nan)


def color_fusion_weight(cam, depth_m, disc_mask, angle: bool = True):
    """Per-pixel colour fusion weight min(1, |n_z|/0.75) * 2 from the
    current frame's normals; 0 on invalid normals and discontinuities."""
    vmap = create_vmap(cam, depth_m)
    nmap = create_nmap(vmap)
    nz = torch.abs(nmap[2])
    valid = torch.isfinite(nmap).all(dim=0) & (depth_m > 0)
    if angle:
        w = torch.clamp(nz / 0.75, max=1.0) * 2.0
    else:
        w = torch.full_like(nz, 2.0)
    return torch.where(valid & torch.logical_not(disc_mask), w, 0.0)


def quantize_color_w(w: torch.Tensor) -> torch.Tensor:
    """Colour weight [0,2] -> byte (int32)."""
    return torch.clamp(torch.round(w * 127.5), 0, 255).to(torch.int32)
