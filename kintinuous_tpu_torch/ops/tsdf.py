"""TSDF volume state, packed colour/weight words and ray-length scaling
(the subset of kintinuous_tpu/ops/tsdf.py the fast tracker needs).

Conventions, shared with the rest of the port:
- volumes are indexed [z, y, x]; coordinate and wrap vectors are [x, y, z];
- logical voxel g has local-world centre (g + 0.5) * voxel;
- the packed word is weight<<24 | r<<16 | g<<8 | b, stored as int32
  BITS (torch has no uint32 shift on the CPU). max_weight=128 sets bit
  31, so a stored word can be negative: always unpack with
  ``(x >> s) & 0xFF``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kintinuous_tpu_torch.config import CameraIntrinsics


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
