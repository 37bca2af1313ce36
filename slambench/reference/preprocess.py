# Frozen copy of kintinuous_tpu_torch/ops/preprocess.py, the benchmark's plain
# reference: imports point into this package, and it is never updated
# to follow the program, which it judges.
"""Depth and intensity preprocessing (port of
kintinuous_tpu/ops/preprocess.py).

Window ops are sums of statically shifted copies of a zero-padded image,
accumulated in the same order as the JAX package so the two agree to
rounding. Depth maps are float32 with 0 marking invalid pixels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _padded(img: torch.Tensor, r: int, value: float = 0.0) -> torch.Tensor:
    return F.pad(img[None], (r, r, r, r), value=value)[0]


def _window(padded: torch.Tensor, r: int, dy: int, dx: int, H: int, W: int):
    """result[y,x] = img[y+dy, x+dx] from an image padded by r."""
    return padded[r + dy : r + dy + H, r + dx : r + dx + W]


def bilateral_filter(depth_mm: torch.Tensor, sigma_depth_mm: float = 30.0,
                     sigma_space: float = 4.5, radius: int = 6) -> torch.Tensor:
    """Edge-preserving depth smoothing over a (2r+1)^2 window."""
    H, W = depth_mm.shape
    valid = depth_mm > 0
    inv2_d = 0.5 / (sigma_depth_mm * sigma_depth_mm)
    inv2_s = 0.5 / (sigma_space * sigma_space)
    p = _padded(depth_mm, radius)
    wsum = torch.zeros_like(depth_mm)
    vsum = torch.zeros_like(depth_mm)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            n = _window(p, radius, dy, dx, H, W)
            diff = n - depth_mm
            w = torch.exp(-(diff * diff) * inv2_d - (dy * dy + dx * dx) * inv2_s)
            w = torch.where(n > 0, w, 0.0)
            wsum = wsum + w
            vsum = vsum + w * n
    out = torch.where(wsum > 0, vsum / torch.clamp(wsum, min=1e-12), 0.0)
    return torch.where(valid, out, 0.0)


def _subsample2(img: torch.Tensor) -> torch.Tensor:
    H, W = img.shape
    return img[: (H // 2) * 2 : 2, : (W // 2) * 2 : 2]


def pyr_down_depth(depth: torch.Tensor, sigma: float = 3.0 * 30.0) -> torch.Tensor:
    """Depth-aware 2x downsample: mean of the 5x5 neighbours within
    `sigma` of the centre, taken at every even pixel."""
    H, W = depth.shape
    p = _padded(depth, 2)
    ssum = torch.zeros_like(depth)
    cnt = torch.zeros_like(depth)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            n = _window(p, 2, dy, dx, H, W)
            ok = (n > 0) & (torch.abs(n - depth) < sigma)
            ssum = ssum + torch.where(ok, n, 0.0)
            cnt = cnt + ok.to(depth.dtype)
    out = torch.where(cnt > 0, ssum / torch.clamp(cnt, min=1.0), 0.0)
    return _subsample2(torch.where(depth > 0, out, 0.0))


_BINOMIAL5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def pyr_down_gauss(img: torch.Tensor) -> torch.Tensor:
    """5x5 binomial blur (rows, then columns, zero padding) and a
    stride-2 downsample, for intensity images."""
    H, W = img.shape
    p = _padded(img, 2)
    tmp = torch.zeros_like(img)
    for k, dy in zip(_BINOMIAL5, range(-2, 3)):
        tmp = tmp + k * _window(p, 2, dy, 0, H, W)
    p = _padded(tmp, 2)
    out = torch.zeros_like(img)
    for k, dx in zip(_BINOMIAL5, range(-2, 3)):
        out = out + k * _window(p, 2, 0, dx, H, W)
    return _subsample2(out)


def depth_to_metres(depth_mm: torch.Tensor, max_depth_m: float = 6.0) -> torch.Tensor:
    """mm -> metres; 0 marks invalid, far-clip to 0."""
    d = depth_mm.to(torch.float32) * 1e-3
    return torch.where((d > 0) & (d < max_depth_m), d, 0.0)


def rgb_to_intensity(rgb: torch.Tensor) -> torch.Tensor:
    """(H,W,3) RGB -> (H,W) float32 luma in [0,255]."""
    r, g, b = (rgb[..., c].to(torch.float32) for c in range(3))
    return 0.299 * r + 0.587 * g + 0.114 * b


def sobel_gradients(img: torch.Tensor):
    """3x3 Sobel dI/dx, dI/dy scaled by 1/8 (zero padding)."""
    H, W = img.shape
    p = _padded(img, 1)

    def s(dy, dx):
        return _window(p, 1, dy, dx, H, W)

    gx = ((s(-1, 1) + 2.0 * s(0, 1) + s(1, 1))
          - (s(-1, -1) + 2.0 * s(0, -1) + s(1, -1))) * 0.125
    gy = ((s(1, -1) + 2.0 * s(1, 0) + s(1, 1))
          - (s(-1, -1) + 2.0 * s(-1, 0) + s(-1, 1))) * 0.125
    return gx, gy


def depth_discontinuity_mask(depth_m: torch.Tensor, radius: int = 3,
                             jump_m: float = 0.2) -> torch.Tensor:
    """True where the (2r+1)^2 window holds a depth jump > jump_m."""
    H, W = depth_m.shape
    p = _padded(depth_m, radius)
    out = torch.zeros(depth_m.shape, dtype=torch.bool, device=depth_m.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            n = _window(p, radius, dy, dx, H, W)
            out = out | ((n > 0) & (torch.abs(n - depth_m) > jump_m))
    return out & (depth_m > 0)
