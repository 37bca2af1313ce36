"""Keyframe features and the bag-of-words vocabulary (port of
kintinuous_tpu/backend/features.py).

Detect ORB features on each place-recognition keyframe, quantise the
descriptors into visual words, and score frames for loop-closure
candidates with an inverted index and tf-idf L1 similarity.

The detector is the port's own, in PyTorch, and runs on the device of
its input (the JAX package calls OpenCV's ORB on the host). It follows
what `cv2.ORB_create(nfeatures=500, fastThreshold=12)` runs: an 8-level
pyramid at a scale of 1.2 with the features shared out over the levels
in a geometric series; on each level FAST-9 on the 16-pixel circle with
3x3 non-maximum suppression on OpenCV's corner score, a 31-pixel
border, the best 2n corners by FAST score and then the best n by the
Harris score (7x7 block, k = 0.04); orientation by the intensity
centroid of the radius-15 disc; and a steered 256-bit BRIEF on the level
image after a 7x7, sigma = 2 Gaussian. The level-0 corners are
OpenCV's. The BRIEF point pairs are not OpenCV's learned table: they
are drawn once from a fixed seed (an isotropic Gaussian of sigma 31/5,
clipped to 13 pixels) and kept below as a literal table. Descriptors
therefore differ from OpenCV's, and a vocabulary trained on OpenCV's
descriptors does not transfer; `train_vocab_from_klg` trains one on the
port's. The pyramid and the blur use fixed-point integer arithmetic,
so the card and the CPU compute the same pixels.

Matching, the vocabulary and the database are numpy on the host, as in
the JAX package, with the same `argsort`, `unique` and `default_rng`
calls, so ties and draws come out the same.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

N_LEVELS = 8
SCALE_FACTOR = 1.2
EDGE_THRESHOLD = 31  # border kept free of keypoints (patchSize)
FAST_THRESHOLD = 12
HARRIS_BLOCK = 7
HARRIS_K = 0.04
HALF_PATCH = 15

# FAST's 16-pixel Bresenham circle of radius 3, (dx, dy) in ring order
_CIRCLE = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
           (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3))

# the steered BRIEF's 256 point pairs, (x0, y0, x1, y1) a bit: drawn once
# with np.random.default_rng(31).normal(0, 31 / 5, (512, 2)), rounded and
# clipped to [-13, 13]
_BRIEF_PATTERN = (
    -2, 2, 4, -6, 5, 2, 5, 2, 7, -6, 11, 7, -4, 4, 3, -11,
    4, -4, -2, -4, -3, 0, 1, -10, -2, -8, -8, -2, 5, 4, -4, -4,
    -5, 1, 6, 0, 4, 2, 9, -12, -13, -1, 4, -3, 3, -7, -8, -4,
    5, 4, -4, 1, -4, 0, -7, 0, -5, 0, -4, -5, 1, -2, 0, -3,
    4, -5, 5, 8, -2, 11, 13, 3, -8, -10, -1, 11, 4, 5, -2, -5,
    2, -7, -1, 3, 0, 3, -3, 4, 3, -10, -6, -4, 4, 2, 2, 1,
    4, 6, -3, -10, 4, -1, 0, -1, -7, -9, 6, 7, 6, 1, 2, -3,
    0, -2, -3, 1, 11, -12, 4, 4, -8, 2, 1, -3, -3, -9, 11, 13,
    10, -2, 2, 2, -5, -2, 3, -3, -11, -8, 2, -2, -2, 8, 1, -4,
    0, 13, -7, 11, 9, -1, -2, 9, 2, -3, 11, 1, 2, 0, -2, 1,
    -2, 3, 7, 7, 7, 9, 5, -4, 6, -10, -4, 2, -10, 9, -6, -9,
    -5, -5, 0, -1, 6, -1, 1, -6, 3, -5, -12, 8, -7, -7, -5, 4,
    -9, -2, 4, 12, -2, 0, -5, 12, -1, 0, 1, -6, 0, -8, 9, -1,
    -1, 7, -8, 9, 9, -5, 4, -1, 5, 0, -6, 4, -1, 1, 6, 8,
    4, -9, 4, -2, 7, -1, 9, 3, 0, 2, -11, 4, 1, -7, 3, 2,
    2, -1, 5, 5, 1, 0, -3, -4, 4, -3, -9, 2, 7, -2, 5, 3,
    -6, 2, -1, 4, -13, 5, 5, -6, 7, -1, 1, 5, 8, 1, 4, 3,
    -4, 10, 5, 1, 7, 3, -3, 6, 0, 4, 6, 6, 12, 1, -1, -4,
    -4, 4, 3, -5, -4, -3, 10, -6, 2, -10, -1, 9, -8, 7, -11, 1,
    -7, 0, -1, 5, 2, 1, -3, 3, -5, -4, -4, 4, 13, 0, 12, -6,
    -3, 3, 4, 5, 10, -1, 7, 2, -13, -6, -3, 1, 4, -1, 8, -6,
    0, 6, -7, 8, 6, -1, 0, 0, 0, 8, 3, -8, -9, 4, -13, -9,
    -4, 0, 9, 1, 13, 2, 6, 7, 0, 6, 4, 2, -4, -2, 5, 0,
    3, 3, 2, 0, 4, 5, 9, 3, -3, -4, 4, -9, -3, 7, -2, -4,
    8, -13, 0, -3, -3, 6, 9, 7, 4, 2, -1, 0, -10, -3, 4, -1,
    5, -9, -3, -6, 7, -1, -2, -7, -3, -6, -3, 13, -7, -1, -5, 8,
    -6, -5, 2, 10, 2, -3, -13, -13, 0, 0, 7, 3, -1, 8, 11, -4,
    6, 8, -5, 4, 0, 7, 7, -13, -1, 9, 3, -6, -3, -7, 2, -8,
    8, 5, 11, 7, 6, 6, 4, -12, 4, -5, -13, 10, 0, -10, 2, 3,
    1, 9, -7, 6, -6, 3, 4, -3, 13, -11, -9, -3, -5, 7, -3, 8,
    -3, 5, 5, 1, 5, 2, 13, 13, -2, 3, 7, 4, 12, 13, -12, -3,
    9, 4, -4, -1, 1, 11, -6, 2, 9, 7, -1, -1, -11, -10, -5, 5,
    5, 8, 6, 5, 1, -5, 8, -2, -11, 3, 1, 13, -1, 2, -7, 4,
    2, -5, 2, -8, 4, -3, 2, -6, -5, -1, 5, 1, -13, 4, -1, 4,
    7, 5, -5, -2, 3, 6, -5, -4, -6, 3, -4, 13, 5, 7, 4, -4,
    -13, 9, 2, -12, 13, 5, 10, -1, -11, -5, 5, -13, -3, 7, 7, 1,
    -13, -2, 8, 5, -2, 2, 4, -2, -5, -4, -5, 0, 0, 4, 4, -1,
    -13, 4, -6, 11, -2, 13, 4, 11, 1, 3, -3, -3, -3, 5, -7, 6,
    -2, 4, -6, 0, -11, -4, -1, -6, -1, 1, 1, -13, -2, -1, -5, -6,
    12, 5, 6, 7, -6, -2, -11, 1, -12, -4, 5, 3, -6, -6, 8, 3,
    -3, 1, 1, -7, -3, -13, 1, 1, 6, 6, -3, 10, -5, 6, -3, -4,
    -8, 0, 13, 1, 3, -2, 3, 4, 3, 9, 0, 3, 10, 4, -5, 8,
    4, -5, -5, -2, 5, 2, 6, 13, 11, 1, -4, 9, -4, -5, -1, 2,
    -1, 2, -13, -2, 0, 4, 2, -1, 13, 6, 4, 2, 3, -5, -6, 2,
    -10, 4, -2, 5, 1, -5, -4, -2, 8, 9, -1, 1, -5, 9, 2, -4,
    -8, 3, 12, 1, -5, -5, -3, -13, 6, -3, -11, -13, 2, 1, 9, 6,
    -3, -11, 1, -4, 1, -10, -2, -1, -8, -11, -13, 0, 7, 0, -13, 0,
    -10, 1, 11, 2, -13, 6, 2, 12, 3, 4, -11, 9, -8, -13, 3, 5,
    9, 7, 2, 2, 5, 2, 3, -13, -1, -2, 3, -5, 6, 5, -7, 0,
    3, -7, -13, -2, 2, 0, 7, 2, 10, -4, 10, -2, 3, -12, -5, 7,
    0, 0, -7, 5, -6, 9, 4, -3, -5, -3, 2, 2, -10, 2, -7, 11,
    -12, 6, -7, 2, 7, 3, -7, -10, 9, -5, 5, 7, -10, 12, -1, -1,
    -6, 1, 3, 7, 6, 6, -1, -1, 1, 1, 8, 6, -1, -6, -12, -1,
    0, -12, -2, 2, 1, -9, -4, -9, 5, 2, 13, -4, 9, 0, 1, 7,
    -12, -7, 9, 6, 12, 4, -3, 5, -3, 0, -1, -5, 13, 4, 1, 2,
    -4, -2, 1, 2, -13, 8, -13, -6, -9, 1, -11, 6, 4, 6, 5, -2,
    1, -6, -3, 3, -8, -2, -3, 6, 3, -3, 5, 12, 7, 1, 1, -6,
    -3, 2, 2, -9, -8, -8, -7, -4, -1, -7, -4, -12, -2, 1, -4, -10,
    13, -5, 2, -13, -5, 1, -1, 1, 0, -5, -6, -2, -4, -4, 2, 1,
    -3, 6, -1, -2, 5, 1, -10, 2, -10, -2, 1, 4, -6, -3, 4, 12,
    12, 5, 10, -4, -2, 5, 5, -10, 7, -6, -1, -7, -2, 6, -8, -4,
    0, 3, 10, 1, 6, -10, -4, -13, 7, -4, 4, -7, -7, -7, -5, -2,
    -11, 0, 3, -12, -10, -7, -6, 10, 4, -8, 13, 5, -8, -11, 2, -11,
    1, 5, -6, -5, -6, 8, 4, 3, 5, 0, -4, 2, 5, -1, -2, -6,
)


_SCALE_SQ_SQ = np.float32(1.0) / (np.float32(4 * HARRIS_BLOCK) * np.float32(255.0))
_SCALE_SQ_SQ = _SCALE_SQ_SQ * _SCALE_SQ_SQ * _SCALE_SQ_SQ * _SCALE_SQ_SQ


def _round_half_even(x: float) -> int:
    return int(np.rint(x))


def _disc_rows(half: int = HALF_PATCH) -> List[int]:
    """The half-width of each row of the orientation disc (OpenCV's
    u_max, made symmetric about the diagonal)."""
    vmax = math.floor(half * math.sqrt(2.0) / 2 + 1)
    vmin = math.ceil(half * math.sqrt(2.0) / 2)
    umax = [0] * (half + 2)
    for v in range(vmax + 1):
        umax[v] = _round_half_even(math.sqrt(half * half - v * v))
    v0 = 0
    for v in range(half, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: half + 1]


def _gauss7_fixed() -> List[int]:
    """7-tap sigma-2 Gaussian in 8-bit fixed point, summing to 256."""
    k = np.exp(-((np.arange(7) - 3.0) ** 2) / (2 * 2.0 ** 2))
    w = np.rint(k / k.sum() * 256).astype(int)
    w[3] += 256 - w.sum()
    return w.tolist()


def level_layout(width: int, height: int, n_features: int) -> List[tuple]:
    """(scale, width, height, features) of each pyramid level, as ORB
    sizes them: level l is 1.2^l smaller, and the n features are shared
    out in a geometric series whose last level takes the remainder."""
    factor = np.float32(1.0 / SCALE_FACTOR)
    per = (np.float32(n_features) * (np.float32(1.0) - factor)
           / (np.float32(1.0) - np.float32(float(factor) ** N_LEVELS)))
    counts, total = [], 0
    for _ in range(N_LEVELS - 1):
        counts.append(_round_half_even(per))
        total += counts[-1]
        per = np.float32(per * factor)
    counts.append(max(n_features - total, 0))
    out = []
    for lev in range(N_LEVELS):
        scale = np.float32(SCALE_FACTOR ** lev)
        inv = np.float32(1.0) / scale
        out.append((scale, _round_half_even(np.float32(width) * inv),
                    _round_half_even(np.float32(height) * inv), counts[lev]))
    return out


def rgb_to_gray(rgb) -> torch.Tensor:
    """(H,W,3) uint8 RGB -> (H,W) uint8 with OpenCV 5.0's fixed-point
    COLOR_RGB2GRAY, (9798 R + 19235 G + 3735 B + 16384) >> 15: equal to
    cv2.cvtColor on all 2^24 colours (OpenCV 4's 14-bit weights, 4899,
    9617 and 1868, differ from it by one on 43,864 of them). A tensor
    stays on its device; a numpy array becomes a CPU tensor."""
    if isinstance(rgb, np.ndarray):
        rgb = torch.from_numpy(np.ascontiguousarray(rgb))
    x = rgb.to(torch.int32)
    g = (x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + 16384) >> 15
    return g.to(torch.uint8)


def _resize(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of a uint8 image (pixel centres at +0.5), with
    8-bit fixed-point weights in each direction and one rounding."""
    H, W = img.shape
    dev = img.device

    def taps(n_out, n_in):
        s = np.maximum((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0)
        i0 = np.minimum(np.floor(s).astype(np.int64), n_in - 1)
        w1 = np.rint((s - np.floor(s)) * 256).astype(np.int32)
        i1 = np.minimum(i0 + 1, n_in - 1)

        def t(a):
            return torch.from_numpy(a).to(dev)

        return t(i0), t(i1), t(256 - w1), t(w1)

    y0, y1, wy0, wy1 = taps(h, H)
    x0, x1, wx0, wx1 = taps(w, W)
    x = img.to(torch.int32)
    rows = x[y0] * wy0[:, None] + x[y1] * wy1[:, None]
    out = rows[:, x0] * wx0 + rows[:, x1] * wx1
    return ((out + (1 << 15)) >> 16).to(torch.uint8)


def _blur(img: torch.Tensor) -> torch.Tensor:
    """7x7, sigma = 2 Gaussian in fixed point on the image's interior;
    the 3-pixel frame keeps its pixels (BRIEF never samples within 12
    pixels of the edge)."""
    H, W = img.shape
    wts = _gauss7_fixed()
    x = img.to(torch.int32)
    hz = sum(wts[j] * x[:, j:W - 6 + j] for j in range(7))
    vt = sum(wts[i] * hz[i:H - 6 + i] for i in range(7))
    out = img.clone()
    out[3:H - 3, 3:W - 3] = ((vt + (1 << 15)) >> 16).to(torch.uint8)
    return out


def fast_scores(img: torch.Tensor, threshold: int = FAST_THRESHOLD) -> torch.Tensor:
    """(H,W) int16 FAST-9 corner scores of a uint8 image: a pixel is a
    corner when 9 contiguous pixels of its 16-pixel circle are all
    brighter than it by more than `threshold`, or all darker; its score
    is OpenCV's, the largest such margin over the arcs less one. 0 where
    there is no corner and on the 3-pixel frame."""
    H, W = img.shape
    out = torch.zeros((H, W), dtype=torch.int16, device=img.device)
    if H < 7 or W < 7:
        return out
    x = img.to(torch.int16)
    v = x[3:H - 3, 3:W - 3]
    d = torch.stack([v - x[3 + dy:H - 3 + dy, 3 + dx:W - 3 + dx] for dx, dy in _CIRCLE])
    ext = torch.cat([d, d[:8]])

    def arcs(op):
        # op over each run of 9 ring pixels, the runs starting at 0..15
        m2 = op(ext[:-1], ext[1:])
        m4 = op(m2[:-2], m2[2:])
        m8 = op(m4[:-4], m4[4:])
        return op(m8[:16], ext[8:24])

    darker = arcs(torch.minimum).amax(0)
    brighter = (-arcs(torch.maximum)).amax(0)
    best = torch.maximum(darker, brighter)
    out[3:H - 3, 3:W - 3] = torch.where(best > threshold, best - 1, torch.zeros_like(best))
    return out


def _nms(score: torch.Tensor) -> torch.Tensor:
    """Corners whose score beats all 8 neighbours."""
    H, W = score.shape
    p = torch.zeros((H + 2, W + 2), dtype=score.dtype, device=score.device)
    p[1:-1, 1:-1] = score
    nb = None
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            s = p[dy:dy + H, dx:dx + W]
            nb = s if nb is None else torch.maximum(nb, s)
    return (score > nb) & (score > 0)


def fast_detect(gray: torch.Tensor, threshold: int = FAST_THRESHOLD) -> torch.Tensor:
    """(N,2) int64 [x, y] of the FAST-9 corners that survive 3x3
    non-maximum suppression, in raster order (OpenCV's
    FastFeatureDetector with nonmaxSuppression on)."""
    ys, xs = torch.nonzero(_nms(fast_scores(gray, threshold)), as_tuple=True)
    return torch.stack([xs, ys], dim=1)


def _retain_best(resp: torch.Tensor, n: int) -> torch.Tensor:
    """Mask of the n best responses and every tie of the n-th
    (KeyPointsFilter::retainBest)."""
    if resp.numel() <= n:
        return torch.ones_like(resp, dtype=torch.bool)
    if n == 0:
        return torch.zeros_like(resp, dtype=torch.bool)
    return resp >= torch.topk(resp, n).values[-1]


def _harris(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Harris response of a 7x7 block of Sobel gradients about each
    keypoint, in OpenCV's integer sums and float32 formula."""
    x = img.to(torch.int32)
    ix = torch.zeros_like(x)
    iy = torch.zeros_like(x)
    ix[1:-1, 1:-1] = ((x[1:-1, 2:] - x[1:-1, :-2]) * 2 + (x[:-2, 2:] - x[:-2, :-2])
                      + (x[2:, 2:] - x[2:, :-2]))
    iy[1:-1, 1:-1] = ((x[2:, 1:-1] - x[:-2, 1:-1]) * 2 + (x[2:, :-2] - x[:-2, :-2])
                      + (x[2:, 2:] - x[:-2, 2:]))
    o = torch.arange(-(HARRIS_BLOCK // 2), HARRIS_BLOCK // 2 + 1, device=img.device)
    yy = ys[:, None, None] + o[None, :, None]
    xx = xs[:, None, None] + o[None, None, :]
    gx, gy = ix[yy, xx], iy[yy, xx]
    a = (gx * gx).sum((1, 2)).to(torch.float32)
    b = (gy * gy).sum((1, 2)).to(torch.float32)
    cc = (gx * gy).sum((1, 2)).to(torch.float32)
    k = torch.tensor(np.float32(HARRIS_K), device=img.device)
    s = a + b
    return ((a * b - cc * cc) - k * s * s) * torch.tensor(_SCALE_SQ_SQ, device=img.device)


def _disc_weights(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """u and v of each pixel of the radius-15 disc over a 31x31 patch
    (0 outside the disc)."""
    umax = _disc_rows()
    n = 2 * HALF_PATCH + 1
    u = np.zeros((n, n), np.int64)
    v = np.zeros((n, n), np.int64)
    for dv in range(-HALF_PATCH, HALF_PATCH + 1):
        r = umax[abs(dv)]
        for du in range(-r, r + 1):
            u[dv + HALF_PATCH, du + HALF_PATCH] = du
            v[dv + HALF_PATCH, du + HALF_PATCH] = dv
    return torch.from_numpy(u).to(device), torch.from_numpy(v).to(device)


def _ic_angle(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation in degrees, [0, 360)."""
    u, v = _disc_weights(img.device)
    o = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=img.device)
    patch = img.to(torch.int64)[ys[:, None, None] + o[None, :, None],
                                xs[:, None, None] + o[None, None, :]]
    m10 = (patch * u).sum((1, 2)).to(torch.float64)
    m01 = (patch * v).sum((1, 2)).to(torch.float64)
    ang = torch.rad2deg(torch.atan2(m01, m10))
    return torch.where(ang < 0, ang + 360.0, ang).to(torch.float32)


def _brief(blurred: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
           angle: torch.Tensor) -> torch.Tensor:
    """(N,32) uint8 steered BRIEF: bit k of byte i is set when the
    pattern's point 2(8i+k) is darker than point 2(8i+k)+1, the pattern
    rotated by the keypoint's angle (least significant bit first, as
    OpenCV packs them)."""
    dev = blurred.device
    pat = torch.tensor(_BRIEF_PATTERN, dtype=torch.float32, device=dev).view(-1, 2)
    rad = (angle * torch.tensor(np.float32(math.pi / 180.0), device=dev)).to(torch.float64)
    a = torch.cos(rad).to(torch.float32)[:, None]
    b = torch.sin(rad).to(torch.float32)[:, None]
    px, py = pat[None, :, 0], pat[None, :, 1]
    ix = torch.round(px * a - py * b).to(torch.int64)
    iy = torch.round(px * b + py * a).to(torch.int64)
    vals = blurred[ys[:, None] + iy, xs[:, None] + ix]
    bits = (vals[:, 0::2] < vals[:, 1::2]).view(-1, 32, 8).to(torch.int32)
    w = torch.tensor([1 << k for k in range(8)], dtype=torch.int32, device=dev)
    return (bits * w).sum(-1).to(torch.uint8)


def orb_keypoints(gray: torch.Tensor, n_features: int = 500) -> Dict[str, torch.Tensor]:
    """ORB on a (H,W) uint8 image, on its device: "pts" (N,2) float32
    [u, v] in level-0 pixels, "angle" (N,) degrees, "octave" (N,) the
    pyramid level, "desc" (N,32) uint8. Level by level, raster order
    within a level."""
    if gray.dtype != torch.uint8 or gray.dim() != 2:
        raise ValueError(f"detect_orb takes a (H,W) uint8 image, not {gray.dtype} "
                         f"{tuple(gray.shape)}")
    dev = gray.device
    H, W = gray.shape
    parts: Dict[str, list] = {"pts": [], "angle": [], "octave": [], "desc": []}
    img = gray
    for lev, (scale, w, h, n_keep) in enumerate(level_layout(W, H, n_features)):
        if lev:
            img = _resize(img, h, w)
        if n_keep == 0 or h <= 2 * EDGE_THRESHOLD or w <= 2 * EDGE_THRESHOLD:
            continue
        score = fast_scores(img)
        keep = _nms(score)
        e = EDGE_THRESHOLD
        keep[:e] = False
        keep[h - e:] = False
        keep[:, :e] = False
        keep[:, w - e:] = False
        ys, xs = torch.nonzero(keep, as_tuple=True)
        sel = _retain_best(score[ys, xs].to(torch.float32), 2 * n_keep)
        ys, xs = ys[sel], xs[sel]
        sel = _retain_best(_harris(img, ys, xs), n_keep)
        ys, xs = ys[sel], xs[sel]
        angle = _ic_angle(img, ys, xs)
        parts["desc"].append(_brief(_blur(img), ys, xs, angle))
        pts = torch.stack([xs, ys], dim=1).to(torch.float32)
        parts["pts"].append(pts * torch.tensor(scale, device=dev))
        parts["angle"].append(angle)
        parts["octave"].append(torch.full_like(xs, lev))
    if not parts["pts"]:
        return {"pts": torch.zeros((0, 2), dtype=torch.float32, device=dev),
                "angle": torch.zeros(0, dtype=torch.float32, device=dev),
                "octave": torch.zeros(0, dtype=torch.int64, device=dev),
                "desc": torch.zeros((0, 32), dtype=torch.uint8, device=dev)}
    return {k: torch.cat(v) for k, v in parts.items()}


def detect_orb(gray: torch.Tensor, n_features: int = 500):
    """-> (keypoints (N,2) float32 [u,v], descriptors (N,32) uint8), as
    numpy arrays on the host; the detection runs on gray's device."""
    kp = orb_keypoints(gray, n_features)
    return kp["pts"].cpu().numpy(), kp["desc"].cpu().numpy()


def hamming_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,32)x(M,32) uint8 -> (N,M) popcount distances."""
    x = np.bitwise_xor(a[:, None, :], b[None, :, :])
    return np.unpackbits(x, axis=2).sum(axis=2)


def match_ratio(desc_a: np.ndarray, desc_b: np.ndarray, ratio: float = 0.7) -> np.ndarray:
    """2-NN ratio-test matching (0.7 linear ~= the reference's 0.49
    squared-distance test). Returns (K,2) index pairs into (a,b)."""
    if len(desc_a) == 0 or len(desc_b) == 0:
        return np.zeros((0, 2), np.int64)
    d = hamming_dist(desc_a, desc_b).astype(np.float32)
    order = np.argsort(d, axis=1)
    best = order[:, 0]
    d1 = d[np.arange(len(d)), best]
    if d.shape[1] > 1:
        d2 = d[np.arange(len(d)), order[:, 1]]
    else:
        d2 = np.full_like(d1, np.inf)
    ok = d1 < ratio * np.maximum(d2, 1e-6)
    return np.stack([np.nonzero(ok)[0], best[ok]], axis=1)


class Vocabulary:
    """Flat k-means vocabulary over binary descriptors (bit-majority
    centroids)."""

    def __init__(self, centroids: np.ndarray):
        self.centroids = centroids  # (K,32) uint8
        self.k = len(centroids)

    @staticmethod
    def train(descriptors: np.ndarray, k: int = 512, iters: int = 8,
              seed: int = 0) -> "Vocabulary":
        rng = np.random.default_rng(seed)
        n = len(descriptors)
        if n == 0:
            return Vocabulary(np.zeros((1, 32), np.uint8))
        k = min(k, max(1, n))
        cent = descriptors[rng.choice(n, k, replace=False)].copy()
        bits = np.unpackbits(descriptors, axis=1).astype(np.float32)  # (n,256)
        for _ in range(iters):
            d = hamming_dist(descriptors, cent)
            assign = d.argmin(axis=1)
            for c in range(k):
                sel = assign == c
                if sel.sum() == 0:
                    cent[c] = descriptors[rng.integers(n)]
                    continue
                maj = (bits[sel].mean(axis=0) > 0.5).astype(np.uint8)
                cent[c] = np.packbits(maj)
        return Vocabulary(cent)

    def save(self, path: str) -> None:
        """Persist the centroids (.npy), the -v file."""
        np.save(path, self.centroids)

    @staticmethod
    def load(path: str) -> "Vocabulary":
        return Vocabulary(np.load(path).astype(np.uint8))

    def quantise(self, descriptors: np.ndarray) -> np.ndarray:
        if len(descriptors) == 0:
            return np.zeros(0, np.int32)
        return hamming_dist(descriptors, self.centroids).argmin(axis=1).astype(np.int32)


def train_vocab_from_klg(klg_path: str, out_path: str, k: int = 512,
                         frame_stride: int = 10, n_features: int = 500,
                         max_frames: int = -1, width: int = 640,
                         height: int = 480, seed: int = 0,
                         device=None) -> Vocabulary:
    """Train and save a BoW vocabulary from a `.klg` sequence with the
    port's detector on `device` (None: the card): every
    `frame_stride`-th frame's ORB descriptors, k-means, `.npy` to
    `out_path`. A vocabulary of the JAX package's (OpenCV's descriptors)
    does not fit the port's detector; this trains one that does."""
    from kintinuous_tpu_torch.device import resolve_device
    from kintinuous_tpu_torch.io.klg import KlgLogReader

    dev = resolve_device(device)
    descs = []
    with KlgLogReader(klg_path, width=width, height=height, max_frames=max_frames) as r:
        for f in r:
            if f.index % frame_stride or f.rgb is None:
                continue
            gray = rgb_to_gray(torch.from_numpy(np.ascontiguousarray(f.rgb)).to(dev))
            _, d = detect_orb(gray, n_features)
            if len(d):
                descs.append(d)
    all_desc = np.concatenate(descs, axis=0) if descs else np.zeros((0, 32), np.uint8)
    vocab = Vocabulary.train(all_desc, k=k, seed=seed)
    vocab.save(out_path)
    return vocab


class BowDatabase:
    """tf-idf BoW scoring with an inverted index (DBoW2-style)."""

    def __init__(self, vocab: Vocabulary):
        self.vocab = vocab
        self.vectors: List[Dict[int, float]] = []
        self.inverted: Dict[int, List[int]] = {}
        self.doc_freq = np.zeros(vocab.k, np.float64)

    def _bow(self, words: np.ndarray) -> Dict[int, float]:
        if len(words) == 0:
            return {}
        uniq, cnt = np.unique(words, return_counts=True)
        n_docs = max(1, len(self.vectors))
        idf = np.log(n_docs / np.maximum(self.doc_freq[uniq], 1.0) + 1.0)
        v = cnt * idf
        norm = np.abs(v).sum()
        return {int(w): float(x / max(norm, 1e-12)) for w, x in zip(uniq, v)}

    def score(self, a: Dict[int, float], b: Dict[int, float]) -> float:
        """L1 similarity in [0,1]: 1 - 0.5*|va - vb|_1 over shared support."""
        s = 0.0
        for w, x in a.items():
            y = b.get(w)
            if y is not None:
                s += abs(x) + abs(y) - abs(x - y)
        return 0.5 * s

    def add(self, words: np.ndarray) -> int:
        v = self._bow(words)
        idx = len(self.vectors)
        self.vectors.append(v)
        for w in v:
            self.inverted.setdefault(w, []).append(idx)
            self.doc_freq[w] += 1
        return idx

    def query(self, words: np.ndarray, exclude_after: int) -> Tuple[int, float]:
        """Best match among entries with id < exclude_after.
        Returns (id, score) or (-1, 0)."""
        v = self._bow(words)
        cand: Dict[int, float] = {}
        for w in v:
            for idx in self.inverted.get(w, []):
                if idx < exclude_after:
                    cand[idx] = 0.0
        best_id, best_s = -1, 0.0
        for idx in cand:
            s = self.score(v, self.vectors[idx])
            if s > best_s:
                best_id, best_s = idx, s
        return best_id, best_s
