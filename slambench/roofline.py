"""The kernels' least bytes and operations, frozen from chip_smoke.py's
kernel table (PERF.md, "Every TPU kernel"): the arithmetic a
`<kernel>_roofline` share will divide by the kernel's device time once
the step reports each frame's work counts (band and carve blocks, dirty
row-pairs, rays), which it does not yet on the captured path. No metric
reads this file yet.

A share is the least time the card could take, the larger of bytes over
peak bytes/s and operations over peak f32 operations/s, over the
kernel's time; it is stated against NVIDIA's published peak at 700 W."""

from __future__ import annotations

from typing import Tuple

# one H100 SXM (NVIDIA's data sheet, at the 700 W limit)
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# f32 operations per unit of work, counted from csrc/*.cu
OPS_BAND_VOXEL = 64
OPS_FREE_VOXEL = 6
OPS_MIRROR_VOXEL = 1
OPS_RAY_PIXEL = 30
OPS_RAY_TAP = 70
VOXELS_PER_BLOCK = 512


def bound_ms(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations", whichever bounds it)."""
    t_mem = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def k1_band_fusion(band_blocks: int, img_floats: int) -> Tuple[float, float]:
    """(bytes, operations): each band voxel's tsdf and cw read and
    written (16 B), the depth tables read once, the block ids."""
    return (band_blocks * VOXELS_PER_BLOCK * 16 + img_floats * 4 + band_blocks * 4,
            band_blocks * VOXELS_PER_BLOCK * OPS_BAND_VOXEL)


def k2_free_carve(free_blocks: int) -> Tuple[float, float]:
    return (free_blocks * VOXELS_PER_BLOCK * 16 + free_blocks * 4,
            free_blocks * VOXELS_PER_BLOCK * OPS_FREE_VOXEL)


def k3_mirror_refresh(pairs: int, blocks_per_edge: int) -> Tuple[float, float]:
    """A row-pair is 2 B blocks of 512 voxels: f32 read, bf16 written."""
    vox = pairs * 2 * blocks_per_edge * VOXELS_PER_BLOCK
    return vox * 6 + pairs * 4, vox * OPS_MIRROR_VOXEL


def k4_tile_raycast(pixels: int, distinct_mirror_voxels: int, window: int = 5,
                    newton: int = 1) -> Tuple[float, float]:
    """Each pixel's warm start in and five outputs out, and each distinct
    bf16 mirror voxel its window's taps read (Newton taps not counted:
    a lower bound)."""
    return (pixels * 24 + distinct_mirror_voxels * 2,
            pixels * (OPS_RAY_PIXEL + OPS_RAY_TAP * (window + newton)))
