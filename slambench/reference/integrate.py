# Frozen copy of kintinuous_tpu_torch/ops/cuda_integrate.py, the benchmark's plain
# reference: imports point into this package, and it is never updated
# to follow the program, which it judges.
"""Fast-path integration on the card (counterpart of
kintinuous_tpu/ops/pallas_integrate.py).

Per frame: classify blocks, compact the BAND and FREE lists (capped
cumsum scatter, counts kept on the device), fuse the band blocks
(`band_fusion`, csrc/integrate.cu), carve the free blocks
(`free_carve`, same source), then refresh the dirty (bz,by) row-pairs
of the dense bf16 mirror (`cuda_raycast.mirror_refresh`), every pair on
a shift frame.

Only the plain PyTorch versions of the kernels are kept here, on any
device: the reference launches no kernel. They update the volume in
place. `integrate_blocked` is the program's `integrate_cuda`.

The volume may be one z-slab of a larger R^3 volume, as each device of
the sharded fast step holds (parallel/fast_sharded.py): its Bz*B*B rows
are block-planes [z_block_offset, z_block_offset + Bz). The caller then
passes `resolution=R` and the slab's `z_block_offset`; the plan
classifies only the slab's blocks, the caps clamp to its rows, and K1
adds the offset to each block's z. K2 addresses rows only. The mirror
is a whole volume's, so a slab takes none.
"""

from __future__ import annotations

from typing import Optional

import torch

from slambench.reference.config import CameraIntrinsics
from slambench.reference.blocked import BLOCK, CELLS
from slambench.reference.tsdf_fast import (
    FREE_CAP,
    build_depth_tables,
    volume_resolution,
    carve_rows,
    classify_blocks,
    compact_block_lists,
    fuse_band_rows,
    write_rows,
)

def fusion_params(Tinv: torch.Tensor, wrap: torch.Tensor,
                  z_block_offset: int = 0) -> torch.Tensor:
    """(16,) f32 [Tinv rotation (9) | Tinv translation (3) | wrap (3) |
    z_block_offset], the Pallas kernel's layout."""
    return torch.cat([
        Tinv[:3, :3].reshape(-1), Tinv[:3, 3], wrap.to(torch.float32),
        torch.full((1,), float(z_block_offset), dtype=torch.float32,
                   device=Tinv.device),
    ]).contiguous()


def band_fusion_plain(tsdf, cw, img_rows, band_ids, n_band, params,
                      cam: CameraIntrinsics, voxel_size: float,
                      trunc_dist: float, max_weight: float,
                      resolution: Optional[int] = None) -> None:
    """Plain version of the band-fusion kernel, in place. The slab's
    z_block_offset is params[15]."""
    zoff = params[15].to(torch.int32)
    R = volume_resolution(tsdf.shape[0], resolution)
    cap = band_ids.shape[0]
    ids = band_ids.long()
    Tinv34 = torch.cat([params[:9].reshape(3, 3), params[9:12, None]], dim=1)
    valid = (torch.arange(cap, device=ids.device) < n_band)[:, None]
    t_upd, c_upd = fuse_band_rows(
        tsdf[ids].reshape(cap, CELLS), cw[ids].reshape(cap, CELLS), band_ids,
        valid, img_rows, Tinv34, params[12:15].to(torch.int32), cam, R,
        voxel_size, trunc_dist, max_weight, z_block_offset=zoff,
    )
    write_rows(tsdf, band_ids, n_band, t_upd)
    write_rows(cw, band_ids, n_band, c_upd)


def free_carve_plain(tsdf, cw, free_ids, n_free, max_weight: float) -> None:
    """Plain version of the free-carve kernel, in place."""
    cap = free_ids.shape[0]
    ids = free_ids.long()
    t_new, c_new = carve_rows(tsdf[ids].reshape(cap, CELLS),
                              cw[ids].reshape(cap, CELLS), max_weight)
    write_rows(tsdf, free_ids, n_free, t_new)
    write_rows(cw, free_ids, n_free, c_new)


def dirty_pairs(lists, B: int, dirty_all: bool):
    """Compacted (bz,by) row-pair ids touched by this frame's band and
    free blocks, and their count on the device; every pair when
    dirty_all (a shift frame rolled the blocked volume under the mirror).
    A pair (rows 2p, 2p+1) is the mirror's refresh unit."""
    dev = lists.band_ids.device
    n_pairs = (B * B) // 2
    if dirty_all:
        # torch.full, not torch.tensor: no host-to-device copy, no sync
        return (torch.arange(n_pairs, dtype=torch.int32, device=dev),
                torch.full((), n_pairs, dtype=torch.int32, device=dev))
    bm = torch.zeros(n_pairs + 1, dtype=torch.bool, device=dev)
    for ids, n in ((lists.band_ids, lists.n_band), (lists.free_ids, lists.n_free)):
        k = torch.arange(ids.shape[0], device=dev)
        p = torch.where(k < n, ids // (2 * B), n_pairs)
        # index_fill_, not `bm[p] = True`: that copies the True from the
        # host, which a CUDA graph's capture refuses
        bm.index_fill_(0, p.long(), True)
    bm = bm[:n_pairs]
    dest = torch.where(bm, torch.cumsum(bm.to(torch.int32), 0) - 1, n_pairs)
    pairs = torch.zeros(n_pairs + 1, dtype=torch.int32, device=dev)
    pairs.scatter_(0, dest.long(),
                   torch.arange(n_pairs, dtype=torch.int32, device=dev))
    return pairs[:n_pairs], bm.sum().to(torch.int32)


def integrate_plan(vol, cam: CameraIntrinsics, depth_m, rgb, color_w, T,
                   voxel_size: float, trunc_dist: float, band_cap: int = 8192,
                   free_cap: int = FREE_CAP, resolution: Optional[int] = None,
                   z_block_offset: int = 0):
    """The kernels' inputs for one frame: the depth tables, the compacted
    band and free lists (of the slab's rows when vol is a z-slab of an
    R^3 volume, `resolution` R), and the fusion parameters."""
    R = volume_resolution(vol.tsdf.shape[0], resolution, z_block_offset)
    B = R // BLOCK
    tables = build_depth_tables(cam, depth_m, rgb, color_w)
    Tinv = torch.linalg.inv_ex(T)[0]
    cls = classify_blocks(vol, cam, tables, Tinv, voxel_size, trunc_dist,
                          resolution=R, z_blocks=vol.tsdf.shape[0] // (B * B),
                          z_block_offset=z_block_offset)
    lists = compact_block_lists(cls, band_cap, free_cap)
    return tables, lists, fusion_params(Tinv, vol.wrap, z_block_offset)


def integrate_blocked(vol, cam: CameraIntrinsics, depth_m, rgb, color_w, T,
                   voxel_size: float, trunc_dist: float,
                   max_weight: float = 128.0, band_cap: int = 8192,
                   free_cap: int = FREE_CAP,
                   mirror: Optional[torch.Tensor] = None,
                   dirty_all: bool = False, resolution: Optional[int] = None,
                   z_block_offset: int = 0):
    """Fuse one frame into the blocked volume (or its z-slab, see the
    module's docstring) IN PLACE; when a mirror is given, refresh its
    dirty row-pairs in place too. Returns the volume. Nothing here reads
    a device value on the host."""
    from slambench.reference.mirror_raycast import mirror_refresh_plain

    R = volume_resolution(vol.tsdf.shape[0], resolution, z_block_offset)
    if mirror is not None and vol.tsdf.shape[0] != (R // BLOCK) ** 3:
        raise ValueError("the mirror refresh takes the whole volume, not a slab")
    tables, lists, params = integrate_plan(
        vol, cam, depth_m, rgb, color_w, T, voxel_size, trunc_dist,
        band_cap, free_cap, R, z_block_offset)
    band_fusion_plain(vol.tsdf, vol.cw, tables.img_rows, lists.band_ids,
                lists.n_band, params, cam, voxel_size, trunc_dist, max_weight, R)
    free_carve_plain(vol.tsdf, vol.cw, lists.free_ids, lists.n_free, max_weight)
    if mirror is not None:
        pairs, count = dirty_pairs(lists, R // BLOCK, dirty_all)
        mirror_refresh_plain(vol.tsdf, mirror, pairs, count)
    return vol
