# Frozen copy of kintinuous_tpu_torch/ops/blocked.py, the benchmark's plain
# reference: imports point into this package, and it is never updated
# to follow the program, which it judges.
"""Block-major volume storage (port of kintinuous_tpu/ops/blocked.py).

The layout is kept exactly: shape (B^3, 4, 128), row bz*B^2 + by*B + bx
holds the 8^3 block, voxel (dz,dy,dx) at flat offset dz*64 + dy*8 + dx.
On the card a block row is 2 KB of contiguous memory, so a CUDA block
that owns one row reads and writes it coalesced; keeping the layout
also lets the port's volumes be compared bit for bit with the JAX
package's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slambench.reference.tsdf import VolumeState

BLOCK = 8
CELLS = BLOCK ** 3


class BlockedVolume(NamedTuple):
    tsdf: torch.Tensor  # (B^3, 4, 128) f32
    cw: torch.Tensor  # (B^3, 4, 128) int32 bits of weight<<24|r<<16|g<<8|b
    wrap: torch.Tensor  # (3,) i32 [x,y,z], multiples of BLOCK
    origin: torch.Tensor  # (3,) f32 [x,y,z] global metres of local 0 corner

    @property
    def resolution(self) -> int:
        return resolution_of(self.tsdf.shape[0])


def resolution_of(blocked_rows: int) -> int:
    return round(blocked_rows ** (1.0 / 3.0)) * BLOCK


def make_blocked_volume(resolution: int, device=None) -> BlockedVolume:
    B = resolution // BLOCK
    return BlockedVolume(
        tsdf=torch.zeros((B ** 3, 4, 128), dtype=torch.float32, device=device),
        cw=torch.zeros((B ** 3, 4, 128), dtype=torch.int32, device=device),
        wrap=torch.zeros(3, dtype=torch.int32, device=device),
        origin=torch.zeros(3, dtype=torch.float32, device=device),
    )


def dense_to_blocked(arr: torch.Tensor) -> torch.Tensor:
    """(R,R,R) [z,y,x] -> (B^3, 4, 128)."""
    R = arr.shape[0]
    B = R // BLOCK
    return (
        arr.reshape(B, BLOCK, B, BLOCK, B, BLOCK)
        .permute(0, 2, 4, 1, 3, 5)
        .reshape(B ** 3, 4, 128)
    )


def blocked_to_dense(arr: torch.Tensor) -> torch.Tensor:
    """(B^3, 4, 128) -> (R,R,R) [z,y,x]."""
    B = round(arr.shape[0] ** (1 / 3))
    R = B * BLOCK
    return (
        arr.reshape(B, B, B, BLOCK, BLOCK, BLOCK)
        .permute(0, 3, 1, 4, 2, 5)
        .reshape(R, R, R)
    )


def as_dense(vol):
    """A BlockedVolume unblocked into the dense VolumeState (a fresh
    copy); a dense VolumeState as it is. A sharded volume, whose tsdf and
    cw are tuples of z-slabs (parallel/), is first gathered on its wrap's
    device."""
    if isinstance(vol.tsdf, (tuple, list)):
        home = vol.wrap.device
        vol = vol._replace(tsdf=torch.cat([t.to(home) for t in vol.tsdf]),
                           cw=torch.cat([c.to(home) for c in vol.cw]))
    if not isinstance(vol, BlockedVolume):
        return vol
    return VolumeState(tsdf=blocked_to_dense(vol.tsdf), cw=blocked_to_dense(vol.cw),
                       wrap=vol.wrap, origin=vol.origin)


# Even axis permutations for the band-leading slab layout:
# VIEW_AXES[axis][k] = volume axis of view coordinate k in (vx, vy, vz);
# the band axis is always vz, the leading array dim.
VIEW_AXES = {0: (1, 2, 0), 1: (2, 0, 1), 2: (0, 1, 2)}
# volume coordinate a lives in view column VIEW_INV[axis][a]
VIEW_INV = {0: (2, 0, 1), 1: (1, 2, 0), 2: (0, 1, 2)}


def slab_to_dense(arr: torch.Tensor, axis: int, b0: int, n_blocks: int,
                  leading: bool = False) -> torch.Tensor:
    """Densify `n_blocks` block-planes along a volume axis (0=x, 1=y,
    2=z) from block index b0. Dense [z,y,x] by default; leading=True
    puts the sliced axis first under VIEW_AXES[axis]."""
    B = round(arr.shape[0] ** (1 / 3))
    g = arr.reshape(B, B, B, 4, 128)  # [bz, by, bx]
    dim = {0: 2, 1: 1, 2: 0}[axis]
    b0 = max(0, min(int(b0), B - n_blocks))  # dynamic_slice clamps the start
    g = g.narrow(dim, b0, n_blocks)
    nbz, nby, nbx = g.shape[:3]
    g6 = g.reshape(nbz, nby, nbx, BLOCK, BLOCK, BLOCK)
    if leading:
        order = {
            0: (2, 5, 0, 3, 1, 4),  # [x, z, y]
            1: (1, 4, 2, 5, 0, 3),  # [y, x, z]
            2: (0, 3, 1, 4, 2, 5),  # [z, y, x]
        }[axis]
    else:
        order = (0, 3, 1, 4, 2, 5)
    t = g6.permute(*order)
    s = t.shape
    return t.reshape(s[0] * s[1], s[2] * s[3], s[4] * s[5])


def flat_index(R: int, pz, py, px):
    """Physical voxel coords -> flat index into (B^3*512,) blocked arrays."""
    B = R // BLOCK
    row = ((pz >> 3) * B + (py >> 3)) * B + (px >> 3)
    off = ((pz & 7) << 6) | ((py & 7) << 3) | (px & 7)
    return row * CELLS + off


def gather_voxels(blocked_arr: torch.Tensor, R: int, pz, py, px) -> torch.Tensor:
    """The voxels at physical coordinates (pz, py, px), any shape, of a
    blocked (B^3, 4, 128) array."""
    return blocked_arr.reshape(-1)[flat_index(R, pz, py, px)]


def axis_keep_mask(keep_x: torch.Tensor, keep_y: torch.Tensor,
                   keep_z: torch.Tensor) -> torch.Tensor:
    """Per-axis physical keep vectors (R,) bool -> the (B^3, 4, 128) mask
    of the voxels kept on all three axes, in the blocked layout."""
    R = keep_x.shape[0]
    B = R // BLOCK
    kx, ky, kz = (k.reshape(B, BLOCK) for k in (keep_x, keep_y, keep_z))
    m = (kz[:, None, None, :, None, None]
         & ky[None, :, None, None, :, None]
         & kx[None, None, :, None, None, :])
    return m.reshape(B ** 3, 4, 128)


def blocked_clear_mask(shift: torch.Tensor, S: int, R: int, row=None):
    """(B^3,4,128) bool KEEP mask for the departing bands of a shift, in
    blocked coordinates (logical == physical: wrap 0). row: optional
    (B^3,) row ids to evaluate the mask at (shift_roll_clear clears at
    SOURCE coords while permuting)."""
    B = R // BLOCK
    dev = shift.device
    if row is None:
        row = torch.arange(B ** 3, dtype=torch.int32, device=dev)
    row = row[:, None, None]
    off = torch.arange(CELLS, dtype=torch.int32, device=dev).reshape(1, 4, 128)
    x = (row % B) * BLOCK + (off & 7)
    y = ((row // B) % B) * BLOCK + ((off >> 3) & 7)
    z = (row // (B * B)) * BLOCK + (off >> 6)

    def clear_axis(coord, s):
        lo = torch.where(s > 0, 0, R - S)
        hi = torch.where(s > 0, S, R)
        return (s != 0) & (coord >= lo) & (coord < hi)

    cl = (
        clear_axis(x, shift[0])
        | clear_axis(y, shift[1])
        | clear_axis(z, shift[2])
    )
    return torch.logical_not(cl)


def shift_roll_clear(tsdf, cw, shift: torch.Tensor, S: int, R: int):
    """Clear the departing bands and roll the blocked volume in one
    row-gather pass. Shifts are multiples of BLOCK, so the roll is a
    block-row permutation out[row] = in[src(row)] with the clear
    evaluated at the source coords. Returns new tensors."""
    B = R // BLOCK
    n = B ** 3
    sb = shift // BLOCK
    row = torch.arange(n, dtype=torch.int32, device=tsdf.device)
    bz = row // (B * B)
    by = (row // B) % B
    bx = row % B
    src = (
        ((bz + sb[2] + B) % B) * B + ((by + sb[1] + B) % B)
    ) * B + ((bx + sb[0] + B) % B)
    keep = blocked_clear_mask(shift, S, R, row=src)
    src = src.long()
    # a cleared voxel is +0.0, as the JAX package's `tsdf[src] * keep`
    # gives (JAX multiplies by a bool as a select; torch's product would
    # keep the sign of a negative value)
    t = torch.where(keep, tsdf[src], 0.0)
    c = torch.where(keep, cw[src], 0)
    return t, c
