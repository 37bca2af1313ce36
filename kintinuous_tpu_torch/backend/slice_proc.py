"""Cloud-slice processing on the host (port of
kintinuous_tpu/backend/slice_proc.py).

Per incoming slice: drop points fused fewer than weight_cull times,
voxel-grid downsample at leaf = voxel size, and k=20 nearest-neighbour
normals oriented towards the camera; the native library
(backend/native_ops.py) when it loads, numpy/scipy otherwise. `save`
concatenates the processed slices into one `.pcd`, optionally
de-overlapped by a second voxel-grid pass over the union.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
from scipy.spatial import cKDTree

from kintinuous_tpu_torch.backend import native_ops
from kintinuous_tpu_torch.config import KintinuousConfig
from kintinuous_tpu_torch.io.pcd import save_pcd
from kintinuous_tpu_torch.tracking.tracker import CloudSlice


def voxel_downsample(points: np.ndarray, colors: Optional[np.ndarray],
                     weights: Optional[np.ndarray], leaf: float):
    """Average points (and attributes) within each leaf-sized voxel cell."""
    if len(points) == 0:
        return points, colors, weights
    keys = np.floor(points / leaf).astype(np.int64)
    # 3 x 21-bit signed grid coordinates packed into one int64 key
    off = 1 << 20
    k = ((keys[:, 0] + off) << 42) | ((keys[:, 1] + off) << 21) | (keys[:, 2] + off)
    order = np.argsort(k)
    _, start, counts = np.unique(k[order], return_index=True, return_counts=True)

    def seg_mean(arr):
        s = np.add.reduceat(arr[order], start, axis=0)
        return s / counts[:, None] if arr.ndim > 1 else s / counts

    p = seg_mean(points)
    c = seg_mean(colors.astype(np.float64)).astype(np.uint8) if colors is not None else None
    w = seg_mean(weights) if weights is not None else None
    return p, c, w


def estimate_normals(points: np.ndarray, k: int = 20,
                     viewpoint: Optional[np.ndarray] = None) -> np.ndarray:
    """PCA normals from the k nearest neighbours, flipped towards the
    viewpoint."""
    n = len(points)
    if n == 0:
        return np.zeros((0, 3), np.float32)
    k = min(k, n)
    _, idx = cKDTree(points).query(points, k=k, workers=-1)
    nbrs = points[idx.reshape(n, k)]  # (n,k,3); the query drops the axis at k = 1
    centered = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered) / k
    _, v = np.linalg.eigh(cov)
    normals = v[:, :, 0]  # the smallest eigenvalue's eigenvector
    if viewpoint is not None:
        flip = np.sum(normals * (viewpoint[None, :] - points), axis=1) < 0
        normals[flip] = -normals[flip]
    return normals.astype(np.float32)


class SliceProcessor:
    """Consumes raw CloudSlices and fills slice.processed in place."""

    def __init__(self, cfg: KintinuousConfig):
        self.cfg = cfg
        self.processed: List[CloudSlice] = []

    def process(self, sl: CloudSlice) -> CloudSlice:
        cfg = self.cfg
        keep = sl.weights >= cfg.weight_cull
        pts, cols, wgts = sl.points[keep], sl.colors[keep], sl.weights[keep]
        normals = None
        if len(pts):
            out = native_ops.voxel_downsample(pts, cols, wgts, cfg.voxel_size)
            if out is not None:
                pts, cols, wgts = out
                normals = native_ops.estimate_normals(
                    pts, k=20, cell=2.0 * cfg.voxel_size, viewpoint=sl.pose[:3, 3])
        if normals is None:
            pts, cols, wgts = voxel_downsample(pts, cols, wgts, cfg.voxel_size)
            normals = estimate_normals(pts, k=20, viewpoint=sl.pose[:3, 3])
        sl.processed = {
            "points": pts.astype(np.float32),
            "colors": cols if cols is not None else np.zeros((len(pts), 3), np.uint8),
            "normals": normals,
            "weights": wgts,
        }
        self.processed.append(sl)
        return sl

    def local_payload(self) -> np.ndarray:
        """(n, 9) [points|colors|normals] of the processed slices."""
        parts = [s.processed for s in self.processed if s.processed is not None]
        if not parts:
            return np.zeros((0, 9), np.float32)
        return np.concatenate([
            np.concatenate([
                p["points"].astype(np.float32),
                np.asarray(p["colors"], np.float32).reshape(-1, 3),
                np.asarray(p["normals"], np.float32).reshape(-1, 3),
            ], axis=1)
            for p in parts
        ])

    def save(self, path: str, deoverlap: bool = False,
             merged_payload: Optional[np.ndarray] = None) -> int:
        """Concatenate the processed slices into one .pcd; with
        deoverlap, a voxel-grid pass over the union collapses the shift
        overlaps. merged_payload: every process's (n, 9) local_payload,
        merged (parallel/multihost.allgather_points), in place of this
        process's slices. Returns the number of points written."""
        payload = self.local_payload() if merged_payload is None else merged_payload
        pts = payload[:, 0:3].astype(np.float32)
        cols = np.clip(payload[:, 3:6], 0, 255).astype(np.uint8)
        nrm = payload[:, 6:9].astype(np.float32)
        if len(pts) == 0:
            save_pcd(path, np.zeros((0, 3), np.float32))
            return 0
        if deoverlap:
            pts2, cols2, _ = voxel_downsample(pts, cols, None, self.cfg.voxel_size)
            pts, cols = pts2.astype(np.float32), cols2
            nrm = estimate_normals(pts, k=20)
        save_pcd(path, pts, cols, nrm)
        return len(pts)
