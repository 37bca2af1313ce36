"""Mesh patches and the welded whole-map mesh (port of
kintinuous_tpu/backend/meshing.py, single device).

Band patches come from the tracker's surface-nets meshing of each
shifted-out band (ops/surface_nets.py); MeshCollector welds them and the
live volume's mesh into one indexed .ply by global cell identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from kintinuous_tpu_torch.config import KintinuousConfig
from kintinuous_tpu_torch.io.ply import save_ply
from kintinuous_tpu_torch.ops.blocked import as_dense
from kintinuous_tpu_torch.ops.surface_nets import MeshResult, extract_mesh


@dataclass
class MeshPatch:
    vertices: np.ndarray  # (N,3)
    colors: np.ndarray  # (N,3) uint8
    faces: np.ndarray  # (M,3)
    timestamp_us: int = 0
    # (N,3) i32 global integer cells (one surface-nets vertex per cell),
    # for seam welding; None for a mesh without cell identity
    cells: Optional[np.ndarray] = None


def patch_from_result(res: MeshResult, timestamp_us: int = 0) -> MeshPatch:
    """A device MeshResult -> a host MeshPatch of its first n_vertices
    vertices and n_faces faces."""
    nv, nf = int(res.n_vertices), int(res.n_faces)
    return MeshPatch(
        vertices=res.vertices[:nv].cpu().numpy(),
        colors=np.clip(res.colors[:nv].cpu().numpy(), 0, 255).astype(np.uint8),
        faces=res.faces[:nf].cpu().numpy(),
        timestamp_us=timestamp_us,
        cells=res.cells[:nv].cpu().numpy(),
    )


def _cell_keys(cells: np.ndarray) -> np.ndarray:
    """(N,3) i32 global cell coords -> (N,) i64 unique keys."""
    O = np.int64(1) << 20  # coords are |x| << 2^20 cells
    c = cells.astype(np.int64) + O
    M = np.int64(1) << 21
    return (c[:, 2] * M + c[:, 1]) * M + c[:, 0]


def weld_patches(patches: List[MeshPatch]):
    """Stitch patches into one indexed mesh by global cell identity: the
    newest patch's vertex wins for a cell seen twice, and seam quads
    emitted twice collapse. Returns (vertices f32, colors u8, faces i32)."""
    verts = np.concatenate([p.vertices for p in patches]).astype(np.float32)
    cols = np.concatenate([p.colors for p in patches]).astype(np.uint8)
    keys = np.concatenate([_cell_keys(p.cells) for p in patches])
    face_keys = np.concatenate([_cell_keys(p.cells)[p.faces] for p in patches])
    uk, ridx = np.unique(keys[::-1], return_index=True)
    sel = len(keys) - 1 - ridx  # the last occurrence of each key
    fidx = np.searchsorted(uk, face_keys).astype(np.int32)
    faces = np.unique(fidx, axis=0) if len(fidx) else fidx
    return verts[sel], cols[sel], faces


class MeshCollector:
    """Accumulates mesh patches; saves them welded (or offset-merged when
    a patch has no cells) as one .ply."""

    def __init__(self):
        self.patches: List[MeshPatch] = []

    def add(self, patch: MeshPatch):
        self.patches.append(patch)

    @property
    def n_triangles(self) -> int:
        """Faces over every patch, before welding."""
        return sum(len(p.faces) for p in self.patches)

    def save(self, path: str) -> int:
        patches = [p for p in self.patches if len(p.vertices)]
        if not patches:
            save_ply(path, np.zeros((0, 3), np.float32))
            return 0
        if all(p.cells is not None for p in patches):
            verts, cols, faces = weld_patches(patches)
            save_ply(path, verts, cols, None, faces.astype(np.int32))
            return len(verts)
        verts, cols, faces = [], [], []
        off = 0
        for p in patches:
            verts.append(p.vertices)
            cols.append(p.colors)
            faces.append(p.faces + off)
            off += len(p.vertices)
        save_ply(path, np.concatenate(verts).astype(np.float32),
                 np.concatenate(cols).astype(np.uint8), None,
                 np.concatenate(faces).astype(np.int32))
        return off


def mesh_current_volume(tracker, cfg: KintinuousConfig,
                        vertex_capacity: int = 2_000_000,
                        face_capacity: int = 4_000_000) -> MeshPatch:
    """Surface-nets mesh of the tracker's live volume (global coords),
    blocked (fast mode) or dense."""
    R = cfg.volume_resolution
    res = extract_mesh(as_dense(tracker.state.vol), (0, 0, 0), (R, R, R), cfg.voxel_size,
                       vertex_capacity, face_capacity)
    return patch_from_result(res)


def save_volume_mesh(path: str, tracker, cfg: KintinuousConfig) -> int:
    mc = MeshCollector()
    mc.add(mesh_current_volume(tracker, cfg))
    return mc.save(path)
