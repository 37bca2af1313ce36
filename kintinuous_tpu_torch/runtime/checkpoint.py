"""Mid-run snapshot and resume (port of
kintinuous_tpu/runtime/checkpoint.py).

save_checkpoint / load_checkpoint
    the tracker: its volume (blocked in fast mode, dense with its wrap
    otherwise), pose and prediction, emitted slices (with their
    processed payloads), mesh patches, trajectory, stats.
save_engine_checkpoint / load_engine_checkpoint
    the tracker plus the engine's counters and the slice processor's
    pool, for an engine without online deformation.

The file format is the JAX package's: one compressed npz with a JSON
`__meta__` entry, the cw volume as uint32, and `fast_mode` in the meta,
which must match the tracker's. A checkpoint written by either package
loads into the other. The fast step's dense bf16 mirror is not saved:
restore rebuilds it from the volume with `build_mirror` (K5), as the
JAX package's _rebuild_logical does with build_logical_bf16, for a
tracker that keeps one (fast mode, an even block count).
The RGB-D pyramid is not saved either: a restored tracker keeps the one
it was built with, as the JAX package's does.

Not ported yet: the pose-graph, deformation and place-recognition
fields of an engine checkpoint of an -od run; a file that holds them
raises NotImplementedError.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from kintinuous_tpu_torch.backend.meshing import MeshPatch
from kintinuous_tpu_torch.ops.blocked import BlockedVolume
from kintinuous_tpu_torch.ops.cuda_raycast import build_mirror
from kintinuous_tpu_torch.ops.tsdf import VolumeState
from kintinuous_tpu_torch.tracking.tracker import CloudSlice, Tracker

_PROC_KEYS = ("points", "colors", "normals", "weights")


def _pack_slice(arrays: dict, meta: dict, prefix: str, sl: CloudSlice) -> None:
    arrays[f"{prefix}_points"] = sl.points
    arrays[f"{prefix}_colors"] = sl.colors
    arrays[f"{prefix}_weights"] = sl.weights
    arrays[f"{prefix}_pose"] = sl.pose
    meta[prefix] = {
        "dimension": sl.dimension,
        "timestamp_us": sl.timestamp_us,
        "frame_index": sl.frame_index,
        "processed": sl.processed is not None,
    }
    if sl.processed is not None:
        for k in _PROC_KEYS:
            arrays[f"{prefix}_proc_{k}"] = sl.processed[k]


def _unpack_slice(data, meta: dict, prefix: str) -> CloudSlice:
    m = meta[prefix]
    processed = None
    if m.get("processed"):
        processed = {k: data[f"{prefix}_proc_{k}"] for k in _PROC_KEYS}
    return CloudSlice(
        points=data[f"{prefix}_points"], colors=data[f"{prefix}_colors"],
        weights=data[f"{prefix}_weights"], pose=data[f"{prefix}_pose"],
        dimension=m["dimension"], timestamp_us=m["timestamp_us"],
        frame_index=m["frame_index"], processed=processed,
    )


def _pack_patch(arrays: dict, meta: dict, prefix: str, p: MeshPatch) -> None:
    arrays[f"{prefix}_vertices"] = p.vertices
    arrays[f"{prefix}_colors"] = p.colors
    arrays[f"{prefix}_faces"] = p.faces
    if p.cells is not None:
        arrays[f"{prefix}_cells"] = p.cells
    meta[prefix] = {"timestamp_us": p.timestamp_us, "cells": p.cells is not None}


def _unpack_patch(data, meta: dict, prefix: str) -> MeshPatch:
    m = meta[prefix]
    return MeshPatch(
        vertices=data[f"{prefix}_vertices"], colors=data[f"{prefix}_colors"],
        faces=data[f"{prefix}_faces"], timestamp_us=m["timestamp_us"],
        cells=data[f"{prefix}_cells"] if m["cells"] else None,
    )


def _tracker_payload(tracker: Tracker):
    tracker.flush()
    st = tracker.state

    def n(x):
        return x.detach().cpu().numpy()

    arrays = {
        "tsdf": n(st.vol.tsdf),
        "cw": n(st.vol.cw).view(np.uint32),
        "wrap": n(st.vol.wrap),
        "origin": n(st.vol.origin),
        "pose": n(st.pose),
        "pred_vmap": n(st.pred_vmap),
        "pred_nmap": n(st.pred_nmap),
        "pred_pose": n(st.pred_pose),
        "frame": n(st.frame),
        "prev_delta": n(st.prev_delta),
        "poses": np.asarray(tracker.poses),
        "stamps_us": np.asarray(tracker.stamps_us, np.int64),
        "shift_log": np.asarray(tracker.shift_log, np.int32).reshape(-1, 3),
    }
    for k, v in tracker.stats.items():
        arrays[f"stat_{k}"] = np.asarray(v, np.float64)
    meta = {
        "frame_idx": tracker._frame_idx,
        "n_slices": len(tracker.slices),
        "n_patches": len(tracker.mesh_patches),
        "stats": sorted(tracker.stats.keys()),
        "fast_mode": bool(tracker.cfg.fast_mode),
    }
    for i, sl in enumerate(tracker.slices):
        _pack_slice(arrays, meta, f"slice{i}", sl)
    for i, p in enumerate(tracker.mesh_patches):
        _pack_patch(arrays, meta, f"patch{i}", p)
    return arrays, meta


def _restore_tracker(data, meta, tracker: Tracker) -> Tracker:
    dev = tracker.device

    def t(name, dtype=np.float32):
        return torch.from_numpy(np.array(data[name], dtype=dtype)).to(dev)

    fast = tracker.cfg.fast_mode
    vol = (BlockedVolume if fast else VolumeState)(
        tsdf=t("tsdf"),
        cw=torch.from_numpy(np.array(data["cw"], np.uint32).view(np.int32)).to(dev),
        wrap=t("wrap", np.int32), origin=t("origin"),
    )
    R = tracker.cfg.volume_resolution
    if vol.tsdf.shape != (((R // 8) ** 3, 4, 128) if fast else (R, R, R)):
        raise ValueError(f"checkpoint volume {tuple(vol.tsdf.shape)} does not fit "
                         f"volume_resolution {R}")
    if fast and bool(vol.wrap.any()):
        raise ValueError("the mirror needs a wrap-free volume (wrap == 0)")
    st = tracker.state
    # dc and pw derive from the configuration, and the RGB-D pyramid is
    # the fresh tracker's: keep them
    tracker.state = st._replace(
        vol=vol, pose=t("pose"), pred_vmap=t("pred_vmap"), pred_nmap=t("pred_nmap"),
        pred_pose=t("pred_pose"), frame=t("frame", np.int32),
        prev_delta=(t("prev_delta") if "prev_delta" in data
                    else torch.eye(4, dtype=torch.float32, device=dev)),
        # a tracker without a mirror (odd block count) rebuilds it in
        # every raycast
        logical=(None if st.logical is None
                 else build_mirror(vol.tsdf, R, out=st.logical)),
    )
    tracker.poses = [p for p in data["poses"]]
    tracker.stamps_us = [int(x) for x in data["stamps_us"]]
    tracker.shift_log = [s for s in data["shift_log"]]
    for k in meta.get("stats", []):
        if f"stat_{k}" in data:
            tracker.stats[k] = [float(x) for x in data[f"stat_{k}"]]
    tracker._frame_idx = int(meta["frame_idx"])
    tracker.slices = [_unpack_slice(data, meta, f"slice{i}")
                      for i in range(meta["n_slices"])]
    tracker.mesh_patches = [_unpack_patch(data, meta, f"patch{i}")
                            for i in range(meta.get("n_patches", 0))]
    return tracker


def _load(path: str, fast_mode: bool):
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    if meta.get("fast_mode", False) != bool(fast_mode):
        raise ValueError("checkpoint fast_mode does not match the configuration")
    return data, meta


def save_checkpoint(path: str, tracker: Tracker) -> None:
    arrays, meta = _tracker_payload(tracker)
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_checkpoint(path: str, tracker: Tracker) -> Tracker:
    """Restore a tracker snapshot into a freshly constructed Tracker (same
    configuration); the mirror is rebuilt on the tracker's device."""
    data, meta = _load(path, tracker.cfg.fast_mode)
    return _restore_tracker(data, meta, tracker)


def save_engine_checkpoint(path: str, engine) -> None:
    """Snapshot the engine at a quiescent point (the frame loop done or
    complete, the slice queue drained)."""
    if engine.cfg.online_deformation:
        raise NotImplementedError("engine checkpoints of an -od run are not ported yet")
    arrays, meta = _tracker_payload(engine.tracker)
    meta["engine"] = {
        "frames_done": engine._frames_done,
        "slice_idx": engine._slice_idx,
        "has_last_kf_pose": False,
    }
    meta["n_proc_slices"] = len(engine.slice_proc.processed)
    for i, sl in enumerate(engine.slice_proc.processed):
        _pack_slice(arrays, meta, f"proc{i}", sl)
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_engine_checkpoint(path: str, engine) -> None:
    """Restore into a freshly constructed SlamEngine (same configuration)."""
    data, meta = _load(path, engine.cfg.fast_mode)
    backend = [k for k in ("deformation", "place_rec", "pose_graph") if k in meta]
    if backend or meta.get("engine", {}).get("has_last_kf_pose"):
        raise NotImplementedError(
            f"this checkpoint holds online-deformation state ({backend or 'keyframes'}): "
            "not ported yet")
    _restore_tracker(data, meta, engine.tracker)
    em = meta["engine"]
    engine._frames_done = int(em["frames_done"])
    engine._slice_idx = int(em["slice_idx"])
    engine.slice_proc.processed = [_unpack_slice(data, meta, f"proc{i}")
                                   for i in range(meta.get("n_proc_slices", 0))]
