"""Headless visualisation exports (port of kintinuous_tpu/viz/headless.py).

The reference's PangoVis draws the live model, the image panes, the
trajectory and the stats into a window; without a display the same
signals go to files: model renders (PNG, written by viz/png.py),
the trajectory as a coloured point cloud (PLY), and a stats dict.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from kintinuous_tpu_torch.io.ply import save_ply
from kintinuous_tpu_torch.ops.image import generate_depth, generate_image
from kintinuous_tpu_torch.viz.png import encode_png


MODEL_PANES = ("model", "model_depth")


def model_view(tracker, name: str) -> np.ndarray:
    """A model pane of the tracker's current prediction, rendered on its
    device, as an (h,w,3) uint8 host array: "model" the shaded render,
    "model_depth" the depth render of the prediction's local z (as the
    JAX package's)."""
    st = tracker.state  # one state: its two maps belong together
    if name == "model":
        img = generate_image(st.pred_vmap, st.pred_nmap)
    else:
        img = generate_depth(torch.nan_to_num(st.pred_vmap[2]), 6.0)
    return img.cpu().numpy()


def save_model_views(basename: str, tracker) -> List[str]:
    """Writes the model panes (PangoVis.cpp:45-80) as
    `<basename>_model.png` and `<basename>_model_depth.png`; returns the
    paths."""
    out = []
    for name in MODEL_PANES:
        p = f"{basename}_{name}.png"
        with open(p, "wb") as f:
            f.write(encode_png(model_view(tracker, name)))
        out.append(p)
    return out


def save_trajectory_ply(path: str, poses: List[np.ndarray]) -> None:
    """The camera positions as a point cloud with a colour ramp along
    the run (the reference draws frusta and lines, PangoVis.cpp:421-436)."""
    if not poses:
        save_ply(path, np.zeros((0, 3), np.float32))
        return
    pts = np.array([T[:3, 3] for T in poses], np.float32)
    t = np.linspace(0, 1, len(pts))
    cols = np.stack([255 * t, 80 + 100 * (1 - t), 255 * (1 - t)], axis=1).astype(np.uint8)
    save_ply(path, pts, cols)


def stats_panel(engine) -> dict:
    """The reference's stats pane (points, triangles, fps, backend lag,
    PangoVis.cpp:584-600) as a dict."""
    n_points = sum(
        len(s.processed["points"]) if s.processed else len(s.points)
        for s in engine.slice_proc.processed
    )
    sw = engine.sw.stats()
    dm = engine.deformation
    return {
        "frames": engine._frames_done,
        "fps": round(engine.fps, 2),
        "map_points": int(n_points),
        "slices": len(engine.tracker.slices),
        "loops_accepted": dm.n_loops_accepted if dm else 0,
        "loops_rejected": dm.n_loops_rejected if dm else 0,
        # the largest backend stage lag (PangoVis.cpp:597-599)
        "backend_lag_ms": round(engine.backend_lag_ms, 1),
        "stage_ms": {k: round(v["mean_ms"], 2) for k, v in sw.items()
                     if not k.startswith("pulse.")},
    }
