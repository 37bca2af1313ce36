"""PLY mesh/cloud writer and reader, binary little-endian (the port's
own copy of kintinuous_tpu/io/ply.py: numpy only, the same file
format, so either package reads what the other writes)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def save_ply(
    path: str,
    vertices: np.ndarray,  # (N,3) float
    colors: Optional[np.ndarray] = None,  # (N,3) uint8
    normals: Optional[np.ndarray] = None,  # (N,3) float
    faces: Optional[np.ndarray] = None,  # (M,3) int
) -> None:
    n = len(vertices)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += ["property float x", "property float y", "property float z"]
    if normals is not None:
        header += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    if faces is not None:
        header += [f"element face {len(faces)}", "property list uchar int vertex_indices"]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        cols = [vertices.astype("<f4")]
        if normals is not None:
            cols.append(normals.astype("<f4"))
        rec = np.concatenate(cols, axis=1).astype("<f4")
        if colors is not None:
            # mixed float/uchar rows need a structured array
            dt = [("v", "<f4", rec.shape[1]), ("c", "u1", 3)]
            buf = np.empty(n, dtype=dt)
            buf["v"] = rec
            buf["c"] = colors.astype(np.uint8)
            f.write(buf.tobytes())
        else:
            f.write(rec.tobytes())
        if faces is not None:
            dt = [("k", "u1"), ("i", "<i4", 3)]
            fb = np.empty(len(faces), dtype=dt)
            fb["k"] = 3
            fb["i"] = faces.astype("<i4")
            f.write(fb.tobytes())


def load_ply(path: str) -> dict:
    """Minimal reader for files written by save_ply (tests/tools)."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        assert line == b"ply"
        n_vert = n_face = 0
        props = []
        while True:
            line = f.readline().strip().decode()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "element" and parts[1] == "vertex":
                n_vert = int(parts[2])
            elif parts[0] == "element" and parts[1] == "face":
                n_face = int(parts[2])
            elif parts[0] == "property" and parts[1] != "list":
                props.append((parts[2], parts[1]))
        float_props = [p for p, t in props if t == "float"]
        has_color = any(p == "red" for p, _ in props)
        dt = [("v", "<f4", len(float_props))]
        if has_color:
            dt.append(("c", "u1", 3))
        data = np.frombuffer(f.read(n_vert * np.dtype(dt).itemsize), dtype=dt)
        out = {"vertices": data["v"][:, :3].copy()}
        if "nx" in float_props:
            i = float_props.index("nx")
            out["normals"] = data["v"][:, i : i + 3].copy()
        if has_color:
            out["colors"] = data["c"].copy()
        if n_face:
            fdt = [("k", "u1"), ("i", "<i4", 3)]
            fdata = np.frombuffer(f.read(n_face * np.dtype(fdt).itemsize), dtype=fdt)
            out["faces"] = fdata["i"].copy()
        return out
