"""Binary PCD point clouds, XYZ[normal][rgb] layout (the port's numpy
copy of kintinuous_tpu/io/pcd.py)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def save_pcd(
    path: str,
    points: np.ndarray,  # (N,3)
    colors: Optional[np.ndarray] = None,  # (N,3) uint8
    normals: Optional[np.ndarray] = None,  # (N,3)
) -> None:
    n = len(points)
    fields = ["x", "y", "z"]
    if normals is not None:
        fields += ["normal_x", "normal_y", "normal_z"]
    if colors is not None:
        fields += ["rgb"]
    k = len(fields)
    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        "FIELDS " + " ".join(fields),
        "SIZE " + " ".join(["4"] * k),
        "TYPE " + " ".join(["F"] * k),
        "COUNT " + " ".join(["1"] * k),
        f"WIDTH {n}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}",
        "DATA binary",
    ])
    cols = [points.astype("<f4")]
    if normals is not None:
        cols.append(normals.astype("<f4"))
    if colors is not None:
        rgb = colors.astype(np.uint32)
        packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
        cols.append(packed.view(np.float32).reshape(-1, 1).astype("<f4"))
    rec = np.concatenate(cols, axis=1).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode() + b"\n")
        f.write(rec.tobytes())


def load_pcd(path: str) -> dict:
    with open(path, "rb") as f:
        fields = []
        n = 0
        while True:
            line = f.readline().decode().strip()
            if line.startswith("FIELDS"):
                fields = line.split()[1:]
            elif line.startswith("POINTS"):
                n = int(line.split()[1])
            elif line.startswith("DATA"):
                if line.split()[1] != "binary":
                    raise ValueError(f"{path}: only binary PCD is read")
                break
        data = np.frombuffer(f.read(n * len(fields) * 4), dtype="<f4").reshape(
            n, len(fields))
        out = {"points": data[:, :3].copy()}
        if "normal_x" in fields:
            i = fields.index("normal_x")
            out["normals"] = data[:, i:i + 3].copy()
        if "rgb" in fields:
            i = fields.index("rgb")
            packed = data[:, i].copy().view(np.uint32)
            out["colors"] = np.stack(
                [(packed >> 16) & 255, (packed >> 8) & 255, packed & 255], axis=1
            ).astype(np.uint8)
        return out
