"""TUM-format trajectory IO (the port's numpy copy of
kintinuous_tpu/io/tum.py).

Format: `timestamp tx ty tz qx qy qz qw` per line, timestamps in
seconds; the loader also takes the comma-separated ground-truth form
`utime,x,y,z,qx,qy,qz,qw`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """(qx,qy,qz,qw) -> 3x3 rotation."""
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0 else 2.0 / n
    return np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
            [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
            [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
        ]
    )


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> (qx,qy,qz,qw)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            x, w = 0.25 * s, (R[2, 1] - R[1, 2]) / s
            y, z = (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s
        elif i == 1:
            s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2
            y, w = 0.25 * s, (R[0, 2] - R[2, 0]) / s
            x, z = (R[0, 1] + R[1, 0]) / s, (R[1, 2] + R[2, 1]) / s
        else:
            s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2
            z, w = 0.25 * s, (R[1, 0] - R[0, 1]) / s
            x, y = (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s
    return np.array([x, y, z, w])


def pose_to_tum_line(timestamp_s: float, T: np.ndarray) -> str:
    q = rot_to_quat(T[:3, :3])
    t = T[:3, 3]
    return (
        f"{timestamp_s:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}"
    )


def save_trajectory(path: str, stamps_s: List[float], poses: List[np.ndarray]):
    with open(path, "w") as f:
        for s, T in zip(stamps_s, poses):
            f.write(pose_to_tum_line(s, T) + "\n")


def load_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (stamps_s (N,), poses (N,4,4))."""
    stamps, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) < 8:
                continue
            ts, x, y, z, qx, qy, qz, qw = (float(p) for p in parts[:8])
            T = np.eye(4)
            T[:3, :3] = quat_to_rot(np.array([qx, qy, qz, qw]))
            T[:3, 3] = [x, y, z]
            stamps.append(ts)
            poses.append(T)
    return np.array(stamps), np.array(poses)


class TrajectoryWriter:
    """Streaming pose writer: one line per frame as its pose lands."""

    def __init__(self, path: str):
        self._f = open(path, "w")

    def write(self, timestamp_us: int, T: np.ndarray):
        self._f.write(pose_to_tum_line(timestamp_us / 1e6, T) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
