"""Camera trajectories, frozen copies of kintinuous_tpu_torch/io/synth.py's
(numpy, float64, camera-to-world 4x4 poses; camera z is the optical axis,
y is image-down). A traffic file names one by its key in TRAJECTORIES
and gives its keyword arguments."""

from __future__ import annotations

from typing import List

import numpy as np


def handheld_trajectory(n_frames: int = 240, sweep_deg: float = 55.0,
                        radius: float = 1.4, tremor_mm: float = 2.0,
                        seed: int = 3) -> List[np.ndarray]:
    """fr1/desk-like handheld motion: an arcing out-and-back sweep around
    the desk with a slow up-down bob and smoothed hand tremor on all axes
    (fr1/desk's published means are 0.41 m/s and 23.3 deg/s)."""
    rng = np.random.default_rng(seed)
    tremor = rng.normal(0.0, tremor_mm / 1000.0, (n_frames, 3))
    k = np.array([0.25, 0.5, 0.25])
    for a in range(3):
        tremor[:, a] = np.convolve(tremor[:, a], k, mode="same")
    poses = []
    for i in range(n_frames):
        ph = np.sin(np.pi * i / max(n_frames - 1, 1))
        yaw = np.deg2rad(sweep_deg) * (ph - 0.5) * 2.0 * 0.5
        pitch = np.deg2rad(8.0) * np.sin(4 * np.pi * i / n_frames)
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        T = np.eye(4)
        T[:3, :3] = Ry @ Rx
        T[:3, 3] = np.array([-sy * radius * 0.55,
                             0.12 * np.sin(2 * np.pi * i / n_frames),
                             radius * 0.12 * (1 - cy)]) + tremor[i]
        poses.append(T)
    return poses


def living_room_trajectory(n_frames: int = 440, rx: float = 1.05, rz: float = 0.75,
                           seed: int = 5) -> List[np.ndarray]:
    """lr kt2-like lap: an ellipse around the room's centre looking
    outward, a full 360-degree pan over the lap back to the start pose,
    with a gentle bob, pitch breathing and smoothed drift."""
    rng = np.random.default_rng(seed)
    drift = rng.normal(0.0, 0.0015, (n_frames, 3))
    k = np.array([0.25, 0.5, 0.25])
    for a in range(3):
        drift[:, a] = np.convolve(drift[:, a], k, mode="same")
    poses = []
    for i in range(n_frames):
        ph = 2.0 * np.pi * i / n_frames
        pos = np.array([rx * np.sin(ph), 0.06 * np.sin(2.0 * ph), rz * np.cos(ph)])
        yaw = ph
        pitch = np.deg2rad(5.0) * np.sin(3.0 * ph)
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        T = np.eye(4)
        T[:3, :3] = Ry @ Rx
        T[:3, 3] = pos + drift[i]
        poses.append(T)
    return poses


TRAJECTORIES = {
    "handheld": handheld_trajectory,
    "living_room": living_room_trajectory,
}


def se3_log(T: np.ndarray) -> np.ndarray:
    """6-vector (omega, v) with T ~= exp; small-angle-safe (io/synth._se3_log)."""
    R = T[:3, :3]
    cos_t = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-8:
        omega = np.zeros(3)
    else:
        omega = (theta / (2.0 * np.sin(theta))
                 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]))
    return np.concatenate([omega, T[:3, 3]])


def se3_exp_rot(omega: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(omega)
    if theta < 1e-8:
        return np.eye(3)
    k = omega / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
