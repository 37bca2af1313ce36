"""Synthetic RGB-D frames (host-side numpy; the port's own copy).

The subset of kintinuous_tpu/io/synth.py that drives the port without
a dataset: the analytic room + spheres + cuboids scene with checker
albedo, its renderer, the orbit and straight-line trajectories, and
`generate_klg`, which renders a trajectory into a `.klg` log. Frames
and poses come out identical to the JAX package's, so both packages
can be fed the same sequence.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from kintinuous_tpu_torch.config import CameraIntrinsics
from kintinuous_tpu_torch.io.klg import KlgLogWriter, jpeg_codec
from kintinuous_tpu_torch.io.tum import save_trajectory


@dataclass
class Sphere:
    center: np.ndarray
    radius: float


@dataclass
class Cuboid:
    """Axis-aligned solid box (exterior hit)."""

    bmin: np.ndarray
    bmax: np.ndarray


@dataclass
class Scene:
    """Interior of an axis-aligned room with spheres and cuboids inside.

    The default scene is deliberately ICP-friendly: several curved and
    planar surfaces at different orientations visible from the origin
    looking +z, so all 6 motion DOF are constrained (a fronto-parallel
    wall alone leaves x/y slide and roll free).
    """

    box_min: np.ndarray = field(default_factory=lambda: np.array([-2.0, -2.0, -2.0]))
    box_max: np.ndarray = field(default_factory=lambda: np.array([2.0, 2.0, 2.0]))
    spheres: List[Sphere] = field(default_factory=list)
    cuboids: List[Cuboid] = field(default_factory=list)

    @staticmethod
    def default() -> "Scene":
        return Scene(
            spheres=[
                Sphere(np.array([0.0, 0.35, 1.1]), 0.35),
                Sphere(np.array([-0.55, -0.35, 1.3]), 0.3),
                Sphere(np.array([0.6, -0.3, 1.5]), 0.35),
            ],
            cuboids=[
                Cuboid(np.array([-0.9, 0.1, 1.5]), np.array([-0.3, 0.7, 1.95])),
                Cuboid(np.array([0.25, 0.45, 1.3]), np.array([0.85, 0.95, 1.8])),
                Cuboid(np.array([-0.15, -0.8, 1.6]), np.array([0.35, -0.35, 1.95])),
            ],
        )


def _ray_box_interior(origins, dirs, bmin, bmax):
    """First positive hit with the box interior walls. Returns t (inf if none)."""
    t_best = np.full(dirs.shape[:-1], np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        for axis in range(3):
            for bound in (bmin[axis], bmax[axis]):
                d = dirs[..., axis]
                t = (bound - origins[..., axis]) / d
                pt = origins + np.nan_to_num(t, posinf=0.0, neginf=0.0)[..., None] * dirs
                ok = (t > 1e-6) & np.isfinite(t)
                for other in range(3):
                    if other == axis:
                        continue
                    ok &= (pt[..., other] >= bmin[other] - 1e-6) & (
                        pt[..., other] <= bmax[other] + 1e-6
                    )
                t_best = np.where(ok & (t < t_best), t, t_best)
    return t_best


def _ray_sphere(origins, dirs, center, radius):
    oc = origins - center
    b = np.sum(oc * dirs, axis=-1)
    c = np.sum(oc * oc, axis=-1) - radius * radius
    disc = b * b - c
    t = np.where(disc >= 0, -b - np.sqrt(np.maximum(disc, 0.0)), np.inf)
    return np.where(t > 1e-6, t, np.inf)


def _ray_cuboid(origins, dirs, bmin, bmax):
    """First positive exterior hit with an AABB (slab method)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / dirs
        t0 = (bmin - origins) * inv
        t1 = (bmax - origins) * inv
        tnear = np.nanmax(np.minimum(t0, t1), axis=-1)
        tfar = np.nanmin(np.maximum(t0, t1), axis=-1)
    hit = (tnear <= tfar) & (tnear > 1e-6)
    return np.where(hit, tnear, np.inf)


def render_frame(
    scene: Scene,
    cam: CameraIntrinsics,
    T_wc: np.ndarray,
    depth_noise_mm: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render (depth_mm uint16, rgb uint8) for camera-to-world pose T_wc."""
    H, W = cam.height, cam.width
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    rays_cam = np.stack(
        [(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, np.ones_like(u, dtype=float)],
        axis=-1,
    )
    R, t = T_wc[:3, :3], T_wc[:3, 3]
    dirs = rays_cam @ R.T
    norm = np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs_n = dirs / norm
    origins = np.broadcast_to(t, dirs_n.shape)

    t_hit = _ray_box_interior(origins, dirs_n, scene.box_min, scene.box_max)
    hit_id = np.zeros(t_hit.shape, dtype=np.int32)  # 0 = wall
    for i, s in enumerate(scene.spheres):
        ts = _ray_sphere(origins, dirs_n, s.center, s.radius)
        closer = ts < t_hit
        t_hit = np.where(closer, ts, t_hit)
        hit_id = np.where(closer, i + 1, hit_id)
    for i, cb in enumerate(scene.cuboids):
        ts = _ray_cuboid(origins, dirs_n, cb.bmin, cb.bmax)
        closer = ts < t_hit
        t_hit = np.where(closer, ts, t_hit)
        hit_id = np.where(closer, len(scene.spheres) + i + 1, hit_id)

    pts = origins + t_hit[..., None] * dirs_n
    # depth = z in camera frame = t_hit / |ray_cam| (ray_cam has z=1)
    z = t_hit / norm[..., 0]
    z = np.where(np.isfinite(z), z, 0.0)
    if depth_noise_mm > 0:
        rng = rng or np.random.default_rng(0)
        z = z + rng.normal(0.0, depth_noise_mm / 1000.0, z.shape) * (z > 0)
    depth_mm = np.clip(z * 1000.0, 0, 65535).astype(np.uint16)

    # checker albedo in world coords, tinted per object
    checker = (
        (np.floor(pts[..., 0] * 4) + np.floor(pts[..., 1] * 4) + np.floor(pts[..., 2] * 4))
        % 2
    ).astype(np.float32)
    base = 0.35 + 0.5 * checker
    tint = np.array(
        [[0.9, 0.9, 0.9], [0.9, 0.4, 0.3], [0.3, 0.8, 0.4], [0.35, 0.45, 0.9]]
    )[np.clip(hit_id, 0, 3)]
    rgb = np.clip(base[..., None] * tint * 255.0, 0, 255).astype(np.uint8)
    rgb[depth_mm == 0] = 0
    return depth_mm, rgb



def orbit_trajectory(
    n_frames: int,
    radius: float = 0.35,
    angle_deg: float = 25.0,
    translation: Optional[np.ndarray] = None,
) -> List[np.ndarray]:
    """Smooth look-around trajectory staying near the origin.

    Small rotations + small translations — comfortably within ICP's
    convergence basin at 30 Hz, like a handheld sensor.
    """
    poses = []
    drift = translation if translation is not None else np.zeros(3)
    for i in range(n_frames):
        a = np.sin(2 * np.pi * i / max(n_frames - 1, 1)) * np.deg2rad(angle_deg)
        b = np.sin(4 * np.pi * i / max(n_frames - 1, 1)) * np.deg2rad(angle_deg * 0.3)
        Ry = np.array(
            [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        )
        Rx = np.array(
            [[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]]
        )
        T = np.eye(4)
        T[:3, :3] = Ry @ Rx
        frac = i / max(n_frames - 1, 1)
        T[:3, 3] = (
            np.array([np.sin(a) * radius, 0.05 * np.sin(2 * a), radius * (1 - np.cos(a))])
            + drift * frac
        )
        poses.append(T)
    return poses


def straight_trajectory(n_frames: int, distance: float, axis: int = 0) -> List[np.ndarray]:
    """Constant-velocity translation — exercises volume shifting."""
    poses = []
    for i in range(n_frames):
        T = np.eye(4)
        T[axis, 3] = distance * i / max(n_frames - 1, 1)
        poses.append(T)
    return poses


def generate_klg(
    path: str,
    cam: CameraIntrinsics,
    poses: List[np.ndarray],
    scene: Optional[Scene] = None,
    fps: float = 30.0,
    depth_noise_mm: float = 0.0,
    gt_path: Optional[str] = None,
    color: bool = False,
) -> None:
    """Render `poses` into a `.klg` log at `fps` (and their TUM ground
    truth into gt_path). Depth is always written; JPEG colour only when
    `color` is asked for and an encoder (cv2 or PIL) exists, else the
    frames carry no image. The depth noise draws from the JAX package's
    seed, so both packages write the same depth."""
    scene = scene or Scene.default()
    if color:
        try:
            jpeg_codec()
        except RuntimeError:
            color = False
    rng = np.random.default_rng(7)
    with KlgLogWriter(path) as w:
        for i, T in enumerate(poses):
            depth, rgb = render_frame(scene, cam, T, depth_noise_mm, rng)
            w.write(int(i * 1e6 / fps), depth, rgb if color else None)
    if gt_path:
        save_trajectory(gt_path, [i / fps for i in range(len(poses))], poses)
