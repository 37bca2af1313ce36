"""Synthetic RGB-D frames (host-side numpy; the port's own copy of
kintinuous_tpu/io/synth.py).

The analytic scenes (the room with spheres and cuboids, the corridor,
the lap room with its island, the desk and the living room), checker
albedo, the ideal renderer and the structured-light SensorModel
renderer, their trajectories (orbit, straight line, out-and-back walk,
the rectangular lap with its partial second lap, the handheld sweep,
the living-room ellipse), `render_frames`, and `generate_klg` /
`generate_klg_sensor`, which render a trajectory into a `.klg` log.
Frames and poses come out identical to the JAX package's, so both
packages can be fed the same sequence.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Tuple

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


def _ray_cuboid(origins, inv, bmin, bmax):
    """First positive exterior hit with an AABB (slab method), given the
    rays' 1 / dirs (shared by every cuboid of a frame). The three slabs
    are folded with fmax / fmin, as nanmax / nanmin fold them."""
    with np.errstate(invalid="ignore"):
        t0 = (bmin - origins) * inv
        t1 = (bmax - origins) * inv
        lo, hi = np.minimum(t0, t1), np.maximum(t0, t1)
        tnear = np.fmax(np.fmax(lo[..., 0], lo[..., 1]), lo[..., 2])
        tfar = np.fmin(np.fmin(hi[..., 0], hi[..., 1]), hi[..., 2])
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
    # every ray starts at t: the helpers take it unbroadcast, so what
    # depends on the origin alone is computed once, not once a pixel
    origins = t

    t_hit = _ray_box_interior(origins, dirs_n, scene.box_min, scene.box_max)
    hit_id = np.zeros(t_hit.shape, dtype=np.int32)  # 0 = wall
    for i, s in enumerate(scene.spheres):
        ts = _ray_sphere(origins, dirs_n, s.center, s.radius)
        closer = ts < t_hit
        t_hit = np.where(closer, ts, t_hit)
        hit_id = np.where(closer, i + 1, hit_id)
    with np.errstate(divide="ignore"):
        inv = 1.0 / dirs_n
    for i, cb in enumerate(scene.cuboids):
        ts = _ray_cuboid(origins, inv, cb.bmin, cb.bmax)
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


@dataclass
class SensorModel:
    """Structured-light (Kinect-v1-class) sensor noise for synthetic
    renders — the highest-fidelity proxy available in an environment
    with no dataset egress (BASELINE.md's metric is ATE on TUM fr1/desk,
    captured with exactly this sensor class).

    Components, with publicly documented magnitudes:
      - axial noise grows quadratically with depth:
        sigma_z(z) = axial_a + axial_b * (z - 0.4)^2  [metres]
        (Nguyen, Izadi, Lovell, 3DIMPVT'12 empirical Kinect fit)
      - depth quantisation from the discretised disparity map:
        step q(z) ~= quant_mm_per_m2 * z^2 millimetres
        (Khoshelham & Elberink, Sensors'12: ~2.5 mm at 1 m, ~1 cm at
        2 m, ~7 cm at 5 m)
      - lateral noise: ~0.8 px jitter of the sampling grid (same paper)
      - invalid returns at depth discontinuities (occlusion shadows of
        the IR projector): pixels adjacent to a > edge_jump_mm step
        drop out
      - operating range gate [min_z, max_z] (Kinect: 0.4-5 m)
      - rolling-shutter-ish readout: each image row is rendered at the
        pose interpolated readout_s * row/H into the inter-frame motion
        (the reference sensor streams rows over ~1/30 s)
    """

    axial_a: float = 0.0012
    axial_b: float = 0.0019
    lateral_px: float = 0.8
    quant_mm_per_m2: float = 2.73
    edge_jump_mm: float = 120.0
    min_z: float = 0.4
    max_z: float = 5.0
    readout_s: float = 0.025
    frame_dt_s: float = 1.0 / 30.0


def _se3_log(T: np.ndarray) -> np.ndarray:
    """6-vector (omega, v) with T ~= exp. Small-angle-safe."""
    R = T[:3, :3]
    cos_t = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-8:
        omega = np.zeros(3)
    else:
        omega = (
            theta
            / (2.0 * np.sin(theta))
            * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        )
    return np.concatenate([omega, T[:3, 3]])


def _se3_exp_rot(omega: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(omega)
    if theta < 1e-8:
        return np.eye(3)
    k = omega / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def render_frame_sensor(
    scene: Scene,
    cam: CameraIntrinsics,
    T_wc: np.ndarray,
    model: SensorModel,
    rng: np.random.Generator,
    T_next: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render one frame through the SensorModel. T_next (the next
    frame's pose) drives the rolling-shutter row interpolation; None
    renders a global-shutter frame with the same noise."""
    H, W = cam.height, cam.width
    # lateral noise: jitter the sampling grid (sub-pixel ray offsets)
    u0, v0 = np.meshgrid(np.arange(W, dtype=float), np.arange(H, dtype=float))
    u = u0 + rng.normal(0.0, model.lateral_px, u0.shape)
    v = v0 + rng.normal(0.0, model.lateral_px, v0.shape)
    rays_cam = np.stack(
        [(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, np.ones_like(u)], axis=-1
    )

    if T_next is not None and model.readout_s > 0:
        # per-row pose: advance along log(T^-1 T_next) by the row's
        # readout fraction of the inter-frame motion
        xi = _se3_log(np.linalg.inv(T_wc) @ T_next)
        fracs = (np.arange(H) / max(H - 1, 1)) * (
            model.readout_s / model.frame_dt_s
        )
        dirs = np.empty((H, W, 3))
        origins = np.empty((H, W, 3))
        # group rows into 16 bands — pose changes smoothly; banding keeps
        # the raytrace vectorised without visible stepping at these rates
        for b0 in range(0, H, max(H // 16, 1)):
            b1 = min(b0 + max(H // 16, 1), H)
            f = float(fracs[(b0 + b1) // 2])
            d = np.eye(4)
            d[:3, :3] = _se3_exp_rot(xi[:3] * f)
            d[:3, 3] = xi[3:] * f
            Trow = T_wc @ d
            dirs[b0:b1] = rays_cam[b0:b1] @ Trow[:3, :3].T
            origins[b0:b1] = Trow[:3, 3]
    else:
        dirs = rays_cam @ T_wc[:3, :3].T
        origins = np.broadcast_to(T_wc[:3, 3], dirs.shape).copy()

    norm = np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs_n = dirs / norm
    t_hit = _ray_box_interior(origins, dirs_n, scene.box_min, scene.box_max)
    hit_id = np.zeros(t_hit.shape, dtype=np.int32)
    for i, s in enumerate(scene.spheres):
        ts = _ray_sphere(origins, dirs_n, s.center, s.radius)
        closer = ts < t_hit
        t_hit = np.where(closer, ts, t_hit)
        hit_id = np.where(closer, i + 1, hit_id)
    with np.errstate(divide="ignore"):
        inv = 1.0 / dirs_n
    for i, cb in enumerate(scene.cuboids):
        ts = _ray_cuboid(origins, inv, cb.bmin, cb.bmax)
        closer = ts < t_hit
        t_hit = np.where(closer, ts, t_hit)
        hit_id = np.where(closer, len(scene.spheres) + i + 1, hit_id)
    pts = origins + t_hit[..., None] * dirs_n
    z = t_hit / norm[..., 0]
    z = np.where(np.isfinite(z), z, 0.0)

    # axial noise, quadratic in depth
    sigma = model.axial_a + model.axial_b * np.square(np.maximum(z - 0.4, 0.0))
    z_noisy = z + rng.normal(0.0, 1.0, z.shape) * sigma * (z > 0)
    # disparity quantisation: the sensor measures inverse depth on a
    # fixed lattice of step s, giving depth steps dz = s * z^2
    s = model.quant_mm_per_m2 / 1000.0  # 1/m
    if s > 0:
        inv = 1.0 / np.maximum(z_noisy, 1e-6)
        z_noisy = np.where(
            z_noisy > 0, 1.0 / np.maximum(np.round(inv / s) * s, 1e-9), z_noisy
        )
    # range gate + discontinuity dropout (projector occlusion shadows)
    valid = (z > model.min_z) & (z < model.max_z)
    jump = model.edge_jump_mm / 1000.0
    dz_x = np.abs(np.diff(z, axis=1, prepend=z[:, :1]))
    dz_y = np.abs(np.diff(z, axis=0, prepend=z[:1, :]))
    edge = (dz_x > jump) | (dz_y > jump)
    edge = edge | np.roll(edge, -1, axis=1) | np.roll(edge, -1, axis=0)
    valid &= ~edge
    depth_mm = np.where(valid, np.clip(z_noisy * 1000.0, 0, 65535), 0.0).astype(
        np.uint16
    )

    checker = (
        (np.floor(pts[..., 0] * 4) + np.floor(pts[..., 1] * 4) + np.floor(pts[..., 2] * 4))
        % 2
    ).astype(np.float32)
    base = 0.35 + 0.5 * checker
    tint = np.array(
        [[0.9, 0.9, 0.9], [0.9, 0.4, 0.3], [0.3, 0.8, 0.4], [0.35, 0.45, 0.9]]
    )[np.clip(hit_id, 0, 3)]
    rgb = np.clip(base[..., None] * tint * 255.0, 0, 255).astype(np.uint8)
    # keep clean RGB where only the DEPTH dropped out: the real RGB
    # camera is independent of the structured-light projector, so
    # dropout edges must not inject frame-varying black gradients the
    # photometric term could latch onto. Zero only true
    # ray misses (the box interior makes these impossible in practice).
    rgb[z <= 0] = 0
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


def corridor_scene(length: float = 8.0, half_width: float = 1.5) -> Scene:
    """A long corridor along +x with geometry-rich walls: periodic
    pillars, boxes and spheres on alternating sides so every viewpoint
    along the walk sees curved + planar surfaces at multiple
    orientations (all 6 ICP DOF constrained). The spatial analogue of
    the reference's 'hundreds of metres' hallway runs (README.md:3)."""
    spheres = []
    cuboids = []
    hw = half_width
    x = -1.2
    k = 0
    # dense enough (every ~1.4 m, starting before the walk origin) that
    # BOTH walk directions always have curved + planar structure in view
    while x < length + 1.4:
        side = 1.0 if k % 2 == 0 else -1.0
        # wall pillar (floor to ceiling), protruding into the corridor
        cuboids.append(
            Cuboid(
                np.array([x - 0.12, -hw, min(side * (hw - 0.35), side * hw) - 0.12]),
                np.array([x + 0.12, hw, max(side * (hw - 0.35), side * hw) + 0.12]),
            )
        )
        # mid-height sphere on the opposite wall
        spheres.append(
            Sphere(np.array([x + 0.45, 0.3 * side, -side * (hw - 0.45)]), 0.3)
        )
        # floor box (y is image-down, so +y is the floor), off-centre
        cuboids.append(
            Cuboid(
                np.array([x + 0.8, hw - 0.5, side * 0.55 - 0.25]),
                np.array([x + 1.2, hw, side * 0.55 + 0.25]),
            )
        )
        # ceiling sphere for pitch/roll constraint
        spheres.append(
            Sphere(np.array([x + 1.0, -(hw - 0.4), -side * 0.5]), 0.25)
        )
        x += 1.4
        k += 1
    return Scene(
        box_min=np.array([-1.8, -hw, -hw]),
        box_max=np.array([length + 1.8, hw, hw]),
        spheres=spheres,
        cuboids=cuboids,
    )


def walk_loop_trajectory(
    n_frames: int,
    distance: float,
    turn_frames: int = 30,
    hold_frames: int = 6,
    sway: float = 0.04,
    warmup_frames: int = 10,
) -> List[np.ndarray]:
    """Out-and-back corridor walk with a revisit: walk +x looking +x,
    smooth 180° turn at the far end, walk back looking -x, turn again
    at the start so the final frames revisit frame 0's viewpoint (the
    loop-closure trigger the reference demos with loop.klg,
    README.md:164-170). Rotation rate stays ICP-trackable
    (180°/turn_frames per frame)."""

    def rot_y(theta):
        c, s = np.cos(theta), np.sin(theta)
        return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])

    # base orientation: camera z (view) -> world +x is rot_y(+90°)
    base = rot_y(np.pi / 2.0)
    walk_frames = n_frames - 2 * turn_frames - hold_frames - warmup_frames
    out_frames = walk_frames // 2
    back_frames = walk_frames - out_frames
    poses = []
    xs = 0.0
    for i in range(n_frames):
        T = np.eye(4)
        if i < warmup_frames:  # stand at the start (dynamic cube settles)
            xs = 0.0
            theta = 0.0
        elif i < warmup_frames + out_frames:  # walk out, looking +x
            frac = (i - warmup_frames) / max(out_frames - 1, 1)
            xs = distance * frac
            theta = 0.0
        elif i < warmup_frames + out_frames + turn_frames:  # turn 180°
            j = i - warmup_frames - out_frames
            xs = distance
            theta = np.pi * (j + 1) / turn_frames
        elif i < warmup_frames + out_frames + turn_frames + back_frames:
            j = i - warmup_frames - out_frames - turn_frames
            frac = j / max(back_frames - 1, 1)
            xs = distance * (1.0 - frac)
            theta = np.pi
        elif i < n_frames - hold_frames:  # turn back to +x at the start
            j = i - (warmup_frames + out_frames + turn_frames + back_frames)
            xs = 0.0
            theta = np.pi * (1.0 + (j + 1) / turn_frames)
        else:  # hold: revisit of frame 0's viewpoint
            xs = 0.0
            theta = 0.0
        T[:3, :3] = base @ rot_y(theta)
        T[:3, 3] = [xs, sway * np.sin(0.7 * i), sway * np.cos(0.9 * i)]
        poses.append(T)
    return poses


def lap_scene(length: float = 3.2, depth: float = 2.4,
              half_height: float = 1.5) -> Scene:
    """A room with a central island for rectangular-lap trajectories
    (lap_trajectory): the camera circles the island looking along the
    travel direction, so a second lap revisits every viewpoint the SAME
    way — the loop-closure-rich regime of the reference's loop.klg demo
    (README.md:164-206), unlike an out-and-back corridor whose return
    leg views everything from the opposite direction. Walls carry the
    same pillar/sphere/box mix as corridor_scene so all 6 ICP DOF stay
    constrained from every heading."""
    hh = half_height
    margin = 1.2  # path rectangle -> outer wall
    bmin = np.array([-margin, -hh, -margin])
    bmax = np.array([length + margin, hh, depth + margin])
    spheres: List[Sphere] = []
    cuboids: List[Cuboid] = []
    # central island: a box the lap circles, inset 0.9 m from the path
    iw = np.array([0.9, -hh, 0.9])
    ix = np.array([max(length - 0.9, 1.3), hh, max(depth - 0.9, 1.3)])
    cuboids.append(Cuboid(iw, ix))
    # island face decorations: STAGGERED pairs per side (heights and
    # along-face offsets differ), plus corner boxes on top. A single
    # centred sphere per face left yaw nearly unobservable from the lap
    # corners — the view there is all vertical planes + floor/ceiling,
    # and point-to-plane ICP confidently rotated the wrong way
    # (measured: 8.6 deg/frame wrong-direction lock-in at corner 1)
    cx, cz = (iw[0] + ix[0]) / 2.0, (iw[2] + ix[2]) / 2.0
    lx = ix[0] - iw[0]
    lz = ix[2] - iw[2]
    for f, (px, pz, nx, nz) in enumerate([
        (cx - 0.25 * lx, iw[2] - 0.18, 0.0, -1.0),
        (cx + 0.3 * lx, iw[2] - 0.22, 0.0, -1.0),
        (cx - 0.3 * lx, ix[2] + 0.2, 0.0, 1.0),
        (cx + 0.22 * lx, ix[2] + 0.16, 0.0, 1.0),
        (iw[0] - 0.18, cz - 0.25 * lz, -1.0, 0.0),
        (iw[0] - 0.23, cz + 0.3 * lz, -1.0, 0.0),
        (ix[0] + 0.2, cz - 0.3 * lz, 1.0, 0.0),
        (ix[0] + 0.15, cz + 0.22 * lz, 1.0, 0.0),
    ]):
        y = (-0.45, 0.3, -0.05, 0.55)[f % 4]
        spheres.append(Sphere(np.array([px, y, pz]), 0.16 + 0.04 * (f % 3)))
    # boxes leaning on the island corners (asymmetric, yaw-breaking)
    for sx_, sz_ in ((iw[0], iw[2]), (ix[0], iw[2]), (iw[0], ix[2]),
                     (ix[0], ix[2])):
        dx = -0.38 if sx_ == iw[0] else 0.02
        dz = -0.3 if sz_ == iw[2] else 0.04
        cuboids.append(
            Cuboid(
                np.array([sx_ + dx, hh - 0.75, sz_ + dz]),
                np.array([sx_ + dx + 0.36, hh, sz_ + dz + 0.26]),
            )
        )
    # free-standing floor clutter in the corner pockets of the walkable
    # ring (clear of the camera path, which hugs the path rectangle):
    # crates + balls at varied sizes, like the lab clutter of loop.klg
    for k, (qx, qz) in enumerate([
        (-0.72, -0.72), (length + 0.72, -0.68), (length + 0.68, depth + 0.72),
        (-0.68, depth + 0.7),
    ]):
        w = 0.22 + 0.05 * (k % 2)
        cuboids.append(
            Cuboid(
                np.array([qx - w, hh - 0.5 - 0.12 * k, qz - w]),
                np.array([qx + w, hh, qz + w]),
            )
        )
        spheres.append(
            Sphere(
                np.array([qx + (0.3 if k % 2 else -0.3), hh - 0.62 - 0.12 * k,
                          qz + (0.28 if k < 2 else -0.28)]),
                0.14 + 0.03 * (k % 3),
            )
        )

    def wall_decor(p0, p1, normal_in):
        """Pillar + floor box + mid sphere along an outer wall from p0
        to p1 (xz points), protruding inward along normal_in (xz)."""
        p0 = np.asarray(p0, float)
        p1 = np.asarray(p1, float)
        n = np.asarray(normal_in, float)
        seg = p1 - p0
        L = np.linalg.norm(seg)
        d = seg / L
        s = 0.4
        k = 0
        while s < L - 0.3:
            base = p0 + d * s
            if k % 3 == 0:
                # floor-to-ceiling pillar
                c = base + n * 0.14
                lo = np.array([c[0] - 0.12, -hh, c[1] - 0.12])
                hi = np.array([c[0] + 0.12, hh, c[1] + 0.12])
                cuboids.append(Cuboid(np.minimum(lo, hi), np.maximum(lo, hi)))
            elif k % 3 == 1:
                # wall sphere at staggered height
                c = base + n * 0.3
                y = (-0.55, 0.35, -0.1, 0.6)[k % 4]
                spheres.append(
                    Sphere(np.array([c[0], y, c[1]]), 0.2 + 0.05 * (k % 3))
                )
            else:
                # wall-mounted box at staggered height (shelf/cabinet)
                c = base + n * 0.26
                y0 = (hh - 0.45, -0.35, 0.15, hh - 0.9)[k % 4]
                lo = np.array([c[0] - 0.22, y0, c[1] - 0.22])
                hi = np.array([c[0] + 0.22, min(y0 + 0.42, hh), c[1] + 0.22])
                cuboids.append(Cuboid(lo, hi))
            s += 0.75
            k += 1

    xm, zm = -margin, -margin
    xM, zM = length + margin, depth + margin
    wall_decor((xm, zm), (xM, zm), (0, 1))   # z-min wall, faces +z
    wall_decor((xM, zm), (xM, zM), (-1, 0))  # x-max wall, faces -x
    wall_decor((xM, zM), (xm, zM), (0, -1))  # z-max wall, faces -z
    wall_decor((xm, zM), (xm, zm), (1, 0))   # x-min wall, faces +x
    # ceiling spheres for pitch/roll constraint (lamps), one per side
    spheres += [
        Sphere(np.array([length * 0.3, -(hh - 0.35), zm + 0.5]), 0.25),
        Sphere(np.array([length * 0.8, -(hh - 0.35), zM - 0.5]), 0.25),
        Sphere(np.array([xm + 0.5, -(hh - 0.3), depth * 0.4]), 0.22),
        Sphere(np.array([xM - 0.5, -(hh - 0.3), depth * 0.7]), 0.22),
    ]
    return Scene(box_min=bmin, box_max=bmax, spheres=spheres, cuboids=cuboids)


def lap_trajectory(
    length: float = 3.2,
    depth: float = 2.4,
    step: float = 0.05,
    turn_frames: int = 28,
    warmup_frames: int = 10,
    revisit_frac: float = 0.35,
    sway: float = 0.03,
    arc_radius: float = 0.0,
) -> List[np.ndarray]:
    """Rectangular lap around lap_scene's island, looking along the
    travel direction, then a partial second lap retracing the first —
    every revisit frame sees lap 1's viewpoint the same way, giving the
    place-recognition chain a stretch of genuine loop closures (the
    operational regime of the reference's loop.klg,
    README.md:164-206). Corners turn 90 deg over turn_frames
    (~3.2 deg/frame at 28 — within ICP's per-frame basin).

    arc_radius > 0 rounds each corner into a quarter-circle arc walked
    over turn_frames (tangent heading): humans arc corners, and an
    in-place pivot's final frames — once near content has rotated out
    of view — leave rotation/lateral-translation nearly ambiguous for
    far-heavy depth (measured: a confident 0.23 m/frame lateral slide
    at 512^3 with 6 mm noise). The arc keeps near structure flowing
    through the whole turn.

    Returns the full pose list; frame count follows from geometry
    (2*(length+depth)/step walking + 4*turn_frames per lap)."""

    def rot_y(theta):
        c, s = np.cos(theta), np.sin(theta)
        return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])

    # heading theta: view direction = (sin t, 0, cos t).
    # Segments counter-clockwise in x-z: +x, +z, -x, -z.
    corners = [np.array([0.0, 0.0]), np.array([length, 0.0]),
               np.array([length, depth]), np.array([0.0, depth])]
    headings = [np.pi / 2.0, 0.0, -np.pi / 2.0, -np.pi]
    r = float(arc_radius)

    events = []  # (kind, payload)
    for i in range(warmup_frames):
        events.append(("pose", (corners[0], headings[0])))
    n_laps_frames = 4 + int(np.ceil(4 * revisit_frac))
    for seg in range(n_laps_frames):
        s = seg % 4
        p0, p1 = corners[s], corners[(s + 1) % 4]
        th = headings[s] - 2.0 * np.pi * (seg // 4)
        d = np.array([np.sin(th), np.cos(th)])  # walk direction (x,z)
        L = np.linalg.norm(p1 - p0)
        last_seg = seg == n_laps_frames - 1
        frac_cap = 1.0
        if last_seg:
            # stop partway down the final revisit segment
            frac_cap = max(0.25, (4 * revisit_frac) - (seg - 4) + 0.0)
            frac_cap = min(1.0, frac_cap)
        start_f = (r / L) if (r > 0 and seg > 0) else 0.0
        end_f = frac_cap if last_seg else (1.0 - (r / L if r > 0 else 0.0))
        n_walk = max(2, int(round((end_f - start_f) * L / step)))
        for k in range(n_walk):
            f = start_f + (end_f - start_f) * (k + 1) / n_walk
            events.append(("pose", (p0 + (p1 - p0) * f, th)))
        if not last_seg:
            th_next = th - np.pi / 2.0
            if r > 0:
                # quarter arc tangent to both legs: entry e = p1 - r*d,
                # exit p1 + r*d2, centre o = e + r*d2
                d2 = np.array([np.sin(th_next), np.cos(th_next)])
                e = p1 - r * d
                o = e + r * d2
                for k in range(turn_frames):
                    phi = (np.pi / 2.0) * (k + 1) / turn_frames
                    pos = o - r * d2 * np.cos(phi) + r * d * np.sin(phi)
                    events.append(("pose", (pos, th - phi)))
            else:
                for k in range(turn_frames):
                    g = (k + 1) / turn_frames
                    events.append(("pose", (p1, th + (th_next - th) * g)))

    poses = []
    for i, (_, (pxz, th)) in enumerate(events):
        T = np.eye(4)
        T[:3, :3] = rot_y(th)
        T[:3, 3] = [pxz[0], sway * np.sin(0.7 * i), pxz[1]]
        poses.append(T)
    return poses


def desk_scene() -> Scene:
    """A cluttered office-desk corner — the fr1/desk proxy. TUM fr1/desk
    sweeps a handheld Kinect around two desks with monitors, mugs and
    books at 0.8-2.5 m range; this scene reproduces that working volume:
    a desk slab with a monitor-like box, stacked books, mug-sized
    spheres, a second lower desk, and the room corner behind them, so
    every viewpoint of the sweep sees planes at several orientations
    plus curved objects (all 6 ICP DOF constrained, like the real
    sequence's geometry)."""
    desk_h = 0.55  # y is image-down: +y floor at +1.2, desk top y = 1.2-desk_h
    top = 1.2 - desk_h
    return Scene(
        box_min=np.array([-2.2, -1.6, -1.4]),
        box_max=np.array([2.2, 1.2, 2.6]),
        cuboids=[
            # main desk slab
            Cuboid(np.array([-1.1, top, 1.1]), np.array([0.9, top + 0.06, 2.0])),
            # monitor on the desk (upright box)
            Cuboid(np.array([-0.55, top - 0.42, 1.75]), np.array([0.05, top, 1.85])),
            # book stack
            Cuboid(np.array([0.3, top - 0.12, 1.5]), np.array([0.65, top, 1.8])),
            # second, lower side desk
            Cuboid(np.array([1.0, top + 0.12, 0.4]), np.array([1.9, top + 0.18, 1.6])),
            # box under the side desk
            Cuboid(np.array([1.25, top + 0.5, 0.7]), np.array([1.75, 1.2, 1.2])),
        ],
        spheres=[
            Sphere(np.array([0.05, top - 0.07, 1.45]), 0.07),  # mug
            Sphere(np.array([-0.8, top - 0.1, 1.55]), 0.10),   # globe
            Sphere(np.array([1.45, top - 0.0, 1.0]), 0.12),    # ball on side desk
        ],
    )


def handheld_trajectory(
    n_frames: int = 240,
    sweep_deg: float = 55.0,
    radius: float = 1.4,
    tremor_mm: float = 2.0,
    seed: int = 3,
) -> List[np.ndarray]:
    """fr1/desk-like handheld motion: an arcing sweep around the desk
    (peak ~0.4 m/s translation, ~25 deg/s yaw — fr1/desk's published
    means are 0.41 m/s and 23.3 deg/s) with a slow up-down bob and
    high-frequency hand tremor on all axes. Starts and ends near the
    same viewpoint, like the real sequence's partial return."""
    rng = np.random.default_rng(seed)
    tremor = rng.normal(0.0, tremor_mm / 1000.0, (n_frames, 3))
    # smooth the tremor slightly (hands are not white noise)
    k = np.array([0.25, 0.5, 0.25])
    for a in range(3):
        tremor[:, a] = np.convolve(tremor[:, a], k, mode="same")
    poses = []
    for i in range(n_frames):
        ph = np.sin(np.pi * i / max(n_frames - 1, 1))  # out-and-back sweep
        yaw = np.deg2rad(sweep_deg) * (ph - 0.5) * 2.0 * 0.5
        pitch = np.deg2rad(8.0) * np.sin(4 * np.pi * i / n_frames)
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        T = np.eye(4)
        T[:3, :3] = Ry @ Rx
        # orbit the desk centre (0.0, ~0.4, 1.6) at `radius`, camera
        # looking +z toward it; translate opposite the yaw so the desk
        # stays framed
        T[:3, 3] = (
            np.array(
                [
                    -sy * radius * 0.55,
                    0.12 * np.sin(2 * np.pi * i / n_frames),
                    radius * 0.12 * (1 - cy),
                ]
            )
            + tremor[i]
        )
        poses.append(T)
    return poses


def living_room_scene() -> Scene:
    """An ICL-NUIM living-room-class scene — the lr kt2 proxy. The real
    lr kt2 is a POV-Ray-rendered ~5 x 4 m living room (sofa, armchair,
    coffee table, shelving, lamps) swept smoothly by a camera that pans
    most of the room; its challenge profile vs fr1/desk is LARGER extent
    (volume shifting engages), LOWER clutter density (long stretches of
    bare wall/floor where geometric-only ICP is weakly conditioned — the
    reason BASELINE config 2 pairs it with fused ICP+RGB-D), and slower,
    smoother motion. This scene reproduces that profile at the same
    scale: a 5.2 x 4.2 m room whose furniture hugs the walls, leaving
    the middle open so most viewpoints see a dominant wall/floor plane
    plus sparse furniture."""
    floor = 1.25  # y is image-down: +y floor
    return Scene(
        box_min=np.array([-2.6, -1.3, -2.1]),
        box_max=np.array([2.6, floor, 2.1]),
        cuboids=[
            # sofa against +z wall: seat + backrest + armrests
            Cuboid(np.array([-1.1, floor - 0.45, 1.55]),
                   np.array([0.7, floor, 2.1])),
            Cuboid(np.array([-1.1, floor - 0.85, 1.85]),
                   np.array([0.7, floor - 0.45, 2.1])),
            Cuboid(np.array([-1.35, floor - 0.62, 1.55]),
                   np.array([-1.1, floor, 2.1])),
            Cuboid(np.array([0.7, floor - 0.62, 1.55]),
                   np.array([0.95, floor, 2.1])),
            # armchair against +x wall
            Cuboid(np.array([1.9, floor - 0.45, -0.5]),
                   np.array([2.6, floor, 0.3])),
            Cuboid(np.array([2.35, floor - 0.85, -0.5]),
                   np.array([2.6, floor - 0.45, 0.3])),
            # coffee table mid-room (thin top slab)
            Cuboid(np.array([-0.5, floor - 0.4, 0.2]),
                   np.array([0.45, floor - 0.34, 0.95])),
            # shelving unit against -x wall
            Cuboid(np.array([-2.6, floor - 1.7, -0.9]),
                   np.array([-2.3, floor, 0.4])),
            # low TV cabinet against -z wall
            Cuboid(np.array([-0.8, floor - 0.5, -2.1]),
                   np.array([0.9, floor, -1.75])),
            # TV panel on the cabinet
            Cuboid(np.array([-0.55, floor - 1.15, -2.1]),
                   np.array([0.65, floor - 0.5, -2.02])),
        ],
        spheres=[
            Sphere(np.array([1.05, floor - 1.45, 1.75]), 0.16),  # floor lamp
            Sphere(np.array([-0.05, floor - 0.47, 0.55]), 0.10),  # table bowl
            Sphere(np.array([-2.15, floor - 1.25, -0.25]), 0.12),  # shelf globe
        ],
    )


def living_room_trajectory(
    n_frames: int = 440,
    rx: float = 1.05,
    rz: float = 0.75,
    seed: int = 5,
) -> List[np.ndarray]:
    """lr kt2-like sweep: the camera rides an ellipse around the room
    centre looking OUTWARD at the walls/furniture, panning a full 360
    over the loop and returning to its start pose — smooth, slow motion
    (~0.26 m/s, ~0.8 deg/frame at 30 Hz, matching kt2's gentle profile)
    with a gentle bob and slight pitch breathing. The ~6.6 m swept path
    at living-room extent is what engages volume shifting."""
    rng = np.random.default_rng(seed)
    drift = rng.normal(0.0, 0.0015, (n_frames, 3))
    k = np.array([0.25, 0.5, 0.25])
    for a in range(3):
        drift[:, a] = np.convolve(drift[:, a], k, mode="same")
    poses = []
    for i in range(n_frames):
        ph = 2.0 * np.pi * i / n_frames
        # position on the ellipse; view direction radially outward
        pos = np.array([rx * np.sin(ph),
                        0.06 * np.sin(2.0 * ph),
                        rz * np.cos(ph)])
        yaw = ph  # outward: view (sin yaw, 0, cos yaw) at yaw = ph
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


def generate_klg_sensor(
    path: str,
    cam: CameraIntrinsics,
    poses: List[np.ndarray],
    scene: Scene,
    model: SensorModel,
    fps: float = 30.0,
    gt_path: Optional[str] = None,
    seed: int = 11,
    color: bool = True,
) -> None:
    """generate_klg through the full SensorModel (rolling shutter uses
    each frame's successor pose). The frames carry JPEG colour when
    `color` is asked for and an encoder exists, as in generate_klg."""
    if color:
        try:
            jpeg_codec()
        except RuntimeError:
            color = False
    rng = np.random.default_rng(seed)
    with KlgLogWriter(path) as w:
        for i, T in enumerate(poses):
            T_next = poses[i + 1] if i + 1 < len(poses) else None
            depth, rgb = render_frame_sensor(scene, cam, T, model, rng, T_next)
            w.write(int(i * 1e6 / fps), depth, rgb if color else None)
    if gt_path:
        save_trajectory(gt_path, [i / fps for i in range(len(poses))], poses)


class _Draws:
    """One frame's depth-noise draws, made beforehand: stands in for the
    generator render_frame draws them from."""

    def __init__(self, draws: np.ndarray):
        self.draws = draws

    def normal(self, loc, scale, size) -> np.ndarray:
        assert tuple(size) == self.draws.shape
        return self.draws


def _render_task(task) -> Tuple[np.ndarray, np.ndarray]:
    scene, cam, T, depth_noise_mm, draws = task
    return render_frame(scene, cam, T, depth_noise_mm,
                        None if draws is None else _Draws(draws))


def render_frames(
    cam: CameraIntrinsics,
    poses: List[np.ndarray],
    scene: Optional[Scene] = None,
    depth_noise_mm: float = 0.0,
    map_fn: Callable = map,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(depth_mm, rgb) of each pose in order, as generate_klg writes
    them. The depth noise is drawn here, frame after frame, from the JAX
    package's seed, so `map_fn` may render the frames in any order or in
    parallel (a process pool's `imap`) and the frames stay the same."""
    scene = scene or Scene.default()
    rng = np.random.default_rng(7)
    shape = (cam.height, cam.width)
    tasks = ((scene, cam, T, depth_noise_mm,
              rng.normal(0.0, depth_noise_mm / 1000.0, shape) if depth_noise_mm > 0 else None)
             for T in poses)
    return map_fn(_render_task, tasks)


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
    """Render `poses` (render_frames) into a `.klg` log at `fps` (and
    their TUM ground truth into gt_path). Depth is always written; JPEG
    colour only when `color` is asked for and an encoder (cv2 or PIL)
    exists, else the frames carry no image. Both packages write the same
    depth."""
    if color:
        try:
            jpeg_codec()
        except RuntimeError:
            color = False
    with KlgLogWriter(path) as w:
        for i, (depth, rgb) in enumerate(render_frames(cam, poses, scene, depth_noise_mm)):
            w.write(int(i * 1e6 / fps), depth, rgb if color else None)
    if gt_path:
        save_trajectory(gt_path, [i / fps for i in range(len(poses))], poses)
