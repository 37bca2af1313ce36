"""The structured-light (Kinect v1 class) renderer of
kintinuous_tpu_torch/io/synth.py (`render_frame_sensor`, `SensorModel`),
frozen and rewritten in PyTorch, float64, batched over frames, so that a
run renders its frames on the card in a few large calls. Its noise is
drawn from a torch.Generator on the rendering device, seeded by the run.
With the noise turned off it computes what the numpy original computes,
which a test checks at a small size."""

from __future__ import annotations

import json
from dataclasses import dataclass, fields
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from slambench.scenes.trajectories import se3_exp_rot, se3_log

SCENES = Path(__file__).resolve().parent
CHUNK = 16  # frames rendered in one call (and one set of noise draws)


@dataclass(frozen=True)
class SensorModel:
    """Kinect v1 noise: axial sigma a + b (z - 0.4)^2 (Nguyen et al.,
    3DIMPVT 2012), inverse-depth quantisation q z^2 mm (Khoshelham and
    Elberink, Sensors 2012), lateral jitter of the sampling grid, dropout
    beside depth jumps, a 0.4-5 m range gate and rolling-shutter rows."""

    axial_a: float = 0.0012
    axial_b: float = 0.0019
    lateral_px: float = 0.8
    quant_mm_per_m2: float = 2.73
    edge_jump_mm: float = 120.0
    min_z: float = 0.4
    max_z: float = 5.0
    readout_s: float = 0.025
    frame_dt_s: float = 1.0 / 30.0

    @classmethod
    def from_dict(cls, d: dict) -> "SensorModel":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown sensor model keys {sorted(unknown)}")
        return cls(**d)


@dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


@dataclass
class Scene:
    box_min: torch.Tensor  # (3,)
    box_max: torch.Tensor
    spheres: List[Tuple[torch.Tensor, float]]
    cuboids: List[Tuple[torch.Tensor, torch.Tensor]]


def load_scene(name: str, device) -> Scene:
    """scenes/<name>.json on `device`, float64."""
    d = json.loads((SCENES / f"{name}.json").read_text())

    def t(x):
        return torch.tensor(x, dtype=torch.float64, device=device)

    return Scene(t(d["box_min"]), t(d["box_max"]),
                 [(t(c), float(r)) for c, r in d["spheres"]],
                 [(t(lo), t(hi)) for lo, hi in d["cuboids"]])


def _ray_box_interior(o, d, bmin, bmax):
    """First positive hit with the room's inside walls (inf if none)."""
    t_best = torch.full(d.shape[:-1], torch.inf, dtype=d.dtype, device=d.device)
    for axis in range(3):
        for bound in (bmin[axis], bmax[axis]):
            t = (bound - o[..., axis]) / d[..., axis]
            pt = o + torch.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0)[..., None] * d
            ok = (t > 1e-6) & torch.isfinite(t)
            for other in range(3):
                if other != axis:
                    ok &= (pt[..., other] >= bmin[other] - 1e-6) & (
                        pt[..., other] <= bmax[other] + 1e-6)
            t_best = torch.where(ok & (t < t_best), t, t_best)
    return t_best


def _ray_sphere(o, d, center, radius):
    oc = o - center
    b = torch.sum(oc * d, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radius * radius
    disc = b * b - c
    t = torch.where(disc >= 0, -b - torch.sqrt(torch.clamp(disc, min=0.0)), torch.inf)
    return torch.where(t > 1e-6, t, torch.inf)


def _ray_cuboid(o, inv, bmin, bmax):
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tnear = torch.fmax(torch.fmax(lo[..., 0], lo[..., 1]), lo[..., 2])
    tfar = torch.fmin(torch.fmin(hi[..., 0], hi[..., 1]), hi[..., 2])
    return torch.where((tnear <= tfar) & (tnear > 1e-6), tnear, torch.inf)


def row_poses(poses: Sequence[np.ndarray], i: int, height: int,
              model: SensorModel) -> np.ndarray:
    """(height, 4, 4) camera-to-world pose of each image row of frame i:
    the frame's pose advanced along the motion to frame i+1 by the row's
    readout time, in 16 bands (the last frame of a trajectory, which has
    no successor, is a global-shutter frame)."""
    T = poses[i]
    out = np.broadcast_to(T, (height, 4, 4)).copy()
    if i + 1 >= len(poses) or model.readout_s <= 0:
        return out
    xi = se3_log(np.linalg.inv(T) @ poses[i + 1])
    fracs = (np.arange(height) / max(height - 1, 1)) * (model.readout_s / model.frame_dt_s)
    step = max(height // 16, 1)
    for b0 in range(0, height, step):
        b1 = min(b0 + step, height)
        f = float(fracs[(b0 + b1) // 2])
        d = np.eye(4)
        d[:3, :3] = se3_exp_rot(xi[:3] * f)
        d[:3, 3] = xi[3:] * f
        out[b0:b1] = T @ d
    return out


def render_chunk(scene: Scene, cam: Camera, rows: torch.Tensor, model: SensorModel,
                 noise: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]):
    """Frames with per-row poses `rows` (b, H, 4, 4) float64 on the scene's
    device -> depth (b, H, W) int32 millimetres and rgb (b, H, W, 3) uint8.
    noise: (lateral u, lateral v, axial) standard normal draws, each
    (b, H, W), or None for none."""
    dev = rows.device
    b, H, W = rows.shape[0], cam.height, cam.width
    v0, u0 = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=dev),
                            torch.arange(W, dtype=torch.float64, device=dev), indexing="ij")
    u = u0.expand(b, H, W)
    v = v0.expand(b, H, W)
    if noise is not None:
        u = u + noise[0] * model.lateral_px
        v = v + noise[1] * model.lateral_px
    rays = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                        torch.ones_like(u)], dim=-1)  # (b,H,W,3)
    Rr = rows[:, :, :3, :3]  # (b,H,3,3)
    dirs = torch.einsum("bhwj,bhij->bhwi", rays, Rr)
    origins = rows[:, :, None, :3, 3].expand_as(dirs)
    norm = torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    dn = dirs / norm
    t_hit = _ray_box_interior(origins, dn, scene.box_min, scene.box_max)
    hit_id = torch.zeros(t_hit.shape, dtype=torch.int64, device=dev)
    for i, (c, r) in enumerate(scene.spheres):
        ts = _ray_sphere(origins, dn, c, r)
        closer = ts < t_hit
        t_hit = torch.where(closer, ts, t_hit)
        hit_id = torch.where(closer, i + 1, hit_id)
    inv = 1.0 / dn
    for i, (lo, hi) in enumerate(scene.cuboids):
        ts = _ray_cuboid(origins, inv, lo, hi)
        closer = ts < t_hit
        t_hit = torch.where(closer, ts, t_hit)
        hit_id = torch.where(closer, len(scene.spheres) + i + 1, hit_id)
    pts = origins + t_hit[..., None] * dn
    z = t_hit / norm[..., 0]
    z = torch.where(torch.isfinite(z), z, 0.0)

    sigma = model.axial_a + model.axial_b * torch.square(torch.clamp(z - 0.4, min=0.0))
    z_noisy = z if noise is None else z + noise[2] * sigma * (z > 0)
    s = model.quant_mm_per_m2 / 1000.0
    if s > 0:
        invz = 1.0 / torch.clamp(z_noisy, min=1e-6)
        z_noisy = torch.where(z_noisy > 0,
                              1.0 / torch.clamp(torch.round(invz / s) * s, min=1e-9), z_noisy)
    valid = (z > model.min_z) & (z < model.max_z)
    jump = model.edge_jump_mm / 1000.0
    dz_x = torch.abs(torch.diff(z, dim=2, prepend=z[:, :, :1]))
    dz_y = torch.abs(torch.diff(z, dim=1, prepend=z[:, :1, :]))
    edge = (dz_x > jump) | (dz_y > jump)
    edge = edge | torch.roll(edge, -1, dims=2) | torch.roll(edge, -1, dims=1)
    valid &= ~edge
    depth = torch.where(valid, torch.clamp(z_noisy * 1000.0, 0, 65535), 0.0).to(torch.int32)

    checker = torch.remainder(torch.floor(pts[..., 0] * 4) + torch.floor(pts[..., 1] * 4)
                              + torch.floor(pts[..., 2] * 4), 2).to(torch.float32)
    base = 0.35 + 0.5 * checker
    tint = torch.tensor([[0.9, 0.9, 0.9], [0.9, 0.4, 0.3], [0.3, 0.8, 0.4],
                         [0.35, 0.45, 0.9]], dtype=torch.float64, device=dev)
    col = base[..., None].to(torch.float64) * tint[torch.clamp(hit_id, 0, 3)] * 255.0
    rgb = torch.clamp(col, 0, 255).to(torch.uint8)
    rgb = torch.where((z <= 0)[..., None], 0, rgb)
    return depth, rgb


def render_frames(scene: Scene, cam: Camera, poses: Sequence[np.ndarray],
                  model: SensorModel, seed: Optional[int], device) -> Tuple[np.ndarray, np.ndarray]:
    """Every pose of `poses` through the sensor model on `device`, noise
    drawn from a generator seeded with `seed` (None: no noise), CHUNK
    frames a call. Returns (depth (N,H,W) uint16 mm, rgb (N,H,W,3) uint8)
    on the host."""
    dev = torch.device(device)
    gen = None
    if seed is not None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    H, W = cam.height, cam.width
    all_rows = np.stack([row_poses(poses, i, H, model) for i in range(len(poses))])
    depths, rgbs = [], []
    for s in range(0, len(poses), CHUNK):
        rows = torch.from_numpy(all_rows[s:s + CHUNK]).to(dev)
        noise = None
        if gen is not None:
            noise = tuple(torch.randn((rows.shape[0], H, W), generator=gen, device=dev,
                                      dtype=torch.float64) for _ in range(3))
        d, c = render_chunk(scene, cam, rows, model, noise)
        depths.append(d.cpu().numpy().astype(np.uint16))
        rgbs.append(c.cpu().numpy())
    return np.concatenate(depths), np.concatenate(rgbs)
