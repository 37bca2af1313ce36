# Frozen copy of kintinuous_tpu_torch/config.py, the benchmark's plain
# reference: imports point into this package, and it is never updated
# to follow the program, which it judges.
"""Configuration for the whole engine (the port's own copy).

Same fields, defaults and clamps as kintinuous_tpu/config.py, so a
configuration means the same thing to both packages; the port keeps
its own copy because importing the JAX package's module runs its
package __init__, which imports JAX. Fields the port does not use yet
(the Pallas switch, batched dispatch, the backend) are kept for that
parity.

Flag-name parity with the reference CLI (reference:
src/utils/ConfigArgs.h:36-74 documents the flag set; defaults at
ConfigArgs.h:111-120). Instead of a mutable singleton, configuration is
an immutable dataclass passed explicitly; geometry derived from it
(voxel size, truncation distance) is computed once in __post_init__ the
way the reference derives them at startup (ConfigArgs.h:159-169,
src/frontend/Volume.h:29-53, src/frontend/TSDFVolume.cpp:90-97).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole intrinsics; scalable per pyramid level.

    Reference: src/frontend/cuda/internal.h:249-273 (Intr with
    operator()(level) halving per level); default 640x480 resolution
    from src/frontend/Resolution.h:24-36.
    """

    fx: float = 528.0
    fy: float = 528.0
    cx: float = 320.0
    cy: float = 240.0
    width: int = 640
    height: int = 480

    def at_level(self, level: int) -> "CameraIntrinsics":
        div = 1 << level
        return CameraIntrinsics(
            fx=self.fx / div,
            fy=self.fy / div,
            cx=self.cx / div,
            cy=self.cy / div,
            width=self.width // div,
            height=self.height // div,
        )


@dataclass(frozen=True)
class KintinuousConfig:
    """Engine configuration.

    Field ↔ reference flag map (src/utils/ConfigArgs.h:36-74):
      log_file          -l   input .klg log
      trajectory_file   -p   ground-truth trajectory to replay
      vocab_file        -v   BoW vocabulary
      volume_size       -s   TSDF volume edge length in metres (default 6)
      voxel_shift       -vs  shift threshold in voxels (default 14, clamp 1..16)
      weight_cull       -c   min fusion weight for extracted points (default 8)
      total_num_frames  -n   frame-count limit
      static_mode       -sm  disable volume shifting (plain KinectFusion)
      mesh              -m   enable meshing
      online_deformation -od enable loop closure + deformation
      rgbd_odometry     -r   photometric odometry
      icp_plus_rgbd     -ri  fused ICP+RGB-D odometry
      frame_to_frame_rgbd -ftf
      fast_odometry     -fo  reduced iteration schedule
      dynamic_cube      -dc  reposition cube based on viewing direction
      trunc_dist        -t   TSDF truncation distance
      loop_throttle           30 s between accepted loops
      dense_sampling_rate     0.8 m pose subsampling for the def. graph
      inlier_ratio            0.35 PnP inlier gate
      isam_thresh             10 pose-graph residual gate
    """

    # --- I/O ---
    log_file: Optional[str] = None
    # live capture: sensor daemon socket ("host:port" or unix path);
    # used when no log_file is given (reference LiveLogReader role)
    live_source: Optional[str] = None
    trajectory_file: Optional[str] = None
    vocab_file: Optional[str] = None
    save_file: str = "output"
    total_num_frames: int = -1

    # --- camera ---
    camera: CameraIntrinsics = field(default_factory=CameraIntrinsics)
    depth_scale: float = 1000.0  # raw uint16 units per metre
    flip_colors: bool = False  # input is BGR (-f, RawLogReader.cpp:122-130)
    # remove shift-overlap duplicates when saving (-nos disables;
    # CloudSliceProcessor::save deoverlap, :180-231)
    save_deoverlap: bool = True
    max_depth: float = 6.0  # metres (reference: RGBDOdometry.cpp:39)

    # --- volume ---
    volume_size: float = 6.0  # metres (ConfigArgs.h:117)
    volume_resolution: int = 512  # voxels per edge (internal.h:243-245)
    trunc_dist: float = 0.03  # metres; clamped up to 2.1*voxel below
    max_weight: int = 128  # fusion weight cap (tsdf_volume.cu:486)
    # view-angle-weighted colour fusion Wrkc = min(1,|n_z|/0.75)*2
    # (tsdf_volume.cu:622-625); the reference's -dc switch disables it
    color_angle_weight: bool = True

    # --- fast path (TPU production mode) ---
    # block-classified sparse integration + warm-started half-res raycast
    fast_mode: bool = False
    # max band blocks per frame in fast integrate; one camera view covers
    # at most ~5k surface blocks at 512^3 (each block spans >=8x8 px), so
    # 8192 keeps headroom while the cap sets the static gather width
    band_cap: int = 8192
    # Pallas integrate: cap on band blocks whose footprint exceeds the
    # patch window (handled by the exact XLA gather path instead)
    fallback_band_cap: int = 512
    # Pallas TPU kernels (None = auto: on when running on TPU). The
    # XLA fast path remains as the CPU/test implementation.
    pallas: Optional[bool] = None
    # offline fast-mode logs: an uploader thread decodes the log and
    # uploads batches of offline_batch_size frames ahead of the step
    # (runtime/engine.py); False runs the per-frame loop
    offline_batched: bool = True
    offline_batch_size: int = 8
    # the JAX package's device pools for a batch's slices and mesh
    # patches; kept so the two configs have the same fields. The port's
    # batch is the per-frame step in a loop and keeps every slice.
    batch_slice_pool: int = 3_000_000
    batch_mesh_vertex_pool: int = 1_600_000
    batch_mesh_face_pool: int = 3_200_000

    # --- shifting ---
    static_mode: bool = False
    voxel_shift: int = 14  # voxels (ConfigArgs.h:117, clamp :162-169)
    shift_overlap: int = 3  # extra band voxels extracted on shift
    dynamic_cube: bool = False
    extraction_capacity: int = 1_000_000  # points per fetch (ref caps 10M)
    # incremental-mesh band patches (surface-nets cells ~= extracted points)
    mesh_vertex_capacity: int = 400_000
    mesh_face_capacity: int = 800_000

    # --- odometry ---
    rgbd_odometry: bool = False
    icp_plus_rgbd: bool = False
    frame_to_frame_rgbd: bool = False
    fast_odometry: bool = False
    pyramid_levels: int = 4
    # per-level GN iterations, index 0 = finest (ICPOdometry.cpp:44-55)
    icp_iterations: Tuple[int, ...] = (10, 5, 4, 0)
    # -fod schedule: skip the finest level, (0,10,5,0) = reference parity
    # (ICPOdometry.cpp:49-55)
    icp_fast_iterations: Tuple[int, ...] = (0, 10, 5, 0)
    icp_dist_thresh: float = 0.10  # metres (reduce.cu:211-254)
    icp_angle_thresh_deg: float = 20.0
    # GN steps per projective association in fast mode (1 = associate
    # every iteration like the reference; the association gather is
    # ~6x the cost of the elementwise system build on TPU)
    icp_reassoc_every: int = 3
    rgbd_max_depth_delta: float = 0.07  # metres (RGBDOdometry.cpp:40)
    rgbd_jump_reject: float = 0.3  # metres (RGBDOdometry.cpp:383-387)
    rgbd_icp_weight: float = 10.0  # fused-solve ICP weight (RGBDOdometry.cpp:316-321)
    # Constant-velocity motion prior: warm-start the odometry GN from
    # the previous frame's delta and regularise each step toward it
    # with this per-block relative weight (ops/reduce.add_motion_prior;
    # 0 = off, matching the reference's identity start). ~0.01 biases
    # observable directions by ~1% while pinning near-null directions
    # (pivot-end rotation/lateral-slide ambiguity) to the prior.
    odom_prior_weight: float = 0.0

    # --- raycast ---
    raycast_step_factor: float = 0.8  # * trunc_dist (ray_caster.cu:444)
    raycast_min_range: float = 0.3  # metres
    raycast_max_range: Optional[float] = None  # default: volume diagonal
    raycast_coarse_block: int = 8  # coarse occupancy downsample factor
    # Pallas raycast: Newton refinement steps after the linear-interp
    # crossing (each costs 4 trilinear tap matmuls per tile)
    raycast_newton_iters: int = 1

    # --- preprocessing ---
    bilateral_sigma_depth: float = 30.0  # mm (bilateral_pyrdown.cu:56)
    bilateral_sigma_space: float = 4.5  # px (bilateral_pyrdown.cu:57)
    bilateral_radius: int = 6  # px (bilateral_pyrdown.cu:60)
    depth_discontinuity_mm: float = 200.0  # (tsdf_volume.cu:490-538)

    # --- backend ---
    mesh: bool = False
    online_deformation: bool = False
    weight_cull: int = 8  # (ConfigArgs.h:117)
    place_rec_motion_thresh: float = 0.15  # keyframe gate (KintinuousTracker.cpp:76)
    pr_recent_window: int = 8  # skip N most recent keyframes in loop queries
    pr_nss_alpha: float = 0.3  # normalised-similarity accept gate (DBowInterfaceSurf.cpp:36-40)
    loop_throttle_s: float = 30.0  # (PlaceRecognition.cpp:118-123)
    loop_min_matches: int = 40  # (PlaceRecognition.cpp:152)
    inlier_ratio: float = 0.35  # (PlaceRecognition.cpp:179)
    loop_icp_score: float = 0.01  # (PlaceRecognition.cpp:191-196)
    isam_thresh: float = 10.0  # (Deformation.cpp:256)
    dense_sampling_rate: float = 0.8  # metres (Deformation.cpp:142-155)
    deformation_k: int = 4  # neighbours per node (DeformationGraph.cpp:217-271)
    fast_loops: bool = False

    # --- runtime ---
    frame_rate_limit: Optional[float] = None  # Hz throttle (TrackerInterface.cpp:108-112)
    telemetry_port: int = 45454  # Stopwatch UDP sink (Stopwatch.h:97-110)
    # multi-chip: shard the volume into z-slabs over this many devices
    # (1 = single chip; the reference is strictly single-GPU, this is
    # the new ICI scaling layer — SURVEY.md §2.7)
    devices: int = 1
    # multi-host (DCN): jax.distributed process topology. When
    # num_processes > 1 the engine calls jax.distributed.initialize,
    # backend work partitions by HostPartition ownership and the
    # pose-graph GN shards factor products over the global mesh
    # (parallel/multihost.py — SURVEY.md §7 stage 6)
    num_processes: int = 1
    process_id: int = 0
    coordinator: Optional[str] = None  # "host:port" of process 0

    def __post_init__(self):
        # reference clamps voxelShift to [1,16] (ConfigArgs.h:162-169)
        object.__setattr__(self, "voxel_shift", max(1, min(16, self.voxel_shift)))
        # trunc >= 2.1 * voxel size (TSDFVolume.cpp:90-97)
        object.__setattr__(
            self, "trunc_dist", max(self.trunc_dist, 2.1 * self.voxel_size)
        )
        if self.fast_mode:
            # blocked layout needs wrap/shift in whole 8-voxel blocks
            vs = ((self.voxel_shift + 7) // 8) * 8
            object.__setattr__(self, "voxel_shift", min(16, max(8, vs)))

    @property
    def voxel_size(self) -> float:
        """Metres per voxel (Volume.h:29-53)."""
        return self.volume_size / self.volume_resolution

    @property
    def incremental_mesh(self) -> bool:
        """Band mesh patches are emitted on every shift whenever meshing
        is on. The reference gates its incremental mesh on deformation
        (ConfigArgs.h:159) and re-triangulates all accumulated slices at
        save instead (MeshGenerator.cpp:37-191); here the same device
        band-patch machinery serves both cases, so a shifting run's
        .ply covers departed regions with or without -od."""
        return self.mesh

    def replace(self, **kw) -> "KintinuousConfig":
        return dataclasses.replace(self, **kw)


def tiny_test_config(**overrides) -> KintinuousConfig:
    """A small configuration for unit tests: 64^3 volume, 80x60 images."""
    base = dict(
        camera=CameraIntrinsics(fx=70.0, fy=70.0, cx=40.0, cy=30.0, width=80, height=60),
        volume_size=3.0,
        volume_resolution=64,
        voxel_shift=4,
        bilateral_radius=2,
        extraction_capacity=120_000,
        pyramid_levels=3,
        icp_iterations=(6, 4, 4),
        icp_fast_iterations=(0, 6, 4),
    )
    base.update(overrides)
    return KintinuousConfig(**base)
