"""The PyTorch port's package boundary: no JAX inside it, the same
configuration as the JAX package, and entry points that need a card
unless the CPU is asked for. Also holds the helpers the other
tests/test_torch_*.py files share."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import kintinuous_tpu.config as jcfg
import kintinuous_tpu_torch.config as pcfg

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def port_cam(cam):
    return pcfg.CameraIntrinsics(**dataclasses.asdict(cam))


def port_cfg(cfg):
    """The port's KintinuousConfig with the same field values as a JAX
    KintinuousConfig."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["camera"] = port_cam(cfg.camera)
    return pcfg.KintinuousConfig(**kw)


def tt(x, dtype=None):
    """numpy (or a JAX array) -> a CPU tensor, copied."""
    a = np.array(x)
    return torch.from_numpy(a if dtype is None else a.astype(dtype))


def port_vol(v):
    """A JAX BlockedVolume -> the port's (cw as int32 bits)."""
    from kintinuous_tpu_torch.ops.blocked import BlockedVolume

    return BlockedVolume(
        tsdf=tt(v.tsdf, np.float32),
        cw=torch.from_numpy(np.array(v.cw, np.uint32).view(np.int32)),
        wrap=tt(v.wrap, np.int32), origin=tt(v.origin, np.float32),
    )


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


RUNTIME_MODULES = [
    "cli.py", "runtime/engine.py", "runtime/pipeline.py", "runtime/checkpoint.py",
    "runtime/stopwatch.py", "backend/native_ops.py", "backend/slice_proc.py",
    "io/klg.py", "io/tum.py", "io/pcd.py", "io/synth.py", "tracking/odometry.py",
    "ops/rgbd.py", "ops/surface_nets.py", "backend/meshing.py", "io/ply.py",
    "tools/proto_integrate.py", "backend/features.py", "backend/place_recognition.py",
    "backend/pose_graph.py", "backend/deformation.py", "backend/deform_runner.py",
    "eval/loop_gate.py", "ops/raycast_fast.py", "ops/image.py", "io/live.py",
    "viz/png.py", "viz/headless.py", "viz/server.py", "parallel/mesh.py",
    "parallel/sharded.py", "parallel/fast_sharded.py", "parallel/tracker.py",
    "parallel/multihost.py", "io/klg_native.py",
]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "kintinuous_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    scanned = {str(f.relative_to(ROOT / "kintinuous_tpu_torch")) for f in files[:-1]}
    assert set(RUNTIME_MODULES) <= scanned
    bad = [
        (str(f.relative_to(ROOT)), m)
        for f in files for m in _imports(f)
        if m.split(".")[0] in ("jax", "jaxlib", "kintinuous_tpu")
    ]
    assert bad == []


@pytest.mark.parametrize("name", ["KintinuousConfig", "CameraIntrinsics"])
def test_config_fields_and_defaults_match(name):
    def spec(cls):
        out = []
        for f in dataclasses.fields(cls):
            if f.default is not dataclasses.MISSING:
                d = f.default
            elif f.default_factory is not dataclasses.MISSING:
                d = f.default_factory()
            else:
                d = None
            out.append((f.name, dataclasses.asdict(d) if dataclasses.is_dataclass(d) else d))
        return out

    assert spec(getattr(pcfg, name)) == spec(getattr(jcfg, name))


@pytest.mark.parametrize("kw", [
    {},
    {"voxel_shift": 40},
    {"voxel_shift": 3, "fast_mode": True},
    {"voxel_shift": 11, "fast_mode": True, "volume_resolution": 128},
    {"volume_size": 3.0, "trunc_dist": 0.001},
])
def test_config_post_init_clamps_match(kw):
    a, b = jcfg.tiny_test_config(**kw), pcfg.tiny_test_config(**kw)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "camera":
            va, vb = dataclasses.asdict(va), dataclasses.asdict(vb)
        assert va == vb, f.name
    assert a.voxel_size == b.voxel_size


def test_tracker_without_a_card_raises_unless_cpu_is_asked(monkeypatch):
    from kintinuous_tpu_torch.tracking.tracker import Tracker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pcfg.tiny_test_config(fast_mode=True, volume_resolution=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Tracker(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Tracker(cfg, device="cuda")
    assert Tracker(cfg, device="cpu").device.type == "cpu"


def test_unported_options_raise(tmp_path, monkeypatch):
    """Several devices are ported: devices=2 with device="cpu" builds the
    engine on a ShardedTracker of 2 CPU slabs and --devices and
    --num-processes reach the configuration; asking for more cards than
    the machine has raises the JAX package's error. Live capture (-live)
    and the web viewer (--viz-port) build a configuration and an
    engine."""
    from kintinuous_tpu_torch import cli
    from kintinuous_tpu_torch.parallel.tracker import ShardedTracker, build_mesh
    from kintinuous_tpu_torch.runtime.engine import SlamEngine
    from kintinuous_tpu_torch.tracking.tracker import Tracker

    cam = pcfg.CameraIntrinsics(fx=70.0, fy=70.0, cx=32.0, cy=24.0, width=64, height=48)
    eng = SlamEngine(pcfg.tiny_test_config(camera=cam, fast_mode=True, devices=2),
                     device="cpu")
    assert isinstance(eng.tracker, ShardedTracker) and eng.tracker.n == 2
    assert eng.tracker.mesh.devices == [torch.device("cpu")] * 2
    cfg = cli.build_config(["-l", "seq.klg", "--fast", "--devices", "2",
                            "--num-processes", "2", "--process-id", "1",
                            "--coordinator", "127.0.0.1:1234"])
    assert (cfg.devices, cfg.num_processes, cfg.process_id, cfg.coordinator) == (
        2, 2, 1, "127.0.0.1:1234")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="requested 2 devices, only 1 available"):
        build_mesh(2, "cuda:0")
    monkeypatch.undo()
    live = pcfg.tiny_test_config(fast_mode=True, live_source="localhost:1",
                                 save_file=str(tmp_path / "out"))
    assert SlamEngine(live, device="cpu").cfg.live_source == "localhost:1"
    cfg = cli.build_config(["-live", "sensor.sock", "--fast", "--viz-port", "8000"])
    assert cfg.live_source == "sensor.sock" and cfg.fast_mode
    # ported now: fused ICP+RGB-D and meshing build a tracker
    cfg = pcfg.tiny_test_config(fast_mode=True, icp_plus_rgbd=True, mesh=True,
                                volume_resolution=32)
    assert Tracker(cfg, device="cpu").state.rgbd is not None


def test_kernel_wrappers_take_the_plain_version_on_cpu():
    """CPU tensors go to the plain versions: nothing is launched, so the
    launch counters stay where they were."""
    from kintinuous_tpu_torch.ops.blocked import make_blocked_volume
    from kintinuous_tpu_torch.ops.cuda_integrate import band_fusion, free_carve
    from kintinuous_tpu_torch.ops.cuda_raycast import (
        build_mirror, mirror_refresh, tile_raycast)
    from kintinuous_tpu_torch.tools import proto_integrate as P
    from kintinuous_tpu_torch.tracking.tracker import Tracker

    wrappers = (band_fusion, free_carve, mirror_refresh, build_mirror, tile_raycast,
                P.run_rows, P.run_dma, P.run_full, P.run_dyn)
    before = [w.launches for w in wrappers]
    cam = pcfg.CameraIntrinsics(fx=40.0, fy=40.0, cx=32.0, cy=24.0, width=64, height=48)
    cfg = pcfg.tiny_test_config(camera=cam, fast_mode=True, volume_resolution=32,
                                bilateral_radius=1, band_cap=256)
    tr = Tracker(cfg, device="cpu")
    depth = np.full((48, 64), 1200, np.uint16)
    tr.process_frame(depth, None, 0)
    tr.process_frame(depth, None, 33333)
    tr.process_frames([(depth, None, 66666), (depth, None, 99999)])
    tr.flush()
    assert build_mirror(tr.state.vol.tsdf, 32).device.type == "cpu"
    x = P.make_inputs("cpu", n_rows=40, k=8)
    P.run_rows(x.tsdf, x.ids)
    P.run_dyn(torch.tensor(3, dtype=torch.int32), x.tsdf, x.ids)
    P.run_dma(x.tsdf, x.ids, (x.cy, x.cx), x.img, x.img2)
    P.run_full(x.tsdf, x.ids, (x.cy, x.cx), x.img, x.img2)
    assert [w.launches for w in wrappers] == before
    assert tr.state.vol.tsdf.device.type == "cpu"
    assert make_blocked_volume(32).tsdf.shape == (64, 4, 128)


def test_state_numpy_round_trip():
    from kintinuous_tpu_torch.tracking.tracker import (
        initial_state, state_from_numpy, state_to_numpy)

    cfg = pcfg.tiny_test_config(fast_mode=True, volume_resolution=32)
    st = initial_state(cfg, torch.device("cpu"))
    rng = np.random.default_rng(0)
    st.vol.tsdf.copy_(tt(rng.standard_normal(st.vol.tsdf.shape), np.float32))
    # max_weight 128 puts bit 31 into the weight byte: negative int32s
    st.vol.cw.copy_(tt(rng.integers(0, 2 ** 32, st.vol.cw.shape, dtype=np.uint64)
                       .astype(np.uint32).view(np.int32)))
    st.logical.copy_(tt(rng.standard_normal(st.logical.shape), np.float32))
    back = state_from_numpy(state_to_numpy(st), "cpu")
    assert torch.equal(back.vol.tsdf, st.vol.tsdf)
    assert torch.equal(back.vol.cw, st.vol.cw)
    assert torch.equal(back.logical.view(torch.int16), st.logical.view(torch.int16))
    assert state_to_numpy(st).vol.cw.dtype == np.uint32
    for f in ("pose", "pred_pose", "prev_delta", "dc", "pw", "frame"):
        assert torch.equal(getattr(back, f), getattr(st, f)), f
