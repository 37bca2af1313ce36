"""A tiny copy of a cell for the CPU tests: the desk traffic at 160x120
on a 64^3 volume over 3 m (shift threshold 8 voxels), its files written
into a directory of their own beside links to the benchmark's metric
readers; its limits are the named cell's."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from slambench import spec

CAMERA = {"fx": 132.0, "fy": 132.0, "cx": 80.0, "cy": 60.0, "width": 160, "height": 120}


def make(root: Path, loop: str = "offline", config: str = "icp",
         limits_of: str = "icp.desk.offline", traffic: str = "") -> tuple:
    """(bench dict, base dir) of one cell named tiny.<loop>, on the desk
    traffic of that loop or on `traffic`."""
    base = root / "slambench"
    for d in ("configs", "traffic", "limits", "metrics"):
        (base / d).mkdir(parents=True, exist_ok=True)
    for f in (spec.HERE / "metrics").glob("*.py"):
        dst = base / "metrics" / f.name
        if not dst.exists():
            dst.symlink_to(f)
    conf = json.loads((spec.HERE / "configs" / f"{config}.json").read_text())
    conf["name"] = "tiny"
    conf["argv"] = conf["argv"][:-2] + ["-t", "8", "-s", "3", "--resolution", "64"]
    conf["overrides"] = dict(conf.get("overrides", {}), camera=CAMERA)
    conf["settings"].update(voxel_shift=8, volume_size=3.0, volume_resolution=64,
                            camera=CAMERA)
    (base / "configs" / "tiny.json").write_text(json.dumps(conf))
    src = traffic or ("desk.live30" if loop == "live" else "desk.offline")
    tr = json.loads((spec.HERE / "traffic" / f"{src}.json").read_text())
    tr.update(stream_frames=400 if loop == "offline" else 3000, trace_frames=3)
    shift = tr["samples"].get("shift")
    tr["samples"] = {"full_offset": [2, 4], "pose_share": 0.5}
    if shift:
        tr["samples"]["shift"] = {"offset": [1, 2], "margin_m": 0.015}
    (base / "traffic" / f"tiny.{loop}.json").write_text(json.dumps(tr))
    shutil.copy(spec.HERE / "limits" / f"{limits_of}.json", base / "limits" / f"tiny.{loop}.json")
    bench = spec.load_benchmark()
    bench["configs"] = [{"name": "tiny", "source": "https://github.com/mp3guy/Kintinuous",
                         "file": "slambench/configs/tiny.json", "reduced": [], "why": "tests"}]
    bench["workloads"] = [{"name": f"tiny.{loop}", "config": "tiny", "traffic": f"tiny.{loop}",
                           "chips": 1, "why": "tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    return bench, base
