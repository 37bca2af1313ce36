"""BENCHMARK.json and the files it names, found by name."""

import json
import re
import shutil

from slambench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_benchmark_parses_to_the_contract():
    b = spec.load_benchmark()
    assert set(b) == TOP
    assert b["paths"] == ["slambench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert {m["name"] for m in b["end_to_end"]} == {"fps", "tracked_pct", "setup_s"}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    ends = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in ends
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    assert {w["name"] for w in b["workloads"]} == {
        "icp.desk.offline", "icp_rgbd.lr_kt2.offline", "icp.desk.live30"}
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_resolves_by_name():
    b = spec.load_benchmark()
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"], b)
        assert cell.config["name"] == w["config"]
        assert cell.limits is not None, f"limits/{w['name']}.json"
        assert (spec.HERE / "scenes" / f"{cell.traffic['scene']}.json").is_file()
        ends = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in ends and len(ends) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in ends
            assert callable(spec.metric_reader(m["name"]))
    for c in b["configs"]:
        assert c["file"].startswith("slambench/configs/")
        assert (spec.ROOT / c["file"]).is_file()


def test_a_cell_added_from_new_files_only_is_listed(tmp_path):
    """A later PR adds a configuration, a traffic mix, a per-layer metric
    and a cell as files and entries; nothing that is there changes."""
    base = tmp_path / "slambench"
    for d in ("configs", "traffic", "metrics", "limits", "scenes"):
        (base / d).mkdir(parents=True)
        for f in (spec.HERE / d).glob("*"):
            if f.is_file():
                (base / d / f.name).symlink_to(f)
    conf = json.loads((spec.HERE / "configs" / "icp.json").read_text())
    conf["name"] = "icp_dummy"
    (base / "configs" / "icp_dummy.json").write_text(json.dumps(conf))
    tr = json.loads((spec.HERE / "traffic" / "desk.offline.json").read_text())
    (base / "traffic" / "dummy.offline.json").write_text(json.dumps(tr))
    (base / "metrics" / "dummy.count.py").write_text(
        "def read(ctx):\n    return float(len(ctx.step_modes))\n")
    shutil.copy(spec.HERE / "limits" / "icp.desk.offline.json",
                base / "limits" / "icp_dummy.dummy.offline.json")
    b = spec.load_benchmark()
    b["configs"].append({"name": "icp_dummy", "source": "https://github.com/mp3guy/Kintinuous",
                         "file": "slambench/configs/icp_dummy.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": "icp_dummy.dummy.offline", "config": "icp_dummy",
                           "traffic": "dummy.offline", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] == "fps":
            m["workloads"].append("icp_dummy.dummy.offline")  # an entry's list grows
    b["per_layer"].append({"name": "dummy.count", "unit": "frames", "better": "higher",
                           "source": "program_counter", "layer": "tracker", "moves": "fps",
                           "workloads": ["icp_dummy.dummy.offline"]})
    cell = spec.load_cell("icp_dummy.dummy.offline", b, base=base)
    assert [m["name"] for m in cell.per_layer] == ["dummy.count"]
    assert "fps" in {m["name"] for m in cell.end_to_end}
    ctx = type("Ctx", (), {"step_modes": ["replayed"] * 3})()
    assert spec.metric_reader("dummy.count", base=base)(ctx) == 3.0
    # the cells already there still resolve the same way
    assert spec.load_cell("icp.desk.offline", b, base=base).traffic["scene"] == "desk"
