"""Run one cell of the benchmark once and print its result as the last
line of standard output:

    python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With --trace 0 the line carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics and the traced sub-window's `busy_s`,
`window_s` and `breakdown`. `correct` is the check of compare.py against
limits/<cell>.json; each number compared is printed beside its limit as
the last lines of standard error and under the line's last key,
`compared`. `--control 1` (not run by the benchmark itself) also puts
the control, the reference with TF32 matmuls, in the program's place and
prints its numbers under `control`.

The run needs a CUDA card (it exits with 2 and prints no result without
one), and ends with 3, printing no result, when JAX or the JAX package
has been loaded into this process by the time the window has closed."""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "kintinuous_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (kintinuous_tpu_torch is neither)."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in mods} & set(FORBIDDEN))


def _caches(root) -> None:
    """Kernel caches inside the checkout, at fixed paths."""
    base = root / "build" / "slambench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"


def _percentile(xs, q: float) -> float:
    """The q-quantile by the nearest rank."""
    s = sorted(xs)
    return s[max(0, min(len(s) - 1, math.ceil(q * len(s)) - 1))]


def end_to_end(sess, rec) -> dict:
    """The end-to-end metrics of the run, by name."""
    out = {"setup_s": (rec.setup_s, "s")}
    if sess.live:
        s = rec.sensor
        t0, period = s["t0_us"] / 1e6, s["period_us"] / 1e6
        lo = math.ceil((sess.t_start - t0) / period)
        hi = math.ceil((sess.t_end - t0) / period)  # frames lo..hi-1 were due in it
        due = {}
        for k, ts in enumerate(rec.stamps):
            n = int(round((ts / 1e6 - t0) / period))
            if lo <= n < hi:
                due[n] = rec.arrival[k] - ts / 1e6
        sess.attempted, sess.failed = hi - lo, (hi - lo) - len(due)
        out["tracked_pct"] = (100.0 * len(due) / max(hi - lo, 1), "%")
        if due:
            lat = list(due.values())
            out["latency_ms.p95"] = (1e3 * _percentile(lat, 0.95), "ms")
            sess.latency_ms = {f"p{int(q * 100)}": 1e3 * _percentile(lat, q)
                               for q in (0.5, 0.9, 0.95, 0.99)}
    else:
        n = rec.last - rec.first + 1
        sess.attempted, sess.failed = n, rec.failed
        out["fps"] = (n / rec.seconds, "frames/s")
    return out


class Ctx:
    """What a per-layer metric's reader reads."""

    def __init__(self, cell, rec, e2e=None):
        self.cell, self.rec = cell, rec
        self.e2e = {k: v for k, (v, _) in (e2e or {}).items()}
        self.trace = rec.trace
        self.step_modes = rec.step_modes

    def span_mean_ms(self, name: str):
        s = self.rec.span_window.get(name)
        return None if not s else s["mean_ms"]


def check(sess, rec, control: bool):
    """(numbers of the program, numbers of the control or None), both as
    {name: worst gap} (compare.py)."""
    import torch

    from slambench import compare

    cfg = compare.reference_config(sess.cell.config)
    sides = [("program", compare.Reference(cfg, sess.dev))]
    if control:
        sides.append(("control", compare.Reference(cfg, sess.dev, tf32=True)))
    ref = sides[0][1]
    gaps = {name: compare.Gaps() for name, _ in sides}
    fr = lambda k: sess.fs.frame(sess.source_index(k))  # noqa: E731
    # the start, from the empty state
    F = rec.start_frame
    start_frames = [fr(k) for k in range(F + 1)]
    hints = rec.shift_log
    r_poses, r_state = ref.from_scratch(start_frames, hints[:F + 1])
    r_map = compare.map_points(r_state, cfg)
    for name, side in sides:
        if name == "program":
            p_poses, p_state = rec.poses[:F + 1], rec.start_state
        else:
            p_poses, p_state = side.from_scratch(start_frames, hints[:F + 1])
        g = gaps[name]
        g.at = f"start 0-{F}"
        for a, b in zip(p_poses, r_poses):
            g.add_pose(a, b)
        g.add_state(p_state, r_state)
        g.add("map_m", compare.slice_gap(compare.map_points(p_state, cfg), r_map))
        del p_state
    del r_state, r_map
    # the map the run ended with: the program's FINAL slice against the
    # reference's extraction of the program's last volume, at the
    # program's capacity (both keep the first points in voxel order)
    if rec.final_points is not None and rec.final_state is not None:
        r_final = compare.map_points(rec.final_state, cfg, cfg.extraction_capacity)
        for name, _ in sides:  # the control extracts as the reference does
            gaps[name].at = "final map"
            p_final = rec.final_points if name == "program" else r_final
            gaps[name].add("map_m", compare.slice_gap(p_final, r_final))
        del r_final
    # the window's whole steps, from the program's state before each:
    # a frame drawn from the seed, and a shift frame whose slice holds points
    for j, states, slice_pts in ((rec.full_frame, rec.full_states, None),
                                 (rec.shift_frame, rec.shift_states,
                                  rec.slices.get(rec.shift_frame))):
        if not (j - 1 in states and j in states and j <= rec.last):
            continue
        before = states[j - 1]
        r_pose, r_after, r_slice = ref.step(compare.clone(before), fr(j), hints[j])
        for name, side in sides:
            if name == "program":
                p_pose, p_after, p_slice = rec.poses[j], states[j], slice_pts
            else:
                p_pose, p_after, p_slice = side.step(compare.clone(before), fr(j), hints[j])
            gaps[name].at = f"step {j}"
            gaps[name].add_pose(p_pose, r_pose)
            gaps[name].add_state(p_after, r_after)
            if p_slice is not None:
                gaps[name].add("map_m", compare.slice_gap(p_slice, r_slice))
            del p_after
        del r_after
    # the window's front halves
    for j, before in sorted(rec.pose_states.items()):
        if j > rec.last:
            continue
        r_pose = ref.front_pose(before, fr(j))
        for name, side in sides:
            gaps[name].at = f"front {j}"
            p_pose = rec.poses[j] if name == "program" else side.front_pose(before, fr(j))
            gaps[name].add_pose(p_pose, r_pose)
    if sess.dev.type == "cuda":
        torch.cuda.synchronize(sess.dev)
    sess.where = gaps["program"].where
    sess.ties = {name: side.ties for name, side in sides}
    return gaps["program"].values, (gaps["control"].values if control else None)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, control: bool = False,
             device: str = "cuda", bench=None, base=None) -> dict:
    """One run; returns the result line as a dict. device="cpu" (tests
    only) runs the program's and the reference's plain versions."""
    from slambench import spec, trace as trace_mod
    from slambench.session import Session

    kw = {} if base is None else {"base": base}
    bench = bench if bench is not None else spec.load_benchmark()
    cell = spec.load_cell(workload, bench, **kw)
    sess = Session(cell, seed, seconds, trace, device=device)
    rec = sess.run()
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    e2e = end_to_end(sess, rec)
    ctx = Ctx(cell, rec, e2e)
    per_layer = {}
    for m in cell.per_layer:
        v = spec.metric_reader(m["name"], **kw)(ctx)
        if v is not None:
            per_layer[m["name"]] = (v, m["unit"])
    device_info = _device(sess, rec)
    sess.release()
    numbers, control_numbers = check(sess, rec, control)
    # a cell compares the numbers its limits file gives a limit; the
    # others are reported under info (a number the control does not
    # separate from sound runs has no limit)
    limits = cell.limits or {}
    compared = {n: {"value": numbers.get(n), "limit": limits[n]} for n in sorted(limits)}
    correct = bool(limits) and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in compared.values())
    if trace:
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in per_layer.items()}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]][0], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
    out = {"correct": correct, "attempted": sess.attempted, "failed": sess.failed,
           "metrics": metrics, "device": device_info}
    if trace and rec.trace is not None:
        out["breakdown"] = trace_mod.breakdown(rec.trace)
    out["info"] = {"seed": seed, "window_frames": rec.last - rec.first + 1,
                   "first_frame": rec.first, "start_frame": rec.start_frame,
                   "full_frame": rec.full_frame, "pose_samples": len(rec.pose_states),
                   "shift_frame": rec.shift_frame, "shift_search": rec.shift_search,
                   "shift_slice_points": int(len(rec.slices.get(rec.shift_frame, ()))),
                   "slice_frames_in_window": [f for f in rec.slice_frames
                                              if rec.first <= f <= rec.last][:8],
                   "shift_frames_in_window": sum(rec.first <= f <= rec.last
                                                 for f in rec.shift_frames),
                   "sensor": rec.sensor,
                   "stream_bytes": sess.fs.stream_bytes(int(cell.traffic["stream_frames"])),
                   "end_to_end": {k: v for k, (v, _) in e2e.items()}}
    out["info"].update(_timing(rec))
    out["info"]["worst_at"] = sess.where
    out["info"]["shift_ties"] = sess.ties
    out["info"]["setup_parts"] = rec.setup_parts
    out["info"]["spans"] = rec.span_window
    out["info"]["latency_ms"] = getattr(sess, "latency_ms", None)
    out["info"]["uncompared"] = {n: v for n, v in numbers.items() if n not in limits}
    if control:
        out["control"] = control_numbers
    out["compared"] = compared
    return out


def _timing(rec) -> dict:
    """Where the window's host time went, from the poses' arrivals: the
    median gap between two poses, the gaps in which a shift frame's step
    ran (frame m's step runs before frame m-1's pose is read), the three
    longest gaps with the frame that arrived after each, and the median
    gap of the traced frames after the window (the profiler's cost)."""
    import numpy as np

    arr = np.asarray(rec.arrival)
    gaps = np.diff(arr[rec.first:rec.last + 1]) * 1e3
    shift_ms = [float(arr[m - 1] - arr[m - 2]) * 1e3 for m in rec.shift_frames
                if rec.first + 1 <= m <= rec.last and m >= 2]
    top = np.argsort(gaps)[::-1][:3] if len(gaps) else []
    traced = np.diff(arr[rec.last + 2:]) * 1e3 if rec.trace is not None else []
    return {"pose_gap_ms_median": float(np.median(gaps)) if len(gaps) else None,
            "pose_gap_ms_p90": float(np.percentile(gaps, 90)) if len(gaps) else None,
            "pose_gap_ms_top": [[float(gaps[i]), int(rec.first + 1 + i)] for i in top],
            "traced_pose_gap_ms_median": float(np.median(traced)) if len(traced) else None,
            "shift_gap_ms_median": float(np.median(shift_ms)) if shift_ms else None,
            "shift_gap_ms_sum": float(np.sum(shift_ms)), "gpu": rec.gpu}


class ForbiddenModules(RuntimeError):
    pass


def _device(sess, rec) -> dict:
    import torch

    if sess.dev.type == "cuda":
        kind, count = torch.cuda.get_device_name(sess.dev), 1
        platform = "gpu"
    else:
        kind, count, platform = "cpu", 1, "cpu"
    d = {"platform": platform, "kind": kind, "count": count,
         "memory_peak_bytes": int(rec.memory_peak)}
    if rec.trace is not None:
        d["busy_s"] = rec.trace.busy_us / 1e6
        d["window_s"] = rec.trace.window_us / 1e6
    return d


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="slambench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    from slambench import spec

    _caches(spec.ROOT)
    import torch

    cell = spec.load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slambench: {a.workload} needs {cell.chips} CUDA card(s); {n} available",
              file=sys.stderr)
        return 2
    try:
        out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), bool(a.control))
    except ForbiddenModules as e:
        print(f"slambench: loaded after the window: {', '.join(e.args[0])}", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
