"""Runs of one cell in sequence, each a process of its own, as the
benchmark's bounds are measured: the result lines go to a JSON-lines
file, and the spread of each metric is printed, the distance between
the first and third quartile (statistics.quantiles(values, n=4)) as a
share of the median.

    python3 -m slambench.sets --workload <cell> --seeds 11,12,13 --seconds 20 \\
        [--trace 0|1] [--control 0|1] --out <file>.jsonl
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def spread(values):
    """(median, first quartile, third quartile, IQR / median)."""
    if len(values) < 2:
        return values[0], values[0], values[0], 0.0
    q1, q2, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return med, q1, q3, (q3 - q1) / abs(med) if med else float("inf")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="slambench.sets")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    for seed in [int(s) for s in a.seeds.split(",")]:
        cmd = [sys.executable, "-m", "slambench.run", "--workload", a.workload, "--seed",
               str(seed), "--seconds", str(a.seconds), "--trace", str(a.trace)]
        if a.control:
            cmd += ["--control", "1"]
        t0 = time.monotonic()
        r = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.monotonic() - t0
        last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
        try:
            res = json.loads(last)
        except json.JSONDecodeError:
            res = None
        rec = {"workload": a.workload, "seed": seed, "trace": a.trace, "rc": r.returncode,
               "wall_s": wall, "result": res, "stderr_tail": r.stderr[-3000:]}
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        lines.append(rec)
        m = res["metrics"] if res else {}
        print(f"seed {seed} rc {r.returncode} wall {wall:.1f}s correct "
              f"{res and res['correct']} " + " ".join(f"{k}={v['value']:.6g}" for k, v in m.items()),
              flush=True)
        if res is None:
            print(r.stderr[-3000:], flush=True)
    names = sorted({k for rec in lines if rec["result"] for k in rec["result"]["metrics"]})
    for n in names:
        vals = [rec["result"]["metrics"][n]["value"] for rec in lines
                if rec["result"] and n in rec["result"]["metrics"]]
        med, q1, q3, s = spread(vals)
        print(f"{n}: n={len(vals)} median {med:.6g} q1 {q1:.6g} q3 {q3:.6g} spread {s:.4%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
