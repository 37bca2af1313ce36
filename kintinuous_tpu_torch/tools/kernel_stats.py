"""Registers, spills and SASS instruction counts of the CUDA kernels.

    python -m kintinuous_tpu_torch.tools.kernel_stats [SOURCE.cu ...]

Compiles each source (default: every csrc/*.cu) to a cubin with the
build's flags (ops/kernels.NVCC_FLAGS) and `-Xptxas -v`, disassembles it
with `cuobjdump -sass`, and prints one JSON line per kernel: registers,
stack frame and spill bytes from ptxas; the static SASS instruction count
of its main path (everything up to the EXIT before the first subroutine:
the slow paths of IEEE division and square root come after it, as
subroutines that a voxel enters only on rare operands), of the body of
its widest loop (a grid-stride kernel's work per pass) and of those
subroutines; and the main path's count per opcode. A static count is
what the code holds, not what a thread executes: a loop body counts once.
Needs the CUDA toolkit (nvcc and cuobjdump); nothing runs on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path
from typing import Dict, List

from kintinuous_tpu_torch.ops import kernels as K

_NOT_FOR_CUBIN = {"-shared", "-Xcompiler", "-fPIC"}
_SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def short_name(mangled: str) -> str:
    """The last component of an Itanium-mangled name
    (`_ZN12_GLOBAL__N_118band_fusion_kernelE...` -> band_fusion_kernel),
    with its integer template arguments, so that each instantiation keeps
    its own row (`...tile_raycast_kernelILi5ELi1EEE...` ->
    tile_raycast_kernel<5,1>)."""
    if not mangled.startswith("_Z"):
        return mangled
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
        if not mangled.startswith("_ZN"):
            break
    args = re.match(r"I((?:Li-?\d+E)+)E", mangled[i:])
    if args:
        name += "<" + ",".join(re.findall(r"Li(-?\d+)E", args.group(1))) + ">"
    return name


def parse_ptxas(log: str) -> Dict[str, dict]:
    """{kernel: {registers, stack_bytes, spill_store_bytes,
    spill_load_bytes}} from `ptxas -v` output."""
    out: Dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = out.setdefault(short_name(m.group(1)), {})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:  # a device function's properties are not its kernel's
            cur = out.get(short_name(m.group(1)))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def opcode(instr: str) -> str:
    """`@!P0 LDG.E.128 R4, desc[UR4][R2.64]` -> LDG"""
    words = instr.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def parse_sass(text: str) -> Dict[str, dict]:
    """{kernel: {sass_main, sass_loop, sass_subroutines, main_opcodes}}
    from `cuobjdump -sass` output. sass_loop counts the body of the
    main path's widest loop (from a backward branch's target to the
    branch; None without one), which a grid-stride kernel runs once per
    pass. NOPs and the closing self-branch are not counted."""
    funcs: Dict[str, List[tuple]] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(short_name(m.group(1)), [])
            continue
        m = _SASS_LINE.search(line)
        if cur is not None and m:
            addr = int(re.search(r"/\*([0-9a-f]+)\*/", line).group(1), 16)
            cur.append((addr, m.group(1)))
    out = {}
    for name, code in funcs.items():
        addrs = [a for a, _ in code]
        instrs = [i for _, i in code]
        ops = [opcode(i) for i in instrs]
        keep = [k for k, op in enumerate(ops) if op != "NOP"]
        if keep and ops[keep[-1]] == "BRA":
            keep = keep[:-1]  # the `BRA` to itself that ends the code
        first_ret = next((k for k in keep if ops[k] == "RET"), None)
        split = len(ops)
        if first_ret is not None:
            exits = [k for k in keep if k < first_ret and ops[k] == "EXIT"]
            split = exits[-1] + 1 if exits else 0
        main = [k for k in keep if k < split]
        spans = []  # (target, branch) of each backward branch in the main path
        for k in main:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", instrs[k])
            if m and int(m.group(1), 16) < addrs[k]:
                spans.append((int(m.group(1), 16), addrs[k]))
        loop = None
        if spans:
            lo, hi = max(spans, key=lambda s: s[1] - s[0])
            loop = sum(1 for k in main if lo <= addrs[k] <= hi)
        out[name] = dict(sass_main=len(main), sass_loop=loop,
                         sass_subroutines=len(keep) - len(main),
                         main_opcodes=dict(Counter(ops[k] for k in main).most_common()))
    return out


def _tool(name: str) -> str:
    nvcc_dir = os.path.dirname(K._nvcc())
    cand = os.path.join(nvcc_dir, name)
    if os.path.isfile(cand):
        return cand
    found = shutil.which(name)
    if not found:
        raise RuntimeError(f"{name} not found beside nvcc or on PATH")
    return found


def stats(source: Path) -> Dict[str, dict]:
    """Per-kernel ptxas and SASS figures of one source."""
    flags = [f for f in K.NVCC_FLAGS if f not in _NOT_FOR_CUBIN]
    with tempfile.TemporaryDirectory() as d:
        cubin = os.path.join(d, "k.cubin")
        build = subprocess.run([K._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o", cubin,
                                str(source)], capture_output=True, text=True)
        if build.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{build.stderr}")
        sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin], capture_output=True,
                              text=True, check=True).stdout
    regs = parse_ptxas(build.stdout + build.stderr)
    out = parse_sass(sass)
    for name in set(regs) | set(out):
        out[name] = {**regs.get(name, {}), **out.get(name, {})}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", type=Path,
                    help="CUDA sources (default: every csrc/*.cu)")
    args = ap.parse_args(argv)
    for src in args.sources or sorted(K.CSRC.glob("*.cu")):
        for name, row in sorted(stats(src).items()):
            print(json.dumps({"source": str(src), "kernel": name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
