"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a plain
C interface, loaded with ctypes. Building happens at first use, into
build/kernels/ at the root of the checkout, one nvcc process per source,
all started together. A library's file name carries a hash of its source
and flags, so an edited source is rebuilt and a current one is reused.

Flags: sm_90a (Hopper), no fast math, and -fmad=false so that
`x / z * fx + cx` rounds after each operation as PyTorch's separate
multiply and add do; a fused multiply-add can land a pixel coordinate on
the other side of a .5 tie than the plain version.

Nothing here is imported at module level from CUDA or nvcc: the CPU
tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("integrate", "logical", "raycast", "probes", "gn")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# builds and loads may come from several threads (the engine builds at
# start-up in the background): one at a time
_LOCK = threading.RLock()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared by the sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet,
    in parallel. Returns {name: seconds} for the ones it compiled."""
    with _LOCK:
        return _build(list(SOURCES if names is None else names))


def _build(names) -> Dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    took = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for csrc/{name}.cu:\n{log.decode(errors='replace')}"
            )
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        took[name] = time.perf_counter() - t0
    return took


def library(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built if needed, with the
    argument types of its C functions set (every function returns the
    launch's cudaGetLastError() as an int)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on t's device. The raw query
    takes a fraction of a microsecond; building a torch.cuda.Stream to
    read its handle takes several, on every launch."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


# a device-side wait of about 0.6 ms at the H100's clock, queued before
# a timed window opens
SPIN_CYCLES = 1_000_000
# written before a cold window: more than the H100's 50 MB L2
FLUSH_BYTES = 128 << 20
_FLUSH: Dict[int, torch.Tensor] = {}


def cuda_window_ms(fn, cold: bool = True) -> float:
    """Device ms from one CUDA event to the next around fn() on the
    current device. With `cold`, a 128 MB buffer is written first, so the
    window starts with none of fn's inputs in L2. A spin is then queued,
    so the host's launch work (Python, the wrapper, ctypes) happens while
    the card is still busy and the window holds the device work only;
    host_window_ms times that launch work."""
    dev = torch.cuda.current_device()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if cold:
        if dev not in _FLUSH:
            _FLUSH[dev] = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
        _FLUSH[dev].zero_()
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def host_window_ms(fn) -> float:
    """Host ms from calling fn() on an idle card until the card has run
    it: the wrapper's launch work (Python, ctypes) and the device work
    together, which is what a host-bound step pays for the call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def require_cuda(fn: str, *tensors: torch.Tensor, align: int = 1) -> None:
    """A kernel wrapper takes CUDA tensors that are contiguous, on one
    device and (for vector loads) start on an `align`-byte boundary;
    anything else raises (there is no silent fallback)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{fn}: tensors must be contiguous, on {dev} and "
                             f"{align}-byte aligned")


def on_device(t: torch.Tensor):
    """Make t's card the calling thread's current device for a launch.
    The C launchers launch on the current device and set none, and a
    slab mesh issues every card's work from one thread, so a launch on
    another card's tensors without this runs on the wrong card."""
    return torch.cuda.device(t.device)


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
