"""The traced sub-window of a `--trace 1` run: torch.profiler over a
stated number of frames, started and stopped at frame boundaries, and
its reduction to what the per-layer readers and `breakdown` take: the
device's events (kernels, copies, sets) and their union, and the host's
calls that CUPTI records beside them, within the sub-window.

On a card only the device is traced (no host operator events, no
record_function range): the sub-window is bounded on the device's own
timeline by two marker kernels queued on the frame loop's stream at its
start and its end. Without a card (the tests) the host is traced and a
record_function range bounds it."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

WINDOW_RANGE = "slambench.trace_window"
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel: the program launches none
# the port's kernels by their CUDA function names (csrc/*.cu)
K1_K4 = ("band_fusion_kernel", "free_carve_kernel", "mirror_refresh_kernel",
         "tile_raycast")


@dataclass
class TraceSummary:
    frames: int  # frames whose step ran inside the sub-window
    window_us: float
    busy_us: float  # union of the device's event intervals in the window
    kernels: int  # kernel events that started in the window
    device_time_us: Dict[str, float]  # device event name -> summed time
    kernel_time_us: Dict[str, float]  # kernels only
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # (host activity, us)


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset")) or "memcpy" in name.lower()


class SubWindow:
    """Profiles from `start()` to `stop()`, both called on the frame
    loop's thread between two frames."""

    def __init__(self, frames: int):
        self.frames = frames
        self._prof = None
        self._range = None
        self._card = torch.cuda.is_available()

    def start(self) -> None:
        act = torch.profiler.ProfilerActivity
        self._prof = torch.profiler.profile(activities=[act.CUDA if self._card else act.CPU])
        self._prof.start()
        self._mark()

    def stop(self) -> None:
        self._mark(end=True)
        self._prof.stop()

    def _mark(self, end: bool = False) -> None:
        if self._card:
            torch.cuda._sleep(1)
        elif not end:
            self._range = torch.profiler.record_function(WINDOW_RANGE)
            self._range.__enter__()
        else:
            self._range.__exit__(None, None, None)

    def summary(self) -> Optional[TraceSummary]:
        if self._prof is None:
            return None
        return summarise(_events(self._prof), self.frames)


def _events(prof) -> List[Tuple[str, bool, float, float]]:
    """(name, on_device, start_us, end_us) of every event of the trace."""
    events = list(prof.events())
    ranges = {e.name for e in events if e.device_type != torch.autograd.DeviceType.CUDA}
    out = []
    for e in events:
        dev = e.device_type == torch.autograd.DeviceType.CUDA
        # a host range (record_function) is mirrored on the device's
        # timeline as a user annotation: not device work
        if dev and (getattr(e, "is_user_annotation", False) or e.name in ranges):
            continue
        out.append((e.name, dev, float(e.time_range.start), float(e.time_range.end)))
    return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _bounds(events) -> Optional[Tuple[float, float]]:
    """The sub-window: from the first marker kernel's start to the last
    one's end, or the host range where there is no card."""
    marks = sorted((s, e) for n, dev, s, e in events if dev and MARKER in n)
    if len(marks) >= 2:
        return marks[0][0], marks[-1][1]
    win = [(s, e) for n, dev, s, e in events if not dev and n == WINDOW_RANGE]
    return win[0] if win else None


def summarise(events: List[Tuple[str, bool, float, float]], frames: int,
              top_gaps: int = 10) -> Optional[TraceSummary]:
    bounds = _bounds(events)
    if bounds is None:
        return None
    w0, w1 = bounds
    dev_ev = sorted((max(s, w0), min(e, w1), n) for n, dev, s, e in events
                    if dev and e > w0 and s < w1 and MARKER not in n)
    device_time: Dict[str, float] = defaultdict(float)
    kernel_time: Dict[str, float] = defaultdict(float)
    kernels = 0
    for s, e, n in dev_ev:
        device_time[n] += e - s
        if not _is_copy(n):
            kernel_time[n] += e - s
            kernels += 1
    busy = _union([(s, e) for s, e, _ in dev_ev])
    busy_us = sum(e - s for s, e in busy)
    # idle gaps inside the window, named by the innermost host call (on a
    # card: the CUDA runtime's) that spans the gap's middle, or else by
    # the device operation that ends the gap
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    host = [(n, s, e) for n, dev, s, e in events if not dev and n != WINDOW_RANGE]
    named = []
    for s, e in gaps[:top_gaps]:
        mid = 0.5 * (s + e)
        spans = [(hs, n) for n, hs, he in host if hs <= mid <= he]
        if spans:
            name = max(spans)[1]
        else:
            after = [n for ds, _, n in dev_ev if ds >= e]
            name = f"before {after[0]}" if after else "the window's end"
        named.append((name, e - s))
    return TraceSummary(frames=frames, window_us=w1 - w0, busy_us=busy_us, kernels=kernels,
                        device_time_us=dict(device_time), kernel_time_us=dict(kernel_time),
                        gaps=named)


def breakdown(t: TraceSummary) -> dict:
    ops = sorted(t.device_time_us.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[n, us / 1e6] for n, us in t.gaps[:10]]}
