"""Captured pieces of work: the port's counterpart of the JAX package's
one compiled step (kintinuous_tpu/tracking/tracker.py:632,
`jax.jit(step, donate_argnums=(0,))`).

A piece is a function of no arguments that reads and writes only
buffers whose storage its owner keeps for its life. `Pieces` runs each
piece, by name:

- its first run is eager (on a card, on the pieces' own stream, so
  that the lazy set-up a capture must not do, such as cuBLAS's
  workspace for that stream, happens outside any capture);
- its second run captures it, as a CUDA graph on a card
  (`capture_error_mode="thread_local"`: other threads may go on using
  the card meanwhile), and replays the capture;
- every later run replays it: one graph launch on a card.

A replay checks that the buffers it was captured against have not
moved (their data pointers) and raises if they have; `drop` forgets
every capture, after which a piece captures again at its next run.
A failed capture or replay raises: nothing falls back to eager.

The kernel wrappers count their launches in Python, which runs only at
capture. So a capture takes back the counts its recording added, and
each replay adds them again: a wrapper's `launches` stays the number of
times its kernel ran.

On the CPU there are no graphs: a capture records the function and the
buffers' addresses, and a replay checks the addresses and calls it. The
bookkeeping, the address check included, is the card's.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

# what a run of a piece was
EAGER, CAPTURED, REPLAYED = "eager", "captured", "replayed"


def counted_wrappers() -> tuple:
    """The kernel wrappers whose `launches` a capture adjusts."""
    from kintinuous_tpu_torch.ops.cuda_integrate import band_fusion, free_carve
    from kintinuous_tpu_torch.ops.cuda_raycast import build_mirror, mirror_refresh, tile_raycast
    from kintinuous_tpu_torch.ops.reduce import gn_update

    return (band_fusion, free_carve, mirror_refresh, build_mirror, tile_raycast, gn_update)


class _Capture:
    """One captured piece: its graph (None on the CPU, where `fn` is
    called instead; a graph keeps no `fn`, so a capture holds no
    reference back to its owner), the addresses of its buffers at
    capture, and the launches each counted wrapper made in it."""

    def __init__(self, name: str, fn: Optional[Callable[[], None]], ptrs: Tuple[int, ...],
                 graph, launches: Tuple[int, ...]):
        self.name, self.fn, self.ptrs = name, fn, ptrs
        self.graph, self.launches = graph, launches
        self.wrappers = counted_wrappers()

    def replay(self, ptrs: Tuple[int, ...]) -> None:
        if ptrs != self.ptrs:
            raise RuntimeError(
                f"captured piece {self.name!r}: its buffers moved since the capture "
                "(a state replaced without dropping the captures)")
        with record_function("kt.replay"):
            if self.graph is None:
                self.fn()
            else:
                self.graph.replay()
        for w, n in zip(self.wrappers, self.launches):
            w.launches += n


def addresses(tensors: Sequence[Optional[torch.Tensor]]) -> Tuple[int, ...]:
    """The data pointers of the tensors (0 for None)."""
    return tuple(0 if t is None else t.data_ptr() for t in tensors)


class Pieces:
    """Runs named pieces eagerly once, then captured (see the module's
    docstring). device: where the pieces' buffers live."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._captures: Dict[str, _Capture] = {}
        self._warm: set = set()  # pieces that have had their eager run
        self._pool = None  # one memory pool for the captures, made at the first
        self.capture_ms: List[float] = []  # host ms of each capture

    @contextlib.contextmanager
    def on_stream(self):
        """Issue the work inside on the pieces' stream (on a card), after
        the caller's stream's work and before its later work."""
        if not self.cuda:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            yield
        caller.wait_stream(self.stream)

    def run(self, name: str, fn: Callable[[], None],
            buffers: Callable[[], Sequence[Optional[torch.Tensor]]]) -> str:
        """Run piece `name` (fn reads and writes buffers()): eagerly the
        first time, then captured and replayed. Returns EAGER, CAPTURED
        or REPLAYED. Call inside on_stream()."""
        cap = self._captures.get(name)
        if cap is not None:
            cap.replay(addresses(buffers()))
            return REPLAYED
        if name not in self._warm:
            fn()
            self._warm.add(name)
            return EAGER
        cap = self._capture(name, fn, addresses(buffers()))
        self._captures[name] = cap
        cap.replay(addresses(buffers()))
        return CAPTURED

    def _capture(self, name: str, fn, ptrs) -> _Capture:
        wrappers = counted_wrappers()
        before = tuple(w.launches for w in wrappers)
        graph = None
        t0 = time.perf_counter()
        if self.cuda:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            # no garbage collection inside a capture: collecting another
            # tracker's graphs there (cudaGraphExecDestroy) invalidates it
            collecting = gc.isenabled()
            gc.disable()
            try:
                with record_function("kt.capture"), torch.cuda.graph(
                        graph, pool=self._pool, stream=self.stream,
                        capture_error_mode="thread_local"):
                    fn()
            finally:
                if collecting:
                    gc.enable()
        self.capture_ms.append((time.perf_counter() - t0) * 1e3)
        launches = tuple(w.launches - b for w, b in zip(wrappers, before))
        for w, b in zip(wrappers, before):
            w.launches = b  # the recording launched nothing
        return _Capture(name, fn if graph is None else None, ptrs, graph, launches)

    @property
    def captured(self) -> Tuple[str, ...]:
        return tuple(self._captures)

    def drop(self) -> None:
        """Forget every capture (and its memory pool): a piece captures
        again at its next run, without another eager run."""
        if self.cuda and self._captures:
            torch.cuda.synchronize(self.device)  # no replay still running
        self._captures.clear()
        self._pool = None
