"""Several processes (port of kintinuous_tpu/parallel/multihost.py:
init_distributed, HostPartition, allgather_points and
DistributedPoseGraph).

Every process tracks the whole log; the heavy host-side work is split
between them and its results cross processes:

- `init_distributed` brings up a torch.distributed process group, and
  `shutdown_distributed` takes it down at the end of a run;
- `HostPartition` gives each extracted slice (and keyframe) one owner,
  round-robin, so each process filters, downsamples and estimates
  normals for its share only;
- `allgather_points` exchanges the processed points at save, in process
  order, and process 0 writes the map;
- `DistributedPoseGraph` splits the factors of the pose-graph solve: each
  process builds the products of its share on its device, and each
  reduction of backend/pose_graph.gn_core (the gradient, every CG
  product, the preconditioner's diagonal, chi2) is an all_reduce, while
  the small replicated CG state steps alike everywhere.

The group's backend is gloo, over host-staged (CPU) tensors. It plays
the part of the JAX package's DCN, and unlike NCCL it serves several
processes on one card: NCCL needs one process per card. The payloads
are small: a graph's normal equations per solve, and once, at save, the
map's points.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from kintinuous_tpu_torch.backend.pose_graph import PoseGraph, gn_core


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join the gloo group at tcp://<coordinator_address> ("host:port",
    process 0's listening address) as `process_id` of `num_processes`.
    A no-op for one process, or when the group is already up."""
    if num_processes is None or num_processes <= 1:
        return
    if dist.is_initialized():
        return
    if not coordinator_address:
        raise ValueError("several processes need a coordinator address (host:port)")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id or 0))


def shutdown_distributed() -> None:
    """Leave the group at the end of a run: a barrier, so that no process
    tears down while another still talks to it (process 0 serves the
    group's store), then the group's teardown. Without it the group's
    threads are left to the interpreter's exit, where one may abort the
    process. A no-op with no group up."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _world():
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class HostPartition:
    """Round-robin ownership of host-side work items across processes."""

    def __init__(self, num_processes: Optional[int] = None,
                 process_id: Optional[int] = None):
        n, r = _world()
        self.num = num_processes if num_processes is not None else n
        self.pid = process_id if process_id is not None else r

    def owns(self, index: int) -> bool:
        return index % self.num == self.pid

    def owner(self, index: int) -> int:
        return index % self.num


def allgather_points(arr: np.ndarray) -> np.ndarray:
    """Every process's (n_i, D) float32 rows, concatenated in process
    order: the counts first, then one padded all_gather. With no group
    up, arr itself."""
    arr = np.ascontiguousarray(arr, np.float32)
    D = arr.shape[1] if arr.ndim == 2 else 1
    arr = arr.reshape(-1, D)
    n, _ = _world()
    if n == 1:
        return arr
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(counts, torch.tensor([arr.shape[0]], dtype=torch.int64))
    counts = [int(c) for c in counts]
    cap = max(counts)
    if cap == 0:
        return np.zeros((0, D), np.float32)
    padded = torch.zeros((cap, D), dtype=torch.float32)
    padded[: arr.shape[0]] = torch.from_numpy(arr)
    out = [torch.zeros((cap, D), dtype=torch.float32) for _ in range(n)]
    dist.all_gather(out, padded)
    return np.concatenate([o[:c].numpy() for o, c in zip(out, counts)])


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the group's processes, on x's device (staged
    through the host)."""
    h = x.detach().to("cpu", copy=True)
    dist.all_reduce(h, op=dist.ReduceOp.SUM)
    return h.to(x.device)


class DistributedPoseGraph(PoseGraph):
    """A PoseGraph whose solve splits the factors over the processes of
    the group: every process holds the whole (small) graph, computes the
    products of its contiguous share of the factor list, and sums each
    reduction over the group. Every process must call optimise() and
    chi2() in step with the others."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.num, self.pid = _world()

    def solve(self, iters: int):
        poses, fi, fj, fZinv, fw, fl = self._packed()
        F = fw.shape[0]
        per = -(-F // self.num)  # padded to a multiple of the process count
        lo, hi = self.pid * per, min((self.pid + 1) * per, F)
        share = slice(lo, max(lo, hi))
        return gn_core(poses, fi[share], fj[share], fZinv[share], fw[share], iters,
                       fl=fl[share], huber_delta=self.huber_delta, reduce=all_reduce_sum)
