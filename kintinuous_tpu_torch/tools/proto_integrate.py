"""Cost-model probes of a row-wise integrate kernel on the card (port of
tools/proto_integrate_pallas.py, P1-P4; kernels in csrc/probes.cu).

At the tool's scale, K = 8192 unique rows of a (32776, 4, 128) f32
volume, it times:

  1. run_rows: each selected row in and out, plus one;
  2. run_dma:  the same, plus a (4,128) corner of a bf16 image per row;
  3. run_full: each row's floats pick a data-dependent pixel in two bf16
     images (five gathers a float), as a projection would;
  4. run_dyn:  run_rows over the first n = 5057 ids, n held on the device.

Each wrapper updates the volume in place and counts its launches in
`<wrapper>.launches`; its `_plain` sibling is the PyTorch version of the
same function, which the wrapper runs for CPU tensors. Inputs come from
numpy seeds. Timing clones the volume before each call, outside the
timed window (ops/kernels.cuda_window_ms: CUDA events from a cold L2
behind a device spin, median of 10).

    python -m kintinuous_tpu_torch.tools.proto_integrate [--device cuda]
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import NamedTuple

import numpy as np
import torch

from kintinuous_tpu_torch.ops import kernels as K

N_ROWS = 32768 + 8
N_K = 8192
N_DYN = 5057
PH, PW = 112, 256  # the TPU probe's image patch (rows, columns)
H, W = 480, 640
H2, W2 = 240, 384

_SIGNATURES = {
    "kt_probe_rows": (K.P, K.P, K.P, K.I, K.P),
    "kt_probe_dma": (K.P,) * 5 + (K.I, K.I, K.P),
    "kt_probe_full": (K.P,) * 6 + (K.I,) * 7 + (K.P,),
}


class ProbeInputs(NamedTuple):
    tsdf: torch.Tensor  # (N_ROWS,4,128) f32
    ids: torch.Tensor  # (N_K,) i32, unique
    cy: torch.Tensor  # (N_K,) i32, multiples of 16 in [0, 352]
    cx: torch.Tensor  # (N_K,) i32, in {0, 128, 256, 384}
    img: torch.Tensor  # (2,480,640) bf16
    img2: torch.Tensor  # (3,240,384) bf16


def make_inputs(device="cpu", n_rows: int = N_ROWS, k: int = N_K) -> ProbeInputs:
    """The tool's inputs at its shapes, from numpy seeds (the ids and
    corners from the same RandomState seeds as the TPU probe)."""
    rng = np.random.default_rng(0)
    ids = np.random.RandomState(0).choice(n_rows - 1, k, False).astype(np.int32)
    cy = (np.random.RandomState(1).randint(0, H - PH, k) // 16 * 16).astype(np.int32)
    cx = (np.random.RandomState(2).randint(0, 4, k) * 128).astype(np.int32)

    def t(a):
        return torch.from_numpy(a).to(device)

    return ProbeInputs(
        tsdf=t(rng.standard_normal((n_rows, 4, 128), dtype=np.float32)),
        ids=t(ids), cy=t(cy), cx=t(cx),
        img=t(rng.standard_normal((2, H, W), dtype=np.float32)).to(torch.bfloat16),
        img2=t(rng.standard_normal((3, H2, W2), dtype=np.float32)).to(torch.bfloat16),
    )


def _lib():
    return K.library("probes", _SIGNATURES)


# ------------------------------------------------------------------ P1
def run_rows_plain(tsdf, ids) -> None:
    rows = ids.long()
    tsdf[rows] = tsdf[rows] + 1.0


def run_rows(tsdf, ids) -> None:
    """tsdf[ids[i]] += 1 for every i, in place (P1)."""
    if tsdf.device.type == "cpu":
        run_rows_plain(tsdf, ids)
        return
    K.require_cuda("run_rows", tsdf, ids)
    K.require_cuda("run_rows", tsdf, align=16)  # float4 rows
    if ids.shape[0] == 0:  # no row: nothing to launch
        return
    with K.on_device(tsdf):
        K.check(_lib().kt_probe_rows(tsdf.data_ptr(), ids.data_ptr(), None, ids.shape[0],
                                     K.stream_of(tsdf)), "kt_probe_rows")
    run_rows.launches += 1


run_rows.launches = 0


# ------------------------------------------------------------------ P2
def _corner(img, cy, cx):
    """(K,4,128): img[cy[i] + s, cx[i] + l] of an (H,W) image."""
    yy = cy.long()[:, None, None] + torch.arange(4, device=img.device)[None, :, None]
    xx = cx.long()[:, None, None] + torch.arange(128, device=img.device)[None, None, :]
    return img[yy, xx]


def run_dma_plain(tsdf, ids, corners, img, img2) -> None:
    rows = ids.long()
    tsdf[rows] = tsdf[rows] + _corner(img[0], *corners).to(torch.float32)


def run_dma(tsdf, ids, corners, img, img2) -> None:
    """tsdf[ids[i]] += img[0, cy[i]:cy[i]+4, cx[i]:cx[i]+128], in place
    (P2). img2 is the probe's second image, which P2 moves but does not
    read."""
    if tsdf.device.type == "cpu":
        run_dma_plain(tsdf, ids, corners, img, img2)
        return
    cy, cx = corners
    K.require_cuda("run_dma", tsdf, ids, cy, cx, img)
    K.require_cuda("run_dma", tsdf, align=16)  # float4 rows
    if ids.shape[0] == 0:
        return
    with K.on_device(tsdf):
        K.check(_lib().kt_probe_dma(tsdf.data_ptr(), ids.data_ptr(), cy.data_ptr(),
                                    cx.data_ptr(), img.data_ptr(), ids.shape[0],
                                    img.shape[2], K.stream_of(tsdf)), "kt_probe_dma")
    run_dma.launches += 1


run_dma.launches = 0


# ------------------------------------------------------------------ P3
def run_full_plain(tsdf, ids, corners, img, img2) -> None:
    rows = ids.long()
    cy, cx = (c.long()[:, None, None] for c in corners)
    t = tsdf[rows]
    a = torch.abs(t)
    u = torch.clamp(a * 100.0, 0, PW - 1).to(torch.int64)
    v = torch.clamp(a * 70.0, 0, PH - 1).to(torch.int64)
    f = torch.float32
    rays = img[0][cy + v, cx + u].to(f) + img[1][cy + v, cx + u].to(f)
    y2, x2 = cy // 2 + v // 2, u // 2
    rgb = (img2[0][y2, x2].to(f) + img2[1][y2, x2].to(f)) + img2[2][y2, x2].to(f)
    tsdf[rows] = t * 0.5 + (rays + rgb) * 0.5


def run_full(tsdf, ids, corners, img, img2) -> None:
    """Per float t of each selected row: a pixel (u, v) from |t|, two
    reads of img around the row's corner and three of img2 at half
    resolution; the row becomes t/2 + (their sum)/2, in place (P3)."""
    if tsdf.device.type == "cpu":
        run_full_plain(tsdf, ids, corners, img, img2)
        return
    cy, cx = corners
    K.require_cuda("run_full", tsdf, ids, cy, cx, img, img2)
    K.require_cuda("run_full", tsdf, align=8)  # float2 loads
    if ids.shape[0] == 0:
        return
    with K.on_device(tsdf):
        K.check(_lib().kt_probe_full(
            tsdf.data_ptr(), ids.data_ptr(), cy.data_ptr(), cx.data_ptr(), img.data_ptr(),
            img2.data_ptr(), ids.shape[0], img.shape[1], img.shape[2], img2.shape[1],
            img2.shape[2], PW, PH, K.stream_of(tsdf)), "kt_probe_full")
    run_full.launches += 1


run_full.launches = 0


# ------------------------------------------------------------------ P4
def run_dyn_plain(n, tsdf, ids) -> None:
    rows = ids.long()
    live = (torch.arange(ids.shape[0], device=ids.device) < n)[:, None, None]
    t = tsdf[rows]
    tsdf[rows] = torch.where(live, t + 1.0, t)


def run_dyn(n, tsdf, ids) -> None:
    """run_rows over the first n ids (P4), n clamped to [0, len(ids)];
    n is a () int32 tensor on the volume's device and is never read on
    the host."""
    if tsdf.device.type == "cpu":
        run_dyn_plain(n, tsdf, ids)
        return
    K.require_cuda("run_dyn", tsdf, ids, n)
    K.require_cuda("run_dyn", tsdf, align=16)  # float4 rows
    if ids.shape[0] == 0:
        return
    with K.on_device(tsdf):
        K.check(_lib().kt_probe_rows(tsdf.data_ptr(), ids.data_ptr(), n.data_ptr(),
                                     ids.shape[0], K.stream_of(tsdf)), "kt_probe_rows")
    run_dyn.launches += 1


run_dyn.launches = 0


def time_in_place(fn, tsdf, *args, reps: int = 10, timer=K.cuda_window_ms) -> float:
    """Median ms of fn(volume, *args) over reps calls, each on a fresh
    clone of tsdf made before the timed window. On the card `timer` takes
    the window (default: device time from a cold L2, as a caller that
    has just touched other data finds it); on the CPU the host clock."""
    cuda = tsdf.device.type == "cuda"
    times = []
    for rep in range(reps + 1):  # the first call warms up
        vol = tsdf.clone()
        if cuda:
            ms = timer(lambda: fn(vol, *args))
        else:
            t0 = time.perf_counter()
            fn(vol, *args)
            ms = (time.perf_counter() - t0) * 1e3
        if rep:
            times.append(ms)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass --device cpu)")
    x = make_inputs(dev)
    corners = (x.cy, x.cx)
    n = torch.tensor(N_DYN, dtype=torch.int32, device=dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for name, fn, args in (
        ("rows only (8192 rows)", run_rows, (x.ids,)),
        ("rows + patch reads", run_dma, (x.ids, corners, x.img, x.img2)),
        ("rows + data-dependent gathers", run_full, (x.ids, corners, x.img, x.img2)),
        (f"rows over a device count (n={N_DYN})",
         lambda vol, ids: run_dyn(n, vol, ids), (x.ids,)),
    ):
        print(f"{name:50s} {time_in_place(fn, x.tsdf, *args):8.4f} ms  ({where})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
