"""kernels.k1_k4_ms: the device time of the port's kernels K1-K4
(band_fusion_kernel, free_carve_kernel, mirror_refresh_kernel,
tile_raycast_*; csrc/) in the traced sub-window, by kernel name, over
its frames, in ms a frame."""

from slambench.trace import K1_K4


def read(ctx):
    t = ctx.trace
    if t is None or t.frames <= 0:
        return None
    us = sum(v for n, v in t.kernel_time_us.items() if any(k in n for k in K1_K4))
    if us <= 0:
        return None
    return us / 1e3 / t.frames
