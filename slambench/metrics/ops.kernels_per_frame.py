"""ops.kernels_per_frame: device kernel events (copies and sets left
out) in the torch.profiler trace of the traced sub-window, over its
frames."""


def read(ctx):
    t = ctx.trace
    if t is None or t.frames <= 0 or t.kernels == 0:
        return None
    return t.kernels / t.frames
