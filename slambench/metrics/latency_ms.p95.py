"""latency_ms.p95: the 95th percentile, over every frame the tracker took
of the live window, of the time from the frame's due time in the
sensor's schedule to its pose on the host (the one-frame-late read
included), in ms. The live cell at 30 Hz runs at the per-frame path's
capacity, where a tail swings with the smallest change of the step's
time; its end-to-end metric is the share of frames tracked."""


def read(ctx):
    return ctx.e2e.get("latency_ms.p95")
