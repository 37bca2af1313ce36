"""tracker.process_ms.live: the mean, over the window, of the engine's
Stopwatch span `processFrame` on the per-frame path (one frame's
Tracker.process_frame), in ms."""


def read(ctx):
    return ctx.span_mean_ms("processFrame")
