"""engine.slice_ms: the mean, over the window, of the engine's Stopwatch
span `SliceProcessor` (runtime/engine.py's slice worker processing one
shift frame's slice), in ms. Nothing to read in a window without a
shift frame."""


def read(ctx):
    return ctx.span_mean_ms("SliceProcessor")
