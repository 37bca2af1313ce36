"""device.busy_ms: the union of the device's events (kernels, copies,
sets) over the traced frames, in ms a frame: the card's own time a frame
takes. CUPTI times each kernel on the device, so this reading holds
under the profiler, where the host's launches (and with them the traced
frames' idle share) are slowed."""


def read(ctx):
    t = ctx.trace
    if t is None or t.frames <= 0 or t.busy_us <= 0:
        return None
    return t.busy_us / 1e3 / t.frames
