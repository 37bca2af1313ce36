"""tracker.eager_pct: the share of the window's frames that the tracker
did not run as a replay of its captured graphs (Tracker.step_counts'
modes: warm-up, shift, captured and eager frames), in %."""


def read(ctx):
    modes = ctx.step_modes
    if not modes:
        return None
    return 100.0 * sum(m != "replayed" for m in modes) / len(modes)
