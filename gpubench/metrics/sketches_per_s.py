"""``sketches_per_s``: sketches whose outputs reached the host inside the
window, over the time from the window's start to the last completion in
it (whole requests only)."""


def read(ctx, metric):
    w = ctx.window
    return w.units_done / w.elapsed_s if w.elapsed_s > 0 else None
