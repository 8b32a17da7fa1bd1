"""``idle_share.<cell>``: the share of the traced sub-window in which no
operation ran on the card, 100 - 100 * (union of device intervals) /
(the window's length)."""


def read(ctx, metric):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 - 100.0 * t.busy_s / t.window_s
