"""``setup_s``: seconds from the process's start to the first timed
request (loading, building the kernels where they are not built yet,
making the weights, the warm-up requests)."""


def read(ctx, metric):
    return ctx.setup_s
