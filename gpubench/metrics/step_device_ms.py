"""``step_device_ms.<cell>``: device ms per solver step of the kernels
launched inside the entry's ``gpubench/step`` ranges, each of which
encloses one of the program's ``inpaint.step`` spans (one DPM-Solver++
step of the diffusion pipeline: ControlNet, UNet, guidance and update).
No reading where no step was traced."""


def read(ctx, metric):
    t = ctx.trace
    if t is None:
        return None
    steps = sum(1 for name, _, _ in t.spans if name == "step")
    us = t.span_us("step")
    return us / 1e3 / steps if steps and us > 0 else None
