"""The share of the traced training window in which no operation ran on
the device."""


def read(ctx):
    if ctx.trace is None or "steps" not in ctx.counts or not ctx.trace.device_events:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
