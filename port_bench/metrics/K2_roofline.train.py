"""K2 (the three-tap dW kernel) against its bound: the window's steps times
one step's fifteen dW bounds (port_bench/flops.py), over the device time of
K2's kernels in the trace."""

from port_bench import flops


def read(ctx):
    if ctx.trace is None or "steps" not in ctx.counts:
        return None
    t = ctx.trace.kernel_seconds(lambda n: "tap_conv_dw" in n or "reduce_splits_kernel" in n)
    if t <= 0:
        return None
    return 100.0 * ctx.counts["steps"] * flops.k2_bound_s_per_step(ctx.cfg, ctx.counts["batch"]) / t
