"""The module path's GLU kernels (``glu_fwd`` and ``glu_bwd``,
``csrc/glu.cu`` of the port) against their bound: the window's steps times
the five ConvBlocks' compulsory bytes a step, over those kernels' device
time in the trace. A block must read Y (2U) and write h (U) forward, and
read g (U) and Y (2U) and write dY (2U) backward, U = B·T·D2 bf16: 8U at the
HBM peak. A program without these kernels leaves the metric out."""

from port_bench import flops

BLOCKS = 5  # one GLU at the end of each of the encoder's five ConvBlocks


def bound_s_per_step(cfg, batch: int) -> float:
    return BLOCKS * 8 * batch * cfg["T"] * cfg["D2"] * 2 / flops.PEAK_HBM_BYTES_PER_S


def read(ctx):
    if ctx.trace is None or "steps" not in ctx.counts:
        return None
    t = ctx.trace.kernel_seconds(lambda n: "glu_fwd" in n or "glu_bwd" in n)
    if t <= 0:
        return None
    return 100.0 * ctx.counts["steps"] * bound_s_per_step(ctx.cfg, ctx.counts["batch"]) / t
