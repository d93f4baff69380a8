"""The module path's train-mode BatchNorm + GELU kernels (``bngelu_*``,
``csrc/batchnorm_gelu.cu`` of the port) against their bound: the window's
steps times the ten layers' compulsory bytes a step, over those kernels'
device time in the trace. A layer must read y and write h forward, and read
dh and y and write dy backward: 5·B·T·D2 bf16 elements at the HBM peak. The
bound counts only those bytes, so the residual a first pass forms and the
passes' second reads can only lower the reading. A program without these
kernels leaves the metric out."""

from port_bench import flops

LAYERS = 10  # two BatchNorm + GELU layers in each of the encoder's five ConvBlocks


def bound_s_per_step(cfg, batch: int) -> float:
    return LAYERS * 5 * batch * cfg["T"] * cfg["D2"] * 2 / flops.PEAK_HBM_BYTES_PER_S


def read(ctx):
    if ctx.trace is None or "steps" not in ctx.counts:
        return None
    t = ctx.trace.kernel_seconds(lambda n: "bngelu_" in n)
    if t <= 0:
        return None
    return 100.0 * ctx.counts["steps"] * bound_s_per_step(ctx.cfg, ctx.counts["batch"]) / t
