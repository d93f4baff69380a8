"""Model operations of the window's train steps (forward, backward and the
CLIP loss, counted from shapes by port_bench/flops.py) over the window's
wall time, as a share of the H100's bf16 dense peak."""

from port_bench import flops


def read(ctx):
    if "steps" not in ctx.counts or not ctx.counts["segments"]:
        return None
    ops = flops.train_flops_per_row(ctx.cfg, ctx.counts["batch"]) * ctx.counts["segments"]
    return 100.0 * ops / ctx.window_s / flops.PEAK_BF16_FLOPS
