"""The share of the traced window in which the device was idle while the
training loop waited for a batch (``sd.loop.wait``)."""

from port_bench import program_spans


def read(ctx):
    return program_spans.idle_share(ctx, "sd.loop.wait")
