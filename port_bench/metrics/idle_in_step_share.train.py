"""The share of the traced window in which the device was idle while the
host was inside a train step (``sd.step``): idle that the step's dispatch
rate causes."""

from port_bench import program_spans


def read(ctx):
    return program_spans.idle_share(ctx, "sd.step")
