"""Milliseconds the Prefetcher's thread spends stacking one scan group
(``sd.loop.stack``, per group)."""

from port_bench import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, ["sd.loop.stack"], "sd.loop.stack")
