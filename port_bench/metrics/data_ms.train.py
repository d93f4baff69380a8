"""Milliseconds the Prefetcher's thread spends drawing one batch's indices
and gathering it on the device (``sd.data.index`` + ``sd.data.gather``,
per gathered batch)."""

from port_bench import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, ["sd.data.index", "sd.data.gather"], "sd.data.gather")
