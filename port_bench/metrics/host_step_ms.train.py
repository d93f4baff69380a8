"""Host milliseconds of one optimizer step (the program's ``sd.step``
spans in the traced window, per step): the Python and launches a step
costs the host."""

from port_bench import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, ["sd.step"], "sd.step")
