"""Host milliseconds a step in the forward (``sd.step.forward``: collate,
encoder and loss)."""

from port_bench import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, ["sd.step.forward"], "sd.step")
