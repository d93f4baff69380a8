"""Host milliseconds a step in the optimizer's step
(``sd.step.optimizer``)."""

from port_bench import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, ["sd.step.optimizer"], "sd.step")
