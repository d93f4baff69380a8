"""Host milliseconds a step in the backward (``sd.step.backward``:
``loss.backward()`` and, under a group, the gradient all-reduce)."""

from port_bench import program_spans


def read(ctx):
    return program_spans.ms_per(ctx, ["sd.step.backward"], "sd.step")
