"""Host milliseconds a step in a replayed step's input copies and graph
launch (``sd.step.graph``), per train step (``sd.step``). Left out where no
step of the window replayed a graph."""

from port_bench import program_spans

GRAPH = "sd.step.graph"


def read(ctx):
    w = program_spans.window_spans(ctx)
    if w is None or not w.count(GRAPH):
        return None
    return program_spans.ms_per(ctx, [GRAPH], program_spans.STEP)
