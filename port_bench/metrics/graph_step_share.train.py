"""The share (%) of the window's train steps (``sd.step``) that ran as a
CUDA graph replay (an ``sd.step.graph`` inside them). Left out where the
program opens no such span, and on a trace without device operations,
where no step can replay a graph."""

from port_bench import program_spans

GRAPH = "sd.step.graph"


def read(ctx):
    from speech_decoding_tpu_torch.utils import profiling

    if GRAPH not in getattr(profiling, "SPANS", ()):
        return None
    w = program_spans.window_spans(ctx)
    if w is None or not w.count(program_spans.STEP) or not ctx.trace.device_events:
        return None
    return 100.0 * w.count(GRAPH) / w.count(program_spans.STEP)
