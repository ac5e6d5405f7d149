"""Device work launched a decode step, in launches: the kernels, copies and
memsets launched inside the program's ``model.decode`` spans in the traced
part of a serving window (``spans.launched``), over the number of those
spans.  Each is one launch the host dispatches, which a CUDA graph of the
step would replace.  Nothing off the card, without a trace, or from a
program that opens no such span."""

from portbench import spans


def read(obs):
    got = spans.per_span(obs, "model.decode")
    if got is None:
        return None
    n, events = got
    return len(events) / n
