"""Device time of a decode step, in ms: the summed device time of the
kernels, copies and memsets launched inside the program's
``model.decode`` spans in the traced part of a serving window, over the
number of those spans.  Against the step's host time it shows how far the
host's dispatch paces decode.  Nothing off the card, without a trace, or
from a program that opens no such span."""

from portbench import spans


def read(obs):
    return spans.device_ms_per_span(obs, "model.decode")
