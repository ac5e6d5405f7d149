"""Device time of a miss's cache re-home, in ms: the summed device time of
the work launched inside the program's ``serve.cache`` spans (the decode
cache made, zeroed, and filled from the prefill's) in the traced part of a
serving window, over the number of those spans.  Nothing off the card,
without a trace, or from a program that opens no such span."""

from portbench import spans


def read(obs):
    return spans.device_ms_per_span(obs, "serve.cache")
