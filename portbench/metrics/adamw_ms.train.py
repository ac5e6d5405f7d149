"""Device time of the optimizer's update, in ms a step: the summed device
time of the work launched inside the program's ``train.optimizer`` spans
(gradient clipping and the AdamW update) in the traced part of the
training window, over the number of those spans.  Nothing off the card,
without a trace, or from a program that opens no such span."""

from portbench import spans


def read(obs):
    return spans.device_ms_per_span(obs, "train.optimizer")
