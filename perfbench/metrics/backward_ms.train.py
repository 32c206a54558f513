"""Mean device milliseconds a training step spends in `train.backward`: the
spans' CUDA events, summed over the steps that began in the traced window,
over those steps (`train.step` spans)."""

from perfbench import spans


def read(run):
    return spans.device_ms_per(run, "train.backward", "train.step")
