"""dac_rvq_ms_per_s (ms/s, moves audio_rtf): device time of the kernels
launched under the program's ``egr.dac.rvq`` spans (the nine stages of
projection, distances, argmin and lookup), per second of one channel's
audio served.  None where the program records no such span."""
from perfbench.metrics.dac_encoder_ms_per_s import device_ms_per_channel_s


def read(ctx):
    return device_ms_per_channel_s(ctx, "egr.dac.rvq")
