"""Median host time of the pooled spectrogram's call, the program's own span
`stft.pooled` around stft_pooled_frames, over the process's calls after the
first, in ms; None where the program has no such span."""

from benchmark import program_spans


def read(r):
    return program_spans.median_ms("stft.pooled")
