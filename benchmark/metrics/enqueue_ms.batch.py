"""Median host time of the engine call of a batch step (analyze_batch_native,
and the spectrogram where the mix asks for it) until it returns, before the
host copies wait for the device, in ms, over the whole window."""


def read(r):
    return r.spans.median("engine.analyze_batch_native")
