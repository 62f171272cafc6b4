"""Median host time of the engine's call, the program's own span
`engine.analyze_batch` around analyze_batch_native, over the process's calls
after the first, in ms."""

from benchmark import program_spans


def read(r):
    return program_spans.median_ms("engine.analyze_batch")
