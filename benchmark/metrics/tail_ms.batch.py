"""Median host time of the engine's BS.1770 tail, the program's span
`engine.tail` (sub-block sums, then gating, timelines and LRA: plain PyTorch
ops enqueued on the device), over the process's calls after the first, in
ms."""

from benchmark import program_spans


def read(r):
    return program_spans.median_ms("engine.tail")
