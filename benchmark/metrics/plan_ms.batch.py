"""Median host time of the engine's plan, the program's span `engine.plan`
(valid lengths to the device, channel weights, the K-weighting filter and
its uploads, the route), over the process's calls after the first, in ms."""

from benchmark import program_spans


def read(r):
    return program_spans.median_ms("engine.plan")
