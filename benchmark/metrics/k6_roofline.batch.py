"""K6's share of its roofline in the library scan: the least time for the
4x true peak of every track's valid
samples (roofline.k6) over K6's device time, in %."""

from benchmark import roofline


def read(r):
    k = r.kernel("K6")
    if k is None or k[1] != r.steps:
        return None
    least_s = sum(roofline.k6(s["valid"], s["b"]) for s in r.shapes)
    return 100.0 * least_s * 1e6 / k[0]
