"""K5's share of its roofline in the library scan: the least time for the
K-weighted energy of every track's valid
samples (roofline.k5) over K5's device time, in %."""

from benchmark import roofline


def read(r):
    k = r.kernel("K5")
    if k is None or k[1] != r.steps:
        return None
    least_s = sum(roofline.k5(s["valid"]) for s in r.shapes)
    return 100.0 * least_s * 1e6 / k[0]
