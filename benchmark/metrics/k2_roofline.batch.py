"""K2's share of its roofline on the frames main path: the least time for
the pooled spectrogram's work at the traced batches' shapes (roofline.k2)
over K2's device time, in %."""

from benchmark import roofline


def read(r):
    k = r.kernel("K2")
    if k is None or k[1] != r.steps:
        return None
    least_s = sum(roofline.k2(s["b"], s["n"]) for s in r.shapes)
    return 100.0 * least_s * 1e6 / k[0]
