"""K1's share of its roofline on the frames main path: the least time for
K1's work at the traced batches' shapes (roofline.k1) over K1's device time
(its kernels as metrics/kernels.json names them), in %."""

from benchmark import roofline


def read(r):
    k = r.kernel("K1")
    if k is None or k[1] != r.steps:
        return None
    least_s = sum(roofline.k1(s["b"], s["n"]) for s in r.shapes)
    return 100.0 * least_s * 1e6 / k[0]
