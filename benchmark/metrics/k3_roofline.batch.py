"""K3's share of its roofline on the rows route of long programmes: the
least time for the K-weighted energy and the 4x true peak of every
programme's valid samples over K3's device time, in %.

K3 is `k3_tile` with `channel_sum` and `peaks_pass`, named here (matched
by name in the trace) because metrics/kernels.json does not list it. Its
least time is K5's bytes (every valid sample read once, one z entry per
32 valid samples of a programme written) with K1's work: the K-filter
and the square against float32, the polyphase FIR against the tensor
cores. None unless `k3_tile` ran once a traced step.
"""

from benchmark.roofline import ENERGY_OPS, FACTOR, FILTER_OPS, GROUP, fir_ops, least_s

K3 = ("k3_tile", "channel_sum", "peaks_pass")


def k3(valid: int) -> float:
    """K3 on stereo programmes whose valid lengths sum to `valid` samples."""
    s = 2 * valid
    return least_s(4 * (s + valid // GROUP), s * (FILTER_OPS + ENERGY_OPS), s * fir_ops(FACTOR))


def read(r):
    ev = r.matching(K3)
    if sum(1 for e in ev if K3[0] in e[2]) != r.steps or not r.steps:
        return None
    least = sum(k3(s["valid"]) for s in r.shapes)
    return 100.0 * least * 1e6 / sum(b - a for a, b, _ in ev)
