"""What the program's own registry of spans and counters recorded in this
process (`soundscope_tpu_torch.utils.metrics.GLOBAL`: `span_stats(name)`,
`counter(name)`), read once the run has ended.

Every reading covers the whole process: the warm-up's calls and the
window's. A median leaves out each span's first call, which the first-call
metric reads alone. Where the registry is not loaded, has no spans (a
program without them), or the span never ran (the control), a reading is
None.
"""

from __future__ import annotations

import sys

MODULE = "soundscope_tpu_torch.utils.metrics"


def registry():
    """The program's registry where the program has loaded it, else None."""
    return getattr(sys.modules.get(MODULE), "GLOBAL", None)


def stats(span: str):
    """The record of `span` (calls, first_s, median_s()), or None."""
    read = getattr(registry(), "span_stats", None)
    return read(span) if read is not None else None


def median_ms(span: str):
    s = stats(span)
    m = s.median_s() if s is not None else None
    return None if m is None else 1e3 * m


def first_s(span: str):
    s = stats(span)
    return None if s is None else s.first_s


def per_call(counter: str, span: str):
    """Counter `counter` over the calls of `span`."""
    s = stats(span)
    return None if s is None else registry().counter(counter) / s.calls
