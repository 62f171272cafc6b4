"""Host-to-device bytes per engine call: the program's counter `h2d.bytes`
(every copy through soundscope_tpu_torch/core/device.upload) over the calls
of its span `engine.analyze_batch`, in B. In this cell the engine is the
only caller of the program that copies from the host."""

from benchmark import program_spans


def read(r):
    return program_spans.per_call("h2d.bytes", "engine.analyze_batch")
