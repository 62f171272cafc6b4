"""Host time of the process's first engine call, the first duration of the
program's span `engine.analyze_batch`, in s: the kernel library's load (and
nvcc where it is not built), the first module loads and the allocator's first
growth, all part of setup_s."""

from benchmark import program_spans


def read(r):
    return program_spans.first_s("engine.analyze_batch")
