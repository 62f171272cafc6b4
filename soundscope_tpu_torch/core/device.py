"""Where the port computes, and how constants get there.

`default_device` picks the card: every entry point computes on it unless
the caller asks for the CPU (``device="cpu"``). Without a working card it
raises rather than fall back to the CPU unasked. `upload` copies a host constant to a device without asking
PyTorch to wait for the stream: the streaming meter builds its constants
at the first push, and a push of a CUDA tensor must not synchronise the
host (chip_smoke.py runs every push under
``torch.cuda.set_sync_debug_mode("error")``). A copy from pageable host
memory is staged by the driver before the call returns, so the source may
be freed at once.
"""

from __future__ import annotations

import numpy as np
import torch

from soundscope_tpu_torch.utils.metrics import GLOBAL


def default_device(device=None) -> torch.device:
    """`device` as a torch.device; None means CUDA. Raises RuntimeError
    when CUDA is asked for (or None given) and no card is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "soundscope_tpu_torch computes on a CUDA device and none is "
            "available; pass device=\"cpu\" (the CLI: --device cpu) to run on the CPU")
    return dev


def upload(a, device) -> torch.Tensor:
    """A tensor, or a host array (anything NumPy takes), on `device`; a copy
    from the host to a CUDA device does not wait for the stream, and counts
    in the registry's `h2d.copies` and `h2d.bytes`."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    dev = torch.device(device)
    if dev.type != "cuda" or t.device.type != "cpu":
        return t.to(dev)
    GLOBAL.count("h2d.copies")
    GLOBAL.count("h2d.bytes", t.numel() * t.element_size())
    return t.to(dev, non_blocking=True)


def as_float32(samples, device) -> torch.Tensor:
    """Samples (a NumPy array or a tensor) as float32 on `device`; a tensor
    already there is not copied."""
    if isinstance(samples, torch.Tensor):
        return upload(samples.to(torch.float32), device)
    return upload(np.array(samples, np.float32), device)
