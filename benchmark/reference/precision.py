"""The two precisions the reference runs in.

FLOAT64 is the reference: every stage in float64. BFLOAT16 is the control
that a sound comparison must fail: the reference put in the program's
place one precision below the configuration's float32. Every stage's
result is stored in bfloat16, and the arithmetic inside a stage runs in
float32, as bfloat16 kernels accumulate (and as the FFT must: PyTorch has
no bfloat16 FFT).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    work: torch.dtype

    def r(self, t: torch.Tensor) -> torch.Tensor:
        """t stored in this precision (and computed on in `work`)."""
        t = t.to(self.work)
        return t if self.work == torch.float64 else t.to(torch.bfloat16).to(self.work)

    def rn(self, a) -> np.ndarray:
        """A NumPy array stored in this precision, returned as float64."""
        return self.r(torch.as_tensor(np.asarray(a, np.float64))).double().numpy()


FLOAT64 = Precision("float64", torch.float64)
BFLOAT16 = Precision("bfloat16", torch.float32)
