"""Carry the JAX package's parameters into the port.

The tests feed the same filter to both packages: the JAX `BlockFilter`'s
fields, as NumPy arrays, become the port's `BlockFilter`, and a JAX
`MeterConfig` becomes the port's. Nothing here imports JAX; the caller
passes plain arrays and an object with the config's attributes.
"""

from __future__ import annotations

import numpy as np
import torch

from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.ops.biquad import BlockFilter


def block_filter_from_numpy(Tt, Wt, Ot, A_pows, block: int,
                            device="cpu") -> BlockFilter:
    """The port's filter from the JAX BlockFilter's fields.

    The realisation (A, B, C, D) that K1 consumes is read back from the
    blocked matrices: A = A_pows[1], B = Wt[block-1] (= A^0 B),
    C = Ot[:, 0] (= C A^0), D = Tt[0, 0] (= h[0]); float32 values held as
    float64. A^L is formed in float64 from A_pows[block], which carries one
    rounding where a power of the rounded A would carry L of them.
    """
    Tt, Wt, Ot, A_pows = (np.asarray(a, np.float32) for a in (Tt, Wt, Ot, A_pows))
    if Tt.shape != (block, block) or A_pows.shape[0] != block + 1:
        raise ValueError("filter arrays do not match the block length")
    return BlockFilter(
        Tt=torch.from_numpy(Tt.copy()).to(device),
        Wt=torch.from_numpy(Wt.copy()).to(device),
        Ot=torch.from_numpy(Ot.copy()).to(device),
        A_pows=torch.from_numpy(A_pows.copy()).to(device),
        block=block,
        A=A_pows[1].astype(np.float64),
        Bv=Wt[block - 1].astype(np.float64),
        Cv=Ot[:, 0].astype(np.float64),
        D=float(Tt[0, 0]),
        A_block=A_pows[block].astype(np.float64),
    )


def meter_config_from_jax(cfg) -> MeterConfig:
    """Map a JAX MeterConfig (any object with its fields) to the port's;
    `iir_impl` has no counterpart and is dropped."""
    return MeterConfig(channels=cfg.channels, rate=cfg.rate,
                       max_blocks=cfg.max_blocks, block=cfg.block)
