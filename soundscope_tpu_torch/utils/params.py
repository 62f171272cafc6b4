"""Carry the JAX package's parameters and states into the port.

The tests feed the same filter to both packages: the JAX `BlockFilter`'s
fields, as NumPy arrays, become the port's `BlockFilter`, and a JAX
`MeterConfig` becomes the port's. A JAX `MeterState` or `LiveState`,
given as NumPy arrays by field name, becomes the port's, so that a stream
begun in JAX can go on in the port. Nothing here imports JAX; the caller
passes plain arrays and an object with the config's attributes. Each
result lies on `device`: the card when there is one, unless the caller
asks for the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.core.device import default_device
from soundscope_tpu_torch.core.state import MeterState
from soundscope_tpu_torch.ops.biquad import BlockFilter


def block_filter_from_numpy(Tt, Wt, Ot, A_pows, block: int,
                            device=None) -> BlockFilter:
    """The port's filter from the JAX BlockFilter's fields.

    The realisation (A, B, C, D) that K1 consumes is read back from the
    blocked matrices: A = A_pows[1], B = Wt[block-1] (= A^0 B),
    C = Ot[:, 0] (= C A^0), D = Tt[0, 0] (= h[0]); float32 values held as
    float64. A^L is formed in float64 from A_pows[block], which carries one
    rounding where a power of the rounded A would carry L of them.
    """
    device = default_device(device)
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


def meter_state_from_numpy(fields: dict, device=None) -> MeterState:
    """The port's MeterState from {field name: array} of a JAX MeterState
    (the same fields, dtypes and modal-basis filter state)."""
    device = default_device(device)
    names = [f.name for f in dataclasses.fields(MeterState)]
    if sorted(fields) != sorted(names):
        raise ValueError(f"MeterState fields {sorted(fields)} != {sorted(names)}")
    return MeterState(**{k: torch.from_numpy(np.array(fields[k])).to(device)
                         for k in names})


def live_state_from_numpy(fields: dict, device=None):
    """The port's LiveState from {"meter": {field: array}, "ring": array,
    "pos": array} of a JAX LiveState."""
    from soundscope_tpu_torch.models.live import LiveState

    device = default_device(device)
    return LiveState(
        meter=meter_state_from_numpy(fields["meter"], device),
        ring=torch.from_numpy(np.array(fields["ring"], np.float32)).to(device),
        pos=torch.from_numpy(np.array(fields["pos"], np.int32)).to(device),
    )
