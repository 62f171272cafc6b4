"""Host side of the tile-scan core (csrc/iir_tile.cuh) shared by K1 and K5.

The core runs the 4-state K-weighting recurrence over segments of T
samples a CTA, 32 samples a thread. Its float32 constants are built here
in float64 from the filter's modal realisation and passed to the kernels
by value (kernel parameters), so a launch uploads nothing and never waits
for the device. `tile_constants` returns them in the layout of the
kernel's `TileConsts`:

    A (16, row-major), B (4), C (4), D,
    W (32, 4):   W[k] = A^(31 - k) B        (a thread's zero-state end state
                                              is sum_k W[k] x_k)
    KS (5, 16):  A^(32 * 2^r)               (the warp's Kogge-Stone rounds)
    AW (16, 16): A^(1024 w)                 (warp w's offset in the CTA)
    AT (16):     A^T                        (the hop to the next segment)

The kernel reads A as its two 2x2 diagonal blocks; `modal_blocks_ok`
checks that the rest of A is rounding noise, as the modal realisation of
the K-weighting cascade (one complex pole pair per biquad) makes it.

`sync_buffer` is the launch's scratch of carry records: int32, all bits
set, word 0 the ticket counter (tickets count from -1 + 1 = 0), then one
float4 per (row, segment).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

TS = 32                 # samples per thread
MAX_WARPS = 16          # warps per CTA: T <= 16384
MAX_CH = 16             # channels a kernel takes
TILE_FLOATS = 16 + 4 + 4 + 1 + TS * 4 + 5 * 16 + MAX_WARPS * 16 + 16


def modal_blocks_ok(A: np.ndarray) -> bool:
    """True when A is block-diagonal in 2x2 blocks up to 1e-9 of its scale."""
    off = A.copy()
    off[:2, :2] = 0.0
    off[2:, 2:] = 0.0
    return A.shape == (4, 4) and float(np.abs(off).max()) <= 1e-9 * float(np.abs(A).max())


@functools.lru_cache(maxsize=64)
def _tile_constants(a_bytes: bytes, b_bytes: bytes, c_bytes: bytes, d: float,
                    T: int) -> np.ndarray:
    A = np.frombuffer(a_bytes).reshape(4, 4)
    B = np.frombuffer(b_bytes)
    Cv = np.frombuffer(c_bytes)
    pw = functools.partial(np.linalg.matrix_power, A)
    W = np.stack([pw(TS - 1 - k) @ B for k in range(TS)])
    KS = np.stack([pw(TS << r) for r in range(5)])
    AW = np.stack([pw(TS * 32 * w) for w in range(MAX_WARPS)])
    out = np.concatenate([A.reshape(-1), B, Cv, [d], W.reshape(-1), KS.reshape(-1),
                          AW.reshape(-1), pw(T).reshape(-1)]).astype(np.float32)
    assert out.size == TILE_FLOATS
    out.setflags(write=False)
    return out


def tile_constants(filt, T: int) -> np.ndarray:
    """The kernels' TileConsts for the filter's modal realisation and a
    segment of T samples (float32 from float64, cached)."""
    return _tile_constants(np.ascontiguousarray(filt.A, np.float64).tobytes(),
                           np.ascontiguousarray(filt.Bv, np.float64).tobytes(),
                           np.ascontiguousarray(filt.Cv, np.float64).tobytes(),
                           float(filt.D), int(T))


def unpack(consts: np.ndarray) -> dict:
    """The named parts of a TileConsts array (for the tests' emulation)."""
    sizes = [("A", (4, 4)), ("B", (4,)), ("C", (4,)), ("D", ()), ("W", (TS, 4)),
             ("KS", (5, 4, 4)), ("AW", (MAX_WARPS, 4, 4)), ("AT", (4, 4))]
    out, i = {}, 0
    for name, shape in sizes:
        n = int(np.prod(shape))
        out[name] = consts[i:i + n].reshape(shape)
        i += n
    return out


def sync_buffer(rows: int, nseg: int, device) -> torch.Tensor:
    """Ticket counter and carry records of one launch, all bits set."""
    return torch.full((4 + 4 * rows * nseg,), -1, dtype=torch.int32, device=device)
