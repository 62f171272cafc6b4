"""Host side of the tile-scan core (csrc/iir_tile.cuh) of K1, K3-K5 and K7.

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
    LB (6, 8):   A^(T 2^b) as its two 2x2   (the look-back: A^(T m) is the
                 diagonal blocks              product picked by the bits of m)

The kernel reads A and LB as their two 2x2 diagonal blocks;
`modal_blocks_ok` checks that the rest of A is rounding noise, as the
modal realisation of the K-weighting cascade (one complex pole pair per
biquad) makes it, and the powers of a block-diagonal matrix are
block-diagonal.

`sync_buffer` is the launch's scratch of carry records: int32, all bits
set, word 0 the ticket counter (tickets count from -1 + 1 = 0), then two
float4s per (row, segment): the segment's aggregate G and its inclusive
end state; K5 keeps the inclusive state alone, one float4 per (track,
segment, channel).

`power_blocks` is A^m as its two 2x2 blocks: K7 takes a row's end state
from its last sub-span of m samples. `lane_powers` is A^(32 l) for each
lane l, the same way: K5 steps a warp's entry state to each lane's with
it.

`fir_taps` is the true-peak FIR as K1, K3 and K6 read it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from soundscope_tpu_torch.ops.truepeak import _polyphase_taps

TS = 32                 # samples per thread
MAX_WARPS = 16          # warps per CTA: T <= 16384
MAX_CH = 16             # channels a kernel takes
LB_BITS = 6             # look-back powers A^(T 2^b): depths D <= 32 < 2^LB_BITS
RECORD_WORDS = 8        # int32 words of carry record per (row, segment)
INCL_WORDS = 4          # K5's record per (track, segment, channel): incl alone
TILE_FLOATS = (16 + 4 + 4 + 1 + TS * 4 + 5 * 16 + MAX_WARPS * 16 + 16
               + LB_BITS * 8)


def modal_blocks_ok(A: np.ndarray) -> bool:
    """True when A is block-diagonal in 2x2 blocks up to 1e-9 of its scale."""
    off = A.copy()
    off[:2, :2] = 0.0
    off[2:, 2:] = 0.0
    return A.shape == (4, 4) and float(np.abs(off).max()) <= 1e-9 * float(np.abs(A).max())


def _kept(filt, key, make):
    """filt._consts[key], made by make() at the first ask and kept (an array
    read-only): the filter lives as long as its (rate, block, device), so
    its constants are built once (ops/biquad.kweight_filter)."""
    cache = filt._consts
    if key not in cache:
        out = make()
        if isinstance(out, np.ndarray):
            out.setflags(write=False)
        cache[key] = out
    return cache[key]


def modal_filter(filt) -> bool:
    """modal_blocks_ok for a 4-state filter's A, kept on the filter."""
    return _kept(filt, "modal", lambda: filt.A.shape == (4, 4) and modal_blocks_ok(filt.A))


def _blocks(M: np.ndarray) -> np.ndarray:
    """The two 2x2 diagonal blocks of M, row-major: 8 values."""
    return np.concatenate([M[:2, :2].reshape(-1), M[2:, 2:].reshape(-1)])


def _power(filt, m: int) -> np.ndarray:
    """A^m of the filter's A in float64."""
    return np.linalg.matrix_power(np.asarray(filt.A, np.float64), m)


def tile_constants(filt, T: int) -> np.ndarray:
    """The kernels' TileConsts for the filter's modal realisation and a
    segment of T samples (float32 from float64), kept on the filter,
    read-only."""
    def make():
        A = np.asarray(filt.A, np.float64)
        B = np.asarray(filt.Bv, np.float64)
        pw = functools.partial(np.linalg.matrix_power, A)
        W = np.stack([pw(TS - 1 - k) @ B for k in range(TS)])
        KS = np.stack([pw(TS << r) for r in range(5)])
        AW = np.stack([pw(TS * 32 * w) for w in range(MAX_WARPS)])
        LB = np.stack([_blocks(pw(T << b)) for b in range(LB_BITS)])
        out = np.concatenate([A.reshape(-1), B, np.asarray(filt.Cv, np.float64),
                              [float(filt.D)], W.reshape(-1), KS.reshape(-1),
                              AW.reshape(-1), pw(T).reshape(-1),
                              LB.reshape(-1)]).astype(np.float32)
        assert out.size == TILE_FLOATS
        return out

    return _kept(filt, ("tile", int(T)), make)


def power_blocks(filt, m: int) -> np.ndarray:
    """A^m (float64, rounded once to float32) as its two 2x2 diagonal
    blocks, kept on the filter, read-only."""
    return _kept(filt, ("power", int(m)),
                 lambda: _blocks(_power(filt, m)).astype(np.float32))


def lane_powers(filt) -> np.ndarray:
    """A^(32 l) for the lanes l = 0 .. 31 (float64, rounded once to
    float32) as their two 2x2 diagonal blocks, (32, 8): K5's step from a
    warp's entry state to each lane's. Kept on the filter, read-only."""
    return _kept(filt, "lanes", lambda: np.stack(
        [_blocks(_power(filt, TS * lane)) for lane in range(TS)]).astype(np.float32))


def unpack(consts: np.ndarray) -> dict:
    """The named parts of a TileConsts array (for the tests' emulation)."""
    sizes = [("A", (4, 4)), ("B", (4,)), ("C", (4,)), ("D", ()), ("W", (TS, 4)),
             ("KS", (5, 4, 4)), ("AW", (MAX_WARPS, 4, 4)), ("AT", (4, 4)),
             ("LB", (LB_BITS, 8))]
    out, i = {}, 0
    for name, shape in sizes:
        n = int(np.prod(shape))
        out[name] = consts[i:i + n].reshape(shape)
        i += n
    return out


def sync_buffer(rows: int, nseg: int, device, words: int = RECORD_WORDS) -> torch.Tensor:
    """Ticket counter and carry records of one launch, all bits set:
    `words` per (row, segment)."""
    return torch.full((4 + words * rows * nseg,), -1, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def fir_taps(factor: int) -> np.ndarray:
    """The true-peak FIR's F x KP taps as K1, K3 and K6 read them (host
    memory). The kernels skip phase 0 and the last tap of the other phases,
    so this checks that phase 0 is a unit impulse (the sample peak stands
    in for its outputs) and that those taps are zero."""
    if factor == 1:
        return np.zeros(1, np.float32)
    taps = np.ascontiguousarray(_polyphase_taps(factor), np.float32)
    c = int(np.argmax(np.abs(taps[0])))
    if (taps[0, c] != 1.0 or np.abs(np.delete(taps[0], c)).max() > 1e-12
            or np.any(taps[1:, -1] != 0.0)):
        raise ValueError("the tile kernels' FIR needs phase 0 to be an impulse "
                         "and the other phases' last tap zero")
    return taps.reshape(-1)
