"""K3, K4, K5: K-weighted energy over the rows layout; K7: the streaming
filter.

The counterpart of the JAX package's ``ops/pallas_iir.py``. Each entry
takes the K-weighting `BlockFilter`, x as (b, ch, N) or as rows (b*ch, N)
(channel-minor: the same memory), the tracks' valid lengths n_valid (b,),
the ch channel weights and a group g dividing N, and returns

    z (b, N/g): sum over each group of g samples of
                mask(i < n_valid) * sum_c w_c * y_c[i]^2,

the channel-weighted squared K-weighted signal, masked at sample
granularity before the group sums. Channels of weight 0 (the 5.1 LFE)
contribute nothing.

* `kweight_energy_tp_prefix` (K3, replaces `kweight_energy_tp_pallas_prefix`,
  pallas_call at ``pallas_iir.py:577``) also returns the BS.1770 true peak
  and sample peak per row, tp = max(tp, sp); the FIR context is the masked
  previous samples and its outputs at positions >= n_valid do not count.
* `kweight_energy_prefix` (K4, replaces `kweight_energy_pallas_prefix`,
  ``pallas_iir.py:500``) is K3 without the peaks.
* `kweight_energy_chain` (K5, replaces `kweight_energy_pallas`,
  ``pallas_iir.py:308``) computes K4's z with a sequential schedule.

On the card (csrc/iir_rows.cu) all three run the tile-scan core of
csrc/iir_tile.cuh (host side ops/iir_tile.py): one launch that reads the
input once, each segment's entry state taken from the segments before it,
each thread refiltering 32 samples from shared memory and writing group
sums (g | 32). K3 runs K1's polyphase FIR beside them over every channel,
weight 0 too, for its peaks. K3 and K4, which serve a few long rows, take
each segment's state through a fixed look-back of LOOKBACK segments,
which shortens a row's chain of waits LOOKBACK + 1 times. K3 is one
kernel, `k3_tile_tracks`, that adds y^2 in registers and leaves its group
sums in the tile, on two kinds of ticket chosen by the channel count:

* files of 1 to K3_TRACK_CHANNELS channels (mono, stereo): one file's
  segment, `k3_segment` samples of every channel in one tile of TP_TILE
  samples, the channels' weighted group sums added in order in the tile
  and z written by the same launch: no scratch of group sums per row and
  no second pass;
* more channels (5.1): one row's segment of TP_TILE samples, its weighted
  group sums written per row, then `channel_sum` adds the channels in
  order into z. Six channels do not split one tile into equal whole
  warps; as six rows of their own they are as long as a mono file's.

K4 (`k5_tile` with a look-back, segments of CHAIN_TILE) runs over the rows
of nonzero weight, writes group sums per row, and `channel_sum` adds
them. K5's many tracks keep the plain chain (`k5_tile_tracks`) on tickets
of one track's segment: `chain_segment` samples of every channel of
nonzero weight in one tile of CHAIN_TILE samples, z written by the same
launch. All three skip the segments of a padded track that start past
n_valid; K5 with more than TRACK_CHANNELS weighted channels runs K4's
kernel without the look-back, a ticket per row, and neither skips nor
writes z itself. See those files for the designs and what bounds them.

K7 (csrc/block_iir.cu, replaces `block_iir_pallas`, pallas_call at
``pallas_iir.py:67``) filters with carried state: `block_iir_stream(filt,
x, s0) -> (y, s_final)` computes what ops/biquad.block_iir computes, for
any N >= 1, with s0 and s_final in the modal basis of the filter. The
streaming meter (models/meter.py) filters every push through it. On the
card it is one launch of the tile-scan core in its S0 mode: segments of
CHAIN_TILE samples read through the input's strides, each row
entering from s0, y stored coalesced and s_final in matrix form; rows of
more than one segment chain through a record buffer that is cached per
(device, stream, rows, segments) and reset on the device before each
launch. `block_iir_zero` is the counterpart of `block_iir_pallas`: zero
state, y only.

Each entry launches its kernel on a CUDA tensor and runs its `*_plain`
version on a CPU tensor; any other device raises. The plain versions are
the port's blocked filter (ops/biquad.block_iir) and true_peak_masked.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from soundscope_tpu_torch.core import constants as C
from soundscope_tpu_torch.ops import iir_tile
from soundscope_tpu_torch.ops.biquad import BlockFilter, block_iir
from soundscope_tpu_torch.ops.truepeak import true_peak_masked
from soundscope_tpu_torch.utils.metrics import GLOBAL

# samples per segment (CTA) of the tile-scan core: K3 as K1's, K4 and K5
CHAIN_TILE = 4096
TP_TILE = 8192

# weighted channels up to which K5's ticket is one track's segment of all
# of them (csrc/iir_rows.cu): with more, each channel's segment and the
# track's chain shorten, and rows of their own were faster on the H100
# (200 5.1 tracks of 30 s at 192 kHz: 13.1 ms on rows, 19.1 on tracks)
TRACK_CHANNELS = 2


def chain_segment(channels: int) -> int:
    """Samples of each of `channels` weighted channels (1 to
    TRACK_CHANNELS) in one of K5's track tickets: one tile of CHAIN_TILE
    samples split between them, a power of two and whole warps (CTAs of
    CHAIN_TILE / 32 threads) each: 4,096 mono, 2,048 stereo."""
    if not 1 <= channels <= TRACK_CHANNELS:
        raise ValueError(f"K5's track tickets take 1 to {TRACK_CHANNELS} weighted channels, "
                         f"got {channels}")
    return CHAIN_TILE // channels


# channels up to which K3's ticket is one file's segment of all of them
# (csrc/iir_rows.cu: K3_TRACK_CH, the channels a tile's rows are cut for);
# a file of more takes a ticket per row
K3_TRACK_CHANNELS = 2


def k3_segment(channels: int) -> int:
    """Samples of each of a file's `channels` channels (1 to
    K3_TRACK_CHANNELS) in one of K3's track tickets: one tile of TP_TILE
    samples split between them, whole warps each: 8,192 mono, 4,096
    stereo."""
    if not 1 <= channels <= K3_TRACK_CHANNELS:
        raise ValueError(f"K3's track tickets take 1 to {K3_TRACK_CHANNELS} channels, "
                         f"got {channels}")
    return TP_TILE // channels


# look-back depth of K3, K4 and K7 (csrc/iir_tile.cuh: TILE_LOOKBACK): a
# row of N samples is N / (T (LOOKBACK + 1)) hops of its chain, 124 for
# K3's stereo tracks at 2^24 samples (62 on row tickets), 124 for K4; K5
# keeps 0
LOOKBACK = 32


def rows_shape(x: torch.Tensor, weights) -> tuple[int, int, int]:
    """(b, ch, N) of a (b, ch, N) or rows (b*ch, N) float32 input."""
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    ch = len(weights)
    if x.ndim == 3:
        b, c, n = x.shape
        if c != ch:
            raise ValueError(f"{ch} channel weights for {c} channels")
    elif x.ndim == 2:
        if ch == 0 or x.shape[0] % ch:
            raise ValueError(f"{x.shape[0]} rows are not tracks of {ch} channels")
        b, n = x.shape[0] // ch, x.shape[1]
    else:
        raise ValueError(f"x must be (b, ch, N) or (b*ch, N), got {tuple(x.shape)}")
    return b, ch, n


def _energy_plain(filt: BlockFilter, x, n_valid, weights, group):
    b, ch, n = rows_shape(x, weights)
    if group <= 0 or n % group:
        raise ValueError(f"group {group} does not divide N = {n}")
    dev = x.device
    filt = filt.to(dev)
    x3 = x.reshape(b, ch, n)
    y, _ = block_iir(filt, x3, x3.new_zeros((b, ch, filt.A.shape[0])))
    z = x3.new_zeros((b, n))
    for c, w in enumerate(weights):
        if float(w) != 0.0:
            z = z + float(w) * (y[:, c] * y[:, c])
    valid = torch.arange(n, device=dev)[None] < n_valid.to(dev, torch.int64)[:, None]
    z = torch.where(valid, z, 0.0)
    return z.reshape(b, n // group, group).sum(dim=-1) if group > 1 else z


def kweight_energy_prefix_plain(filt: BlockFilter, x, n_valid, weights, group=1):
    """Plain PyTorch version of K4 (and K5): block_iir, the channel-weighted
    square in channel order, the mask, then the group sums."""
    return _energy_plain(filt, x, n_valid, weights, group)


def kweight_energy_chain_plain(filt: BlockFilter, x, n_valid, weights, group=1):
    """Plain PyTorch version of K5: the same function as K4's."""
    return _energy_plain(filt, x, n_valid, weights, group)


def kweight_energy_tp_prefix_plain(filt: BlockFilter, x, n_valid, weights,
                                   rate: int, group=1):
    """Plain PyTorch version of K3: K4's z plus true_peak_masked per row."""
    z = _energy_plain(filt, x, n_valid, weights, group)
    b, ch, n = rows_shape(x, weights)
    nv = n_valid.to(x.device, torch.int64).repeat_interleave(ch)
    tp, sp = true_peak_masked(x.reshape(b * ch, n), nv[:, None], rate)
    return z, tp, sp


def _launchable(filt: BlockFilter, x, n_valid, weights, what: str):
    """Check a CUDA input; returns (b, ch, n, nv int64 (b,))."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, not {x.device}")
    b, ch, n = rows_shape(x, weights)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be contiguous and 16-byte aligned")
    if n % 128:
        raise ValueError(f"{what}: N must be a multiple of 128, got {n}")
    if filt.A.shape != (4, 4):
        raise ValueError(f"{what} is built for the 4-state K-weighting cascade")
    nv = n_valid.to(x.device, torch.int64).contiguous()
    if nv.shape != (b,):
        raise ValueError(f"n_valid must be ({b},), got {tuple(nv.shape)}")
    return b, ch, n, nv


def _tile_checks(filt, group, ch, what):
    if group <= 0 or iir_tile.TS % group:
        raise ValueError(f"{what}: group {group} does not divide {iir_tile.TS}")
    if not iir_tile.modal_filter(filt):
        raise ValueError(f"{what} is built for the 4-state K-weighting cascade")
    if ch > iir_tile.MAX_CH:
        raise ValueError(f"{what} takes at most {iir_tile.MAX_CH} channels, got {ch}")


def _tile_rows(filt, x, n_valid, weights, group, T, lookback, what):
    """Launch ss_kweight_energy_rows on the tile-scan core: K4 or K5 over
    the rows of nonzero weight, then `channel_sum`; `what` names the kernel
    first. Returns z."""
    b, ch, n, nv = _launchable(filt, x, n_valid, weights, what)
    _tile_checks(filt, group, ch, what)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    w = np.asarray([float(v) for v in weights], np.float32)
    sync = iir_tile.sync_buffer(b * int(np.count_nonzero(w)), -(-n // T), dev)
    zr = torch.empty((b * ch, n // group), **f32)
    z = torch.empty((b, n // group), **f32)

    from soundscope_tpu_torch.ops import _build

    _build.launch("ss_kweight_energy_rows", what, dev,
                  x.data_ptr(), nv.data_ptr(), iir_tile.tile_constants(filt, T).ctypes.data,
                  w.ctypes.data, b, ch, n, group, T, lookback, sync.data_ptr(),
                  zr.data_ptr(), z.data_ptr())
    return z


def _k3_tile(filt, x, n_valid, weights, group, factor, what):
    """Launch ss_kweight_energy_tp_tracks: K3 (`k3_tile_tracks`) on tickets
    of one file's segment of its 1 to K3_TRACK_CHANNELS channels, or of one
    row's segment then `channel_sum` for more channels, then `peaks_pass`.
    Adds the rows times their segments of TP_TILE to `k3.segments` and the
    tickets of files, b ceil(N / k3_segment(ch)) or 0, to
    `k3.track_tickets`. Returns (z, tp, sp)."""
    b, ch, n, nv = _launchable(filt, x, n_valid, weights, what)
    _tile_checks(filt, group, ch, what)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    tracks = ch <= K3_TRACK_CHANNELS
    Tc = k3_segment(ch) if tracks else TP_TILE
    rows, nseg = b * ch, -(-n // Tc)
    w = np.asarray([float(v) for v in weights], np.float32)
    sync = iir_tile.sync_buffer(rows, nseg, dev)
    z = torch.empty((b, n // group), **f32)
    zr = None if tracks else torch.empty((rows, n // group), **f32)
    tp_part, sp_part, tp, sp = [torch.empty(s, **f32) for s in
                                ((rows, nseg), (rows, nseg), (rows,), (rows,))]

    from soundscope_tpu_torch.ops import _build

    _build.launch("ss_kweight_energy_tp_tracks", what, dev,
                  x.data_ptr(), nv.data_ptr(), iir_tile.tile_constants(filt, Tc).ctypes.data,
                  iir_tile.lane_powers(filt).ctypes.data, iir_tile.fir_taps(factor).ctypes.data,
                  w.ctypes.data, factor, b, ch, n, group, Tc, sync.data_ptr(),
                  None if zr is None else zr.data_ptr(), z.data_ptr(),
                  tp_part.data_ptr(), sp_part.data_ptr(), tp.data_ptr(), sp.data_ptr())
    GLOBAL.count("k3.segments", rows * -(-n // TP_TILE))
    GLOBAL.count("k3.track_tickets", b * nseg if tracks else 0)
    return z, tp, sp


def kweight_energy_tp_prefix(filt: BlockFilter, x: torch.Tensor,
                             n_valid: torch.Tensor, weights, rate: int,
                             group: int = 1):
    """Energy + true/sample peak (K3; JAX: kweight_energy_tp_pallas_prefix).

    x: (b, ch, N) or (b*ch, N) float32, N % 128 == 0 on CUDA. n_valid: (b,)
    integer valid lengths. weights: the ch channel weights. rate: the
    sample rate, which must need oversampling (< 192 kHz). On CUDA the
    group divides 32, and the call is one launch of `k3_tile_tracks`:
    files of 1 to K3_TRACK_CHANNELS channels on tickets of a file's
    segment (`k3_segment(ch)` samples a channel, z written by the launch),
    more channels on tickets of a row's segment of TP_TILE, then
    `channel_sum`; either then `peaks_pass`. The call adds its rows times
    their segments of TP_TILE to the counter `k3.segments`, and its
    tickets of files, b ceil(N / k3_segment(ch)) or 0, to
    `k3.track_tickets`. Returns (z (b, N/group), tp (rows,), sp (rows,)).
    """
    factor = C.true_peak_factor(rate)
    if factor == 1:
        raise ValueError("K3 needs an oversampling true-peak factor (rate < 192 kHz)")
    if x.device.type == "cpu":
        return kweight_energy_tp_prefix_plain(filt, x, n_valid, weights, rate, group)
    return _k3_tile(filt, x, n_valid, weights, group, factor, "K3 kweight_energy_tp_prefix")


def kweight_energy_prefix(filt: BlockFilter, x: torch.Tensor,
                          n_valid: torch.Tensor, weights, group: int = 1):
    """Energy (K4; JAX: kweight_energy_pallas_prefix): z (b, N/group). On
    CUDA the group divides 32."""
    if x.device.type == "cpu":
        return kweight_energy_prefix_plain(filt, x, n_valid, weights, group)
    return _tile_rows(filt, x, n_valid, weights, group, CHAIN_TILE, LOOKBACK,
                      "K4 kweight_energy_prefix")


def kweight_energy_chain(filt: BlockFilter, x: torch.Tensor,
                         n_valid: torch.Tensor, weights, group: int = 1):
    """Energy (K5; JAX: kweight_energy_pallas) on the tile-scan core with
    the plain chain: z (b, N/group), as `kweight_energy_prefix`. On CUDA
    the group divides 32. With 1 to TRACK_CHANNELS channels of nonzero
    weight a ticket is one track's segment of them (`chain_segment`
    samples each): one launch after the reset of its records, the segments
    past n_valid skipped and added, on the device, to the counter
    `k5.segments_skipped`; otherwise K4's kernel without the look-back, a
    ticket per row, and `channel_sum`. Either way the tickets times their
    channels are added to `k5.segments`."""
    what = "K5 kweight_energy_chain"
    if x.device.type == "cpu":
        return kweight_energy_chain_plain(filt, x, n_valid, weights, group)
    w = np.asarray([float(v) for v in weights], np.float32)
    na = int(np.count_nonzero(w))
    if not 1 <= na <= TRACK_CHANNELS:
        b, _, n = rows_shape(x, weights)
        z = _tile_rows(filt, x, n_valid, weights, group, CHAIN_TILE, 0, what)
        GLOBAL.count("k5.segments", b * na * -(-n // CHAIN_TILE))
        return z
    b, ch, n, nv = _launchable(filt, x, n_valid, weights, what)
    _tile_checks(filt, group, ch, what)
    dev = x.device
    Tc = chain_segment(na)
    nseg = -(-n // Tc)
    consts = iir_tile.tile_constants(filt, Tc)
    sync = iir_tile.sync_buffer(b * na, nseg, dev, iir_tile.INCL_WORDS)
    z = torch.empty((b, n // group), dtype=torch.float32, device=dev)

    from soundscope_tpu_torch.ops import _build

    _build.launch("ss_kweight_energy_chain", what, dev,
                  x.data_ptr(), nv.data_ptr(), consts.ctypes.data,
                  iir_tile.lane_powers(filt).ctypes.data, w.ctypes.data, b, ch, n,
                  group, CHAIN_TILE, Tc, sync.data_ptr(), z.data_ptr(),
                  _skipped_cell(dev).data_ptr())
    GLOBAL.count("k5.segments", b * nseg * na)
    return z


@functools.lru_cache(maxsize=None)
def _skipped_cell(device: torch.device) -> torch.Tensor:
    """The device's count of K5's channel segments past n_valid, which the
    registry reads as `k5.segments_skipped`."""
    cell = torch.zeros(1, dtype=torch.int64, device=device)
    GLOBAL.count_on_device("k5.segments_skipped", cell)
    return cell


def rows_attributes(factor: int, lookback: int, tracks: bool = False) -> dict:
    """Resources of K3's kernel `k3_tile_tracks` (factor 2 or 4, at TP_TILE,
    groups of 32; both of its tickets) or of K4's (factor 0, lookback
    LOOKBACK) or K5's (factor 0, lookback 0: on track tickets if `tracks`,
    else on row tickets), at CHAIN_TILE, as the CUDA runtime reports them
    (needs a card): registers per thread, static and dynamic shared memory
    bytes per CTA, local (spill) bytes per thread, threads per CTA and CTAs
    per SM."""
    from soundscope_tpu_torch.ops import _build

    return _build.attributes("ss_kweight_energy_rows_attrs", factor,
                             TP_TILE if factor else CHAIN_TILE, lookback, int(tracks))


def block_iir_stream_plain(filt: BlockFilter, x: torch.Tensor, s0: torch.Tensor):
    """Plain PyTorch version of K7: ops/biquad.block_iir."""
    return block_iir(filt.to(x.device), x, s0)


def block_iir_stream(filt: BlockFilter, x: torch.Tensor, s0: torch.Tensor):
    """Filter x (..., N) float32 from the state s0 (..., 4) (K7).

    Returns (y (..., N), s_final (..., 4)), as ops/biquad.block_iir. x may
    be a strided view (the meter's channels of interleaved audio): the
    kernel reads it through its strides. N = 0 launches nothing. On CUDA
    a call is one launch, after a reset of its record buffer when a row
    spans more than one segment, and allocates only y and s_final.
    """
    what = "K7 block_iir_stream"
    if x.device.type == "cpu":
        return block_iir_stream_plain(filt, x, s0)
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, not {x.device}")
    if x.dtype != torch.float32 or s0.dtype != torch.float32:
        raise TypeError(f"{what}: x and s0 must be float32")
    if not iir_tile.modal_filter(filt):
        raise ValueError(f"{what} is built for the 4-state K-weighting cascade")
    batch, n = x.shape[:-1], x.shape[-1]
    if tuple(s0.shape) != (*batch, 4) or s0.device != x.device:
        raise ValueError(f"{what}: s0 must be {(*batch, 4)} on {x.device}, "
                         f"got {tuple(s0.shape)} on {s0.device}")
    rows = math.prod(batch)
    if n == 0 or rows == 0:
        return x.new_empty(x.shape), s0.clone()
    x2 = x.reshape(rows, n)
    s0c = s0.reshape(rows, 4).contiguous()
    T = CHAIN_TILE
    nseg = -(-n // T)
    dev = x.device
    consts = iir_tile.tile_constants(filt, T)
    ar = iir_tile.power_blocks(filt, (n - 1) % iir_tile.TS + 1)
    sync = None
    if nseg > 1:
        sync = _stream_records(dev, torch.cuda.current_stream(dev).cuda_stream, rows, nseg)
        sync.fill_(-1)
    y = torch.empty((rows, n), dtype=torch.float32, device=dev)
    s_out = torch.empty((rows, 4), dtype=torch.float32, device=dev)

    from soundscope_tpu_torch.ops import _build

    _build.launch("ss_block_iir_stream", what, dev,
                  x2.data_ptr(), x2.stride(0), x2.stride(1), s0c.data_ptr(), consts.ctypes.data,
                  ar.ctypes.data, rows, n, T, None if sync is None else sync.data_ptr(),
                  y.data_ptr(), s_out.data_ptr())
    return y.reshape(*batch, n), s_out.reshape(*batch, 4)


@functools.lru_cache(maxsize=8)
def _stream_records(device: torch.device, stream: int, rows: int, nseg: int):
    """K7's record buffer for one (device, stream, rows, segments): the
    caller resets it before each launch, in stream order."""
    return iir_tile.sync_buffer(rows, nseg, device)


def stream_attributes() -> dict:
    """Resources of K7's kernel at segments of CHAIN_TILE samples, as the
    CUDA runtime reports them (needs a card); the keys of
    `rows_attributes`."""
    from soundscope_tpu_torch.ops import _build

    return _build.attributes("ss_block_iir_stream_attrs", CHAIN_TILE)


def block_iir_zero(filt: BlockFilter, x: torch.Tensor) -> torch.Tensor:
    """Zero-initial-state filtering of (..., N) (K7; JAX: block_iir_pallas)."""
    y, _ = block_iir_stream(filt, x, x.new_zeros((*x.shape[:-1], 4)))
    return y
