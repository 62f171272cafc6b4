"""Streaming BS.1770-4 meter: a transition and queries on an explicit state.

    step   = meter_step(cfg)
    state' = step(state, chunk (C, L))
    lufs   = shortterm_lufs(cfg, state')        # etc.

The port of the JAX package's models/meter.py. The state (core/state.py)
lives on the chunk's device; the step filters through K7
(ops/iir.block_iir_stream: the kernel on a CUDA tensor, the blocked filter
on a CPU tensor) and computes everything else with tensor ops on that
device. A push of a CUDA tensor never waits for the device: the rings are
rolled by index arithmetic on device tensors, every shape depends on the
chunk length alone, and the constants are uploaded without a host sync at
the first push on a device; the one wait is the K-weighting filter's, for
its upload, at its first use in the process (ops/biquad.kweight_filter).

Exactness notes (as in the JAX package):
* momentary / short-term are computed from a ring of the channel-weighted
  squared K-weighted signal, so the 400 ms / 3 s windows end at the last
  pushed sample exactly, not quantised to 100 ms.
* gating and LRA histories are kept both exactly (fixed capacity
  cfg.max_blocks) and as libebur128-style histograms; queries use the
  exact history until it overflows, then the histogram (<= 0.04 LU
  quantisation), giving unbounded stream duration.

The JAX step walks the sub-blocks a push completes in a Python loop of
about a dozen ops each (eleven passes for a 1 s slab). Here they are
handled at once: the last 30 completed sub-block sums, oldest first,
followed by this push's give every gating and LRA energy as a window sum
and the new sub-block ring as a gather; the exact histories take one
scatter each and the histograms one `index_add` each. The energies are the
JAX loop's sums, taken in chronological order. On an H100 this issues 144
device operations per 1 s slab where a literal port of the loop issues
1,028 and takes 3.6x-8.3x the time, and 129 per 800-frame tick against
143 (chip_smoke.py, PERF.md).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from soundscope_tpu_torch.core import constants as C
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.core.device import upload
from soundscope_tpu_torch.core.state import MeterState, init_meter_state
from soundscope_tpu_torch.ops import loudness as L
from soundscope_tpu_torch.ops.biquad import kweight_filter
from soundscope_tpu_torch.ops.iir import block_iir_stream
from soundscope_tpu_torch.ops.kweight import channel_weights
from soundscope_tpu_torch.ops.truepeak import oversampled_abs_peak, sample_peak

_S = C.SHORTTERM_SUBBLOCKS    # 30 sub-blocks in the 3 s window and the ring
_M = C.MOMENTARY_SUBBLOCKS    # 4 sub-blocks in a 400 ms gating block


@functools.lru_cache(maxsize=None)
def _constants(cfg: MeterConfig, device: torch.device):
    """The K-weighting filter and the channel weights on `device`."""
    filt = kweight_filter(cfg.rate, cfg.block, device)
    weights = upload(channel_weights(cfg.channels).astype(np.float32), device)
    return filt, weights


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap, as JAX's int32 adds wrap."""
    return ((v + 2**31) % 2**32 - 2**31).to(torch.int32)


def _append(buf: torch.Tensor, count: torch.Tensor, emit: torch.Tensor,
            e: torch.Tensor) -> torch.Tensor:
    """buf with the emitted e[j] written at count, count + 1, ... in order
    of j, as far as buf reaches; the rest go to a slot past its end."""
    cap = buf.shape[0]
    at = count + torch.cumsum(emit.to(torch.int64), 0) - 1
    at = torch.where(emit & (at < cap), at, cap)
    return torch.cat([buf, buf[:1]]).index_put((at,), e)[:cap]


def _hist_add(hist: torch.Tensor, emit: torch.Tensor, hb: torch.Tensor) -> torch.Tensor:
    """hist with one count added at each emitted bin hb (-1: below the gate)."""
    add = (emit & (hb >= 0)).to(torch.int32)
    return hist.index_add(0, torch.clamp(hb, min=0).to(torch.int64), add)


@functools.lru_cache(maxsize=None)
def meter_step(cfg: MeterConfig):
    """The transition for a config: step(state, chunk (C, L)) -> state, for
    any chunk length L >= 1, on the chunk's device."""
    h = cfg.subblock
    ring_n = cfg.shortterm_window
    exact = cfg.max_blocks > 0

    def step(state: MeterState, chunk: torch.Tensor) -> MeterState:
        _, n = chunk.shape
        dev = chunk.device
        filt, weights = _constants(cfg, dev)
        y, filt_state = block_iir_stream(filt, chunk, state.filt_state)
        z = L.weighted_square(y, weights)                         # (n,)

        # --- z ring: the most recent 3 s, ring[(z_pos + j) % R] j-th oldest
        z_pos0 = state.z_pos.to(torch.int64)
        if n >= ring_n:
            # the newest R values, rolled by z_pos + n (only these are written)
            idx = (torch.arange(ring_n, device=dev) - (z_pos0 + n)) % ring_n
            z_ring = z[-ring_n:][idx]
        else:
            idx = (z_pos0 + torch.arange(n, device=dev)) % ring_n
            z_ring = state.z_ring.index_put((idx,), z)
        z_pos = ((z_pos0 + n) % ring_n).to(torch.int32)

        # --- 100 ms sub-block sums of this push (float64, one rounding) ---
        k_max = n // h + 1
        fill = state.subblock_fill.to(torch.int64)
        b = (fill + torch.arange(n, device=dev)) // h
        onehot = (b[:, None] == torch.arange(k_max + 1, device=dev)[None, :]).to(torch.float64)
        sums = z.to(torch.float64) @ onehot
        sums[0] += state.subblock_partial.to(torch.float64)
        sums = sums.to(torch.float32)                              # (k_max + 1,)
        k_complete = (fill + n) // h
        # (index_select: a 0-d index tensor would be read on the host)
        new_partial = sums.index_select(0, torch.clamp(k_complete, max=k_max).reshape(1))[0]

        # --- gating (400 ms) and LRA (3 s at 1 s hop) blocks -------------
        # ext[i] is sub-block done - 30 + i: the last 30 completed ones,
        # oldest first, then this push's. The j-th new sub-block ends a
        # gating block of the 4 and an LRA block of the 30 up to ext[30 + j].
        done = state.subblocks_done.to(torch.int64)
        last30 = torch.arange(_S, device=dev)
        ext = torch.cat([state.subblock_ring[(done + last30) % _S], sums[:k_max]])
        e_g = ext.unfold(0, _M, 1)[_S - _M + 1:][:k_max].sum(-1) / (_M * h)
        e_l = ext.unfold(0, _S, 1)[1:][:k_max].sum(-1) / (_S * h)
        j1 = torch.arange(1, k_max + 1, device=dev)       # j + 1
        completes = j1 <= k_complete
        n_done = done + j1
        emit_g = completes & (n_done >= _M)
        emit_l = (completes & (n_done >= _S)
                  & ((n_done - _S) % C.LRA_HOP_SUBBLOCKS == 0))
        # ring position p holds the completed sub-block m = p (mod 30)
        done2 = done + k_complete
        subblock_ring = ext[k_complete + (last30 - done2) % _S]

        block_energy, lra_energy = state.block_energy, state.lra_energy
        if exact:
            block_energy = _append(block_energy, state.block_count, emit_g, e_g)
            lra_energy = _append(lra_energy, state.lra_count, emit_l, e_l)
        block_count = state.block_count + emit_g.sum(dtype=torch.int32)
        lra_count = state.lra_count + emit_l.sum(dtype=torch.int32)
        bins = L.hist_bin_index(torch.cat([e_g, e_l]))     # one lookup for both

        # --- peaks ---
        tp, tp_tail = oversampled_abs_peak(chunk, state.tp_tail, cfg.true_peak_factor)
        return MeterState(
            filt_state=filt_state,
            z_ring=z_ring,
            z_pos=z_pos,
            frames_total=_wrap_int32(state.frames_total.to(torch.int64) + n),
            subblock_partial=new_partial,
            subblock_fill=((fill + n) % h).to(torch.int32),
            subblock_ring=subblock_ring,
            subblocks_done=_wrap_int32(done2),
            block_energy=block_energy,
            block_count=block_count,
            lra_energy=lra_energy,
            lra_count=lra_count,
            block_hist=_hist_add(state.block_hist, emit_g, bins[:k_max]),
            lra_hist=_hist_add(state.lra_hist, emit_l, bins[k_max:]),
            true_peak=torch.maximum(state.true_peak, tp),
            sample_peak=torch.maximum(state.sample_peak, sample_peak(chunk)),
            tp_tail=tp_tail,
        )

    return step


def _window_energy(cfg: MeterConfig, state: MeterState, window: int):
    """Mean z over the newest `window` samples of the ring."""
    ring_n = cfg.shortterm_window
    idx = (state.z_pos.to(torch.int64) + (ring_n - window)
           + torch.arange(window, device=state.z_ring.device)) % ring_n
    return state.z_ring[idx].mean()


def momentary_lufs(cfg: MeterConfig, state: MeterState):
    return L.loudness_from_energy(_window_energy(cfg, state, cfg.momentary_window))


def shortterm_lufs(cfg: MeterConfig, state: MeterState):
    return L.loudness_from_energy(_window_energy(cfg, state, cfg.shortterm_window))


def integrated_lufs(cfg: MeterConfig, state: MeterState):
    hist_val = L.gated_loudness_hist(state.block_hist)
    if cfg.max_blocks == 0:
        return hist_val
    cap = cfg.max_blocks
    mask = torch.arange(cap, device=state.block_energy.device) < state.block_count
    exact_val = L.gated_loudness(state.block_energy, mask)
    return torch.where(state.block_count <= cap, exact_val, hist_val)


def loudness_range_lu(cfg: MeterConfig, state: MeterState):
    hist_val = L.loudness_range_hist(state.lra_hist)
    if cfg.max_blocks == 0:
        return hist_val
    lcap = cfg.max_lra_blocks
    mask = torch.arange(lcap, device=state.lra_energy.device) < state.lra_count
    exact_val = L.loudness_range(state.lra_energy, mask)
    return torch.where(state.lra_count <= lcap, exact_val, hist_val)


def true_peak_linear(state: MeterState):
    return state.true_peak


__all__ = [
    "MeterState",
    "init_meter_state",
    "meter_step",
    "momentary_lufs",
    "shortterm_lufs",
    "integrated_lufs",
    "loudness_range_lu",
    "true_peak_linear",
]
