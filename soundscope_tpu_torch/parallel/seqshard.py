"""Sequence-sharded whole-file analysis over torch.distributed.

The counterpart of the JAX package's parallel/seqshard.py. For files too
long for one device, or to cut latency, the time axis is split across the
mesh's "seq" axis. The K-weighting IIR carries state across shard
boundaries; the hand-off is exact, by the affine-map trick:

  1. every shard filters its samples from zero state, giving its output
     and its boundary map s_out = s_in @ P_total + f0 (P_total the state
     propagator across one shard, the same on every shard);
  2. the shards' end states f0 (4 floats a row) are all-gathered over
     "seq", and each shard composes its true incoming state s0 from those
     of the shards before it, in float64;
  3. each shard makes its output exact for s0.

The filter is K7 (ops/iir.block_iir_stream, "the filter from a carried
state"; its plain version on a CPU tensor): pass 1 from zero state gives
y0 and f0; shards after the first run it again from s0 for the exact y
(shard 0's s0 is zero, so it keeps y0): one launch for shard 0, two for
every other. The JAX package's route, ops/biquad.block_iir_parts and the
state response (s0 @ P[j]) @ Ot per block, computes the same output; the
port keeps it for its tests only, since its (nb, 4, 4) table P would be
173 MB a shard of a 2-hour programme.

The true peak needs k - 1 samples of left context (k the interpolator's
taps per phase: 12 at 4x, 24 at 2x): each shard's masked last k - 1
samples are all-gathered (the JAX package's ppermute) and the next shard
takes its neighbour's. The peaks of all shards are all-gathered and
reduced by a max that keeps NaN, as the port's peaks do (a backend's MAX
need not). The 100 ms sums are all-gathered too, so every shard finishes
with the exact global integrated loudness, LRA and timelines, through
the single-device engine's own tail (models/engine._finish).

A shard's steps are one generator, `shard_steps`, which yields each
tensor the seq axis gathers and is sent every shard's. `sharded_analyze_fn`
drives it with dist.all_gather on the rank's seq group; `composed_parts`
drives every shard's generator in lockstep in one process. A card takes
one NCCL rank, so that is how one card runs a 4-shard hand-off, and both
run one order of steps.

The weighted square, the sub-block sums and the shard's true peak
(ops/truepeak.polyphase_outputs on the left context and the shard, masked
at n_valid, with the sample peak) are plain ops, as in the JAX package.
Each shard is a multiple of shard_granularity(cfg) samples long;
pad_for_mesh gives the padded length.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist

from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.core.device import upload
from soundscope_tpu_torch.models.engine import AnalysisResult, _finish
from soundscope_tpu_torch.ops import loudness as L
from soundscope_tpu_torch.ops.biquad import BlockFilter, kweight_filter
from soundscope_tpu_torch.ops.iir import block_iir_stream
from soundscope_tpu_torch.ops.kweight import channel_weights
from soundscope_tpu_torch.ops.truepeak import _polyphase_taps, polyphase_outputs
from soundscope_tpu_torch.parallel.mesh import mesh_device

# samples of a shard whose interpolator outputs are taken at a time: a
# whole 2-hour shard at 4x would be 2.8 G outputs, past 2^31 and 11 GB
PEAK_CHUNK = 1 << 23


def shard_granularity(cfg: MeterConfig) -> int:
    return math.lcm(cfg.block, cfg.subblock)


def pad_for_mesh(n: int, cfg: MeterConfig, n_seq: int) -> int:
    g = shard_granularity(cfg) * n_seq
    return -(-n // g) * g


@functools.lru_cache(maxsize=None)
def _propagator(rate: int, block: int, nloc: int):
    """(A^nloc)^T in float64: the state propagator across one shard."""
    filt = kweight_filter(rate, block)
    return filt.power(nloc).T.copy()


def _setup(cfg: MeterConfig, x: torch.Tensor, nloc: int):
    """(the filter on x's device, the shard propagator there in float64)."""
    if x.ndim != 3 or x.shape[1] != cfg.channels or x.dtype != torch.float32:
        raise ValueError(f"x must be (B, {cfg.channels}, N) float32, "
                         f"got {tuple(x.shape)} {x.dtype}")
    g = shard_granularity(cfg)
    if nloc % g:
        raise ValueError(f"a shard of {nloc} samples is no multiple of {g} "
                         "(pad with pad_for_mesh)")
    filt = kweight_filter(cfg.rate, cfg.block, x.device)
    return filt, upload(_propagator(cfg.rate, cfg.block, nloc), x.device)


def incoming_state(f0s: torch.Tensor, idx: int, p_total: torch.Tensor) -> torch.Tensor:
    """Shard idx's true incoming state, float64 (B, C, 4), from the end
    states f0s (S, B, C, 4) float64 of all shards:
    sum_(k < idx) f0s[k] @ p_total^(idx - 1 - k), by Horner's rule."""
    s = torch.zeros_like(f0s[0])
    for k in range(idx):
        s = s @ p_total + f0s[k]
    return s


def exact_output(filt: BlockFilter, x: torch.Tensor, y0: torch.Tensor,
                 s0: torch.Tensor, idx: int) -> torch.Tensor:
    """The shard's exact K-weighted output (B, C, n) for its incoming state
    s0. Shard 0 enters from zero: its pass-1 output y0. A later shard runs
    the filter again from s0 (a second K7 launch on a CUDA tensor)."""
    if idx == 0:
        return y0
    return block_iir_stream(filt, x, s0.float())[0]


def _valid(n_valid: torch.Tensor, start: int, n: int, device) -> torch.Tensor:
    """(B, 1, n): positions start .. start + n - 1 below each n_valid."""
    pos = start + torch.arange(n, device=device)
    return pos < n_valid[:, None, None]


def shard_sums(cfg: MeterConfig, y: torch.Tensor, n_valid: torch.Tensor,
               start: int) -> torch.Tensor:
    """100 ms sums (B, n / subblock) of the channel-weighted square of the
    shard's output y, which starts at sample `start`, masked at n_valid."""
    y = torch.where(_valid(n_valid, start, y.shape[-1], y.device), y, 0.0)
    z = L.weighted_square(y, upload(channel_weights(cfg.channels), y.device))
    return L.subblock_sums(z, cfg.subblock)


def _taps_per_phase(cfg: MeterConfig) -> int:
    factor = cfg.true_peak_factor
    return 1 if factor == 1 else _polyphase_taps(factor).shape[1]


def left_context(cfg: MeterConfig, x: torch.Tensor, n_valid: torch.Tensor,
                 start: int) -> torch.Tensor:
    """The shard's last k - 1 samples (B, C, k - 1), masked at n_valid:
    the context of the next shard's true peak (none at factor 1)."""
    n, k = x.shape[-1], _taps_per_phase(cfg)
    tail = x[..., n - (k - 1):]
    return torch.where(_valid(n_valid, start + n - (k - 1), k - 1, x.device), tail, 0.0)


def shard_peaks(cfg: MeterConfig, x: torch.Tensor, left: torch.Tensor,
                n_valid: torch.Tensor, start: int):
    """(true peak, sample peak), each (B, C), of the shard x (B, C, n) that
    starts at sample `start`, with `left` the context from the shard
    before (zeros for the first). Samples at and past n_valid count as 0
    and interpolator outputs there do not count; tp = max(tp, sp). The
    interpolator runs over PEAK_CHUNK samples at a time, each chunk with
    its own k - 1 samples of context; a max is associative, so the chunks
    change no value. Maxima keep NaN."""
    n, k = x.shape[-1], _taps_per_phase(cfg)
    factor = cfg.true_peak_factor
    tp = sp = x.new_zeros(x.shape[:-1])
    for a in range(0, n, PEAK_CHUNK):
        b = min(a + PEAK_CHUNK, n)
        valid = _valid(n_valid, start + a, b - a, x.device)
        seg = torch.where(valid, x[..., a:b], 0.0)
        sp = torch.maximum(sp, seg.abs().amax(dim=-1))
        if factor > 1:
            ctx = left if a == 0 else torch.where(
                _valid(n_valid, start + a - (k - 1), k - 1, x.device),
                x[..., a - (k - 1):a], 0.0)
            y = polyphase_outputs(torch.cat([ctx, seg], dim=-1), factor)
            y = torch.where(valid.unsqueeze(-2), y, 0.0)
            tp = torch.maximum(tp, y.abs().amax(dim=(-2, -1)))
    return torch.maximum(tp, sp), sp


def shard_steps(cfg: MeterConfig, x: torch.Tensor, n_valid: torch.Tensor, idx: int):
    """The analysis of shard idx, x (B, C, n) from sample idx * n, with
    n_valid (B,) int64 on x's device, as a generator: it yields each tensor
    that the seq axis all-gathers and is sent the list of every shard's, in
    shard order. It returns the gathered parts every shard then holds:
    (sums (B, N / subblock), true peak, sample peak), each peak (B, C)."""
    nloc = x.shape[-1]
    start = idx * nloc
    filt, p_total = _setup(cfg, x, nloc)
    y0, f0 = block_iir_stream(filt, x, x.new_zeros((*x.shape[:-1], 4)))
    f0s = torch.stack((yield f0.double()))
    y = exact_output(filt, x, y0, incoming_state(f0s, idx, p_total), idx)
    del y0
    sums = shard_sums(cfg, y, n_valid, start)
    del y
    lefts = yield left_context(cfg, x, n_valid, start)
    tp, sp = shard_peaks(cfg, x, lefts[idx - 1] if idx else torch.zeros_like(lefts[0]),
                         n_valid, start)
    allsums = torch.cat((yield sums), dim=-1)
    tp = torch.stack((yield tp)).amax(dim=0)
    sp = torch.stack((yield sp)).amax(dim=0)
    return allsums, tp, sp


def _gather(t: torch.Tensor, group, size: int) -> list:
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def sharded_analyze_fn(cfg: MeterConfig, mesh):
    """The analysis of one rank's block on a (data, seq) mesh:
    fn(x (B_loc, C, N_loc), n_valid (B_loc,)) -> AnalysisResult of the
    rank's tracks (their whole length), the same on every rank of a seq
    group. x is the rank's block of the global batch (global_batch) on the
    mesh's device; N_loc is a multiple of shard_granularity(cfg).

    Raises where no process group is initialised or x or n_valid is not on
    the mesh's device: it never runs the single-device engine instead.
    """
    n_seq = mesh.shape[1]

    def fn(x: torch.Tensor, n_valid: torch.Tensor) -> AnalysisResult:
        if not dist.is_initialized():
            raise RuntimeError("sharded analysis needs a process group: "
                               "call init_distributed first")
        dev = mesh_device(mesh)
        if x.device != dev or n_valid.device != dev:
            raise ValueError(f"x on {x.device} and n_valid on {n_valid.device}: "
                             f"this rank's mesh device is {dev}")
        group, idx = mesh.get_group("seq"), mesh.get_local_rank("seq")
        nv = n_valid.to(torch.int64)
        steps = shard_steps(cfg, x, nv, idx)
        try:
            part = next(steps)
            while True:
                part = steps.send(_gather(part, group, n_seq))
        except StopIteration as done:
            sums, tp, sp = done.value
        return _finish(cfg, sums, nv, tp, sp)

    return fn


def composed_parts(cfg: MeterConfig, x: torch.Tensor, n_valid: torch.Tensor,
                   n_seq: int):
    """The gathered parts of the sequence-sharded analysis of a (B, C, N)
    batch as n_seq shards in this process: (sums (B, N / subblock), tp,
    sp), what every rank of sharded_analyze_fn holds after its gathers.
    Every shard (a contiguous copy, as a rank holds it) runs shard_steps;
    the generators advance in lockstep, each step's yields in shard order
    standing in for the gather."""
    if x.shape[-1] % n_seq:
        raise ValueError(f"N = {x.shape[-1]} does not split into {n_seq} shards")
    nloc = x.shape[-1] // n_seq
    nv = n_valid.to(x.device, torch.int64)
    steps = [shard_steps(cfg, x[..., k * nloc:(k + 1) * nloc].contiguous(), nv, k)
             for k in range(n_seq)]
    parts = None
    while True:
        try:
            parts = [s.send(parts) for s in steps]
        except StopIteration as done:
            # every shard ends at the same step, holding the same parts
            return done.value


def composed_analyze(cfg: MeterConfig, x: torch.Tensor, n_valid: torch.Tensor,
                     n_seq: int) -> AnalysisResult:
    """The sequence-sharded analysis of a (B, C, N) batch as n_seq shards
    in this process (composed_parts, then the engine's tail). The result
    equals a run of ranks on the same device over the same blocks bit for
    bit (gloo ranks on the CPU, one NCCL rank on a card)."""
    sums, tp, sp = composed_parts(cfg, x, n_valid, n_seq)
    return _finish(cfg, sums, n_valid.to(x.device, torch.int64), tp, sp)


def gather_tracks(mesh, res: AnalysisResult, axis: str = "data") -> AnalysisResult:
    """Every rank's per-track results concatenated over a mesh axis, in
    mesh order (the JAX package's process_allgather): the whole batch's
    result on every rank. The ranks' results have equal shapes."""
    group, size = mesh.get_group(axis), mesh.shape[mesh.mesh_dim_names.index(axis)]
    return AnalysisResult(**{
        name: torch.cat(_gather(getattr(res, name), group, size), dim=0)
        for name in AnalysisResult.__dataclass_fields__})
