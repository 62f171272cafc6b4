#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero before the result line):

1. CUDA present; build the kernels (K1-K6) from soundscope_tpu_torch/csrc.
2. K1 against its plain PyTorch version on the card: the CPU tests' cases
   (48 kHz and 44.1 kHz ragged, 96 kHz) and the bench shape (32 tracks x
   60 s of 48 kHz stereo): sub-block sums rtol 3e-4 / atol 2e-5, true peak
   rtol 2e-6 / atol 1e-7, sample peak exact.
3. K2 against its plain version at 48 kHz and 44.1 kHz and at the bench
   shape: at most 1e-3 dB.
4. The main path at full size (analyze_batch_native, then
   stft_pooled_frames, on (32, 2, N/128, 128) float32 made on the card
   from a seeded generator): both kernels launched, every output finite
   and of the expected shape; the same path on a small slice agrees with
   the plain versions on the CPU; EBU Tech 3341 case 1 reads -23.0 LUFS.
5. The CLI (`analyze --json --spectrogram`) in-process on WAV files this
   script writes: every row complete, K1 and K2 launched.
6. Timings with CUDA events: K1 and K2 against their plain versions at
   the bench shape, and the main path's audio-seconds per second.
7. K3, K4, K5 (ops/iir.py) and K6 (ops/truepeak_stream.py) against their
   plain versions on the card: the CPU tests' cases, then each at its
   configuration's shape (K5 and K6 on a 64-row slice of the library scan
   at full length). z per group rtol 1e-3 / atol 1e-6 * max|z|, sub-block
   sums rtol 3e-4 / atol 2e-5, true peak rtol 2e-6 / atol 1e-7, sample
   peak exact.
8. The rows-layout engine path in three configurations at full size, each
   with the launch counts set to 0 just before and read just after:
   the 1,000-track library scan (rows (2000, 720000) through
   analyze_batch_native: K5 + K6), one 240 s 48 kHz stereo file through
   analyze_array (EBU Tech 3341 case 1, -23.0 LUFS: K3) and a 60 s 5.1
   track at 192 kHz through analyze_array (K4); shapes, finiteness, and a
   small slice against the plain path on the CPU.
9. Timings with CUDA events: K3-K6 against their plain versions, K4 and
   K5 both at the library shape, the library scan in ms per scan and
   tracks per second, the single-file path in ms.

The plain versions run with TF32 off. Prints one JSON line of per-kernel
numbers, the card's name and power limit, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 1234
RATE = 48000
TRACKS = 32
SECONDS = 60


class SmokeFailure(Exception):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def check_close(what, got, want, rtol, atol) -> float:
    import torch

    require(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    got, want = got.double().cpu(), want.double().cpu()
    bad = (got - want).abs() > atol + rtol * want.abs()
    bad |= torch.isnan(got) != torch.isnan(want)
    require(not bool(bad.any()),
            f"{what}: {int(bad.sum())} values outside rtol {rtol} atol {atol} "
            f"(max abs err {max_err(got, want):.3e})")
    return max_err(got, want)


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call on the current stream (after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def noise(gen, shape, dev):
    """Seeded noise with a louder second half (keeps gates and LRA busy)."""
    import torch

    x = torch.randn(shape, generator=gen, device=dev) * 0.1
    x[..., x.shape[-2] // 2:, :] *= 3.0
    return x


def rows_noise(gen, shape, dev):
    """Seeded noise over (..., N) with a louder second half in time."""
    import torch

    x = torch.randn(shape, generator=gen, device=dev) * 0.1
    x[..., x.shape[-1] // 2:] *= 3.0
    return x


def energy_close(what, got, want, h, group) -> float:
    """K3-K5 z against its plain version: per group and as 100 ms sums."""
    err = check_close(f"{what} z", got, want, 1e-3,
                      1e-6 * float(want.abs().max()))
    hg = h // group
    nb = got.shape[-1] // hg

    def sums(z):
        return z[:, : nb * hg].double().reshape(z.shape[0], nb, hg).sum(-1)

    check_close(f"{what} sub-block sums", sums(got), sums(want), 3e-4, 2e-5)
    return err


def rows_compare(IIR, K6, filt, x, nv, rate, group, kernels):
    """K3/K4/K5/K6 (those named) against their plain versions on x;
    returns {kernel: max abs error} (z for K3-K5, true peak for K6)."""
    import torch

    from soundscope_tpu_torch.core.constants import samples_in_100ms
    from soundscope_tpu_torch.ops.kweight import channel_weights

    ch = x.shape[1] if x.ndim == 3 else 2
    w = tuple(float(v) for v in channel_weights(ch))
    h = samples_in_100ms(rate)
    tag = f"rate {rate} shape {tuple(x.shape)} group {group}"
    errs = {}
    if "K3" in kernels:
        got = IIR.kweight_energy_tp_prefix(filt, x, nv, w, rate, group)
        want = IIR.kweight_energy_tp_prefix_plain(filt, x, nv, w, rate, group)
        torch.cuda.synchronize()
        errs["K3"] = energy_close(f"K3 {tag}", got[0], want[0], h, group)
        check_close(f"K3 {tag} true peak", got[1], want[1], 2e-6, 1e-7)
        check_close(f"K3 {tag} sample peak", got[2], want[2], 0.0, 0.0)
    for k, fn, plain in (("K4", IIR.kweight_energy_prefix, IIR.kweight_energy_prefix_plain),
                         ("K5", IIR.kweight_energy_chain, IIR.kweight_energy_chain_plain)):
        if k in kernels:
            got = fn(filt, x, nv, w, group)
            want = plain(filt, x, nv, w, group)
            torch.cuda.synchronize()
            errs[k] = energy_close(f"{k} {tag}", got, want, h, group)
    if "K6" in kernels:
        got = K6.true_peak_stream(x, nv, rate)
        want = K6.true_peak_stream_plain(x, nv, rate)
        torch.cuda.synchronize()
        errs["K6"] = check_close(f"K6 {tag} true peak", got[0], want[0], 2e-6, 1e-7)
        check_close(f"K6 {tag} sample peak", got[1], want[1], 0.0, 0.0)
    print(f"phase rows: {tag} " + " ".join(
        f"{k} max abs err {v:.3e}" for k, v in errs.items()) + " ok")
    return errs


def k1_compare(K1, filt_fn, x4, nv, rate):
    """K1 kernel against its plain version on the card; returns the max
    abs error of the sub-block energy sums."""
    import torch

    from soundscope_tpu_torch.core.constants import samples_in_100ms
    from soundscope_tpu_torch.ops.kweight import channel_weights

    b, ch, nc, _ = x4.shape
    n = nc * 128
    h = samples_in_100ms(rate)
    filt = filt_fn(rate)
    w = tuple(float(v) for v in channel_weights(ch))
    got = K1.kweight_energy_tp_chunked(filt, x4, nv, w, rate, h)
    want = K1.kweight_energy_tp_chunked_plain(filt, x4, nv, w, rate, h)
    torch.cuda.synchronize()
    span = K1.step_length(n, h)
    sg = K1.subblock_sums_from_steps(got[0], h, span, n).reshape(b, ch, -1).sum(1)
    sw = K1.subblock_sums_from_steps(want[0], h, span, n).reshape(b, ch, -1).sum(1)
    tag = f"K1 rate {rate} shape {tuple(x4.shape)}"
    err = check_close(f"{tag} sub-block sums", sg, sw, 3e-4, 2e-5)
    check_close(f"{tag} true peak", got[1], want[1], 2e-6, 1e-7)
    check_close(f"{tag} sample peak", got[2], want[2], 0.0, 0.0)
    print(f"phase k1: rate {rate} shape {tuple(x4.shape)} sub-block max abs err "
          f"{err:.3e} true-peak max abs err {max_err(got[1], want[1]):.3e} ok")
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from soundscope_tpu_torch.apps import cli
    from soundscope_tpu_torch.core.config import MeterConfig
    from soundscope_tpu_torch.models.engine import (
        analyze_array,
        analyze_batch_native,
        analyze_fn,
        pad_bucket,
        rows_plan,
    )
    from soundscope_tpu_torch.ops import _build
    from soundscope_tpu_torch.ops import iir as IIR
    from soundscope_tpu_torch.ops import iir_chunked as K1
    from soundscope_tpu_torch.ops import stft_pooled as K2
    from soundscope_tpu_torch.ops import truepeak_stream as K6
    from soundscope_tpu_torch.ops.biquad import make_block_filter
    from soundscope_tpu_torch.ops.kweight import channel_weights, kweight_cascade_ss

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    on = f"[{card}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 1. build
    t0 = time.time()
    _build.library()
    print(f"phase build: {time.time() - t0:.2f} s (nvcc {_build.nvcc()})")

    def filt_fn(rate):
        return make_block_filter(kweight_cascade_ss(rate), 128, dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    n_bench = (SECONDS * RATE // 2048) * 2048
    nc_bench = n_bench // 128

    # 2. K1 against its plain version
    for rate, b, ragged in [(48000, 3, True), (44100, 3, True), (96000, 2, False)]:
        x4 = noise(gen, (b, 2, 512, 128), dev)
        n = 512 * 128
        nv = torch.tensor([n, n - 700, n // 2][:b] if ragged else [n] * b, device=dev)
        k1_compare(K1, filt_fn, x4, nv, rate)
    x_bench = noise(gen, (TRACKS, 2, nc_bench, 128), dev)
    nv_bench = torch.full((TRACKS,), n_bench, device=dev)
    nv_ragged = nv_bench.clone()
    nv_ragged[1::4] -= 48000 * 7 + 333
    k1_err = k1_compare(K1, filt_fn, x_bench, nv_ragged, RATE)

    # 3. K2 against its plain version
    for rate in (48000, 44100):
        fr = noise(gen, (3, 2, 16 * 240, 128), dev)    # 240 hops, 233 windows
        got = K2.stft_pooled_frames(fr, rate)
        want = K2.stft_pooled_frames_plain(fr, rate)
        torch.cuda.synchronize()
        for name, g, w in zip(("mid", "side"), got, want):
            check_close(f"K2 rate {rate} {name}", g, w, 0.0, 1e-3)
        print(f"phase k2: rate {rate} shape {tuple(fr.shape)} max abs dB err "
              f"{max(max_err(got[0], want[0]), max_err(got[1], want[1])):.3e} ok")
    got = K2.stft_pooled_frames(x_bench, RATE)
    want = K2.stft_pooled_frames_plain(x_bench, RATE)
    torch.cuda.synchronize()
    k2_err = max(check_close("K2 bench mid", got[0], want[0], 0.0, 1e-3),
                 check_close("K2 bench side", got[1], want[1], 0.0, 1e-3))
    print(f"phase k2: bench shape {tuple(x_bench.shape)} max abs dB err {k2_err:.3e} ok")
    del got, want

    # 4. the main path at full size
    cfg = MeterConfig(channels=2, rate=RATE, max_blocks=0)
    K1.LAUNCHES = 0
    K2.LAUNCHES = 0
    res = analyze_batch_native(cfg, x_bench, nv_bench)
    mid, side = K2.stft_pooled_frames(x_bench, RATE)
    torch.cuda.synchronize()
    launches = {"K1": K1.LAUNCHES, "K2": K2.LAUNCHES}
    require(launches["K1"] >= 1 and launches["K2"] >= 1,
            f"main path did not launch every kernel: {launches}")
    nw = n_bench // 2048 - 7
    require(res.integrated_lufs.shape == (TRACKS,) and res.true_peak.shape == (TRACKS, 2),
            "engine output shapes")
    require(mid.shape == side.shape == (TRACKS, nw, 128), "spectrogram shapes")
    valid_st = torch.arange(res.shortterm.shape[1], device=dev)[None] < res.n_shortterm[:, None]
    for name, v in [("integrated", res.integrated_lufs), ("lra", res.lra),
                    ("true_peak", res.true_peak), ("sample_peak", res.sample_peak),
                    ("shortterm", res.shortterm[valid_st]), ("mid_db", mid),
                    ("side_db", side)]:
        require(bool(torch.isfinite(v).all()), f"main path output {name} not finite")
    print(f"phase main: {TRACKS} x {n_bench / RATE:.3f} s at {RATE} Hz, launches {launches}, "
          f"integrated [{float(res.integrated_lufs.min()):.3f}, "
          f"{float(res.integrated_lufs.max()):.3f}] LUFS, all outputs finite")

    # the same path on a small slice, against the plain versions on the CPU
    xs = x_bench[:2, :, : 10 * RATE // 128].contiguous()
    nvs = torch.tensor([10 * RATE // 128 * 128, 8 * RATE], device=dev)
    r_gpu = analyze_batch_native(cfg, xs, nvs)
    r_cpu = analyze_batch_native(cfg, xs.cpu(), nvs.cpu())
    for f, rtol, atol in [("integrated_lufs", 0, 2e-3), ("lra", 0, 2e-3),
                          ("true_peak", 2e-6, 1e-7), ("sample_peak", 0, 0)]:
        check_close(f"engine cuda vs cpu {f}", getattr(r_gpu, f), getattr(r_cpu, f), rtol, atol)
    m = r_cpu.shortterm > -1e9
    check_close("engine cuda vs cpu shortterm", r_gpu.shortterm.cpu()[m], r_cpu.shortterm[m], 0, 2e-3)
    for g, c in zip(K2.stft_pooled_frames(xs, RATE), K2.stft_pooled_frames(xs.cpu(), RATE)):
        check_close("K2 cuda vs cpu", g, c, 0, 1e-3)
    print("phase main: small slice agrees with the plain versions on the CPU")

    t = torch.arange(20 * RATE, dtype=torch.float64) / RATE
    tone = (10 ** (-23 / 20) * torch.sin(2 * torch.pi * 997.0 * t)).float()
    ebu = analyze_array(torch.stack([tone, tone]).numpy(), cfg, device=dev)
    require(abs(float(ebu.integrated_lufs) + 23.0) < 0.1,
            f"EBU 3341 case 1 integrated {float(ebu.integrated_lufs)}")
    require(bool(((ebu.true_peak - 0.0708).abs() < 1e-3).all()),
            f"EBU 3341 case 1 true peak {ebu.true_peak.tolist()}")
    print(f"phase main: EBU 3341 case 1 integrated {float(ebu.integrated_lufs):.4f} LUFS "
          f"true peak {[round(v, 5) for v in ebu.true_peak.tolist()]}")

    # 5. the CLI in-process
    with tempfile.TemporaryDirectory() as tmp:
        wav = cli._io().write_wav
        g = torch.Generator().manual_seed(SEED)
        files = []
        for name, secs in [("tone", 8), ("noise_a", 6), ("noise_b", 4)]:
            if name == "tone":
                x = torch.stack([tone[: secs * RATE]] * 2)
            else:
                x = torch.randn((2, secs * RATE), generator=g) * 0.05
            files.append(os.path.join(tmp, name + ".wav"))
            wav(files[-1], x.numpy(), RATE, bits=32)
        K1.LAUNCHES = 0
        K2.LAUNCHES = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["analyze", *files, "--json", "--spectrogram",
                           os.path.join(tmp, "spec")])
        rows = json.loads(out.getvalue())
        require(rc == 0 and len(rows) == 3, f"cli rc {rc} rows {len(rows)}")
        for r in rows:
            for k in ("integrated_lufs", "lra_lu", "true_peak", "spectrogram"):
                require(r.get(k) is not None, f"cli row {r['file']} lacks {k}")
        require(abs(rows[0]["integrated_lufs"] + 23.0) < 0.1, "cli tone loudness")
        require(K1.LAUNCHES >= 1 and K2.LAUNCHES >= 1,
                f"cli launches K1 {K1.LAUNCHES} K2 {K2.LAUNCHES}")
        print(f"phase cli: {len(rows)} rows, launches K1 {K1.LAUNCHES} K2 {K2.LAUNCHES}, "
              f"integrated {[r['integrated_lufs'] for r in rows]}")

    # 6. timings at the bench shape (kernel, plain, kernel)
    f_bench = filt_fn(RATE)
    w2 = (1.0, 1.0)
    h = cfg.subblock

    def k1():
        K1.kweight_energy_tp_chunked(f_bench, x_bench, nv_bench, w2, RATE, h)

    def k1_plain():
        K1.kweight_energy_tp_chunked_plain(f_bench, x_bench, nv_bench, w2, RATE, h)

    def k2():
        K2.stft_pooled_frames(x_bench, RATE)

    def k2_plain():
        K2.stft_pooled_frames_plain(x_bench, RATE)

    def main_path():
        analyze_batch_native(cfg, x_bench, nv_bench)
        K2.stft_pooled_frames(x_bench, RATE)

    k1_ms = time_ms(k1, 5)
    k1_plain_ms = time_ms(k1_plain, 3)
    k1_ms = (k1_ms + time_ms(k1, 5)) / 2
    k2_ms = time_ms(k2, 5)
    k2_plain_ms = time_ms(k2_plain, 2)
    k2_ms = (k2_ms + time_ms(k2, 5)) / 2
    main_ms = time_ms(main_path, 5)
    audio_s = TRACKS * n_bench / RATE
    print(f"timing K1 kernel {k1_ms:.4f} ms plain {k1_plain_ms:.4f} ms "
          f"(bench shape {tuple(x_bench.shape)}) {on}")
    print(f"timing K2 kernel {k2_ms:.4f} ms plain {k2_plain_ms:.4f} ms "
          f"(bench shape {tuple(x_bench.shape)}) {on}")
    print(f"timing main path {main_ms:.4f} ms per batch = "
          f"{audio_s / (main_ms / 1000):.1f} audio-seconds per second "
          f"({TRACKS} x {n_bench / RATE:.3f} s) {on}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {on}")

    # 7. K3-K6 against their plain versions: the CPU tests' cases ...
    for rate, b, ch, group, ks in [
            (48000, 3, 2, 32, "K3 K4 K5 K6"), (48000, 3, 2, 1, "K3 K4 K5"),
            (44100, 3, 2, 1, "K3 K4 K5 K6"), (96000, 3, 2, 32, "K3 K6"),
            (48000, 1, 2, 32, "K3 K4 K5 K6"), (192000, 1, 6, 32, "K4 K5")]:
        n = 226 * 128
        x = rows_noise(gen, (b, ch, n), dev)
        nv = torch.tensor([n, n - 700, n // 2][:b], device=dev)
        rows_compare(IIR, K6, filt_fn(rate), x, nv, rate, group, ks.split())
    for blk_n in (512 * 20, 384 * 25, 256 * 37, 128 * 73):
        x = rows_noise(gen, (3, 2, blk_n), dev)
        nv = torch.tensor([blk_n, blk_n - 333, blk_n // 2], device=dev)
        for rate in (48000, 96000):
            rows_compare(IIR, K6, None, x, nv, rate, 1, ["K6"])

    # ... and at each configuration's shape
    NPAD = pad_bucket(240 * 48000)                       # 2^24
    LIB_TRACKS, LIB_N = 1000, 15 * 48000                 # 720,000 = 5625 blocks
    NV_SINGLE = 240 * 48000
    NV_51 = 60 * 192000
    x_single = rows_noise(gen, (1, 2, NPAD), dev)
    nv_single = torch.tensor([NV_SINGLE], device=dev)
    x_51 = rows_noise(gen, (1, 6, NPAD), dev)
    nv_51 = torch.tensor([NV_51], device=dev)
    x_lib = rows_noise(gen, (2 * LIB_TRACKS, LIB_N), dev)
    nv_lib = torch.full((LIB_TRACKS,), LIB_N, device=dev)
    nv_lib[1::4] -= 48000 * 3 + 333
    x_slice, nv_slice = x_lib[:64], nv_lib[:32]         # 32 tracks, full length
    errs = {}
    errs.update(rows_compare(IIR, K6, filt_fn(48000), x_single, nv_single, 48000, 32, ["K3"]))
    errs.update(rows_compare(IIR, K6, filt_fn(192000), x_51, nv_51, 192000, 32, ["K4"]))
    lib_errs = rows_compare(IIR, K6, filt_fn(48000), x_slice, nv_slice, 48000, 32,
                            ["K4", "K5", "K6"])
    errs["K5"], errs["K6"] = lib_errs["K5"], lib_errs["K6"]

    # 8. the rows-layout engine path in three configurations at full size
    def require_finite(what, res, lead, ch):
        """lead: the track axis, (b,) for a batch, () for one file."""
        require(tuple(res.integrated_lufs.shape) == lead and
                tuple(res.true_peak.shape) == (*lead, ch), f"{what}: output shapes")
        ok = (torch.arange(res.shortterm.shape[-1], device=dev)
              < res.n_shortterm.unsqueeze(-1))
        require(bool(ok.any()), f"{what}: no short-term value")
        for name, v in [("integrated", res.integrated_lufs), ("lra", res.lra),
                        ("true_peak", res.true_peak), ("sample_peak", res.sample_peak),
                        ("shortterm", res.shortterm[ok])]:
            require(bool(torch.isfinite(v).all()), f"{what}: {name} not finite")

    def counts():
        return {**IIR.LAUNCHES, "K6": K6.LAUNCHES}

    def zero_counts():
        IIR.LAUNCHES.update(K3=0, K4=0, K5=0)
        K6.LAUNCHES = 0

    def agree(what, r_gpu, r_cpu):
        for f, rtol, atol in [("integrated_lufs", 0, 2e-3), ("lra", 0, 2e-3),
                              ("true_peak", 2e-6, 1e-7), ("sample_peak", 0, 0)]:
            check_close(f"{what} cuda vs cpu {f}", getattr(r_gpu, f), getattr(r_cpu, f),
                        rtol, atol)
        m = r_cpu.shortterm > -1e9
        check_close(f"{what} cuda vs cpu shortterm", r_gpu.shortterm.cpu()[m],
                    r_cpu.shortterm[m], 0, 2e-3)

    path_launches = {}
    cfg_lib = MeterConfig(channels=2, rate=48000, max_blocks=0)
    require(rows_plan(LIB_N, LIB_TRACKS, 2, 48000, 128) == ("chain", True), "library plan")
    zero_counts()
    res_lib = analyze_batch_native(cfg_lib, x_lib, nv_lib)
    torch.cuda.synchronize()
    path_launches["library"] = counts()
    require(path_launches["library"]["K5"] >= 1 and path_launches["library"]["K6"] >= 1,
            f"library scan did not launch K5 and K6: {path_launches['library']}")
    require_finite("library scan", res_lib, (LIB_TRACKS,), 2)
    r_cpu = analyze_batch_native(cfg_lib, x_lib[:4].cpu(), nv_lib[:2].cpu())
    agree("library scan track 0", res_lib.track(0), r_cpu.track(0))
    agree("library scan track 1", res_lib.track(1), r_cpu.track(1))
    print(f"phase library: {LIB_TRACKS} x {LIB_N / 48000:.1f} s rows {tuple(x_lib.shape)}, "
          f"launches {path_launches['library']}, integrated "
          f"[{float(res_lib.integrated_lufs.min()):.3f}, "
          f"{float(res_lib.integrated_lufs.max()):.3f}] LUFS, finite, agrees with the CPU")

    t = np.arange(NV_SINGLE, dtype=np.float64) / 48000
    tone = (10 ** (-23 / 20) * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)
    track = np.stack([tone, tone])
    require(rows_plan(NPAD, 1, 2, 48000, 128) == ("fused", False), "single-file plan")
    zero_counts()
    res_one = analyze_array(track, cfg, device=dev)
    torch.cuda.synchronize()
    path_launches["single"] = counts()
    require(path_launches["single"]["K3"] >= 1,
            f"single file did not launch K3: {path_launches['single']}")
    require_finite("single file", res_one, (), 2)
    st = res_one.shortterm[: int(res_one.n_shortterm)]
    require(abs(float(res_one.integrated_lufs) + 23.0) < 0.1 and
            float((st + 23.0).abs().max()) < 0.1,
            f"single file EBU 3341 case 1: {float(res_one.integrated_lufs)} LUFS")
    require(bool(((res_one.true_peak - 0.0708).abs() < 1e-3).all()),
            f"single file true peak {res_one.true_peak.tolist()}")
    short = track[:, : 20 * 48000]
    agree("single file first 20 s", analyze_array(short, cfg, device=dev),
          analyze_array(short, cfg))
    print(f"phase single: 240 s EBU 3341 case 1 through analyze_array, launches "
          f"{path_launches['single']}, integrated {float(res_one.integrated_lufs):.4f} LUFS, "
          f"true peak {[round(v, 5) for v in res_one.true_peak.tolist()]}")

    cfg_51 = MeterConfig(channels=6, rate=192000, max_blocks=0)
    surround = x_51[0, :, :NV_51].cpu().numpy()
    require(rows_plan(NPAD, 1, 6, 192000, 128) == ("prefix", False), "5.1 plan")
    zero_counts()
    res_51 = analyze_array(surround, cfg_51, device=dev)
    torch.cuda.synchronize()
    path_launches["5.1"] = counts()
    require(path_launches["5.1"]["K4"] >= 1,
            f"5.1 at 192 kHz did not launch K4: {path_launches['5.1']}")
    require_finite("5.1 at 192 kHz", res_51, (), 6)
    short = surround[:, : 8 * 192000]
    agree("5.1 first 8 s", analyze_array(short, cfg_51, device=dev),
          analyze_array(short, cfg_51))
    print(f"phase 5.1: 60 s at 192 kHz through analyze_array, launches "
          f"{path_launches['5.1']}, integrated {float(res_51.integrated_lufs):.4f} LUFS")

    # 9. timings (kernel, plain, kernel), each pair at one shape
    w2, w6 = (1.0, 1.0), tuple(float(v) for v in channel_weights(6))
    f48, f192 = filt_fn(48000), filt_fn(192000)

    def pair(kernel, plain, iters, plain_iters):
        k = time_ms(kernel, iters)
        p = time_ms(plain, plain_iters)
        return (k + time_ms(kernel, iters)) / 2, p

    k3_ms, k3_plain_ms = pair(
        lambda: IIR.kweight_energy_tp_prefix(f48, x_single, nv_single, w2, 48000, 32),
        lambda: IIR.kweight_energy_tp_prefix_plain(f48, x_single, nv_single, w2, 48000, 32),
        5, 2)
    k4_ms, k4_plain_ms = pair(
        lambda: IIR.kweight_energy_prefix(f192, x_51, nv_51, w6, 32),
        lambda: IIR.kweight_energy_prefix_plain(f192, x_51, nv_51, w6, 32), 5, 2)
    k4_slice_ms, k4_slice_plain_ms = pair(
        lambda: IIR.kweight_energy_prefix(f48, x_slice, nv_slice, w2, 32),
        lambda: IIR.kweight_energy_prefix_plain(f48, x_slice, nv_slice, w2, 32), 5, 2)
    k5_ms, k5_plain_ms = pair(
        lambda: IIR.kweight_energy_chain(f48, x_slice, nv_slice, w2, 32),
        lambda: IIR.kweight_energy_chain_plain(f48, x_slice, nv_slice, w2, 32), 5, 2)
    k6_ms, k6_plain_ms = pair(
        lambda: K6.true_peak_stream(x_slice, nv_slice, 48000),
        lambda: K6.true_peak_stream_plain(x_slice, nv_slice, 48000), 5, 2)
    k4_lib_ms = time_ms(lambda: IIR.kweight_energy_prefix(f48, x_lib, nv_lib, w2, 32), 3)
    k5_lib_ms = time_ms(lambda: IIR.kweight_energy_chain(f48, x_lib, nv_lib, w2, 32), 3)
    k4_lib_ms = (k4_lib_ms + time_ms(
        lambda: IIR.kweight_energy_prefix(f48, x_lib, nv_lib, w2, 32), 3)) / 2
    k6_lib_ms = time_ms(lambda: K6.true_peak_stream(x_lib, nv_lib, 48000), 3)
    scan_ms = time_ms(lambda: analyze_batch_native(cfg_lib, x_lib, nv_lib), 3)
    x_one = torch.zeros((2, NPAD), device=dev)
    x_one[:, :NV_SINGLE] = torch.from_numpy(track).to(dev)
    single_ms = time_ms(lambda: analyze_fn(cfg, x_one, NV_SINGLE), 5)
    t0 = time.time()
    analyze_array(track, cfg, device=dev)
    torch.cuda.synchronize()
    single_wall_ms = (time.time() - t0) * 1000
    x_5 = torch.zeros((6, NPAD), device=dev)
    x_5[:, :NV_51] = x_51[0, :, :NV_51]
    surround_ms = time_ms(lambda: analyze_fn(cfg_51, x_5, NV_51), 5)
    lib_shape = f"library shape ({2 * LIB_TRACKS}, {LIB_N})"
    slice_shape = f"library slice {tuple(x_slice.shape)}"
    print(f"timing K3 kernel {k3_ms:.4f} ms plain {k3_plain_ms:.4f} ms "
          f"(single-file shape {tuple(x_single.shape)}) {on}")
    print(f"timing K4 kernel {k4_ms:.4f} ms plain {k4_plain_ms:.4f} ms "
          f"(5.1 shape {tuple(x_51.shape)}) {on}")
    print(f"timing K4 kernel {k4_slice_ms:.4f} ms plain {k4_slice_plain_ms:.4f} ms "
          f"({slice_shape}) {on}")
    print(f"timing K5 kernel {k5_ms:.4f} ms plain {k5_plain_ms:.4f} ms ({slice_shape}) {on}")
    print(f"timing K6 kernel {k6_ms:.4f} ms plain {k6_plain_ms:.4f} ms ({slice_shape}) {on}")
    print(f"timing K4 {k4_lib_ms:.4f} ms K5 {k5_lib_ms:.4f} ms K6 {k6_lib_ms:.4f} ms "
          f"({lib_shape}) {on}")
    print(f"timing library scan {scan_ms:.4f} ms per scan = "
          f"{LIB_TRACKS / (scan_ms / 1000):.1f} tracks per second "
          f"({LIB_TRACKS} x {LIB_N / 48000:.1f} s) {on}")
    print(f"timing single file (240 s, 48 kHz stereo) {single_ms:.4f} ms on the device "
          f"tensor, {single_wall_ms:.4f} ms through analyze_array from host memory {on}")
    print(f"timing 5.1 at 192 kHz (60 s) {surround_ms:.4f} ms on the device tensor {on}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {on}")

    kernels = [
        {"name": "K1 kweight_energy_tp_chunked", "route": "cuda",
         "source": "soundscope_tpu_torch/csrc/iir_chunked.cu",
         "replaces": "soundscope_tpu/ops/pallas_iir_chunked.py:383",
         "launches": launches["K1"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "K2 stft_pooled_frames", "route": "cuda",
         "source": "soundscope_tpu_torch/csrc/stft_pooled.cu",
         "replaces": "soundscope_tpu/ops/pallas_stft.py:364",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "K3 kweight_energy_tp_prefix", "route": "cuda",
         "source": "soundscope_tpu_torch/csrc/iir_rows.cu",
         "replaces": "soundscope_tpu/ops/pallas_iir.py:577",
         "launches": path_launches["single"]["K3"], "max_abs_err": errs["K3"],
         "ms": k3_ms, "plain_ms": k3_plain_ms},
        {"name": "K4 kweight_energy_prefix", "route": "cuda",
         "source": "soundscope_tpu_torch/csrc/iir_rows.cu",
         "replaces": "soundscope_tpu/ops/pallas_iir.py:500",
         "launches": path_launches["5.1"]["K4"], "max_abs_err": errs["K4"],
         "ms": k4_ms, "plain_ms": k4_plain_ms},
        {"name": "K5 kweight_energy_chain", "route": "cuda",
         "source": "soundscope_tpu_torch/csrc/iir_rows.cu",
         "replaces": "soundscope_tpu/ops/pallas_iir.py:308",
         "launches": path_launches["library"]["K5"], "max_abs_err": errs["K5"],
         "ms": k5_ms, "plain_ms": k5_plain_ms},
        {"name": "K6 true_peak_stream", "route": "cuda",
         "source": "soundscope_tpu_torch/csrc/truepeak_stream.cu",
         "replaces": "soundscope_tpu/ops/pallas_truepeak.py:166",
         "launches": path_launches["library"]["K6"], "max_abs_err": errs["K6"],
         "ms": k6_ms, "plain_ms": k6_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
