"""Fidelity sweep of every kernel route against the float64 chain.

    python -m soundscope_tpu_torch.tools.conformance [--json] [--levels N]
        [--stft-windows W] [--rate HZ] [--device cuda|cpu]

The port's counterpart of the JAX package's ``tools/tpu_conformance.py``:
a sweep of stereo sines (3 s, -2 to -60 dBFS, the right channel scaled
and sign-flipped on odd tracks so that mid and side both carry energy),
padded to a multiple of the filter block with n_valid the true length,
driven through each route separately and compared with the float64 chain
of tools/reference64.py:

  K1     models/engine.analyze_batch_native on the frames view
         (levels, 2, N/128, 128), the main path;
  K3     the same call on (levels, 2, N): rows_plan routes up to 64 rows
         to the fused kernel;
  K4+K6  ops/iir.kweight_energy_prefix, then
         ops/truepeak_stream.true_peak_stream, each called directly;
  K5     ops/iir.kweight_energy_chain on the same rows (integrated only);
  K2     ops/stft_pooled.stft_pooled_frames against the float64 pooled
         spectrogram on the first 8 tracks, on the bands above -140 dB in
         the float64 truth (sub-floor bands are clamped, not measured);
  K7     the streaming meter: models/analyzer.Analyzer fed 1 s slabs.

Integrated loudness from K4's and K5's z goes through the engine's own
tail (models/engine._sums_from_z, then _finish's gating).
Budgets (BS.1770-4 and the display's resolution): 0.1 LU integrated,
0.1 dB true peak, 0.1 dB display spectrum. On the card every route must
launch its kernels (the registry's launch.K1 ... launch.K7 counters); on the CPU
(--device cpu) the same routes run the kernels' plain versions. The last
line of stdout is the report (with --json one JSON object); the exit code
is 1 when a budget is missed or a kernel did not launch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from soundscope_tpu_torch.core import constants as C
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.core.device import default_device
from soundscope_tpu_torch.models.analyzer import Analyzer
from soundscope_tpu_torch.models import engine
from soundscope_tpu_torch.ops import iir as IIR
from soundscope_tpu_torch.ops import stft_pooled as K2
from soundscope_tpu_torch.ops import truepeak_stream as K6
from soundscope_tpu_torch.ops.biquad import kweight_filter
from soundscope_tpu_torch.ops.kweight import channel_weights
from soundscope_tpu_torch.tools.reference64 import analyze_reference, f64_stft_pooled
from soundscope_tpu_torch.utils.metrics import launches

SECONDS = 3.0
FREQS = [997.0, 440.0, 1000.0, 5000.0, 100.0, 12000.0, 2500.0, 16000.0]

BUDGET_LU = 0.1
BUDGET_TP_DB = 0.1
BUDGET_STFT_DB = 0.1

# tracks whose spectrograms are checked (the float64 STFT is slow)
STFT_TRACKS = 8
# rows_plan sends at most 64 rows, 32 stereo tracks, to the fused K3
FUSED_TRACKS = 32

# each route and the kernels it must launch on the card
ROUTES = {"K1": ("K1",), "K3": ("K3",), "K4+K6": ("K4", "K6"), "K5": ("K5",),
          "K2": ("K2",), "K7": ("K7",)}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def make_sweep(levels: int, rate: int = 48000) -> np.ndarray:
    """(levels, 2, 3 s) float32 stereo sines from -2 to -60 dBFS at varied
    frequencies; the right channel is 0.8 x the left, sign-flipped on odd
    tracks, so that mid and side spectra both carry energy."""
    n = int(SECONDS * rate)
    t = np.arange(n, dtype=np.float64) / rate
    xs = np.zeros((levels, 2, n), np.float32)
    for i in range(levels):
        db = -2.0 - 58.0 * i / max(levels - 1, 1)
        amp = 10.0 ** (db / 20.0)
        left = amp * np.sin(2 * np.pi * FREQS[i % len(FREQS)] * t)
        xs[i, 0] = left.astype(np.float32)
        xs[i, 1] = (0.8 * left * (-1.0 if i % 2 else 1.0)).astype(np.float32)
    return xs


def f64_reference(xs: np.ndarray, rate: int):
    """Integrated LUFS (levels,) and true peak (levels, 2) in float64."""
    integ = np.zeros(xs.shape[0])
    tp = np.zeros((xs.shape[0], 2))
    for i in range(xs.shape[0]):
        r = analyze_reference(xs[i].astype(np.float64), rate)
        integ[i] = r["integrated"]
        tp[i] = r["true_peak"]
    return integ, tp


def _abs_err(got, want) -> float:
    """Largest |got - want|, equal values (infinities too) counting 0."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    with np.errstate(invalid="ignore"):
        d = np.where(got == want, 0.0, np.abs(got - want))
    return float(np.nan_to_num(d, nan=np.inf).max())


def _host(v) -> np.ndarray:
    """A result (a tensor on any device, or an array) as a host array."""
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _db(v) -> np.ndarray:
    return 20.0 * np.log10(np.maximum(np.asarray(v, np.float64), 1e-12))


def _routes(xs: np.ndarray, rate: int, dev: torch.device) -> list:
    """The routes over the sweep xs (levels, 2, n), as (name, run) with
    run() -> (integrated (levels,) or None, true peak (levels, 2) or None,
    (mid, side) or None)."""
    levels, _, n = xs.shape
    cfg = MeterConfig(channels=2, rate=rate, max_blocks=0)
    npad = -(-n // cfg.block) * cfg.block
    xpad = np.zeros((levels, 2, npad), np.float32)
    xpad[..., :n] = xs
    x3 = torch.from_numpy(xpad).to(dev)
    x4 = x3.reshape(levels, 2, npad // 128, 128)
    nv = torch.full((levels,), n, dtype=torch.int64, device=dev)
    h, g = cfg.subblock, engine.z_group(cfg)
    w = tuple(float(v) for v in channel_weights(2))
    filt = kweight_filter(rate, cfg.block, dev)

    def k1():
        res = engine.analyze_batch_native(cfg, x4, nv)
        return res.integrated_lufs, res.true_peak, None

    def k3():
        parts = [engine.analyze_batch_native(cfg, x3[i:i + FUSED_TRACKS],
                                             nv[i:i + FUSED_TRACKS])
                 for i in range(0, levels, FUSED_TRACKS)]
        return (torch.cat([r.integrated_lufs for r in parts]),
                torch.cat([r.true_peak for r in parts]), None)

    def integrated(z):
        # the engine's own tail: its 100 ms sums of z, then its gating
        peaks = torch.zeros((levels, 2), device=dev)
        return engine._finish(cfg, engine._sums_from_z(z, h, g), nv, peaks,
                              peaks).integrated_lufs

    def k4_k6():
        z = IIR.kweight_energy_prefix(filt, x3, nv, w, g)
        tp, _ = K6.true_peak_stream(x3, nv, rate)
        return integrated(z), tp, None

    def k5():
        return integrated(IIR.kweight_energy_chain(filt, x3, nv, w, g)), None, None

    def k2():
        return None, None, K2.stft_pooled_frames(x4, rate)

    def k7():
        integ, tp = np.zeros(levels), np.zeros((levels, 2))
        for i in range(levels):
            a = Analyzer(channels=2, rate=rate, device=dev)
            inter = x3[i, :, :n].T.reshape(-1)
            for s in range(0, n, rate):
                a.add_samples(inter[2 * s: 2 * min(s + rate, n)])
            integ[i] = a.get_integrated_lufs()
            tp[i] = a.get_true_peak()
        return integ, tp, None

    return [("K1", k1), ("K3", k3), ("K4+K6", k4_k6), ("K5", k5), ("K2", k2), ("K7", k7)]


def sweep(levels: int = 32, rate: int = 48000, device=None,
          stft_windows: int = 8) -> dict:
    """Run the sweep on `device` (None: the card) and return the report:
    per route its largest integrated error (LU), true-peak error (dB),
    spectrum error (dB) and launches, the worst of each over the routes,
    the budgets, the kernels that did not launch on the card and `pass`."""
    dev = default_device(device)
    xs = make_sweep(levels, rate)
    t0 = time.time()
    ref_integ, ref_tp = f64_reference(xs, rate)
    log(f"f64 reference chain: {time.time() - t0:.1f} s")

    routes, not_launched = {}, []
    for route, run in _routes(xs, rate, dev):
        before = launches()
        t0 = time.time()
        integ, tp, spec = run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ran = {k: v for k, v in launches(since=before).items() if v}
        log(f"route {route}: {time.time() - t0:.2f} s wall, launches {ran}")
        out = {"launches": ran}
        if integ is not None:
            out["integrated_max_err_lu"] = _abs_err(_host(integ), ref_integ)
        if tp is not None:
            out["true_peak_max_err_db"] = _abs_err(_db(_host(tp)), _db(ref_tp))
        if spec is not None:
            mid, side = (_host(s) for s in spec)
            nw = min(stft_windows, mid.shape[1])
            err = 0.0
            for i in range(min(levels, STFT_TRACKS)):
                m64, s64 = f64_stft_pooled(xs[i], nw, rate)
                for got, want in ((mid[i, :nw], m64), (side[i, :nw], s64)):
                    live = want > -140.0
                    if live.any():
                        err = max(err, _abs_err(got[live], want[live]))
            out["stft_pooled_max_err_db"] = err
        if dev.type == "cuda":
            not_launched += [k for k in ROUTES[route] if k not in ran]
        routes[route] = out

    def worst(key):
        return max(r[key] for r in routes.values() if key in r)

    report = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "rate": rate,
        "levels": levels,
        "stft_windows": stft_windows,
        "routes": routes,
        "integrated_max_err_lu": worst("integrated_max_err_lu"),
        "true_peak_max_err_db": worst("true_peak_max_err_db"),
        "stft_pooled_max_err_db": worst("stft_pooled_max_err_db"),
        "budgets": {"lu": BUDGET_LU, "tp_db": BUDGET_TP_DB, "stft_db": BUDGET_STFT_DB},
        "not_launched": not_launched,
    }
    report["pass"] = bool(
        report["integrated_max_err_lu"] <= BUDGET_LU
        and report["true_peak_max_err_db"] <= BUDGET_TP_DB
        and report["stft_pooled_max_err_db"] <= BUDGET_STFT_DB
        and not not_launched)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m soundscope_tpu_torch.tools.conformance",
        description="Sweep every kernel route against the float64 chain.")
    ap.add_argument("--json", action="store_true", help="print the report as one JSON line")
    ap.add_argument("--levels", type=int, default=32, help="tracks in the sweep (default 32)")
    ap.add_argument("--stft-windows", type=int, default=8,
                    help="windows per track checked against the float64 STFT (default 8)")
    ap.add_argument("--rate", type=int, default=48000, help="sample rate (default 48000)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the routes run (default: cuda)")
    args = ap.parse_args(argv)
    if args.levels < 1 or args.stft_windows < 1:
        ap.error("--levels and --stft-windows must be at least 1")
    if not (K2.rate_supported(args.rate) and C.true_peak_factor(args.rate) > 1):
        ap.error(f"rate {args.rate}: K2 needs a rate above 40 kHz and K3 one below "
                 "192 kHz")
    try:
        dev = default_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    report = sweep(args.levels, args.rate, dev, args.stft_windows)
    if args.json:
        print(json.dumps(report))
    else:
        for k, v in report.items():
            print(f"{k}: {v}")
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
