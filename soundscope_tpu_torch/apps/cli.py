"""Batch CLI host of the PyTorch port.

    python -m soundscope_tpu_torch.apps.cli analyze FILE... [--json]
        [--spectrogram DIR] [--timeline DIR] [--device cuda|cpu]
    python -m soundscope_tpu_torch.apps.cli scan DIR [--json] [--device cuda|cpu]

Files are decoded on the host, grouped into (channels, rate, padded
length) buckets, and each bucket is analyzed as one batch in the frames
view (b, ch, N/128, 128) on `--device`: the CUDA device (the default;
the command fails when there is none) or the CPU. On CUDA the bucket runs
through K1 and, with --spectrogram above 40 kHz, K2.

Decoding uses the port's own NumPy WAV and AIFF readers (utils/io.py);
other formats fall to the ffmpeg command line where one is installed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from soundscope_tpu_torch import __version__
from soundscope_tpu_torch.core.device import default_device
from soundscope_tpu_torch.utils import io as sio

FLUSH_AT = 64


def _export_path(dir_: str, title: str, suffix: str, used: dict) -> str:
    """Collision-free export filename for same-titled tracks."""
    n = used.get((dir_, title, suffix), 0) + 1
    used[(dir_, title, suffix)] = n
    name = title if n == 1 else f"{title}-{n}"
    return os.path.join(dir_, name + suffix)


def _analyze_bucket(key, items, results, dev, spectrogram_dir=None,
                    timeline_dir=None, used_names=None) -> None:
    import torch

    from soundscope_tpu_torch.core.config import MeterConfig
    from soundscope_tpu_torch.models.engine import analyze_batch_native

    ch, rate, npad = key
    used = used_names if used_names is not None else {}
    cfg = MeterConfig(channels=ch, rate=rate, max_blocks=0)
    xs = np.zeros((len(items), ch, npad), np.float32)
    nv = np.zeros(len(items), np.int64)
    for i, (_, d) in enumerate(items):
        xs[i, :, : d.samples.shape[1]] = d.samples
        nv[i] = d.samples.shape[1]
    x4 = torch.from_numpy(xs).to(dev).reshape(len(items), ch, npad // 128, 128)
    res = analyze_batch_native(cfg, x4, torch.from_numpy(nv).to(dev))
    tp = res.true_peak.cpu().numpy()
    sp = res.sample_peak.cpu().numpy()
    integ = res.integrated_lufs.cpu().numpy()
    lra = res.lra.cpu().numpy()
    for i, (p, d) in enumerate(items):
        with np.errstate(divide="ignore"):
            tp_db = 20.0 * np.log10(tp[i].max())
        # silence -> -inf, which is not valid JSON; report null
        tp_db = float(tp_db) if np.isfinite(tp_db) else None
        integ_i = float(integ[i])
        integ_i = round(integ_i, 2) if np.isfinite(integ_i) else None
        row = {
            "file": p,
            "title": d.title,
            "channels": ch,
            "rate": rate,
            "duration_s": round(d.duration, 3),
            "integrated_lufs": integ_i,
            "lra_lu": round(float(lra[i]), 2),
            "true_peak": [round(float(v), 4) for v in tp[i]],
            "true_peak_dbtp": round(tp_db, 2) if tp_db is not None else None,
            "sample_peak": [round(float(v), 4) for v in sp[i]],
        }
        if spectrogram_dir is not None:
            from soundscope_tpu_torch.ops.stft import spectrogram

            out = _export_path(spectrogram_dir, d.title, ".spec.npz", used)
            np.savez_compressed(out, **spectrogram(d.samples, d.rate, dev))
            row["spectrogram"] = out
        if timeline_dir is not None:
            nm = int(res.n_momentary[i])
            nst = int(res.n_shortterm[i])
            out = _export_path(timeline_dir, d.title, ".loudness.npz", used)
            np.savez_compressed(
                out,
                momentary_lufs=res.momentary[i][:nm].cpu().numpy(),
                shortterm_lufs=res.shortterm[i][:nst].cpu().numpy(),
                hop_seconds=0.1,
                rate=rate,
            )
            row["timeline"] = out
        results.append(row)


def _analyze_paths(paths: list[str], dev, spectrogram_dir: str | None = None,
                   timeline_dir: str | None = None) -> list[dict]:
    from soundscope_tpu_torch.models.engine import pad_bucket

    results: list[dict] = []
    buckets: dict[tuple, list] = {}
    used_names: dict = {}

    def flush(key):
        _analyze_bucket(key, buckets.pop(key), results, dev, spectrogram_dir,
                        timeline_dir, used_names)

    for p in paths:
        try:
            d = sio.decode_file(p)
        except (sio.DecodeError, OSError) as e:
            results.append({"file": p, "error": str(e)})
            continue
        key = (d.channels, d.rate, pad_bucket(d.samples.shape[1]))
        buckets.setdefault(key, []).append((p, d))
        if len(buckets[key]) >= FLUSH_AT:
            flush(key)
    for key in list(buckets):
        flush(key)
    order = {p: i for i, p in enumerate(paths)}
    return sorted(results, key=lambda r: order.get(r["file"], 1 << 30))


def _print_table(rows: list[dict]) -> None:
    cols = ["file", "duration_s", "integrated_lufs", "lra_lu", "true_peak_dbtp"]
    hdr = ["FILE", "DUR(s)", "LUFS-I", "LRA", "dBTP"]
    widths = [max(len(h), *(len(str(r.get(c, "-"))) for r in rows))
              for c, h in zip(cols, hdr)]
    print("  ".join(h.ljust(w) for h, w in zip(hdr, widths)))
    for r in rows:
        if "error" in r:
            print(f"{r['file']}: ERROR {r['error']}")
            continue
        print("  ".join(str(r.get(c, "-")).ljust(w) for c, w in zip(cols, widths)))


def cmd_analyze(args) -> int:
    try:
        dev = default_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    spec_dir = getattr(args, "spectrogram", None)
    if spec_dir:
        os.makedirs(spec_dir, exist_ok=True)
    tl_dir = getattr(args, "timeline", None)
    if tl_dir:
        os.makedirs(tl_dir, exist_ok=True)
    rows = _analyze_paths(args.files, dev, spectrogram_dir=spec_dir,
                          timeline_dir=tl_dir)
    if args.json:
        print(json.dumps(rows, indent=None if args.compact else 2))
    else:
        _print_table(rows)
    return 1 if any("error" in r for r in rows) else 0


def cmd_scan(args) -> int:
    exts = sio.AUDIO_EXTENSIONS
    paths = []
    for root, _, names in os.walk(args.dir):
        for nm in sorted(names):
            if nm.rsplit(".", 1)[-1].lower() in exts:
                paths.append(os.path.join(root, nm))
    if not paths:
        print("no audio files found", file=sys.stderr)
        return 1
    args.files = paths
    return cmd_analyze(args)


_DECODE_NOTE = (
    "Decoding: WAV and AIFF are read by the port's NumPy decoders; other "
    "formats need an ffmpeg binary on PATH.")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="soundscope-tpu-torch",
        description="Batch loudness and spectrogram analysis on PyTorch/CUDA "
                    "(port of soundscope-tpu). " + _DECODE_NOTE,
    )
    ap.add_argument("-v", "--version", action="version", version=__version__)
    sub = ap.add_subparsers(dest="cmd")

    a = sub.add_parser("analyze", help="analyze audio files (one batch per bucket)",
                       description=_DECODE_NOTE)
    a.add_argument("files", nargs="+")
    a.add_argument("--json", action="store_true")
    a.add_argument("--compact", action="store_true")
    a.add_argument("--spectrogram", metavar="DIR",
                   help="also write pooled mid/side spectrograms (.spec.npz)")
    a.add_argument("--timeline", metavar="DIR",
                   help="also write momentary/short-term timelines (.loudness.npz)")
    a.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to compute (default: cuda)")
    a.set_defaults(fn=cmd_analyze)

    s = sub.add_parser("scan", help="recursively analyze a directory",
                       description=_DECODE_NOTE)
    s.add_argument("dir")
    s.add_argument("--json", action="store_true")
    s.add_argument("--compact", action="store_true")
    s.add_argument("--timeline", metavar="DIR",
                   help="also write momentary/short-term timelines (.loudness.npz)")
    s.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to compute (default: cuda)")
    s.set_defaults(fn=cmd_scan)

    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if not getattr(args, "fn", None):
        ap.print_help()
        return 2
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
