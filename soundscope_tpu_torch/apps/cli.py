"""CLI host of the PyTorch port.

The reference binary is `soundscope [OPTIONS] [FILE]` and opens straight
into the TUI (src/main.rs:21-30); a bare path maps to `tui PATH`, no
arguments to `tui`. The batch commands analyze whole files on the card:

    python -m soundscope_tpu_torch.apps.cli [FILE]            # the TUI
    python -m soundscope_tpu_torch.apps.cli tui [FILE] [--device cuda|cpu] [--metrics]
    python -m soundscope_tpu_torch.apps.cli analyze FILE... [--json]
        [--spectrogram DIR] [--timeline DIR] [--decode-threads N]
        [--metrics] [--profile DIR] [--device cuda|cpu]
    python -m soundscope_tpu_torch.apps.cli scan DIR [--json] [...]
    python -m soundscope_tpu_torch.apps.cli themes
    python -m soundscope_tpu_torch.apps.cli bench [--check] [...]  (soundscope_tpu_torch/bench.py)
    python -m soundscope_tpu_torch.apps.cli warmup [--device cuda|cpu]

A thread pool decodes files ahead (the native decoders drop the GIL) while
the main thread takes them in input order, groups them into (channels,
rate, padded length) buckets and analyzes each bucket as one batch in the
frames view (b, ch, N/128, 128) on `--device`: the CUDA device (the
default; the command fails when there is none) or the CPU. On CUDA a
bucket runs through K1 and, with --spectrogram above 40 kHz, one K2.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from soundscope_tpu_torch import __version__
from soundscope_tpu_torch.core.device import default_device, upload
from soundscope_tpu_torch.utils import io as sio
from soundscope_tpu_torch.utils.metrics import GLOBAL as RT

FLUSH_AT = 64


def _decode_workers(n_paths: int, threads: int = 0) -> int:
    """Decode thread count: `threads` when positive, else one per core
    (at most 16), never more than the files."""
    if threads > 0:
        return min(threads, max(n_paths, 1))
    return max(1, min(os.cpu_count() or 4, 16, n_paths))


def _export_path(dir_: str, title: str, suffix: str, used: dict) -> str:
    """Collision-free export filename for same-titled tracks."""
    n = used.get((dir_, title, suffix), 0) + 1
    used[(dir_, title, suffix)] = n
    name = title if n == 1 else f"{title}-{n}"
    return os.path.join(dir_, name + suffix)


def _analyze_bucket(key, items, results, dev, spectrogram_dir=None,
                    timeline_dir=None, used_names=None) -> None:
    from soundscope_tpu_torch.core.config import MeterConfig
    from soundscope_tpu_torch.models.engine import analyze_batch_native
    from soundscope_tpu_torch.ops.stft import spectrogram_batch

    ch, rate, npad = key
    used = used_names if used_names is not None else {}
    cfg = MeterConfig(channels=ch, rate=rate, max_blocks=0)
    xs = np.zeros((len(items), ch, npad), np.float32)
    nv = np.zeros(len(items), np.int64)
    for i, (_, d) in enumerate(items):
        xs[i, :, : d.samples.shape[1]] = d.samples
        nv[i] = d.samples.shape[1]
    with RT.span("analyze", float(nv.sum()) / rate):
        x4 = upload(xs, dev).reshape(len(items), ch, npad // 128, 128)
        res = analyze_batch_native(cfg, x4, upload(nv, dev))
        tp = res.true_peak.cpu().numpy()
        sp = res.sample_peak.cpu().numpy()
        integ = res.integrated_lufs.cpu().numpy()
        lra = res.lra.cpu().numpy()
    specs = None
    if spectrogram_dir is not None:
        with RT.span("spectrogram", float(nv.sum()) / rate):
            specs = spectrogram_batch(x4, nv, rate)
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
        if specs is not None:
            out = _export_path(spectrogram_dir, d.title, ".spec.npz", used)
            np.savez_compressed(out, **specs[i])
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
                   timeline_dir: str | None = None, threads: int = 0) -> list[dict]:
    from soundscope_tpu_torch.models.engine import pad_bucket

    results: list[dict] = []
    # buckets flush at FLUSH_AT files, so peak memory is the decode window
    # plus one bucket of decoded audio, not the whole library
    buckets: dict[tuple, list] = {}
    used_names: dict = {}

    def flush(key):
        _analyze_bucket(key, buckets.pop(key), results, dev, spectrogram_dir,
                        timeline_dir, used_names)

    def decode_one(p):
        try:
            with RT.span("decode", 0.0):
                d = sio.decode_file(p)
            RT.add_audio("decode", d.duration)
            return d
        except (sio.DecodeError, OSError) as e:
            return e

    # A thread pool decodes ahead while this thread takes the futures in
    # submission order (a deterministic bucket composition) and sends full
    # buckets to the device: bucket k's analysis overlaps the decode of
    # bucket k+1.
    workers = _decode_workers(len(paths), threads)
    window = max(2 * FLUSH_AT, 4 * workers)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        pending = collections.deque()
        it = iter(paths)

        def top_up():
            while len(pending) < window:
                p = next(it, None)
                if p is None:
                    return
                pending.append((p, ex.submit(decode_one, p)))

        top_up()
        while pending:
            p, fut = pending.popleft()
            d = fut.result()
            top_up()
            if isinstance(d, Exception):
                results.append({"file": p, "error": str(d)})
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
    prof_dir = getattr(args, "profile", None)
    if prof_dir:
        from soundscope_tpu_torch.utils.metrics import profile_trace

        prof_ctx = profile_trace(prof_dir)
    else:
        prof_ctx = contextlib.nullcontext()
    with prof_ctx as trace:
        rows = _analyze_paths(args.files, dev, spectrogram_dir=spec_dir,
                              timeline_dir=tl_dir, threads=args.decode_threads)
    if prof_dir:
        print(f"trace written to {trace}", file=sys.stderr)
    if args.json:
        print(json.dumps(rows, indent=None if args.compact else 2))
    else:
        _print_table(rows)
    if args.metrics:
        # per-op wall/audio/RT-factor report on stderr (keeps stdout parseable)
        print(json.dumps({"metrics": RT.report()}), file=sys.stderr)
    return 1 if any("error" in r for r in rows) else 0


def cmd_scan(args) -> int:
    paths = []
    for root, _, names in os.walk(args.dir):
        for nm in sorted(names):
            if nm.rsplit(".", 1)[-1].lower() in sio.AUDIO_EXTENSIONS:
                paths.append(os.path.join(root, nm))
    if not paths:
        print("no audio files found", file=sys.stderr)
        return 1
    args.files = paths
    return cmd_analyze(args)


def cmd_themes(_args) -> int:
    from soundscope_tpu_torch.apps.themes import list_themes

    for name in list_themes():
        print(name)
    return 0


def cmd_tui(args) -> int:
    from soundscope_tpu_torch.apps.tui import run_tui

    # before curses takes the terminal: without a card (and without
    # --device cpu) this raises
    dev = default_device(args.device)
    return run_tui(args.file, device=dev, show_metrics=args.metrics)


def cmd_warmup(args) -> int:
    """Build the libraries that outlive a process, once after install.

    A fresh process's first `analyze` builds the kernel library with nvcc
    (``build/soundscope_tpu_torch/<key>/libsstorch.so``, keyed by the
    content of its sources) and the native decoders
    (``native/libssnative_torch.so``, rebuilt when a source is newer or the
    CPU differs); every later process loads them. Nothing else is kept
    from one process to the next (the kernels are built for sm_90a only,
    no PTX is compiled per shape at run time), so this is all a warmup can
    do. With --device cpu only the decoders are built.
    """
    from soundscope_tpu_torch import native

    try:
        dev = default_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    parts = []
    if dev.type == "cuda":
        from soundscope_tpu_torch.ops import _build

        t0 = time.time()
        path = _build.build()
        parts.append(f"kernel library {path} in {time.time() - t0:.1f} s")
    t0 = time.time()
    path = native.build()
    parts.append(f"native decoders {path} in {time.time() - t0:.1f} s")
    print("warmup: built " + "; ".join(parts))
    return 0


_SUBCOMMANDS = ("analyze", "scan", "tui", "themes", "bench", "warmup")


def _normalize_argv(argv: list[str]) -> list[str]:
    """Reference surface: `soundscope [OPTIONS] [FILE]` opens the TUI —
    with FILE, on that file; with no arguments, empty (src/main.rs:21-30).
    A bare path maps to `tui PATH`; no arguments map to `tui`."""
    if not argv:
        return ["tui"]
    if not argv[0].startswith("-") and argv[0] not in _SUBCOMMANDS:
        return ["tui"] + list(argv)
    return list(argv)


_DECODE_NOTE = (
    "Decoding: the port's native decoders (WAV, FLAC, MPEG audio, ALAC, Ogg "
    "Vorbis, AAC, and the libav codec bridge where it was built), NumPy for "
    "AIFF, and an ffmpeg binary on PATH for the rest.")


def _batch_args(p, spectrogram: bool) -> None:
    p.add_argument("--json", action="store_true")
    p.add_argument("--compact", action="store_true")
    if spectrogram:
        p.add_argument("--spectrogram", metavar="DIR",
                       help="also write pooled mid/side spectrograms (.spec.npz)")
    p.add_argument("--timeline", metavar="DIR",
                   help="also write momentary/short-term timelines (.loudness.npz)")
    p.add_argument("--decode-threads", type=int, default=0, metavar="N",
                   help="decode threads (default: one per core, at most 16)")
    p.add_argument("--metrics", action="store_true",
                   help="print per-op RT-factor metrics JSON on stderr")
    p.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run to DIR "
                        "(on the card its first 64 kernels are padding, under "
                        "the range 'profile_trace: padding, 64 kernels')")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to compute (default: cuda)")


def main(argv=None) -> int:
    argv = _normalize_argv(sys.argv[1:] if argv is None else argv)
    if argv[0] == "bench":
        # the benchmark, in this process, on the rest of the line
        from soundscope_tpu_torch import bench

        return bench.main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="soundscope-tpu-torch",
        description="Loudness, spectrum and waveform analyzer on PyTorch/CUDA "
                    "(port of soundscope-tpu). " + _DECODE_NOTE,
    )
    ap.add_argument("-v", "--version", action="version", version=__version__)
    sub = ap.add_subparsers(dest="cmd")

    a = sub.add_parser("analyze", help="analyze audio files (one batch per bucket)",
                       description=_DECODE_NOTE)
    a.add_argument("files", nargs="+")
    _batch_args(a, spectrogram=True)
    a.set_defaults(fn=cmd_analyze)

    s = sub.add_parser("scan", help="recursively analyze a directory",
                       description=_DECODE_NOTE)
    s.add_argument("dir")
    _batch_args(s, spectrogram=False)
    s.set_defaults(fn=cmd_scan)

    t = sub.add_parser("tui", help="interactive TUI (reference-compatible)")
    t.add_argument("file", nargs="?")
    t.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where to analyze (default: cuda)")
    t.add_argument("--metrics", action="store_true",
                   help="show the tick and RT-factor readout")
    t.set_defaults(fn=cmd_tui)

    sub.add_parser("themes", help="list built-in themes").set_defaults(fn=cmd_themes)

    # `bench` takes the rest of the line as its own (main() hands it over
    # before parsing); listed here for the help
    sub.add_parser("bench", help="the RT-factor benchmark (bench --help for its flags)")

    w = sub.add_parser("warmup", help="build the kernel and decoder libraries "
                       "that every later process loads")
    w.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to compute (default: cuda)")
    w.set_defaults(fn=cmd_warmup)

    args = ap.parse_args(argv)
    if not getattr(args, "fn", None):
        ap.print_help()
        return 2
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
