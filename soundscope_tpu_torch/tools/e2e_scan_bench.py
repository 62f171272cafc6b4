"""The end-to-end library scan: a directory of encoded files to JSON rows.

    python -m soundscope_tpu_torch.tools.e2e_scan_bench [tracks] [seconds]
        [--keep DIR] [--threads N] [--device cuda|cpu]

The counterpart of the JAX package's ``tools/e2e_scan_bench.py``.
library_scan_bench.py times the analysis alone on samples already on the
device; this times what a user runs: `analyze` of a directory of
compressed audio (apps/cli._analyze_paths), that is the decode pool, the
filling of buckets of up to 64 files and one K1 launch per bucket on the
card.

The corpus (`make_corpus`) holds the JAX tool's files: the same material
from the same seed, in the same rotation of kinds (WAV, FLAC, MP3 where
libmp3lame is installed, and Ogg Vorbis, ALAC in M4A and AAC where the
native library's codec bridge is compiled in), so that corpora made with
the same arguments hold the same files. The tracks are encoded in a
process pool; the build time goes to stderr apart from the scan. With
`--keep DIR` the corpus is made in DIR and kept, and a DIR that already
holds enough tracks is reused.

The scan is warmed as the JAX tool warms it, on one full bucket plus the
last partial bucket's size, then the RT counters are reset and the scan
of every file is timed by the wall clock. `--threads N` sets the decode
threads (0, the default: one per core, at most 16).

Stdout is one JSON line with the JAX tool's keys: {"metric":
"e2e_scan_tracks_per_sec", "value", "unit", "tracks", "errors",
"audio_sec", "rt_factor", "wall_s", "decode_rt", "analyze_rt",
"decode_threads"}, and "device" and "kinds" (the kinds of file made).
The exit code is 1 when a file fails to analyze. `--device cpu` runs the
kernels' plain versions; without a card the default device is an error
(exit 2).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

RATE = 48000
SEED = 7


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _lame_encode(path, x, rate, kbps=128) -> bool:
    """x (2, N) float32 as a CBR MP3 through the system's libmp3lame;
    False when the library is not installed."""
    import ctypes

    lame = None
    for name in ("libmp3lame.so.0", "libmp3lame.so"):
        try:
            lame = ctypes.CDLL(name)
            break
        except OSError:
            pass
    if lame is None:
        return False
    lame.lame_init.restype = ctypes.c_void_p
    lame.lame_encode_buffer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]
    lame.lame_encode_flush.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    g = ctypes.c_void_p(lame.lame_init())
    lame.lame_set_in_samplerate(g, ctypes.c_int(rate))
    lame.lame_set_out_samplerate(g, ctypes.c_int(rate))
    lame.lame_set_num_channels(g, ctypes.c_int(2))
    lame.lame_set_brate(g, ctypes.c_int(kbps))
    if lame.lame_init_params(g) < 0:
        return False
    li = np.ascontiguousarray((x[0] * 32767).clip(-32768, 32767), np.int16)
    ri = np.ascontiguousarray((x[1] * 32767).clip(-32768, 32767), np.int16)
    buf = ctypes.create_string_buffer(len(li) * 4 + (1 << 16))
    n = lame.lame_encode_buffer(g, li.ctypes.data, ri.ctypes.data,
                                len(li), buf, len(buf))
    out = buf.raw[:n]
    n2 = lame.lame_encode_flush(g, buf, len(buf))
    out += buf.raw[:n2]
    lame.lame_close(ctypes.c_void_p(g.value))
    with open(path, "wb") as f:
        f.write(out)
    return True


def _encode(path: str, kind: str, x: np.ndarray, rate: int) -> bool:
    """Write planar (2, N) float32 x to `path` as `kind`; False when the
    kind cannot be made here (MP3 without libmp3lame)."""
    import wave

    from soundscope_tpu_torch.native import decoder as native
    from soundscope_tpu_torch.utils.flacenc import encode_flac

    if kind == "wav":
        with wave.open(path, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes((x.T * 32767).astype("<i2").reshape(-1).tobytes())
    elif kind == "flac":
        with open(path, "wb") as f:
            f.write(encode_flac(x, rate))
    elif kind == "mp3":
        return _lame_encode(path, x, rate)
    else:
        native.encode(path, x, rate, codec={"ogg": "vorbis", "m4a": "alac", "aac": "aac"}[kind])
    return True


def corpus_kinds() -> list[str]:
    """The rotation of kinds: the codec bridge's three where it is there."""
    from soundscope_tpu_torch.native import decoder as native

    return ["wav", "flac", "mp3"] + (["ogg", "m4a", "aac"] if native.codecs_available() else [])


def make_corpus(d: str, tracks: int, seconds: float, rate: int = RATE) -> list[str]:
    """Write `tracks` files of tones and noise at mixed levels into d as
    track0000.<kind> ...; returns the paths made in order (the MP3 slots
    are skipped where libmp3lame is missing). The material is drawn here,
    in track order, and encoded by a process pool."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    kinds = corpus_kinds()
    rng = np.random.default_rng(SEED)
    t = np.arange(int(seconds * rate)) / rate
    workers = max(1, min(os.cpu_count() or 4, 8, tracks))
    made, pending = [], collections.deque()

    def take():
        p, fut = pending.popleft()
        if fut.result():
            made.append(p)

    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        for i in range(tracks):
            f0 = 80.0 * (1 + (i % 37))
            amp = 10.0 ** (rng.uniform(-30.0, -8.0) / 20.0)
            x = np.stack([
                amp * (np.sin(2 * np.pi * f0 * t + c) + 0.3 * rng.standard_normal(t.size))
                for c in range(2)
            ]).astype(np.float32).clip(-0.99, 0.99)
            kind = kinds[i % len(kinds)]
            p = os.path.join(d, f"track{i:04d}.{kind}")
            pending.append((p, ex.submit(_encode, p, kind, x, rate)))
            if len(pending) > 2 * workers:   # a bounded window of samples in flight
                take()
        while pending:
            take()
    return made


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m soundscope_tpu_torch.tools.e2e_scan_bench",
        description="Encoded tracks per second through `analyze`.")
    ap.add_argument("tracks", type=int, nargs="?", default=1000,
                    help="files in the corpus (default 1000)")
    ap.add_argument("seconds", type=float, nargs="?", default=15.0,
                    help="seconds per file (default 15)")
    ap.add_argument("--keep", metavar="DIR",
                    help="make the corpus in DIR and keep it (reused when it holds enough)")
    ap.add_argument("--threads", type=int, default=0,
                    help="decode threads (default 0: one per core, at most 16)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to compute (default: cuda)")
    args = ap.parse_args(argv)
    if args.tracks < 1 or args.seconds <= 0 or args.threads < 0:
        ap.error("tracks and seconds must be positive, --threads at least 0")
    return args


def run(args, d: str, dev) -> dict:
    """Make or reuse the corpus in d, warm, and time the scan on `dev`;
    returns the JSON line."""
    import torch

    from soundscope_tpu_torch.apps.cli import FLUSH_AT, _analyze_paths, _decode_workers
    from soundscope_tpu_torch.utils.metrics import GLOBAL as RT

    t0 = time.perf_counter()
    existing = sorted(os.path.join(d, f) for f in os.listdir(d) if f.startswith("track"))
    if args.keep and len(existing) >= args.tracks:
        paths = existing[: args.tracks]
        log(f"corpus: reusing {len(paths)} files in {d}")
    else:
        paths = make_corpus(d, args.tracks, args.seconds)
        log(f"corpus: {len(paths)} files made in {time.perf_counter() - t0:.2f} s in {d}")
    kinds = [k for k in corpus_kinds() if any(p.endswith("." + k) for p in paths)]

    warm = min(FLUSH_AT, len(paths)) + (len(paths) % FLUSH_AT or FLUSH_AT)
    t0 = time.perf_counter()
    _analyze_paths(paths[:warm], dev, threads=args.threads)
    log(f"warm-up on {min(warm, len(paths))} files: {time.perf_counter() - t0:.2f} s")
    RT.reset()

    t0 = time.perf_counter()
    rows = _analyze_paths(paths, dev, threads=args.threads)
    wall = time.perf_counter() - t0
    errs = [r for r in rows if "error" in r]
    for r in errs[:5]:
        log(f"error: {r['file']}: {r['error']}")
    audio = sum(r.get("duration_s", 0.0) for r in rows)
    rep = RT.report()
    return {
        "metric": "e2e_scan_tracks_per_sec",
        "value": len(rows) / wall,
        "unit": "encoded_tracks/sec",
        "tracks": len(rows),
        "errors": len(errs),
        "audio_sec": audio,
        "rt_factor": audio / wall,
        "wall_s": wall,
        "decode_rt": rep.get("decode", {}).get("rt_factor"),
        "analyze_rt": rep.get("analyze", {}).get("rt_factor"),
        "decode_threads": _decode_workers(len(paths), args.threads),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "kinds": kinds,
    }


def main(argv=None) -> int:
    from soundscope_tpu_torch.core.device import default_device

    args = parse_args(sys.argv[1:] if argv is None else argv)
    try:
        dev = default_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    d = args.keep or tempfile.mkdtemp(prefix="ss_e2e_")
    try:
        os.makedirs(d, exist_ok=True)
        line = run(args, d, dev)
    finally:
        if not args.keep:
            shutil.rmtree(d, ignore_errors=True)
    print(json.dumps(line), flush=True)
    return 1 if line["errors"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
