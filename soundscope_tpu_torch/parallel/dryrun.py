"""Certify the data- and sequence-parallel analysis on ranks of cards or
of the CPU.

    python -m soundscope_tpu_torch.parallel.dryrun --world 8 [--seq S] [--out DIR]
    python -m soundscope_tpu_torch.parallel.dryrun --world 4 --multihost
    python -m soundscope_tpu_torch.parallel.dryrun --world 8 --device cpu

The counterpart of the JAX package's dryrun_multichip and
dryrun_multihost (__graft_entry__.py, tools/multihost_worker.py). The
launcher spawns `--world` ranks, each a fresh interpreter running this
module with `--rank` (no JAX is imported), joined by a process group at
tcp://127.0.0.1 on a free port with a timeout: by default one card a
rank under NCCL (rank r on card r of this machine), with `--device cpu`
CPU processes under gloo. Asked for more ranks than the machine has
cards, or for a card where there is none, it raises before it spawns a
rank. It
waits for the ranks at most `--timeout` seconds, kills any still
running, prints every rank's output and exits 0 only if every rank did.
The references (the single-device engine, the meters on whole signals)
run on the rank's device.

Multichip (the default) runs on a (data x seq) mesh, seq the largest of
1, 2 and 4 that divides the world unless --seq is given, two tracks per
data row, and holds each product to the port's single-device engine
within the JAX dryrun's own asserts:
  * 48 kHz with ragged lengths (tracks end inside different shards, one
    inside shard 0, garbage past n_valid) and 16 kHz uniform, through
    sharded_analyze_fn: integrated, LRA, true and sample peak and the
    valid momentary and short-term timelines within 5e-3; the same
    blocks through composed_analyze (one process) equal bit for bit;
  * the streaming meter with max_blocks=16, forced into histogram mode,
    under data parallelism (each rank its own tracks' meters): within
    0.05 LU of the engine's integrated loudness;
  * the live pipeline (push and frame at 44.1 kHz in 2,048-sample chunks)
    under data parallelism against the same pipeline on the whole
    signal: within 5e-3;
  * the data axis alone (a world x 1 mesh, a track a rank, results
    gathered over "data"): integrated within 1e-5 LU of one process.
Rank 0 prints `dryrun_multichip ok: mesh=(D data x S seq), ...` with the
largest delta of each component over all ranks; --out DIR saves the
gathered results to DIR/results.npz.

--multihost makes two hosts of world / 2 ranks each (LOCAL_WORLD_SIZE),
seq 2 inside a host (make_multihost_mesh), and every host passes its own
tracks to global_batch; the gathered integrated
loudness must be within 1e-4 LU of one process. Each rank prints
MULTIHOST_OK.
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import soundscope_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(soundscope_tpu_torch.__file__)))
FIELDS = ("integrated_lufs", "lra", "momentary", "shortterm", "n_momentary",
          "n_shortterm", "true_peak", "sample_peak")
# the JAX dryrun's asserts
PIN = 5e-3
PIN_HIST = 0.05
PIN_DATA = 1e-5
PIN_MULTIHOST = 1e-4


def default_seq(world: int) -> int:
    """The JAX dryrun's choice: the largest of 1, 2 and 4 dividing world."""
    seq = 1
    while seq * 2 <= world and world % (seq * 2) == 0 and seq < 4:
        seq *= 2
    return seq


def certify_inputs(n_data: int, n_seq: int) -> list:
    """[(label, cfg, x (b, 2, N) float32, n_valid (b,) int64)] of the
    multichip certificate, b = 2 n_data, made from numpy seed 0: 48 kHz
    ragged (2.35 s) and 16 kHz uniform (4 s), each padded for n_seq shards
    with noise past n_valid."""
    from soundscope_tpu_torch.core.config import MeterConfig
    from soundscope_tpu_torch.parallel import pad_for_mesh

    rng = np.random.default_rng(0)
    b = 2 * n_data
    cfg48 = MeterConfig(channels=2, rate=48000, max_blocks=0)
    n48 = int(2.35 * cfg48.rate)
    npad48 = pad_for_mesh(n48, cfg48, n_seq)
    nloc48 = npad48 // n_seq
    # >= 5 sub-blocks, so even the shortest track has gating blocks
    ragged = [n48, n48 - 1237, max(nloc48 // 2 + 17, 5 * cfg48.subblock + 23),
              min(3 * nloc48 // 2 + 999, n48)]
    nv48 = np.asarray([ragged[i % len(ragged)] for i in range(b)], np.int64)
    x48 = (rng.standard_normal((b, 2, npad48)) * 0.05).astype(np.float32)
    cfg16 = MeterConfig(channels=2, rate=16000, max_blocks=0)
    n16 = 4 * cfg16.rate
    x16 = (rng.standard_normal((b, 2, pad_for_mesh(n16, cfg16, n_seq))) * 0.05
           ).astype(np.float32)
    nv16 = np.full(b, n16, np.int64)
    return [("48k_ragged", cfg48, x48, nv48), ("16k", cfg16, x16, nv16)]


def data_parallel_inputs(world: int):
    """(cfg, x (world, 2, 4 s at 16 kHz), n_valid) from numpy seed 1."""
    from soundscope_tpu_torch.core.config import MeterConfig

    cfg = MeterConfig(channels=2, rate=16000, max_blocks=0)
    x = (np.random.default_rng(1).standard_normal((world, 2, 4 * cfg.rate)) * 0.05
         ).astype(np.float32)
    return cfg, x, np.full(world, x.shape[-1], np.int64)


def multihost_inputs(n_data: int, n_seq: int):
    """(cfg, x (n_data, 2, N), n_valid) of the multi-host scan: 3 s at
    16 kHz from numpy seed 0, zero past n_valid (tools/multihost_worker.py)."""
    from soundscope_tpu_torch.core.config import MeterConfig
    from soundscope_tpu_torch.parallel import pad_for_mesh

    cfg = MeterConfig(channels=2, rate=16000, max_blocks=0)
    n = 3 * cfg.rate
    x = (np.random.default_rng(0).standard_normal(
        (n_data, 2, pad_for_mesh(n, cfg, n_seq))) * 0.05).astype(np.float32)
    x[:, :, n:] = 0.0
    return cfg, x, np.full(n_data, n, np.int64)


def _host(v) -> np.ndarray:
    return np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v, np.float64)


def _delta(a, r, counts=None) -> float:
    """Largest |a - r|, equal values (infinities too) counting 0; a
    timeline compares each track's valid prefix only."""
    a, r = _host(a), _host(r)
    if counts is not None:
        return max((_delta(a[i, :c], r[i, :c]) for i, c in enumerate(counts)), default=0.0)
    if a.size == 0:
        return 0.0
    if a.shape != r.shape:
        return float("inf")
    return float(np.max(np.where(a == r, 0.0, np.abs(a - r))))


def component_deltas(res, ref) -> dict:
    """The JAX dryrun's per-component deltas of an AnalysisResult (on any
    device)."""
    counts = _host(ref.n_momentary).astype(np.int64)
    if not (np.array_equal(_host(res.n_momentary), counts)
            and np.array_equal(_host(res.n_shortterm), _host(ref.n_shortterm))):
        raise AssertionError("timeline lengths differ")
    return {
        "integrated_lufs": _delta(res.integrated_lufs, ref.integrated_lufs),
        "lra_lu": _delta(res.lra, ref.lra),
        "true_peak": _delta(res.true_peak, ref.true_peak),
        "sample_peak": _delta(res.sample_peak, ref.sample_peak),
        "momentary": _delta(res.momentary, ref.momentary, counts),
        "shortterm": _delta(res.shortterm, ref.shortterm,
                            _host(ref.n_shortterm).astype(np.int64)),
    }


def same(a, b) -> bool:
    """Equal results field by field (NaN equal to NaN)."""
    for f in FIELDS:
        u, v = getattr(a, f), getattr(b, f)
        if u.shape != v.shape or not bool(((u == v) | (u.isnan() & v.isnan())).all()):
            return False
    return True


def _max_over_ranks(values: dict, dev: torch.device) -> dict:
    """Each value's largest over all ranks (NaN wins); every rank passes
    the same keys in the same order."""
    import torch.distributed as dist

    keys = list(values)
    t = torch.tensor([values[k] for k in keys], dtype=torch.float64, device=dev)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    top = torch.stack(parts).amax(dim=0).cpu()
    return {k: float(v) for k, v in zip(keys, top)}


def _numpy(res) -> dict:
    return {f: getattr(res, f).cpu().numpy() for f in FIELDS}


def _save(out: str, arrays: dict) -> None:
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, "results.npz"), **arrays)


def _multichip(args) -> str:
    import torch.distributed as dist

    from soundscope_tpu_torch.core.config import MeterConfig
    from soundscope_tpu_torch.core.state import init_meter_state
    from soundscope_tpu_torch.models import live as LV
    from soundscope_tpu_torch.models import meter as M
    from soundscope_tpu_torch.models.engine import analyze_batch_native
    from soundscope_tpu_torch.parallel import global_batch, make_mesh, sharded_analyze_fn
    from soundscope_tpu_torch.parallel.mesh import mesh_device
    from soundscope_tpu_torch.parallel.seqshard import composed_analyze, gather_tracks

    world = dist.get_world_size()
    seq = args.seq or default_seq(world)
    mesh = make_mesh(world, seq=seq, device=args.device)
    dev = mesh_device(mesh)
    n_data = mesh.shape[0]
    d, s = mesh.get_coordinate()
    b = 2 * n_data
    rows = slice(2 * d, 2 * d + 2)                # this rank's data row
    deltas, saved, refs = {}, {}, {}
    composed_differs = 0.0
    integ = []
    sets = certify_inputs(n_data, seq)
    for label, cfg, x, nv in sets:
        xs, nvs = global_batch(mesh, x, nv)
        res = sharded_analyze_fn(cfg, mesh)(xs, nvs)
        xr, nvr = torch.from_numpy(x[rows]).to(dev), torch.from_numpy(nv[rows]).to(dev)
        refs[label] = ref = analyze_batch_native(cfg, xr, nvr)
        for k, v in component_deltas(res, ref).items():
            deltas[f"{label}.{k}"] = v
        if not same(composed_analyze(cfg, xr, nvr, seq), res):
            composed_differs = 1.0
        if label == "48k_ragged":                 # the JAX dryrun's printed range
            integ.append(res.integrated_lufs.cpu().numpy())
        saved.update({f"{label}.{f}": v for f, v in _numpy(gather_tracks(mesh, res)).items()})

    # the streaming meter in histogram mode: max_blocks=16 < the 37 gating
    # blocks of a 4 s track, each rank its own tracks
    _, cfg16, x16, nv16 = sets[1]
    cfg_ov = MeterConfig(channels=2, rate=cfg16.rate, max_blocks=16)
    step = M.meter_step(cfg_ov)
    chunk = cfg16.rate // 2
    d_ov = 0.0
    for i, g in enumerate(range(rows.start, rows.stop)):
        st = init_meter_state(cfg_ov, dev)
        for a in range(0, int(nv16[g]), chunk):
            st = step(st, torch.from_numpy(x16[g, :, a:a + chunk]).to(dev))
        if int(st.block_count) <= cfg_ov.max_blocks:
            raise AssertionError("the overflow config did not overflow the exact history")
        d_ov = max(d_ov, _delta(M.integrated_lufs(cfg_ov, st), refs["16k"].integrated_lufs[i]))
    deltas["integrated_hist_overflow"] = d_ov

    # the live pipeline at 44.1 kHz in 2,048-sample chunks, each rank its
    # own tracks, against the same pipeline on the whole signal
    cfg_lv = MeterConfig(channels=2, rate=44100, max_blocks=0)
    t = np.arange(int(1.5 * cfg_lv.rate)) / cfg_lv.rate
    sig = np.stack([0.2 * np.sin(2 * np.pi * (300.0 + 40.0 * k) * t)
                    for k in range(b)]).astype(np.float32)
    inter = np.repeat(sig, 2, axis=-1)            # pseudo-interleave
    push, frame = LV.live_push(cfg_lv), LV.live_frame(cfg_lv)

    def live(track: np.ndarray):
        state = LV.init_live_state(cfg_lv, seconds=4, device=dev)
        for j in range(track.shape[-1] // 2048):
            state = push(state, torch.from_numpy(track[j * 2048:(j + 1) * 2048]).to(dev))
        return frame(state)

    d_live = 0.0
    mine = inter[rows]
    for i, g in enumerate(range(rows.start, rows.stop)):
        fr, fr1 = live(mine[i]), live(inter[g].copy())
        if not bool(torch.isfinite(fr.shortterm)):
            raise AssertionError("live short-term not finite")
        d_live = max(d_live, *(_delta(getattr(fr, f), getattr(fr1, f))
                               for f in ("shortterm", "true_peak", "fft_mid", "wf_max")))
    deltas["live_sharded"] = d_live

    # the data axis alone: a world x 1 mesh, a track a rank
    cfg_dp, x_dp, nv_dp = data_parallel_inputs(world)
    mesh1 = make_mesh(world, seq=1, device=args.device)
    xd, nvd = global_batch(mesh1, x_dp, nv_dp)
    got = gather_tracks(mesh1, analyze_batch_native(cfg_dp, xd, nvd))
    want = analyze_batch_native(cfg_dp, torch.from_numpy(x_dp).to(dev),
                                torch.from_numpy(nv_dp).to(dev))
    deltas["data_parallel"] = _delta(got.integrated_lufs, want.integrated_lufs)
    saved.update({f"data_parallel.{f}": v for f, v in _numpy(got).items()})

    deltas = _max_over_ranks({**deltas, "composed_differs": composed_differs}, dev)
    composed_differs = deltas.pop("composed_differs")
    for k, v in deltas.items():
        pin = {"integrated_hist_overflow": PIN_HIST, "data_parallel": PIN_DATA}.get(k, PIN)
        if not v <= pin:
            raise AssertionError(f"{k} diverges: {v} > {pin}")
    if composed_differs:
        raise AssertionError(f"composed_analyze differs from the {dist.get_backend()} run")
    span = _max_over_ranks({"hi": max(float(np.max(v)) for v in integ),
                            "neg_lo": -min(float(np.min(v)) for v in integ)}, dev)
    if args.out and dist.get_rank() == 0:
        _save(args.out, {**saved, "mesh": np.asarray(mesh.shape),
                         **{f"delta.{k}": np.asarray(v) for k, v in deltas.items()}})
    return (f"dryrun_multichip ok: mesh=({n_data} data x {seq} seq) on {dev.type}, "
            f"{b} tracks, "
            f"integrated range [{-span['neg_lo']:.2f}, {span['hi']:.2f}] LUFS; max |sharded - "
            "single-device| per component: "
            + ", ".join(f"{k}={v:.2e}" for k, v in deltas.items())
            + f"; composed_analyze equals the {dist.get_backend()} run bit for bit")


def _multihost(args) -> str:
    import torch.distributed as dist

    from soundscope_tpu_torch.models.engine import analyze_batch_native
    from soundscope_tpu_torch.parallel import (
        global_batch,
        make_multihost_mesh,
        sharded_analyze_fn,
    )
    from soundscope_tpu_torch.parallel.mesh import local_world_size, mesh_device
    from soundscope_tpu_torch.parallel.seqshard import gather_tracks

    local = local_world_size()
    seq = 2 if local % 2 == 0 else 1
    mesh = make_multihost_mesh(seq=seq, device=args.device)
    dev = mesh_device(mesh)
    n_data = mesh.shape[0]
    cfg, x_all, nv_all = multihost_inputs(n_data, seq)
    # every host generates the whole set, keeps its own tracks and can
    # compute the one-process reference
    per_host = local // seq
    lo = dist.get_rank() // local * per_host
    xs, nv = global_batch(mesh, x_all[lo:lo + per_host], nv_all[lo:lo + per_host])
    res = gather_tracks(mesh, sharded_analyze_fn(cfg, mesh)(xs, nv))
    want = analyze_batch_native(cfg, torch.from_numpy(x_all).to(dev),
                                torch.from_numpy(nv_all).to(dev))
    err = _delta(res.integrated_lufs, want.integrated_lufs)
    if not err < PIN_MULTIHOST:
        raise AssertionError(f"multihost mismatch: {err}")
    if args.out and dist.get_rank() == 0:
        _save(args.out, {f"multihost.{f}": v for f, v in _numpy(res).items()})
    return (f"MULTIHOST_OK pid={dist.get_rank()} mesh=({n_data}x{seq}) on {dev.type} "
            f"hosts={dist.get_world_size() // local} tracks={n_data} max_err={err:.2e}")


def run_rank(args) -> int:
    """One rank: join the process group, run the certificate, leave."""
    import torch.distributed as dist

    from soundscope_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"tcp://127.0.0.1:{args.port}", args.world, args.rank, device=args.device,
                     timeout=datetime.timedelta(seconds=max(args.timeout - 10, 5)))
    try:
        line = (_multihost if args.multihost else _multichip)(args)
    finally:
        dist.destroy_process_group()
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "soundscope_tpu"))
    if bad:
        raise AssertionError(f"a rank imported {bad[:5]}")
    print(f"rank {args.rank}: no jax, jaxlib, flax or soundscope_tpu module loaded")
    print(line, flush=True)
    return 0


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for a process group's store."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_devices(device, world: int) -> list:
    """Each of `world` ranks' device on this machine for `device` (None:
    the card): rank r takes card r, or the CPU. Raises rather than put two
    ranks on one card (NCCL refuses them) or fall back to the CPU."""
    from soundscope_tpu_torch.core.device import default_device

    kind = default_device(device).type
    if kind == "cpu":
        return ["cpu"] * world
    if kind != "cuda":
        raise ValueError(f"ranks run on CUDA or the CPU, not {kind}")
    if torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} cards, one a rank (NCCL refuses "
                           f"two ranks on one card), and this machine has "
                           f"{torch.cuda.device_count()}; pass --device cpu for CPU ranks")
    return [f"cuda:{r}" for r in range(world)]


def launch(world: int, multihost: bool = False, seq: int | None = None,
           out: str | None = None, timeout: float = 60.0, device=None) -> list:
    """Spawn `world` ranks of this module on `device` (None: one card a
    rank; "cpu": CPU processes) and wait for them at most `timeout`
    seconds, killing any left after it. Returns each rank's output; raises
    RuntimeError unless every rank exited 0."""
    local = world // 2 if multihost else world
    devices = rank_devices(device, world)
    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "LOCAL_WORLD_SIZE": str(local),
           "PYTHONPATH": os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    cmd = [sys.executable, "-m", "soundscope_tpu_torch.parallel.dryrun", "--world", str(world),
           "--port", str(port), "--timeout", str(timeout)]
    cmd += ["--multihost"] if multihost else []
    cmd += ["--seq", str(seq)] if seq else []
    cmd += ["--out", out] if out else []
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(world)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r), "--device", devices[r]],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              env={**env, "LOCAL_RANK": str(r % local)}, cwd=REPO)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    if timed_out or any(p.returncode for p in procs):
        why = f"ranks killed after {timeout} s" if timed_out else "a rank failed"
        raise RuntimeError(f"dryrun: {why}:\n" + "\n---\n".join(
            f"rank {r} (exit {p.returncode}):\n{o[-3000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m soundscope_tpu_torch.parallel.dryrun")
    ap.add_argument("--world", type=int, default=8, help="ranks")
    ap.add_argument("--device", default=None,
                    help="the ranks' device: cuda (the default; rank r on card r) or cpu")
    ap.add_argument("--seq", type=int, default=None, help="seq axis (default: 4, 2 or 1)")
    ap.add_argument("--multihost", action="store_true", help="the multi-host scan")
    ap.add_argument("--out", default=None, help="rank 0 saves results.npz here")
    ap.add_argument("--timeout", type=float, default=60.0, help="seconds for all ranks")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return run_rank(args)
    try:
        outs = launch(args.world, args.multihost, args.seq, args.out, args.timeout,
                      args.device)
    except (RuntimeError, ValueError) as e:
        print(e, file=sys.stderr)
        return 1
    for o in outs[1:]:
        print(o.strip().splitlines()[0])
    print(outs[0].strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
