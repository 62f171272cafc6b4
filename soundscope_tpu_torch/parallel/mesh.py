"""Process groups and the (data, seq) device mesh over torch.distributed.

The counterpart of the JAX package's parallel/mesh.py. The workload's
parallel axes are:
  * "data": independent tracks (the library scan; nothing is exchanged
    but the final gather of per-track results);
  * "seq": the time axis within a track (long files), with the exact
    filter-state hand-off of parallel/seqshard.py.
There is no tensor, pipeline or expert parallelism: the analyzer has no
weight matrices, layers or experts to shard.

One rank is one device: a CUDA card under NCCL, or a CPU process under
gloo. Ranks are laid out row-major on the mesh, rank = data * seq + s,
so a seq group is `seq` consecutive ranks. A launcher that numbers a
host's ranks consecutively (torchrun does) keeps each seq group inside a
host when seq divides the host's rank count (`make_multihost_mesh`): only
the data axis then crosses hosts.

Nothing here falls back: a CUDA device asked for where there is none, a
backend the installation lacks, a mesh that does not divide the world,
or a second initialisation raises.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from soundscope_tpu_torch.core.device import default_device

DIMS = ("data", "seq")
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device=None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join (or start) a run of ranks; returns this rank's device.

    With no coordinator the launcher's environment says everything
    (``env://``: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE), as JAX defers
    to the cluster's; a coordinator ("tcp://host:port" or "host:port")
    takes num_processes and process_id. `device` None means the card:
    NCCL for a CUDA device (this rank's card: the device's index, else
    LOCAL_RANK, else the rank modulo the cards), gloo for the CPU.
    `timeout` bounds every collective, so a rank that never arrives ends
    the run rather than hangs it.
    """
    dev = default_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"ranks run on CUDA or the CPU, not {dev}")
    if not dist.is_available():
        raise RuntimeError("this torch has no torch.distributed")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not (dist.is_nccl_available() if backend == "nccl" else dist.is_gloo_available()):
        raise RuntimeError(f"this torch has no {backend} backend for {dev.type} ranks")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    if coordinator is None:
        init = "env://"
        rank = int(os.environ["RANK"])
        kw = {}
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        rank = process_id
        kw = dict(world_size=num_processes, rank=process_id)
    if dev.type == "cuda":
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            dev = torch.device("cuda", int(local) if local is not None
                               else rank % torch.cuda.device_count())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} asks for {dev} and this machine has "
                               f"{torch.cuda.device_count()} cards")
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init, timeout=timeout, **kw)
    return dev


def _mesh_type(device) -> str:
    if device is not None:
        return torch.device(device).type
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _build(device_type: str, seq: int) -> DeviceMesh:
    n = dist.get_world_size()
    return init_device_mesh(device_type, (n // seq, seq), mesh_dim_names=DIMS)


def make_mesh(n_devices: int | None = None, seq: int = 1, device=None) -> DeviceMesh:
    """Mesh over (data, seq) of every rank; `seq` divides the rank count,
    data = n / seq. n_devices, where given, must be the world size (one
    device a rank). device: the ranks' device type ("cuda" or "cpu"; None:
    the process group's)."""
    kind = _mesh_type(device)
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}: one device a rank, and there are {n} ranks")
    if seq < 1 or n % seq != 0:
        raise ValueError(f"seq={seq} must divide device count {n}")
    return _build(kind, seq)


def local_world_size() -> int:
    """Ranks on this host: LOCAL_WORLD_SIZE, as a launcher such as torchrun
    sets it, else every rank (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def make_multihost_mesh(seq: int = 1, device=None) -> DeviceMesh:
    """Mesh over every host's ranks with the seq axis confined to one host:
    seq divides the host's rank count (LOCAL_WORLD_SIZE), so the
    state hand-off stays inside a host and only the data axis, which
    exchanges nothing but results, crosses hosts."""
    kind = _mesh_type(device)
    local, n = local_world_size(), dist.get_world_size()
    if seq < 1 or seq > local or local % seq != 0:
        raise ValueError(f"seq={seq} must divide the per-process device count {local}")
    if n % local != 0:
        raise ValueError(f"{n} ranks are no whole number of hosts of {local}")
    return _build(kind, seq)


def data_sharding(mesh: DeviceMesh) -> tuple:
    """Placements of a (B, C, N) track batch split over the data axis."""
    return (Shard(0), Replicate())


def seq_sharding(mesh: DeviceMesh) -> tuple:
    """Placements of a (B, C, N) track batch split over data and time."""
    return (Shard(0), Shard(2))


def replicated(mesh: DeviceMesh) -> tuple:
    return (Replicate(), Replicate())


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on the mesh: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _block(t: torch.Tensor, placements, coord, sizes) -> torch.Tensor:
    """The block of t at mesh coordinate `coord` under `placements`, each
    Shard(k) of a mesh dimension of `sizes[i]` splitting dim k evenly."""
    for p, c, size in zip(placements, coord, sizes):
        if isinstance(p, Shard):
            n = t.shape[p.dim]
            if n % size:
                raise ValueError(f"dim {p.dim} of length {n} does not split {size} ways")
            t = t.narrow(p.dim, c * (n // size), n // size)
    return t


def global_batch(mesh: DeviceMesh, local_tracks, local_n_valid):
    """This rank's block of the global (B, C, N) batch and its valid
    lengths, on the mesh's device.

    Every rank passes ITS HOST's tracks, as in the JAX package each process
    passes its own: the rows of the data coordinates of the host's ranks
    (all of the batch on one host), at full length. The rank keeps the
    rows of its data coordinate and the time shard of its seq coordinate
    (`seq_sharding`), and their n_valid (`data_sharding`). Returns
    (x (B_loc, C, N / seq) float32, n_valid (B_loc,) int64).
    """
    n_data, n_seq = mesh.shape
    d, s = mesh.get_coordinate()
    local = local_world_size()
    if local % n_seq:
        raise ValueError(f"the seq axis ({n_seq}) must stay inside a host of {local} ranks")
    d_host = local // n_seq                      # data coordinates per host
    coord, sizes = (d % d_host, s), (d_host, n_seq)
    dev = mesh_device(mesh)
    x = torch.as_tensor(np.ascontiguousarray(local_tracks, np.float32)
                        if isinstance(local_tracks, np.ndarray) else local_tracks)
    nv = torch.as_tensor(np.asarray(local_n_valid, np.int64)
                         if isinstance(local_n_valid, np.ndarray) else local_n_valid)
    if x.ndim != 3 or x.dtype != torch.float32:
        raise ValueError(f"tracks must be (B, C, N) float32, got {tuple(x.shape)} {x.dtype}")
    if nv.shape != x.shape[:1]:
        raise ValueError(f"n_valid must be ({x.shape[0]},), got {tuple(nv.shape)}")
    xb = _block(x, seq_sharding(mesh), coord, sizes)
    nvb = _block(nv, data_sharding(mesh), coord, sizes)
    return xb.to(dev).contiguous(), nvb.to(dev, torch.int64)
