"""Meter-state checkpoint/resume, in the JAX package's .npz format.

A checkpoint is one .npz file: the config as JSON bytes (``__config__``
for a meter, ``__live__`` with the ring length for a live pipeline) and
the state's arrays as ``leaf_0``, ``leaf_1``, ... in the JAX pytree order,
which is the field order of core/state.py (a live state: the meter's
fields, then the ring, then the cursor). A file written by either package
loads in the other: the JAX config's ``iir_impl`` has no counterpart here
and is dropped on load, and the JAX loader gives it its default.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.core.device import default_device
from soundscope_tpu_torch.core.state import MeterState, init_meter_state

# MeterConfig fields of the JAX package that the port does not have
_DROPPED = ("iir_impl",)


def _leaves(state) -> list[torch.Tensor]:
    """The state's tensors in the JAX pytree order."""
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out.extend(_leaves(v) if dataclasses.is_dataclass(v) else [v])
    return out


def _config(meta: dict) -> MeterConfig:
    return MeterConfig(**{k: v for k, v in meta.items() if k not in _DROPPED})


def _save(path: str, key: str, meta: dict, state) -> None:
    arrays = {f"leaf_{i}": v.detach().cpu().numpy() for i, v in enumerate(_leaves(state))}
    tmp = path + ".tmp.npz"  # savez appends .npz unless present
    np.savez(tmp, **{key: np.frombuffer(json.dumps(meta).encode(), np.uint8)}, **arrays)
    os.replace(tmp, path)


def _load_into(data, template, device):
    """The template's structure (a CPU state) filled with the file's leaves
    on `device` (None: the card when there is one)."""
    device = default_device(device)
    def fill(t, it):
        vals = {}
        for f in dataclasses.fields(t):
            v = getattr(t, f.name)
            if dataclasses.is_dataclass(v):
                vals[f.name] = fill(v, it)
                continue
            got = next(it)
            if got.shape != tuple(v.shape):
                raise ValueError(
                    f"checkpoint shape mismatch: {got.shape} vs {tuple(v.shape)} "
                    "(was the config changed?)")
            vals[f.name] = torch.from_numpy(got.astype(np.asarray(v).dtype)).to(device)
        return type(t)(**vals)

    n = len(_leaves(template))
    return fill(template, iter(data[f"leaf_{i}"] for i in range(n)))


def save_meter(path: str, cfg: MeterConfig, state: MeterState) -> None:
    """Write config + state. `path` is a .npz file (created atomically)."""
    _save(path, "__config__", dataclasses.asdict(cfg), state)


def load_meter(path: str, device=None) -> tuple[MeterConfig, MeterState]:
    """-> (cfg, MeterState on `device`; None: the card when there is one)."""
    data = np.load(path)
    cfg = _config(json.loads(bytes(data["__config__"]).decode()))
    return cfg, _load_into(data, init_meter_state(cfg, "cpu"), device)


def save_live(path: str, cfg: MeterConfig, state, seconds: int) -> None:
    """Checkpoint a live-pipeline state (models/live.LiveState: meter +
    ring + cursor) so mic sessions resume bit-exactly."""
    _save(path, "__live__", {"config": dataclasses.asdict(cfg), "seconds": seconds}, state)


def load_live(path: str, device=None):
    """-> (cfg, seconds, LiveState on `device`; None: the card when there is one)."""
    from soundscope_tpu_torch.models.live import init_live_state

    data = np.load(path)
    meta = json.loads(bytes(data["__live__"]).decode())
    cfg = _config(meta["config"])
    seconds = int(meta["seconds"])
    return cfg, seconds, _load_into(data, init_live_state(cfg, seconds, "cpu"), device)
