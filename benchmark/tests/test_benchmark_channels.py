"""The batch harness takes the configuration's channel count: the stereo
signal is the one it always was, bit for bit; six channels keep the
generator's sections, silence and ceiling with each channel's stated
correlation; and a 5.1 cell at 192 kHz is added from new files alone,
correct for the program and not for the control or a fault."""

import json
import math
import shutil
import time

import pytest
import torch

from benchmark import generator, harness, systems
from benchmark.tests.conftest import REPO
from benchmark.tests.test_benchmark_control import Altered, HalfBatch

SIGNAL = json.loads((REPO / "benchmark" / "traffic" / "library_rows.json").read_text())["signal"]
RATE = 48000


def stereo_tracks(seed: int, b: int, n: int, rate: int, signal: dict, device) -> torch.Tensor:
    """The stereo generator as it was before it took a channel count, kept
    frozen: (b, 2, n) float32 programme-like stereo on `device`."""
    if n % generator.UNIT:
        raise ValueError(f"track length {n} is no multiple of {generator.UNIT}")
    g = generator.torch_generator(seed, device)
    x = torch.empty((b, 2, n), dtype=torch.float32, device=device)
    x.normal_(generator=g)
    c = float(signal["correlation"])
    x[:, 1].mul_(math.sqrt(1.0 - c * c)).add_(x[:, 0], alpha=c)
    units = n // generator.UNIT
    lo_s, hi_s = signal["section_s"]
    lo_u = max(1, round(lo_s * rate / generator.UNIT))
    hi_u = max(1, round(hi_s * rate / generator.UNIT))
    sections = units // lo_u + 1
    length = torch.randint(lo_u, hi_u + 1, (b, sections), generator=g, device=device)
    lo_db, hi_db = signal["level_dbfs"]
    level = torch.rand((b, sections), generator=g, device=device) * (hi_db - lo_db) + lo_db
    gain = torch.pow(10.0, level / 20.0)
    gain = torch.where(torch.rand((b, sections), generator=g, device=device) < signal["silence"],
                       0.0, gain)
    ends = torch.cumsum(length, dim=1)
    which = torch.searchsorted(ends, torch.arange(units, device=device).expand(b, units)
                               .contiguous(), right=True)
    unit_gain = torch.gather(gain, 1, which.clamp(max=sections - 1))
    x.view(b, 2, units, generator.UNIT).mul_(unit_gain[:, None, :, None])
    ceiling = 10.0 ** (signal["ceiling_dbfs"] / 20.0)
    return x.clamp_(-ceiling, ceiling)


# a library-like shape (rows of 4 s) and a frames-like one (a multiple of 2,048)
SHAPES = {"rows": (3, 4 * RATE), "frames": (2, 4 * RATE // 2048 * 2048)}


@pytest.mark.parametrize("seed", [2**31 + 101, 7])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_stereo_signal_is_the_frozen_generators_bit_for_bit(seed, shape):
    b, n = SHAPES[shape]
    got = generator.tracks(seed, b, n, RATE, SIGNAL, "cpu")
    assert torch.equal(got, stereo_tracks(seed, b, n, RATE, SIGNAL, "cpu"))
    assert torch.equal(got, generator.tracks(seed, b, n, RATE, SIGNAL, "cpu", channels=2))


def _corr(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double() - a.double().mean(), b.double() - b.double().mean()
    return float((a * b).sum() / (a.norm() * b.norm()))


@pytest.mark.parametrize("correlation", [0.8, [0.8, 0.5, 0.0, 0.3, -0.2]],
                         ids=["number", "list"])
def test_six_channels_keep_sections_silence_ceiling_and_correlation(correlation):
    signal = {**SIGNAL, "correlation": correlation}
    b, n = 2, 30 * RATE
    x = generator.tracks(2**31 + 55, b, n, RATE, signal, "cpu", channels=6)
    assert x.shape == (b, 6, n) and x.dtype == torch.float32
    assert torch.equal(x, generator.tracks(2**31 + 55, b, n, RATE, signal, "cpu", channels=6))
    assert not torch.equal(x, generator.tracks(2**31 + 56, b, n, RATE, signal, "cpu",
                                               channels=6))
    assert x.abs().max() <= 10 ** (signal["ceiling_dbfs"] / 20) + 1e-7
    # a unit is silent on every channel or on none
    silent = (x.view(b, 6, -1, generator.UNIT) == 0).all(-1)
    assert torch.equal(silent, silent[:, :1].expand_as(silent))
    assert silent.any() and not silent.all()
    want = correlation if isinstance(correlation, list) else [correlation] * 5
    for t in range(b):
        sounding = ~silent[t, 0]
        assert sounding.sum() * generator.UNIT >= RATE      # at least 1 s
        units = x[t].view(6, -1, generator.UNIT)[:, sounding].reshape(6, -1)
        for k in range(1, 6):
            assert abs(_corr(units[0], units[k]) - want[k - 1]) <= 0.02, (t, k)


def test_a_correlation_list_of_the_wrong_length_is_refused():
    with pytest.raises(ValueError, match="3 correlations for 6 channels"):
        generator.tracks(1, 1, 1280, RATE, {**SIGNAL, "correlation": [0.8, 0.5, 0.1]}, "cpu",
                         channels=6)


CELL = "offline.surround_tiny"
NUMBERS = {"integrated_lu", "lra_lu", "sample_peak", "timeline_lu", "true_peak_db"}


@pytest.fixture(scope="module")
def surround(tmp_path_factory):
    """A 5.1 cell at 192 kHz added by a configuration, a traffic and a
    limits file and entries in a spec, and no edit to any file there was:
    2 tracks in rows of 8 s, valid for 5-8 s."""
    root = tmp_path_factory.mktemp("bench") / "benchmark"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(REPO / "benchmark" / d, root / d)
    config = {"name": "surround_192k", "channels": 6, "rate": 192000, "max_blocks": 0,
              "precision": "float32", "reduced": []}
    (root / "configs" / "surround_192k.json").write_text(json.dumps(config))
    traffic = json.loads((root / "traffic" / "library_rows.json").read_text())
    traffic.update(tracks=2, track_s=8, valid_s=[5, 8], check_tracks=2, warmup_steps=1)
    (root / "traffic" / "surround_rows.json").write_text(json.dumps(traffic))
    shutil.copy(root / "limits" / "offline.library_rows.json", root / "limits" / f"{CELL}.json")
    spec = harness.load_spec()
    spec["configs"].append({"name": "surround_192k", "source": "ITU-R BS.1770-4",
                            "file": "benchmark/configs/surround_192k.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": CELL, "config": "surround_192k",
                              "traffic": "surround_rows", "chips": 1, "why": "test"})
    spec["end_to_end"][0]["workloads"].append(CELL)
    return spec, root


class Recorded(systems.Program):
    """The program, keeping each result it returned."""

    def __init__(self):
        self.results = []

    def analyze_batch(self, mc, x, n_valid):
        self.results.append(super().analyze_batch(mc, x, n_valid))
        return self.results[-1]


def _run(surround, system):
    spec, root = surround
    return harness.execute(CELL, 2**31 + 51, 0.2, False, "cpu", time.perf_counter(),
                           system=system, spec=spec, root=root)


def test_surround_cell_from_new_files_alone_is_correct(surround):
    program = Recorded()
    line = _run(surround, program)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == NUMBERS
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    res = program.results[-1]
    assert res.true_peak.shape == (2, 6)
    # at 192 kHz the true peak is the sample peak (no oversampling)
    assert torch.equal(res.true_peak, res.sample_peak)


@pytest.mark.parametrize("system", [systems.Control, HalfBatch, Altered],
                         ids=["control", "half_batch", "altered"])
def test_surround_cell_control_and_faults_are_not_correct(surround, system):
    line = _run(surround, system())
    assert not line["correct"], line["checks"]


def test_spectrogram_with_six_channels_is_refused():
    cell = "offline.frames_spectrogram"
    over = {"config": {"channels": 6}, "traffic": {"tracks": 2, "track_s": 4}}
    with pytest.raises(ValueError, match="2 channels; the configuration has 6"):
        harness.execute(cell, 3, 0.2, False, "cpu", time.perf_counter(), overrides=over)
