"""Where the port computes: the card unless the caller asks for the CPU.

Without a working card every entry point raises instead of carrying on
on the CPU unasked; `device="cpu"` (the CLI's `--device cpu`) is the way
to the host. The card's absence is simulated, so these run on any
machine."""

import io
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from soundscope_tpu_torch.apps.cli import main as cli_main
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.core.device import default_device
from soundscope_tpu_torch.core.state import init_meter_state
from soundscope_tpu_torch.models.analyzer import Analyzer
from soundscope_tpu_torch.models.engine import analyze_array
from soundscope_tpu_torch.models.live import LiveAnalyzer
from soundscope_tpu_torch.ops.stft import spectrogram
from soundscope_tpu_torch.utils.io import write_wav
from soundscope_tpu_torch.utils.params import meter_state_from_numpy


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_card):
    for asked in (None, "cuda", torch.device("cuda", 0)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            default_device(asked)
    assert default_device("cpu") == torch.device("cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device(None) == torch.device("cuda")
    assert default_device("cpu") == torch.device("cpu")


CFG = MeterConfig(channels=2, rate=48000, max_blocks=100)
ENTRIES = {
    "Analyzer": lambda: Analyzer(),
    "Analyzer.get_waveform": lambda: Analyzer.get_waveform(np.zeros(4800, np.float32), 1.0),
    "LiveAnalyzer": lambda: LiveAnalyzer(CFG),
    "init_meter_state": lambda: init_meter_state(CFG),
    "meter_state_from_numpy": lambda: meter_state_from_numpy(
        {k: v.numpy() for k, v in vars(init_meter_state(CFG, "cpu")).items()}),
    "analyze_array": lambda: analyze_array(np.zeros((2, 4800), np.float32), CFG),
    "spectrogram": lambda: spectrogram(np.zeros((2, 48000), np.float32), 48000),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_points_raise_without_a_card(no_card, entry):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRIES[entry]()


def test_cli_fails_without_a_card_unless_asked_for_the_cpu(no_card, tmp_path):
    wav = str(tmp_path / "tone.wav")
    t = np.arange(48000 * 4) / 48000
    x = (0.1 * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)
    write_wav(wav, np.stack([x, x]), 48000, bits=32)
    err = io.StringIO()
    with redirect_stderr(err):
        assert cli_main(["analyze", wav, "--json"]) == 2
    assert "--device cpu" in err.getvalue()
    out = io.StringIO()
    with redirect_stdout(out):
        assert cli_main(["analyze", wav, "--json", "--device", "cpu"]) == 0
    assert '"integrated_lufs"' in out.getvalue()
