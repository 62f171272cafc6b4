"""The port's native runtime and decoders against the JAX package's.

Every kind of fixture the JAX codec tests build (FLAC, MPEG audio, ALAC,
Vorbis, AAC, WAV) decodes bit-identically through both packages'
`decode_file`; the port's native ring behaves like the NumPy ring; the
port's FLAC encoder writes byte-identical files. The compressed fixtures
are encoded with the JAX package's codec bridge (or libmp3lame), and
skip where those are absent, as the JAX tests do."""

import ctypes
import os

import numpy as np
import pytest

import soundscope_tpu.native as jnative
import soundscope_tpu.utils.flacenc as jflac
import soundscope_tpu.utils.io as jio
import soundscope_tpu_torch.native as tnative
import soundscope_tpu_torch.utils.flacenc as tflac
import soundscope_tpu_torch.utils.io as tio
from soundscope_tpu_torch.apps.capture import PyRing, make_ring

RATE = 44100


def _signal(seconds=1.0, channels=2, rate=RATE, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    x = [0.4 * np.sin(2 * np.pi * (440.0 + 110 * c) * t) + 0.05 * rng.standard_normal(len(t))
         for c in range(channels)]
    return np.stack(x).astype(np.float32)


def _bridge():
    dec = jnative.decoder
    if not (dec.available() and dec.codecs_available()):
        pytest.skip("codec bridge not compiled in (fixture encoder)")
    return dec


def _write_mp3(path, planar, rate, kbps=192):
    """Stereo MP3 through libmp3lame (tests/test_mp3_native.py's writer)."""
    for name in ("libmp3lame.so.0", "libmp3lame.so"):
        try:
            lame = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        pytest.skip("libmp3lame not present")
    lame.lame_init.restype = ctypes.c_void_p
    g = ctypes.c_void_p(lame.lame_init())
    lame.lame_set_in_samplerate(g, rate)
    lame.lame_set_out_samplerate(g, rate)
    lame.lame_set_num_channels(g, 2)
    lame.lame_set_brate(g, kbps)
    assert lame.lame_init_params(g) >= 0
    n = planar.shape[1]
    inter = np.ascontiguousarray(planar.T, np.float32).reshape(-1)
    out = ctypes.create_string_buffer(int(1.4 * n) + 7200)
    wrote = lame.lame_encode_buffer_interleaved_ieee_float(
        g, inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, out, len(out))
    tail = ctypes.create_string_buffer(7200)
    wrote2 = lame.lame_encode_flush(g, tail, len(tail))
    lame.lame_close(g)
    assert wrote >= 0
    with open(path, "wb") as f:
        f.write(out.raw[:wrote] + tail.raw[: max(wrote2, 0)])


def _fixture(kind, d):
    x = _signal()
    p = os.path.join(d, {
        "wav16": "a.wav", "wav32": "a.wav", "flac": "a.flac", "flac_mono": "a.flac",
        "flac_ls": "a.flac", "mp3": "a.mp3", "mp2": "a.mp2", "alac_m4a": "a.m4a",
        "alac_caf": "a.caf", "vorbis": "a.ogg", "aac_adts": "a.aac",
        "aac_m4a": "a.m4a", "bridge": "a.ogg"}[kind])
    if kind in ("wav16", "wav32"):
        jio.write_wav(p, x, RATE, bits=int(kind[3:]))
    elif kind == "flac":
        jflac.write_flac(p, x, RATE)
    elif kind == "flac_mono":
        jflac.write_flac(p, x[:1], RATE)
    elif kind == "flac_ls":
        jflac.write_flac(p, x, RATE, stereo_mode="ls", block=1152)
    elif kind == "mp3":
        _write_mp3(p, x, RATE)
    elif kind == "mp2":
        _bridge().encode(p, x, RATE, codec="mp2")
    elif kind.startswith("alac"):
        _bridge().encode(p, x, RATE, codec="alac")
    elif kind in ("vorbis", "bridge"):
        _bridge().encode(p, x, RATE, codec="libvorbis")
    elif kind == "aac_adts":
        _bridge().encode(p, x, 48000)
    elif kind == "aac_m4a":
        _bridge().encode(p, x, RATE, codec="aac")
    return p


@pytest.mark.parametrize("kind", ["wav16", "wav32", "flac", "flac_mono", "flac_ls", "mp3",
                                  "mp2", "alac_m4a", "alac_caf", "vorbis", "aac_adts",
                                  "aac_m4a", "bridge"])
def test_decodes_bit_identical_to_jax(kind, tmp_path):
    assert tnative.available(), "the port's native runtime did not build"
    p = _fixture(kind, str(tmp_path))
    if kind == "bridge":
        # the codec bridge itself (libav), both packages' builds, probed and
        # with the container forced
        got, want = tnative.decoder.decode_any(p), jnative.decoder.decode_any(p)
        forced = tnative.decoder.decode_any_fmt(p, "ogg")
        want_forced = jnative.decoder.decode_any_fmt(p, "ogg")
        np.testing.assert_array_equal(forced.samples, want_forced.samples)
    else:
        got, want = tio.decode_file(p), jio.decode_file(p)
    assert (got.rate, got.title, got.channels) == (want.rate, want.title, want.channels)
    assert got.samples.dtype == want.samples.dtype == np.float32
    assert got.samples.shape[1] > 0
    np.testing.assert_array_equal(got.samples, want.samples)


def test_native_decoders_are_dispatched(tmp_path, monkeypatch):
    """FLAC and WAV go to the port's native library: with the NumPy and
    ffmpeg paths disabled they still decode, to what the NumPy WAV reader
    and the quantized signal give."""
    x = _signal()
    wav, flac = str(tmp_path / "a.wav"), str(tmp_path / "a.flac")
    tio.write_wav(wav, x, RATE, bits=16)
    tflac.write_flac(flac, x, RATE)
    plain = tio.decode_wav(wav)

    def refuse(path):
        raise AssertionError("not the native decoder")

    monkeypatch.setattr(tio, "decode_wav", refuse)
    monkeypatch.setattr(tio, "decode_ffmpeg", refuse)
    np.testing.assert_array_equal(tio.decode_file(wav).samples, plain.samples)
    q = (np.clip(np.round(x * 32768.0), -32768, 32767) / 32768.0).astype(np.float32)
    np.testing.assert_array_equal(tio.decode_file(flac).samples, q)
    bad = tmp_path / "bad.flac"
    bad.write_bytes(b"fLaC" + bytes(range(64)))
    with pytest.raises(tio.DecodeError):
        tnative.decoder.decode_flac(str(bad))


def test_libraries_apart_and_no_environment_compiler(monkeypatch):
    assert os.path.dirname(tnative._SO) == os.path.dirname(os.path.abspath(tnative.__file__))
    assert tnative._SO != jnative._SO
    assert os.path.basename(tnative._SO) != os.path.basename(jnative._SO)
    monkeypatch.setenv("SS_CXX", "/nonexistent/compiler")
    assert tnative._cxx() in ("g++", "c++", "clang++")
    assert not tnative._stale()


@pytest.mark.parametrize("capacity,pushes", [(1000, [10, 990, 1, 999, 1000, 2500, 7, 0]),
                                             (4096, [2048] * 5 + [100, 4096, 1])])
def test_native_ring_behaves_like_pyring(capacity, pushes):
    rng = np.random.default_rng(capacity)
    rings = [tnative.NativeRing(capacity), PyRing(capacity), jnative.NativeRing(capacity)]
    assert isinstance(make_ring(capacity), tnative.NativeRing)
    for n in pushes:
        x = rng.standard_normal(n).astype(np.float32)
        for r in rings:
            r.push(x)
        snaps = [r.snapshot_with_total() for r in rings]
        for s, total in snaps[1:]:
            np.testing.assert_array_equal(snaps[0][0], s)
            assert snaps[0][1] == total
        np.testing.assert_array_equal(rings[0].snapshot(), rings[1].snapshot())
        assert rings[0].total_pushed == rings[1].total_pushed


@pytest.mark.parametrize("mode,channels,block", [("auto", 2, 4096), ("independent", 2, 1152),
                                                 ("rs", 2, 4096), ("auto", 1, 4096),
                                                 ("auto", 6, 2048)])
def test_flacenc_writes_identical_bytes(mode, channels, block):
    x = _signal(0.7 if channels <= 2 else 0.25, channels, seed=channels)
    x[:, :300] = 0.0                                 # a constant stretch
    a = tflac.encode_flac(x, 48000, block=block, stereo_mode=mode)
    b = jflac.encode_flac(x, 48000, block=block, stereo_mode=mode)
    assert a == b
    v = tflac.encode_flac(x, 48000, force_subframe="verbatim")
    assert v == jflac.encode_flac(x, 48000, force_subframe="verbatim")


def test_flacenc_identical_bytes_on_escapes_odd_blocks_and_rates():
    """Full-scale noise (escape partitions), silence (CONSTANT), a block of
    200 (an odd-length frame for the CRC), 11,025 Hz (16-bit rate code)."""
    rng = np.random.default_rng(11)
    cases = [(rng.uniform(-0.999, 0.999, (2, 6000)).astype(np.float32), 48000, {}),
             (np.zeros((2, 10000), np.float32), 44100, {"block": 200}),
             (_signal(0.3, 2, 11025), 11025, {}),
             (_signal(0.2, 1, 96000), 96000, {"block": 1000})]
    for x, rate, kw in cases:
        assert tflac.encode_flac(x, rate, **kw) == jflac.encode_flac(x, rate, **kw)
