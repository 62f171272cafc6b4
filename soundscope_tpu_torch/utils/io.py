"""Audio file IO — host-side decode to float32 planar arrays.

The port's own copy of the JAX package's decoders
(soundscope_tpu/utils/io.py), dispatched as there:

  * a pure-NumPy RIFF/WAVE decoder (PCM 8/16/24/32-bit, float32/64,
    WAVE_FORMAT_EXTENSIBLE) and AIFF/AIFC (PCM, sowt) decoder, and a WAV
    writer for fixtures and export;
  * the native C++ runtime (soundscope_tpu_torch/native): a WAV decoder,
    the first-party FLAC, MPEG audio (Layers I-III), ALAC with its MP4/CAF
    demux, Ogg Vorbis and AAC-LC decoders, and the libav codec bridge where
    the libav headers were found at build time; with
    utils/flacenc.py, a matching FLAC encoder;
  * the ffmpeg command line as the last resort, where an ffmpeg binary is
    installed.

All paths return planar float32 (C, N) and the rate.
"""

from __future__ import annotations

import os
import re
import shutil
import struct
import subprocess
from dataclasses import dataclass

import numpy as np

# The reference's explorer whitelist (its SUPPORTED_FORMATS minus "theme").
AUDIO_EXTENSIONS = (
    "wav", "wave", "aiff", "aif", "flac",   # uncompressed / lossless
    "mp3", "mp2", "mp1", "mpa", "aac",      # MPEG audio
    "m4a", "m4b", "mp4", "m4r", "m4p",      # MP4/M4A family (AAC/ALAC)
    "ogg", "oga", "ogv",                    # OGG family
    "caf", "alac",                          # Apple formats
)


@dataclass
class DecodedAudio:
    samples: np.ndarray  # planar (C, N) float32
    rate: int
    title: str

    @property
    def channels(self) -> int:
        return self.samples.shape[0]

    @property
    def duration(self) -> float:
        return self.samples.shape[1] / self.rate

    def interleaved(self) -> np.ndarray:
        return np.ascontiguousarray(self.samples.T).reshape(-1)

    def mid_side(self):
        """mid=(l+r)/2, side=(l-r)/2; mono maps to (mono, zeros)."""
        if self.channels >= 2:
            l, r = self.samples[0], self.samples[1]
        else:
            l = r = self.samples[0]
        return (l + r) * 0.5, (l - r) * 0.5


class DecodeError(Exception):
    pass


# --- WAV ---------------------------------------------------------------------

def _pcm_to_f32(raw: bytes, bits: int, fmt: int) -> np.ndarray:
    if fmt == 3:  # IEEE float
        if bits == 32:
            return np.frombuffer(raw, "<f4").astype(np.float32)
        if bits == 64:
            return np.frombuffer(raw, "<f8").astype(np.float32)
        raise DecodeError(f"unsupported float width {bits}")
    if fmt == 1:  # integer PCM
        if bits == 8:
            x = np.frombuffer(raw, np.uint8).astype(np.float32)
            return (x - 128.0) / 128.0
        if bits == 16:
            return np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        if bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = np.where(x >= 1 << 23, x - (1 << 24), x)
            return x.astype(np.float32) / float(1 << 23)
        if bits == 32:
            return np.frombuffer(raw, "<i4").astype(np.float32) / float(1 << 31)
    raise DecodeError(f"unsupported WAV format tag={fmt} bits={bits}")


def decode_wav(path: str) -> DecodedAudio:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise DecodeError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    pcm = None
    while pos + 8 <= len(data):
        cid = data[pos: pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4: pos + 8])
        body = data[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            tag, ch, rate, _, _, bits = struct.unpack("<HHIIHH", body[:16])
            if tag == 0xFFFE and size >= 40:  # extensible: real tag in GUID
                (tag,) = struct.unpack("<H", body[24:26])
            fmt = (tag, ch, rate, bits)
        elif cid == b"data":
            pcm = body
        pos += 8 + size + (size & 1)
    if fmt is None or pcm is None:
        raise DecodeError("missing fmt/data chunk")
    tag, ch, rate, bits = fmt
    flat = _pcm_to_f32(pcm[: len(pcm) - len(pcm) % (ch * bits // 8)], bits, tag)
    frames = len(flat) // ch
    planar = np.ascontiguousarray(flat[: frames * ch].reshape(frames, ch).T)
    return DecodedAudio(planar, rate, os.path.splitext(os.path.basename(path))[0])


def write_wav(path: str, samples: np.ndarray, rate: int, bits: int = 16):
    """Planar (C, N) float32 -> PCM WAV (test fixtures / export)."""
    samples = np.asarray(samples, np.float32)
    ch, n = samples.shape
    inter = np.ascontiguousarray(samples.T)
    if bits == 16:
        pcm = (np.clip(inter, -1, 1) * 32767.0).astype("<i2").tobytes()
        tag, bw = 1, 2
    elif bits == 32:
        pcm = inter.astype("<f4").tobytes()
        tag, bw = 3, 4
    else:
        raise ValueError("bits must be 16 or 32")
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, tag, ch, rate, rate * ch * bw, ch * bw, bits
    )
    hdr += b"data" + struct.pack("<I", len(pcm))
    with open(path, "wb") as f:
        f.write(hdr + pcm)


# --- AIFF --------------------------------------------------------------------

def _read_f80(b: bytes) -> float:
    (exp,) = struct.unpack(">H", b[:2])
    (mant,) = struct.unpack(">Q", b[2:10])
    sign = -1.0 if exp & 0x8000 else 1.0
    exp &= 0x7FFF
    if exp == 0 and mant == 0:
        return 0.0
    return sign * mant * 2.0 ** (exp - 16383 - 63)


def decode_aiff(path: str) -> DecodedAudio:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise DecodeError("not an AIFF file")
    is_aifc = data[8:12] == b"AIFC"
    pos = 12
    comm = ssnd = None
    compression = b"NONE"
    while pos + 8 <= len(data):
        cid = data[pos: pos + 4]
        (size,) = struct.unpack(">I", data[pos + 4: pos + 8])
        body = data[pos + 8: pos + 8 + size]
        if cid == b"COMM":
            ch, nframes, bits = struct.unpack(">HIH", body[:8])
            rate = int(round(_read_f80(body[8:18])))
            if is_aifc and len(body) >= 22:
                compression = body[18:22]
            comm = (ch, nframes, bits, rate)
        elif cid == b"SSND":
            (offset, _) = struct.unpack(">II", body[:8])
            ssnd = body[8 + offset:]
        pos += 8 + size + (size & 1)
    if comm is None or ssnd is None:
        raise DecodeError("missing COMM/SSND chunk")
    ch, nframes, bits, rate = comm
    le = compression == b"sowt"
    if compression not in (b"NONE", b"sowt"):
        raise DecodeError(f"unsupported AIFC compression {compression!r}")
    if bits == 16:
        x = np.frombuffer(ssnd[: nframes * ch * 2], "<i2" if le else ">i2")
        flat = x.astype(np.float32) / 32768.0
    elif bits == 8:
        flat = np.frombuffer(ssnd[: nframes * ch], np.int8).astype(np.float32) / 128.0
    elif bits == 24:
        b3 = np.frombuffer(ssnd[: nframes * ch * 3], np.uint8).reshape(-1, 3)
        if le:
            b3 = b3[:, ::-1]
        x = (
            (b3[:, 0].astype(np.int32) << 16)
            | (b3[:, 1].astype(np.int32) << 8)
            | b3[:, 2].astype(np.int32)
        )
        x = np.where(x >= 1 << 23, x - (1 << 24), x)
        flat = x.astype(np.float32) / float(1 << 23)
    elif bits == 32:
        x = np.frombuffer(ssnd[: nframes * ch * 4], "<i4" if le else ">i4")
        flat = x.astype(np.float32) / float(1 << 31)
    else:
        raise DecodeError(f"unsupported AIFF width {bits}")
    frames = len(flat) // ch
    planar = np.ascontiguousarray(flat[: frames * ch].reshape(frames, ch).T)
    return DecodedAudio(planar, rate, os.path.splitext(os.path.basename(path))[0])


# --- ffmpeg command line -------------------------------------------------------

def _ffmpeg_bin() -> str | None:
    return shutil.which("ffmpeg")


def decode_ffmpeg(path: str) -> DecodedAudio:
    bin_ = _ffmpeg_bin()
    if bin_ is None:
        raise DecodeError(
            f"no decoder for {os.path.splitext(path)[1]!r} (ffmpeg not present)"
        )
    probe = subprocess.run(
        [bin_, "-i", path, "-f", "f32le", "-acodec", "pcm_f32le", "-"],
        capture_output=True,
    )
    if probe.returncode != 0:
        raise DecodeError(probe.stderr.decode(errors="replace")[-500:])
    # parse channel/rate from stderr metadata
    m = re.search(rb"(\d+) Hz, ([^,]+),", probe.stderr)
    if not m:
        raise DecodeError("could not parse ffmpeg stream info")
    rate = int(m.group(1))
    layout = m.group(2).decode().split("(")[0].strip()
    layouts = {
        "mono": 1, "stereo": 2, "2.1": 3, "3.0": 3, "quad": 4, "4.0": 4,
        "5.0": 5, "5.1": 6, "6.1": 7, "7.1": 8, "downmix": 2,
    }
    if layout in layouts:
        ch = layouts[layout]
    else:
        mc = re.match(r"(\d+) channels", layout)
        if not mc:
            raise DecodeError(f"unrecognised ffmpeg channel layout {layout!r}")
        ch = int(mc.group(1))
    flat = np.frombuffer(probe.stdout, "<f4")
    frames = len(flat) // ch
    planar = np.ascontiguousarray(flat[: frames * ch].reshape(frames, ch).T)
    return DecodedAudio(planar, rate, os.path.splitext(os.path.basename(path))[0])


# --- dispatch ------------------------------------------------------------------

def _native():
    from soundscope_tpu_torch.native import decoder as native_decoder

    return native_decoder if native_decoder.available() else None


def decode_file(path: str) -> DecodedAudio:
    """Decode any supported audio file to planar float32.

    Dispatch: WAV -> native C++ (NumPy fallback); AIFF -> NumPy;
    FLAC -> first-party native decoder (native/flac.cpp); MPEG audio,
    Ogg Vorbis, AAC, ALAC/MP4/CAF -> their first-party native decoders;
    everything else, and what those reject, -> the native codec bridge
    (native/codecs.cpp), then the ffmpeg command line."""
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    nat = _native()
    if ext in ("wav", "wave"):
        if nat is not None:
            try:
                return nat.decode(path)
            except DecodeError:
                pass  # fall through: the NumPy decoder gives the clearer error
        return decode_wav(path)
    if ext in ("aiff", "aif", "aifc"):
        return decode_aiff(path)
    if nat is not None:
        # first-party decoders by extension; what one rejects (exotic
        # framing, a non-Vorbis Ogg payload, AAC in an MP4) tries the next
        firsts = {
            "flac": ("decode_flac",),
            "mp3": ("decode_mp3",), "mp2": ("decode_mp3",),
            "mp1": ("decode_mp3",), "mpa": ("decode_mp3",),
            "ogg": ("decode_vorbis",), "oga": ("decode_vorbis",),
            "ogv": ("decode_vorbis",),
            "aac": ("decode_aac",),
        }
        for e in ("m4a", "m4b", "mp4", "m4r", "m4p", "caf", "alac"):
            firsts[e] = ("decode_alac", "decode_aac")
        for fn in firsts.get(ext, ()):
            try:
                return getattr(nat, fn)(path)
            except DecodeError:
                if fn == firsts[ext][-1] and not nat.codecs_available() \
                        and _ffmpeg_bin() is None:
                    raise
        if nat.codecs_available():
            try:
                return nat.decode_any(path)
            except DecodeError:
                if _ffmpeg_bin() is None:
                    raise
    return decode_ffmpeg(path)
