"""Minimal FLAC encoder — test fixtures and lossless export.

Writes spec-compliant FLAC streams: STREAMINFO with MD5, fixed-blocksize
frames with correct CRC-8/CRC-16, subframe types CONSTANT / VERBATIM /
FIXED(order 0-2) with Rice-coded residuals (including escape partitions),
and channel modes independent / left-side / right-side / mid-side.
16-bit samples (the fixture/export case).

Counterpart of the first-party decoder (native/flac.cpp). The port's copy
of the JAX package's utils/flacenc.py writes the same bytes
(tests/test_torch_native.py); its residuals and verbatim samples are
packed with NumPy and its CRCs are table-driven, so that corpora of
minutes of audio encode in seconds. The reference gets FLAC via
symphonia (Cargo.toml:21) and never encodes.
"""

from __future__ import annotations

import hashlib

import numpy as np

_RATE_CODES = {
    88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
    24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11,
}
_BS_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8, 512: 9,
             1024: 10, 2048: 11, 4096: 12, 8192: 13, 16384: 14, 32768: 15}


class BitWriter:
    """MSB-first bit packer."""

    def __init__(self):
        self.buf = bytearray()
        self._acc = 0
        self._n = 0

    def write(self, value: int, bits: int):
        self._acc = (self._acc << bits) | (value & ((1 << bits) - 1))
        self._n += bits
        while self._n >= 8:
            self._n -= 8
            self.buf.append((self._acc >> self._n) & 0xFF)
        self._acc &= (1 << self._n) - 1

    def write_many(self, values: np.ndarray, widths: np.ndarray):
        """write(v, w) for each pair in order, packed with NumPy."""
        values = np.concatenate([[self._acc], np.asarray(values, np.int64)])
        widths = np.concatenate([[self._n], np.asarray(widths, np.int64)])
        total = int(widths.sum())
        item = np.repeat(np.arange(len(widths)), widths)
        starts = np.cumsum(widths) - widths
        # bit j of an item, MSB first; shifts past 62 read zeros (a unary
        # run longer than a value's 32 bits)
        shift = np.minimum(widths[item] - 1 - (np.arange(total) - starts[item]), 63)
        bits = ((values[item] & ((np.int64(1) << np.minimum(widths[item], 62)) - 1))
                >> shift) & 1
        full = total // 8 * 8
        self.buf += np.packbits(bits[:full].astype(np.uint8)).tobytes()
        self._n = total - full
        self._acc = int(np.dot(bits[full:], 1 << np.arange(self._n)[::-1])) if self._n else 0

    def write_signed(self, value: int, bits: int):
        self.write(value & ((1 << bits) - 1), bits)

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)  # q zeros then a 1

    def align(self):
        if self._n:
            self.write(0, 8 - self._n)

    def getvalue(self) -> bytes:
        assert self._n == 0, "unaligned"
        return bytes(self.buf)


def _crc_table(poly: int, width: int, bits: int) -> list:
    """The MSB-first CRC register after shifting in `bits` bits of value i
    (all of the register, bits == width) from zero: crc' = T[crc ^ chunk]."""
    top, mask = 1 << (width - 1), (1 << width) - 1
    crc = np.arange(1 << bits, dtype=np.int64) << (width - bits)
    for _ in range(bits):
        crc = np.where(crc & top, ((crc << 1) ^ poly) & mask, (crc << 1) & mask)
    return crc.tolist()


_CRC8 = _crc_table(0x07, 8, 8)
_CRC16 = _crc_table(0x8005, 16, 16)     # two bytes a step


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = _CRC8[crc ^ b]
    return crc


def _crc16(data: bytes) -> int:
    crc, t = 0, _CRC16
    words = np.frombuffer(data[: len(data) // 2 * 2], ">u2").tolist()
    for w in words:
        crc = t[crc ^ w]
    if len(data) % 2:                   # the last byte: 8 bits through T
        crc = (t[(crc >> 8) ^ data[-1]] ^ (crc << 8)) & 0xFFFF
    return crc


def _utf8_number(n: int) -> bytes:
    """FLAC's UTF-8-style coded number (plain UTF-8 logic, no surrogate
    exclusions)."""
    if n < 0x80:
        return bytes([n])
    for nbytes, lead in ((2, 0xC0), (3, 0xE0), (4, 0xF0), (5, 0xF8), (6, 0xFC)):
        if n < 1 << (5 * nbytes + 1):
            out = [lead | (n >> (6 * (nbytes - 1)))]
            for i in range(nbytes - 2, -1, -1):
                out.append(0x80 | ((n >> (6 * i)) & 0x3F))
            return bytes(out)
    raise ValueError("frame number too large")


def _rice_cost(zig: np.ndarray, param: int) -> int:
    return int(np.sum(zig >> param)) + len(zig) * (param + 1)


def _write_residual(bw: BitWriter, res: np.ndarray):
    """Rice method 0, partition order 0 (one partition), escape when raw
    coding is cheaper (exercises the decoder's escape path on noisy data)."""
    zig = np.where(res >= 0, res.astype(np.int64) * 2, -2 * res.astype(np.int64) - 1)
    best_p, best_c = 0, None
    for p in range(15):
        c = _rice_cost(zig, p)
        if best_c is None or c < best_c:
            best_p, best_c = p, c
    pos_bits = int(res.max()).bit_length() + 1 if res.max() > 0 else 1
    neg_bits = (-int(res.min()) - 1).bit_length() + 1 if res.min() < 0 else 1
    raw_bits = max(pos_bits, neg_bits)
    raw_cost = len(res) * raw_bits
    bw.write(0, 2)   # coding method: Rice 4-bit
    bw.write(0, 4)   # partition order 0
    if raw_cost < best_c:
        bw.write(15, 4)        # escape
        bw.write(raw_bits, 5)
        bw.write_many(res.astype(np.int64), np.full(len(res), raw_bits))
    else:
        bw.write(best_p, 4)
        # per sample: q zeros and a 1 (the unary quotient), then p low bits
        vals = np.stack([np.ones_like(zig), zig & ((1 << best_p) - 1)], axis=1)
        wids = np.stack([(zig >> best_p) + 1, np.full_like(zig, best_p)], axis=1)
        bw.write_many(vals.reshape(-1), wids.reshape(-1))


def _write_subframe(bw: BitWriter, x: np.ndarray, bps: int, force: str | None):
    x = x.astype(np.int64)
    n = len(x)
    bw.write(0, 1)  # pad bit
    if force != "verbatim" and np.all(x == x[0]):
        bw.write(0, 6)  # CONSTANT
        bw.write(0, 1)
        bw.write_signed(int(x[0]), bps)
        return
    if force == "verbatim" or n < 5:
        bw.write(1, 6)  # VERBATIM
        bw.write(0, 1)
        bw.write_many(x, np.full(n, bps))
        return
    order = 2
    bw.write(0b001000 | order, 6)  # FIXED, order 2
    bw.write(0, 1)
    for v in x[:order]:
        bw.write_signed(int(v), bps)
    res = x[2:] - 2 * x[1:-1] + x[:-2]
    _write_residual(bw, res)


def _frame_header(frame_no: int, n: int, rate: int, chan_code: int) -> bytes:
    bw = BitWriter()
    bw.write(0b11111111111110, 14)
    bw.write(0, 1)  # reserved
    bw.write(0, 1)  # fixed-blocksize stream
    bs_code = _BS_CODES.get(n)
    bs_extra = None
    if bs_code is None:
        if n <= 256:
            bs_code, bs_extra = 6, (n - 1, 8)
        else:
            bs_code, bs_extra = 7, (n - 1, 16)
    sr_code = _RATE_CODES.get(rate)
    sr_extra = None
    if sr_code is None:
        if rate % 1000 == 0 and rate // 1000 < 256:
            sr_code, sr_extra = 12, (rate // 1000, 8)
        elif rate < 65536:
            sr_code, sr_extra = 13, (rate, 16)
        else:
            sr_code, sr_extra = 14, (rate // 10, 16)
    bw.write(bs_code, 4)
    bw.write(sr_code, 4)
    bw.write(chan_code, 4)
    bw.write(4, 3)  # sample size: 16-bit
    bw.write(0, 1)  # reserved
    bw.align()
    hdr = bytearray(bw.getvalue())
    hdr += _utf8_number(frame_no)
    if bs_extra is not None:
        hdr += bs_extra[0].to_bytes(bs_extra[1] // 8, "big")
    if sr_extra is not None:
        hdr += sr_extra[0].to_bytes(sr_extra[1] // 8, "big")
    hdr.append(_crc8(bytes(hdr)))
    return bytes(hdr)


def encode_flac(samples: np.ndarray, rate: int, block: int = 4096,
                stereo_mode: str = "auto", force_subframe: str | None = None) -> bytes:
    """Planar float32 (C, N) in [-1, 1) -> FLAC stream bytes (16-bit).

    stereo_mode: 'auto' (mid-side for stereo), 'independent', 'ms', 'ls',
    'rs'. force_subframe='verbatim' disables prediction (fixture knob).
    """
    samples = np.asarray(samples, np.float32)
    ch, n_total = samples.shape
    if ch > 8:
        raise ValueError("FLAC supports at most 8 channels")
    ints = np.clip(np.round(samples * 32768.0), -32768, 32767).astype(np.int32)

    if ch != 2 and stereo_mode not in ("auto", "independent"):
        raise ValueError("stereo modes need 2 channels")
    mode = stereo_mode
    if mode == "auto":
        mode = "ms" if ch == 2 else "independent"

    md5 = hashlib.md5()
    inter = np.ascontiguousarray(ints.astype("<i2").T)
    md5.update(inter.tobytes())

    out = bytearray(b"fLaC")
    si = BitWriter()
    si.write(block, 16)  # min blocksize (last frame may be shorter, per spec)
    si.write(block, 16)
    si.write(0, 24)      # min frame size unknown
    si.write(0, 24)
    si.write(rate, 20)
    si.write(ch - 1, 3)
    si.write(15, 5)      # bps - 1 = 15
    si.write(n_total, 36)
    body = si.getvalue() + md5.digest()
    out += bytes([0x80 | 0]) + len(body).to_bytes(3, "big") + body

    for frame_no, lo in enumerate(range(0, n_total, block)):
        blk = ints[:, lo: lo + block]
        n = blk.shape[1]
        if mode == "independent":
            chan_code, subs = ch - 1, [(blk[c], 16) for c in range(ch)]
        elif mode == "ms":
            mid = (blk[0].astype(np.int64) + blk[1]) >> 1
            side = blk[0].astype(np.int64) - blk[1]
            chan_code, subs = 10, [(mid, 16), (side, 17)]
        elif mode == "ls":
            side = blk[0].astype(np.int64) - blk[1]
            chan_code, subs = 8, [(blk[0], 16), (side, 17)]
        elif mode == "rs":
            side = blk[0].astype(np.int64) - blk[1]
            chan_code, subs = 9, [(side, 17), (blk[1], 16)]
        else:
            raise ValueError(f"unknown stereo_mode {stereo_mode!r}")

        frame = bytearray(_frame_header(frame_no, n, rate, chan_code))
        bw = BitWriter()
        for x, bps in subs:
            _write_subframe(bw, np.asarray(x), bps, force_subframe)
        bw.align()
        frame += bw.getvalue()
        frame += _crc16(bytes(frame)).to_bytes(2, "big")
        out += frame
    return bytes(out)


def write_flac(path: str, samples: np.ndarray, rate: int, **kw) -> None:
    with open(path, "wb") as f:
        f.write(encode_flac(samples, rate, **kw))
