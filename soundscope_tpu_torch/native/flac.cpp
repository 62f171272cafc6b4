// Native FLAC decoder — written from the format specification, no
// third-party code. Covers the full decode surface a player needs:
// STREAMINFO parsing, fixed and variable blocksize frames, all subframe
// types (CONSTANT / VERBATIM / FIXED 0-4 / LPC 1-32), Rice and Rice2
// residual coding with escape partitions, wasted bits, and all four
// channel assignments (independent, left/side, right/side, mid/side),
// 4-32 bit sample widths.
//
// The reference delegates FLAC to the symphonia crate
// (audio_player.rs:169-267, Cargo.toml:21 symphonia-all); this is the
// rebuild's own implementation. Output matches the C ABI of decoder.cpp
// (DecodedWav: planar float32), consumed via ctypes.
//
// Robustness: decode errors mid-stream return the frames decoded so far
// (the reference skips undecodable packets, audio_player.rs:261);
// returns an error only when no audio could be decoded at all.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

struct DecodedWav;  // matches decoder.cpp layout
struct DecodedWavLayout {
  float* data;
  int64_t frames;
  int32_t channels;
  int32_t rate;
};

namespace {

// MSB-first bit reader over an in-memory buffer.
struct BitReader {
  const uint8_t* p;
  size_t n;        // total bytes
  size_t byte = 0; // current byte index
  int bit = 0;     // bits consumed of current byte (0..7)
  bool err = false;

  BitReader(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}

  bool at_end() const { return byte >= n; }

  inline uint32_t bit1() {
    if (byte >= n) { err = true; return 0; }
    uint32_t v = (p[byte] >> (7 - bit)) & 1u;
    if (++bit == 8) { bit = 0; byte++; }
    return v;
  }

  uint64_t bits64(int k) {
    uint64_t v = 0;
    while (k > 0 && !err) {
      if (byte >= n) { err = true; return 0; }
      int avail = 8 - bit;
      int take = k < avail ? k : avail;
      uint32_t cur = (uint32_t)(p[byte] >> (avail - take)) & ((1u << take) - 1u);
      v = (v << take) | cur;
      bit += take;
      if (bit == 8) { bit = 0; byte++; }
      k -= take;
    }
    return v;
  }

  uint32_t bits(int k) { return (uint32_t)bits64(k); }

  int64_t sbits64(int k) {
    if (k == 0) return 0;
    uint64_t v = bits64(k);
    uint64_t sign = 1ull << (k - 1);
    return (int64_t)((v ^ sign) - sign);  // sign-extend
  }

  uint32_t unary() {
    uint32_t q = 0;
    while (!err && bit1() == 0) {
      q++;
      if (q > 1u << 24) { err = true; break; }  // corrupt-stream guard
    }
    return q;
  }

  void align() {
    if (bit) { bit = 0; byte++; }
  }
};

struct StreamInfo {
  uint32_t rate = 0;
  uint32_t channels = 0;
  uint32_t bps = 0;
  uint64_t total_samples = 0;
};

bool read_residual(BitReader& br, uint32_t bsize, int order,
                   std::vector<int64_t>& x) {
  uint32_t method = br.bits(2);
  if (method > 1) return false;
  int pbits = method ? 5 : 4;
  uint32_t esc = method ? 31u : 15u;
  uint32_t porder = br.bits(4);
  uint32_t nparts = 1u << porder;
  uint32_t per = bsize >> porder;
  if (per == 0 || (per << porder) != bsize) return false;
  if (per < (uint32_t)order && porder == 0) return false;
  size_t idx = (size_t)order;
  for (uint32_t part = 0; part < nparts && !br.err; part++) {
    uint32_t cnt = per - (part == 0 ? (uint32_t)order : 0u);
    if (part == 0 && per < (uint32_t)order) return false;
    uint32_t param = br.bits(pbits);
    if (param == esc) {
      uint32_t raw = br.bits(5);
      for (uint32_t i = 0; i < cnt; i++)
        x[idx++] = raw ? br.sbits64((int)raw) : 0;
    } else {
      for (uint32_t i = 0; i < cnt; i++) {
        uint32_t q = br.unary();
        uint64_t v = ((uint64_t)q << param) | br.bits64((int)param);
        x[idx++] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
      }
    }
  }
  return !br.err && idx == (size_t)bsize;
}

bool read_subframe(BitReader& br, int bps, uint32_t bsize,
                   std::vector<int64_t>& x) {
  if (br.bits(1) != 0) return false;  // mandatory zero pad bit
  uint32_t type = br.bits(6);
  int wasted = 0;
  if (br.bits(1)) {
    wasted = 1;
    while (!br.err && br.bit1() == 0) wasted++;
  }
  if (br.err) return false;
  bps -= wasted;
  if (bps <= 0 || bps > 33) return false;

  if (type == 0) {  // CONSTANT
    int64_t v = br.sbits64(bps);
    for (uint32_t i = 0; i < bsize; i++) x[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (uint32_t i = 0; i < bsize; i++) x[i] = br.sbits64(bps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED
    int order = (int)(type & 0x07);
    if ((uint32_t)order > bsize) return false;
    for (int i = 0; i < order; i++) x[i] = br.sbits64(bps);
    if (!read_residual(br, bsize, order, x)) return false;
    switch (order) {
      case 0: break;
      case 1:
        for (uint32_t i = 1; i < bsize; i++) x[i] += x[i - 1];
        break;
      case 2:
        for (uint32_t i = 2; i < bsize; i++) x[i] += 2 * x[i - 1] - x[i - 2];
        break;
      case 3:
        for (uint32_t i = 3; i < bsize; i++)
          x[i] += 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3];
        break;
      case 4:
        for (uint32_t i = 4; i < bsize; i++)
          x[i] += 4 * x[i - 1] - 6 * x[i - 2] + 4 * x[i - 3] - x[i - 4];
        break;
    }
  } else if (type & 0x20) {  // LPC, order = low 5 bits + 1
    int order = (int)(type & 0x1F) + 1;
    if ((uint32_t)order > bsize) return false;
    for (int i = 0; i < order; i++) x[i] = br.sbits64(bps);
    uint32_t prec_code = br.bits(4);
    if (prec_code == 15) return false;  // invalid per spec
    int prec = (int)prec_code + 1;
    int shift = (int)br.sbits64(5);
    if (shift < 0) return false;  // negative shift is spec-invalid
    int32_t coef[32];
    for (int j = 0; j < order; j++) coef[j] = (int32_t)br.sbits64(prec);
    if (!read_residual(br, bsize, order, x)) return false;
    for (uint32_t i = (uint32_t)order; i < bsize; i++) {
      int64_t acc = 0;
      for (int j = 0; j < order; j++) acc += (int64_t)coef[j] * x[i - 1 - j];
      x[i] += acc >> shift;
    }
  } else {
    return false;  // reserved subframe type
  }
  if (wasted)
    for (uint32_t i = 0; i < bsize; i++) x[i] <<= wasted;
  return !br.err;
}

// Consume the UTF-8-style coded frame/sample number (value unused for
// sequential decode, but it must be skipped exactly).
bool skip_coded_number(BitReader& br) {
  uint32_t b0 = br.bits(8);
  if (br.err) return false;
  int follow;
  if (b0 < 0x80) follow = 0;
  else if ((b0 & 0xE0) == 0xC0) follow = 1;
  else if ((b0 & 0xF0) == 0xE0) follow = 2;
  else if ((b0 & 0xF8) == 0xF0) follow = 3;
  else if ((b0 & 0xFC) == 0xF8) follow = 4;
  else if ((b0 & 0xFE) == 0xFC) follow = 5;
  else if (b0 == 0xFE) follow = 6;
  else return false;
  for (int i = 0; i < follow; i++) {
    uint32_t b = br.bits(8);
    if (br.err || (b & 0xC0) != 0x80) return false;
  }
  return true;
}

const uint32_t kRates[] = {0,      88200, 176400, 192000, 8000,  16000,
                           22050,  24000, 32000,  44100,  48000, 96000};

}  // namespace

extern "C" {

// Decode a FLAC file to planar float32. Returns 0 on success, negative on
// hard failure (no audio decodable). Caller frees with ss_free_decoded.
int ss_decode_flac(const char* path, DecodedWavLayout* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (fsize < 42) { fclose(f); return -2; }
  std::vector<uint8_t> buf((size_t)fsize);
  if (fread(buf.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
    fclose(f);
    return -3;
  }
  fclose(f);
  // tolerate a leading ID3v2 tag (common in the wild; other decoders skip it)
  size_t off = 0;
  if (buf.size() >= 10 && memcmp(buf.data(), "ID3", 3) == 0) {
    uint32_t sz = ((uint32_t)(buf[6] & 0x7F) << 21) |
                  ((uint32_t)(buf[7] & 0x7F) << 14) |
                  ((uint32_t)(buf[8] & 0x7F) << 7) | (buf[9] & 0x7F);
    off = 10u + sz;
    if (off + 4 > buf.size()) return -4;
  }
  if (memcmp(buf.data() + off, "fLaC", 4) != 0) return -4;

  // --- metadata blocks ---
  StreamInfo si;
  size_t pos = off + 4;
  bool have_si = false, last = false;
  while (!last && pos + 4 <= buf.size()) {
    uint8_t hdr = buf[pos];
    last = (hdr & 0x80) != 0;
    uint8_t btype = hdr & 0x7F;
    uint32_t blen = ((uint32_t)buf[pos + 1] << 16) |
                    ((uint32_t)buf[pos + 2] << 8) | buf[pos + 3];
    pos += 4;
    if (pos + blen > buf.size()) return -5;
    if (btype == 0 && blen >= 34) {
      const uint8_t* b = buf.data() + pos;
      si.rate = ((uint32_t)b[10] << 12) | ((uint32_t)b[11] << 4) | (b[12] >> 4);
      si.channels = ((b[12] >> 1) & 0x7) + 1;
      si.bps = (((b[12] & 1) << 4) | (b[13] >> 4)) + 1;
      si.total_samples = ((uint64_t)(b[13] & 0x0F) << 32) |
                         ((uint64_t)b[14] << 24) | ((uint64_t)b[15] << 16) |
                         ((uint64_t)b[16] << 8) | b[17];
      have_si = true;
    }
    pos += blen;
  }
  if (!have_si || si.rate == 0 || si.channels == 0) return -6;

  // --- frames ---
  std::vector<std::vector<float>> chans(si.channels);
  std::vector<std::vector<int64_t>> sub;
  BitReader br(buf.data(), buf.size());
  br.byte = pos;

  while (br.byte + 2 < buf.size()) {
    // sync: 14 bits 0x3FFE + reserved 0 bit + blocking-strategy bit
    if (buf[br.byte] != 0xFF || (buf[br.byte + 1] & 0xFC) != 0xF8) break;
    size_t frame_start = br.byte;
    br.bit = 0;
    br.err = false;
    br.bits(16);  // consume sync+reserved+strategy
    uint32_t bs_code = br.bits(4);
    uint32_t sr_code = br.bits(4);
    uint32_t chan_code = br.bits(4);
    uint32_t ss_code = br.bits(3);
    br.bits(1);  // reserved
    if (!skip_coded_number(br)) break;

    uint32_t bsize;
    if (bs_code == 0) break;  // reserved
    else if (bs_code == 1) bsize = 192;
    else if (bs_code <= 5) bsize = 576u << (bs_code - 2);
    else if (bs_code == 6) bsize = br.bits(8) + 1;
    else if (bs_code == 7) bsize = br.bits(16) + 1;
    else bsize = 256u << (bs_code - 8);

    uint32_t rate = si.rate;
    if (sr_code == 15) break;
    else if (sr_code == 12) rate = br.bits(8) * 1000;
    else if (sr_code == 13) rate = br.bits(16);
    else if (sr_code == 14) rate = br.bits(16) * 10;
    else if (sr_code > 0) rate = kRates[sr_code];
    (void)rate;  // per-frame rate must match STREAMINFO in valid files

    int bps;
    switch (ss_code) {
      case 0: bps = (int)si.bps; break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: bps = 0;
    }
    if (bps == 0 || br.err) break;
    br.bits(8);  // CRC-8 of the header (not verified; fixtures + CRC'd files)

    uint32_t nch;
    if (chan_code < 8) nch = chan_code + 1;
    else if (chan_code <= 10) nch = 2;
    else break;
    if (nch != si.channels) break;

    sub.assign(nch, std::vector<int64_t>(bsize));
    bool ok = true;
    for (uint32_t c = 0; c < nch && ok; c++) {
      int sub_bps = bps;
      // the difference (side) channel carries one extra bit
      if ((chan_code == 8 && c == 1) || (chan_code == 9 && c == 0) ||
          (chan_code == 10 && c == 1))
        sub_bps += 1;
      ok = read_subframe(br, sub_bps, bsize, sub[c]);
    }
    if (!ok) break;
    br.align();
    br.bits(16);  // frame CRC-16 (not verified)
    if (br.err) break;

    // stereo decorrelation
    if (chan_code == 8) {  // left/side: R = L - S
      for (uint32_t i = 0; i < bsize; i++) sub[1][i] = sub[0][i] - sub[1][i];
    } else if (chan_code == 9) {  // right/side: L = R + S
      for (uint32_t i = 0; i < bsize; i++) {
        int64_t s = sub[0][i];
        sub[0][i] = sub[1][i] + s;
      }
    } else if (chan_code == 10) {  // mid/side
      for (uint32_t i = 0; i < bsize; i++) {
        int64_t s = sub[1][i];
        // shift in unsigned space: << of a negative mid is UB (hostile
        // streams reach here with any value; found by tools/fuzz)
        int64_t m2 = (int64_t)(((uint64_t)sub[0][i] << 1) | (uint64_t)(s & 1));
        sub[0][i] = (m2 + s) >> 1;
        sub[1][i] = (m2 - s) >> 1;
      }
    }

    float scale = 1.0f / (float)(1ull << (bps - 1));
    for (uint32_t c = 0; c < nch; c++) {
      std::vector<float>& dst = chans[c];
      size_t base = dst.size();
      dst.resize(base + bsize);
      for (uint32_t i = 0; i < bsize; i++)
        dst[base + i] = (float)sub[c][i] * scale;
    }
    (void)frame_start;
  }

  size_t frames = chans[0].size();
  if (frames == 0) return -7;
  if (si.total_samples && frames > si.total_samples)
    frames = (size_t)si.total_samples;

  float* dst = (float*)malloc(sizeof(float) * frames * si.channels);
  if (!dst) return -8;
  for (uint32_t c = 0; c < si.channels; c++)
    memcpy(dst + (size_t)c * frames, chans[c].data(), frames * sizeof(float));
  out->data = dst;
  out->frames = (int64_t)frames;
  out->channels = (int32_t)si.channels;
  out->rate = (int32_t)si.rate;
  return 0;
}

}  // extern "C"
