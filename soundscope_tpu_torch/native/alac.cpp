// First-party ALAC (Apple Lossless) decoder — written from the public
// format description and validated bit-exactly against libavcodec on
// randomized fixtures (tests/test_alac.py); the bitstream layout was
// pinned empirically against bridge-encoded files before this port.
// Also decodes CAF LPCM payloads (the other first-party-able CAF codec).
//
// Scope: SCE/CPE/LFE elements, LPC predictor with sign-sign coefficient
// adaptation, first-order fallback mode (order 31), adaptive-Golomb
// residuals with zero-run compression, escape (verbatim) frames,
// mid/side decorrelation (mixRes/mixBits), shifted-byte planes for
// >16-bit depths, partial last frames, DSE/FIL skip elements, and
// multichannel layouts built from successive elements.
//
// Reference parity: symphonia-alac fills this slot for the Rust app
// (audio_player.rs:169-267, Cargo.toml:21 symphonia-all).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "demux.h"

struct DecodedWavLayout {
  float* data;
  int64_t frames;
  int32_t channels;
  int32_t rate;
};

namespace alac {
namespace {

// MSB-first bit reader (same contract as flac.cpp's).
struct BitReader {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // bit position
  bool err = false;

  BitReader(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}

  inline uint32_t bit1() {
    if (pos >= n * 8) { err = true; return 0; }
    uint32_t v = (p[pos >> 3] >> (7 - (pos & 7))) & 1u;
    pos++;
    return v;
  }

  uint64_t bits64(int k) {
    uint64_t v = 0;
    if (pos + (size_t)k > n * 8) { err = true; return 0; }
    for (int i = 0; i < k; i++) {
      v = (v << 1) | ((p[pos >> 3] >> (7 - (pos & 7))) & 1u);
      pos++;
    }
    return v;
  }

  uint32_t bits(int k) { return (uint32_t)bits64(k); }

  int64_t sbits(int k) {
    uint64_t v = bits64(k);
    uint64_t sign = 1ull << (k - 1);
    return (int64_t)((v ^ sign) - sign);
  }

  // count of leading 1 bits, consuming at most 9
  uint32_t unary9() {
    uint32_t q = 0;
    while (q < 9 && !err) {
      if (bit1() == 0) return q;
      q++;
    }
    return q;
  }

  void skip(size_t k) {
    pos += k;
    if (pos > n * 8) err = true;
  }
};

inline int32_t ilog2i(uint32_t x) {
  return x ? 31 - __builtin_clz(x) : -1;
}

inline int64_t sext(int64_t v, int bits) {
  uint64_t u = (uint64_t)v << (64 - bits);
  return (int64_t)u >> (64 - bits);
}

inline int sign_of(int64_t v) { return (v > 0) - (v < 0); }

// One adaptive-Golomb symbol: unary quotient (runs of 1s, max 9 ->
// escape to a raw bps-bit value), modulus 2^k - 1, adjusted-binary
// remainder (v < 2 encodes remainder 0 in k-1 bits).
uint32_t ag_symbol(BitReader& b, int k, int bps) {
  uint32_t q = b.unary9();
  if (q > 8) return b.bits(bps);
  if (k == 1) return q;
  uint32_t x = q * ((1u << k) - 1);
  uint32_t v = b.bits(k);
  if (v >= 2) x += v - 1;
  else b.pos -= 1;  // the last bit belongs to the next symbol
  return x;
}

// Residual stream: zigzag values with an adaptive rice parameter driven
// by a 9-bit fixed-point history, plus zero-run compression when the
// history collapses.
bool residuals(BitReader& b, int32_t* out, int nsamples, int bps,
               uint32_t mb0, uint32_t pb, uint32_t kb) {
  uint32_t history = mb0;
  uint32_t sign_modifier = 0;
  for (int i = 0; i < nsamples && !b.err; i++) {
    int k = ilog2i((history >> 9) + 3);
    if (k > (int)kb) k = (int)kb;
    uint32_t x = ag_symbol(b, k, bps) + sign_modifier;
    sign_modifier = 0;
    out[i] = (int32_t)((x >> 1) ^ (uint32_t)-(int32_t)(x & 1));
    if (x > 0xFFFF) history = 0xFFFF;
    else history += x * pb - ((history * pb) >> 9);
    if (history < 128 && i + 1 < nsamples) {
      int kz = 7 - ilog2i(history) + (((int)history + 16) >> 6);
      if (kz > (int)kb) kz = (int)kb;
      uint32_t run = ag_symbol(b, kz, 16);
      if (run > (uint32_t)(nsamples - i - 1)) return false;
      if (run > 0) {
        memset(out + i + 1, 0, run * sizeof(int32_t));
        i += (int)run;
      }
      if (run < 0xFFFF) sign_modifier = 1;
      history = 0;
    }
  }
  return !b.err;
}

// LPC reconstruction with sign-sign coefficient adaptation; order 31 is
// the pure first-order fallback, order 0 a passthrough. In-place safe
// (err may alias out).
void predict(const int32_t* err, int32_t* out, int n, int16_t* coefs,
             int order, int denshift, int chanbits) {
  out[0] = err[0];
  if (order == 0) {
    if (out != err) memcpy(out + 1, err + 1, (size_t)(n - 1) * 4);
    return;
  }
  if (order == 31) {
    int64_t prev = out[0];
    for (int j = 1; j < n; j++) {
      prev = sext(err[j] + prev, chanbits);
      out[j] = (int32_t)prev;
    }
    return;
  }
  for (int j = 1; j <= order && j < n; j++)
    out[j] = (int32_t)sext((int64_t)err[j] + out[j - 1], chanbits);
  int64_t denhalf = denshift > 0 ? (1ll << (denshift - 1)) : 0;
  for (int j = order + 1; j < n; j++) {
    int64_t top = out[j - order - 1];
    int64_t sum = 0;
    for (int kk = 0; kk < order; kk++)
      sum += (int64_t)coefs[kk] * (out[j - 1 - kk] - top);
    int64_t d = err[j];
    int64_t d0 = d;
    int sg = sign_of(d);
    out[j] = (int32_t)sext(d + top + ((sum + denhalf) >> denshift), chanbits);
    if (sg > 0) {
      for (int kk = order - 1; kk >= 0; kk--) {
        int64_t dd = top - out[j - 1 - kk];
        int sgn = sign_of(dd);
        coefs[kk] -= (int16_t)sgn;
        d0 -= (int64_t)(order - kk) * ((sgn * dd) >> denshift);
        if (d0 <= 0) break;
      }
    } else if (sg < 0) {
      for (int kk = order - 1; kk >= 0; kk--) {
        int64_t dd = top - out[j - 1 - kk];
        int sgn = sign_of(dd);
        coefs[kk] += (int16_t)sgn;
        d0 -= (int64_t)(order - kk) * ((-sgn * dd) >> denshift);
        if (d0 >= 0) break;
      }
    }
  }
}

struct Config {
  uint32_t frame_length;
  int bit_depth;
  uint32_t pb, mb, kb;
  int channels;
  uint32_t rate;
};

bool parse_config(const uint8_t* c, Config* cfg) {
  cfg->frame_length = ((uint32_t)c[0] << 24) | (c[1] << 16) | (c[2] << 8) | c[3];
  cfg->bit_depth = c[5];
  cfg->pb = c[6];
  cfg->mb = c[7];
  cfg->kb = c[8];
  cfg->channels = c[9];
  cfg->rate = ((uint32_t)c[20] << 24) | (c[21] << 16) | (c[22] << 8) | c[23];
  return cfg->frame_length > 0 && cfg->frame_length <= (1u << 20) &&
         cfg->channels >= 1 && cfg->channels <= 8 &&
         (cfg->bit_depth == 16 || cfg->bit_depth == 20 ||
          cfg->bit_depth == 24 || cfg->bit_depth == 32);
}

// Decode one packet; appends per-channel int32 samples to pcm. Returns
// the number of frames decoded, or -1 on parse failure (caller skips the
// packet, like the reference skips undecodable ones, audio_player.rs:261).
int64_t decode_packet(const uint8_t* pkt, size_t len, const Config& cfg,
                      std::vector<std::vector<int32_t>>& pcm) {
  BitReader b(pkt, len);
  int chan = 0;
  int64_t frames = -1;
  std::vector<int32_t> u, v, shifts;
  std::vector<size_t> base(pcm.size());
  for (size_t c = 0; c < pcm.size(); c++) base[c] = pcm[c].size();

  auto fail = [&]() {
    for (size_t c = 0; c < pcm.size(); c++) pcm[c].resize(base[c]);
    return (int64_t)-1;
  };

  while (!b.err) {
    uint32_t tag = b.bits(3);
    if (b.err) return fail();
    if (tag == 7) break;  // END
    if (tag == 4) {       // DSE: skip
      b.skip(4);
      uint32_t align = b.bit1();
      uint32_t cnt = b.bits(8);
      if (cnt == 255) cnt += b.bits(8);
      if (align) b.pos = (b.pos + 7) & ~(size_t)7;
      b.skip((size_t)cnt * 8);
      continue;
    }
    if (tag == 6) {  // FIL: skip
      uint32_t cnt = b.bits(4);
      if (cnt == 15) cnt += b.bits(8) - 1;
      b.skip((size_t)cnt * 8);
      continue;
    }
    if (tag != 0 && tag != 1 && tag != 3) return fail();  // SCE/CPE/LFE only
    int nch = tag == 1 ? 2 : 1;
    if (chan + nch > cfg.channels) return fail();

    b.skip(4);  // element instance tag
    if (b.bits(12) != 0) return fail();  // unused header bits
    uint32_t partial = b.bit1();
    uint32_t bytes_shifted = b.bits(2);
    if (bytes_shifted == 3) return fail();
    int shift = (int)bytes_shifted * 8;
    uint32_t escape = b.bit1();
    uint32_t nsamples = partial ? b.bits(32) : cfg.frame_length;
    if (b.err || nsamples == 0 || nsamples > cfg.frame_length) return fail();

    u.assign(nsamples, 0);
    if (nch == 2) v.assign(nsamples, 0);
    int mixbits = 0, mixres = 0;

    if (!escape) {
      int chanbits = cfg.bit_depth - shift + nch - 1;
      if (chanbits <= 0 || chanbits > 32) return fail();
      // decorrelation pair: present (unused) even for mono elements
      mixbits = (int)b.bits(8);
      mixres = (int)b.sbits(8);

      uint32_t mode[2], denshift[2], pbf[2], order[2];
      int16_t coefs[2][32];
      for (int c = 0; c < nch; c++) {
        mode[c] = b.bits(4);
        denshift[c] = b.bits(4);
        pbf[c] = b.bits(3);
        order[c] = b.bits(5);
        if (mode[c] != 0 && mode[c] != 15) return fail();
        for (uint32_t i = 0; i < order[c]; i++)
          coefs[c][i] = (int16_t)b.sbits(16);
      }
      size_t shift_pos = b.pos;
      if (bytes_shifted) b.skip((size_t)shift * nch * nsamples);

      for (int c = 0; c < nch; c++) {
        int32_t* dst = c == 0 ? u.data() : v.data();
        uint32_t pb_c = (cfg.pb * pbf[c]) >> 2;
        if (!residuals(b, dst, (int)nsamples, chanbits, cfg.mb, pb_c, cfg.kb))
          return fail();
        if (mode[c] == 0) {
          predict(dst, dst, (int)nsamples, coefs[c], (int)order[c],
                  (int)denshift[c], chanbits);
        } else {  // mode 15: first-order pass, then the real predictor
          predict(dst, dst, (int)nsamples, nullptr, 31, 0, chanbits);
          predict(dst, dst, (int)nsamples, coefs[c], (int)order[c],
                  (int)denshift[c], chanbits);
        }
      }
      if (bytes_shifted) {
        BitReader sb(pkt, len);
        sb.pos = shift_pos;
        shifts.assign((size_t)nsamples * nch, 0);
        for (uint32_t i = 0; i < nsamples * (uint32_t)nch; i++)
          shifts[i] = (int32_t)sb.bits(shift);
        if (sb.err) return fail();
      }
    } else {
      // escape: verbatim full-depth samples, interleaved across the pair
      shift = 0;
      bytes_shifted = 0;
      for (uint32_t i = 0; i < nsamples; i++) {
        u[i] = (int32_t)b.sbits(cfg.bit_depth);
        if (nch == 2) v[i] = (int32_t)b.sbits(cfg.bit_depth);
      }
      if (b.err) return fail();
    }

    // un-decorrelate, then splice the shifted-off low bytes back in
    if (nch == 2) {
      if (mixres != 0) {
        for (uint32_t i = 0; i < nsamples; i++) {
          int32_t l = u[i] + v[i] - (int32_t)(((int64_t)mixres * v[i]) >> mixbits);
          int32_t r = l - v[i];
          u[i] = l;
          v[i] = r;
        }
      }
      if (bytes_shifted) {
        for (uint32_t i = 0; i < nsamples; i++) {
          u[i] = (int32_t)(((uint32_t)u[i] << shift) | (uint32_t)shifts[2 * i]);
          v[i] = (int32_t)(((uint32_t)v[i] << shift) | (uint32_t)shifts[2 * i + 1]);
        }
      }
      pcm[chan].insert(pcm[chan].end(), u.begin(), u.end());
      pcm[chan + 1].insert(pcm[chan + 1].end(), v.begin(), v.end());
    } else {
      if (bytes_shifted)
        for (uint32_t i = 0; i < nsamples; i++)
          u[i] = (int32_t)(((uint32_t)u[i] << shift) | (uint32_t)shifts[i]);
      pcm[chan].insert(pcm[chan].end(), u.begin(), u.end());
    }
    chan += nch;
    if (frames < 0) frames = nsamples;
    else if (frames != (int64_t)nsamples) return fail();
  }
  // a reader error (truncated packet, overrunning DSE/FIL skip, missing
  // END tag) must drop the whole packet like any other parse failure —
  // the bit-exact oracle (libav) skips such packets entirely
  if (b.err || chan == 0 || frames < 0) return fail();
  // elements may legally cover fewer channels than the config claims
  // (defensive); pad the missing ones with silence
  for (int c = chan; c < cfg.channels; c++)
    pcm[c].resize(base[c] + (size_t)frames, 0);
  return frames;
}

// CAF LPCM payload -> planar float (16/24/32-bit int, 32/64-bit float,
// either endianness per the format flags).
bool decode_lpcm(const uint8_t* d, size_t len, const demux::Track& t,
                 std::vector<std::vector<float>>& pcm) {
  bool is_float = t.lpcm_flags & 1;
  bool little = t.lpcm_flags & 2;
  int bytes = t.bits / 8;
  if (bytes < 1 || bytes > 8 || t.channels < 1) return false;
  size_t stride = (size_t)bytes * t.channels;
  size_t frames = len / stride;
  for (auto& ch : pcm) ch.reserve(ch.size() + frames);
  double scale = is_float ? 1.0 : 1.0 / (double)(1ull << (t.bits - 1));
  for (size_t i = 0; i < frames; i++) {
    for (int c = 0; c < t.channels; c++) {
      const uint8_t* s = d + i * stride + (size_t)c * bytes;
      uint64_t raw = 0;
      if (little)
        for (int k = bytes - 1; k >= 0; k--) raw = (raw << 8) | s[k];
      else
        for (int k = 0; k < bytes; k++) raw = (raw << 8) | s[k];
      double val;
      if (is_float && bytes == 4) {
        float f;
        uint32_t r32 = (uint32_t)raw;
        memcpy(&f, &r32, 4);
        val = f;
      } else if (is_float && bytes == 8) {
        double f;
        memcpy(&f, &raw, 8);
        val = f;
      } else {
        int64_t v = sext((int64_t)raw, t.bits);
        val = (double)v * scale;
      }
      pcm[c].push_back((float)val);
    }
  }
  return frames > 0;
}

}  // namespace
}  // namespace alac

extern "C" void ss_free_decoded(DecodedWavLayout* w);  // decoder.cpp

// Decode ALAC (in .m4a/.mp4 or .caf) or CAF LPCM to planar float32.
// Returns 0 on success, -2 when the container holds a codec this
// first-party path does not cover (caller falls to the bridge).
extern "C" int ss_decode_alac(const char* path, DecodedWavLayout* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (fsz <= 0) { fclose(f); return -1; }
  std::vector<uint8_t> buf((size_t)fsz);
  size_t rd = fread(buf.data(), 1, buf.size(), f);
  fclose(f);
  if (rd != buf.size()) return -1;

  demux::Track t;
  bool is_caf = buf.size() >= 4 && memcmp(buf.data(), "caff", 4) == 0;
  if (is_caf) {
    if (!demux::parse_caf(buf.data(), buf.size(), &t)) return -3;
  } else {
    if (!demux::parse_mp4(buf.data(), buf.size(), demux::fourcc("alac"), &t))
      return -2;  // maybe AAC/mp4a: bridge's job
  }

  // --- CAF LPCM: direct PCM unpack ---
  if (is_caf && t.codec == demux::fourcc("lpcm")) {
    // desc fields come straight from the file: validate before any
    // allocation sized by them (a crafted chunk must DecodeError, not
    // abort the process)
    if (t.channels < 1 || t.channels > 64 || t.bits < 8 || t.bits > 64)
      return -4;
    std::vector<std::vector<float>> fpcm(t.channels);
    const demux::Packet& p = t.packets[0];
    // overflow-safe: p.off is a 64-bit file-supplied chunk offset, so
    // p.off + p.size can wrap; compare against the remaining span instead
    if (p.off > buf.size() || p.size > buf.size() - p.off ||
        !alac::decode_lpcm(buf.data() + p.off, p.size, t, fpcm))
      return -4;
    int64_t frames = (int64_t)fpcm[0].size();
    float* data = (float*)malloc(sizeof(float) * (size_t)frames * t.channels);
    if (!data) return -6;
    for (int c = 0; c < t.channels; c++)
      memcpy(data + (size_t)c * frames, fpcm[c].data(),
             sizeof(float) * (size_t)frames);
    out->data = data;
    out->frames = frames;
    out->channels = t.channels;
    out->rate = (int32_t)t.rate;
    return 0;
  }

  if (t.codec != demux::fourcc("alac")) return -2;  // bridge's job
  const uint8_t* cfg_bytes = demux::alac_config(t.cookie);
  if (!cfg_bytes) return -3;
  alac::Config cfg;
  if (!alac::parse_config(cfg_bytes, &cfg)) return -3;

  std::vector<std::vector<int32_t>> pcm(cfg.channels);
  for (const demux::Packet& p : t.packets) {
    // overflow-safe bounds check (p.off comes from a 64-bit co64 field)
    if (p.off > buf.size() || p.size > buf.size() - p.off || p.size == 0)
      continue;
    // undecodable packets are skipped (reference: audio_player.rs:261)
    alac::decode_packet(buf.data() + p.off, p.size, cfg, pcm);
  }
  int64_t frames = (int64_t)pcm[0].size();
  if (frames == 0) return -5;

  // CAF pakt may trim a full final frame (Apple-muxed files) and
  // encoder priming; ffmpeg-muxed files use in-band partial frames and
  // report valid_frames >= decoded, so this is a no-op there
  int64_t start = 0;
  if (t.priming_frames > 0 && t.priming_frames < frames)
    start = t.priming_frames;
  int64_t end = frames;
  if (t.valid_frames > 0 && start + t.valid_frames < frames)
    end = start + t.valid_frames;
  frames = end - start;

  float* data = (float*)malloc(sizeof(float) * (size_t)frames * cfg.channels);
  if (!data) return -6;
  float scale = 1.0f / (float)(1u << (cfg.bit_depth - 1));
  // ALAC multichannel layouts follow the MPEG element order (C first);
  // emit the canonical L/R-leading order the independent decoders use
  // (verified bit-exact under permutation against libav on 5.1)
  static const int kPerm3[] = {1, 2, 0};
  static const int kPerm4[] = {1, 2, 0, 3};
  static const int kPerm5[] = {1, 2, 0, 3, 4};
  static const int kPerm6[] = {1, 2, 0, 5, 3, 4};
  // 6.1 (tag = AAC_6_1, element order C L R Ls Rs Cs LFE) -> the libav
  // 6.1 order FL FR FC LFE BC SL SR, matching vorbis.cpp's verified
  // kPerm7 convention (no local oracle: ffmpeg's alac encoder rejects
  // 6.1, so this rides the sibling decoders' pinned layout)
  static const int kPerm7[] = {1, 2, 0, 6, 5, 3, 4};
  static const int kPerm8[] = {3, 4, 0, 7, 5, 6, 1, 2};
  const int* perm = nullptr;
  if (cfg.channels == 3) perm = kPerm3;
  else if (cfg.channels == 4) perm = kPerm4;
  else if (cfg.channels == 5) perm = kPerm5;
  else if (cfg.channels == 6) perm = kPerm6;
  else if (cfg.channels == 7) perm = kPerm7;
  else if (cfg.channels == 8) perm = kPerm8;
  for (int c = 0; c < cfg.channels; c++) {
    float* dst = data + (size_t)c * frames;
    const int32_t* src = pcm[perm ? perm[c] : c].data() + start;
    for (int64_t i = 0; i < frames; i++) dst[i] = (float)src[i] * scale;
  }
  out->data = data;
  out->frames = frames;
  out->channels = cfg.channels;
  out->rate = (int32_t)cfg.rate;
  return 0;
}
