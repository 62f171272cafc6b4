// First-party MPEG audio (Layer I / Layer III) decoder — written from
// the format specification with every arbitrary constant table (Huffman
// codes, synthesis window, scalefactor bands, slen pairs, requant
// constants) derived by black-box probing of the system's decoders with
// crafted bitstreams (tools/mp3_extract/*.py). No third-party decoder
// source was consulted.
//
// The reference delegates MPEG audio to the symphonia crate
// (/root/reference/src/audio_player.rs:169-267, Cargo.toml:21); this is
// the rebuild's own implementation; the libav codec bridge
// (codecs.cpp) is only used for non-MPEG codecs.
//
// Scope: MPEG-1/2/2.5 Layer III at all nine sample rates, mono/stereo/
// joint (MS and intensity, including the LSF intensity variant)/dual,
// long/short/start/stop and mixed blocks, bit reservoir, scfsi, CRC
// frames, free format, ID3v2 skip, Xing/Info/VBRI skip;
// Layer I (384-sample frames, 4-bit allocations, joint-stereo bound)
// and Layer II (measured allocation tables a/b/c/d/LSF, scfsi, grouped
// classes) at every MPEG-1/2/2.5 rate, sharing the polyphase synthesis
// filterbank.
// Output: planar float32 via the DecodedWav ABI of decoder.cpp.
//
// Robustness: undecodable frames are skipped (the reference skips bad
// packets, audio_player.rs:261); an error is returned only when no
// audio could be decoded at all.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include "mp3_tables.inc"

struct DecodedWavLayout {
  float* data;
  int64_t frames;
  int32_t channels;
  int32_t rate;
};

namespace mp3 {

// ---------------------------------------------------------------------------
// bit reader (MSB first)

struct Bits {
  const uint8_t* p;
  size_t nbits;
  size_t pos = 0;
  bool err = false;

  Bits(const uint8_t* p_, size_t nbytes) : p(p_), nbits(nbytes * 8) {}

  inline uint32_t get1() {
    if (pos >= nbits) { err = true; return 0; }
    uint32_t v = (p[pos >> 3] >> (7 - (pos & 7))) & 1u;
    pos++;
    return v;
  }
  uint32_t get(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | get1();
    return v;
  }
  // Peek up to 24 bits without consuming; zero-padded past the buffer
  // end via the per-byte bounds check below (do NOT drop it: the main
  // data buffer has no guard bytes). Callers bound actual consumption
  // with part2_3 checks.
  inline uint32_t peek24() const {
    size_t byte = pos >> 3;
    uint32_t w = 0;
    size_t nbytes = (nbits + 7) >> 3;
    for (int i = 0; i < 4; i++)
      w = (w << 8) | (byte + i < nbytes ? p[byte + i] : 0);
    return (w >> (8 - (pos & 7))) & 0xFFFFFF;
  }
  inline void consume(int n) {
    pos += n;
    if (pos > nbits) { err = true; pos = nbits; }
  }
};

// ---------------------------------------------------------------------------
// header

struct Header {
  int version;      // 3 = MPEG-1, 2 = MPEG-2 (LSF), 0 = MPEG-2.5 (LSF)
  int layer;        // 1, 2 or 3 (Layer III is the primary path)
  bool lsf;         // one granule, 576 samples/frame (Layer III only)
  int bitrate;      // bits/s
  int rate;         // Hz
  int rate_idx;     // header rate index within the version's rate family
  bool crc;         // protection bit == 0 -> 16-bit CRC follows header
  bool padding;
  int mode;         // 0 stereo, 1 joint, 2 dual, 3 mono
  int mode_ext;
  int channels;
  int frame_bytes;  // 0 until discovered for free-format streams
  int samples;      // 1152 (MPEG-1) or 576 (LSF)
  bool free;        // free-format: bitrate index 0, size found by sync scan
};

static const int kBitrateV1L3[16] = {0,   32,  40,  48,  56,  64,  80, 96,
                                     112, 128, 160, 192, 224, 256, 320, 0};
static const int kBitrateV1L1[16] = {0,   32,  64,  96,  128, 160, 192, 224,
                                     256, 288, 320, 352, 384, 416, 448, 0};
static const int kBitrateV2L1[16] = {0,   32,  48,  56,  64,  80,  96, 112,
                                     128, 144, 160, 176, 192, 224, 256, 0};
static const int kBitrateV1L2[16] = {0,   32,  48,  56,  64,  80,  96, 112,
                                     128, 160, 192, 224, 256, 320, 384, 0};
// MPEG-2/2.5 Layers II and III share one bitrate table
static const int kBitrateV2L3[16] = {0,  8,  16, 24, 32,  40,  48, 56,
                                     64, 80, 96, 112, 128, 144, 160, 0};
static const int kRateV1[4] = {44100, 48000, 32000, 0};
static const int kRateV2[4] = {22050, 24000, 16000, 0};
static const int kRateV25[4] = {11025, 12000, 8000, 0};

static bool parse_header(uint32_t h, Header* out) {
  if ((h >> 21) != 0x7FF) return false;
  int version = (h >> 19) & 3;
  int layerf = (h >> 17) & 3;
  if (layerf == 0) return false;                 // reserved
  if (version == 1) return false;                // reserved
  int layer = 4 - layerf;                        // 1, 2 or 3
  int bidx = (h >> 12) & 15;
  int ridx = (h >> 10) & 3;
  if (bidx == 15 || ridx == 3) return false;  // bad
  out->free = bidx == 0;
  out->version = version;
  out->layer = layer;
  out->lsf = layer == 3 && version != 3;
  out->rate = (version == 3 ? kRateV1 : version == 2 ? kRateV2 : kRateV25)[ridx];
  if (layer == 3)
    out->bitrate = (version == 3 ? kBitrateV1L3 : kBitrateV2L3)[bidx] * 1000;
  else if (layer == 2)
    out->bitrate = (version == 3 ? kBitrateV1L2 : kBitrateV2L3)[bidx] * 1000;
  else
    out->bitrate = (version == 3 ? kBitrateV1L1 : kBitrateV2L1)[bidx] * 1000;
  out->rate_idx = ridx;
  out->crc = ((h >> 16) & 1) == 0;
  out->padding = (h >> 9) & 1;
  out->mode = (h >> 6) & 3;
  out->mode_ext = (h >> 4) & 3;
  out->channels = out->mode == 3 ? 1 : 2;
  if (layer == 1) {
    out->samples = 384;
    out->frame_bytes = (12 * out->bitrate / out->rate + (out->padding ? 1 : 0)) * 4;
  } else if (layer == 2) {
    out->samples = 1152;  // also for LSF: Layer II keeps 1152 samples/frame
    out->frame_bytes = 144 * out->bitrate / out->rate + (out->padding ? 1 : 0);
  } else {
    out->samples = out->lsf ? 576 : 1152;
    out->frame_bytes = (out->lsf ? 72 : 144) * out->bitrate / out->rate +
                       (out->padding ? 1 : 0);
  }
  if (out->free) out->frame_bytes = 0;  // discovered at stream lock
  return true;
}

// bytes-per-frame = kFrameCoef * bitrate / rate (x4 slots for Layer I);
// inverted to recover an effective bitrate for free-format streams
static int frame_coef(const Header& h) {
  if (h.layer == 1) return 48;          // (12 * br/rate) * 4
  if (h.layer == 2) return 144;
  return h.lsf ? 72 : 144;
}

// Layer II allocation-table selection, measured by the extract_layer2
// selection scan (layer2.json "selection"): the choice collapses to a
// bitrate-per-channel rule; every LSF stream uses the single LSF table.
static const Mp3L2Table* l2_select(const Header& h) {
  if (h.version != 3) return &kL2Table_lsf;
  int per = (h.bitrate / 1000) / h.channels;
  if (h.rate == 48000) return per <= 48 ? &kL2Table_c : &kL2Table_a;
  const Mp3L2Table* low = h.rate == 32000 ? &kL2Table_d : &kL2Table_c;
  if (per <= 48) return low;
  return per <= 80 ? &kL2Table_a : &kL2Table_b;
}

// scalefactor band tables for this stream
static inline const uint16_t* sfb_long(const Header& h) {
  if (!h.lsf) return kSfbLong[h.rate_idx];
  return kSfbLongLsf[h.version == 2 ? 0 : 1][h.rate_idx];
}
static inline const uint16_t* sfb_short(const Header& h) {
  if (!h.lsf) return kSfbShort[h.rate_idx];
  return kSfbShortLsf[h.version == 2 ? 0 : 1][h.rate_idx];
}

// ---------------------------------------------------------------------------
// side info

struct GrInfo {
  int part2_3_length, big_values, global_gain, scalefac_compress;
  bool window_switching;
  int block_type, mixed;
  int table_select[3];
  int subblock_gain[3];
  int region0, region1;
  int preflag, scalefac_scale, count1table;
};

struct SideInfo {
  int main_data_begin;
  int scfsi[2][4];
  GrInfo gr[2][2];  // [granule][channel]
};

static bool read_side_info(Bits& b, const Header& h, SideInfo* si) {
  int channels = h.channels;
  si->main_data_begin = b.get(h.lsf ? 8 : 9);
  if (h.lsf)
    b.get(channels == 1 ? 1 : 2);  // private bits
  else
    b.get(channels == 1 ? 5 : 3);
  memset(si->scfsi, 0, sizeof(si->scfsi));
  if (!h.lsf)
    for (int ch = 0; ch < channels; ch++)
      for (int g = 0; g < 4; g++) si->scfsi[ch][g] = b.get1();
  int granules = h.lsf ? 1 : 2;
  for (int gr = 0; gr < granules; gr++) {
    for (int ch = 0; ch < channels; ch++) {
      GrInfo& g = si->gr[gr][ch];
      g.part2_3_length = b.get(12);
      g.big_values = b.get(9);
      g.global_gain = b.get(8);
      g.scalefac_compress = b.get(h.lsf ? 9 : 4);
      g.window_switching = b.get1();
      if (g.window_switching) {
        g.block_type = b.get(2);
        g.mixed = b.get1();
        g.table_select[0] = b.get(5);
        g.table_select[1] = b.get(5);
        g.table_select[2] = 0;
        for (int w = 0; w < 3; w++) g.subblock_gain[w] = b.get(3);
        // implied regions (spec): region0 covers the first 36 lines for
        // short/mixed; start/stop blocks behave like long single-region
        g.region0 = 7;
        g.region1 = 13;
        if (g.block_type == 0) return false;  // forbidden combination
      } else {
        g.block_type = 0;
        g.mixed = 0;
        for (int r = 0; r < 3; r++) g.table_select[r] = b.get(5);
        g.region0 = b.get(4);
        g.region1 = b.get(3);
        g.subblock_gain[0] = g.subblock_gain[1] = g.subblock_gain[2] = 0;
      }
      g.preflag = h.lsf ? 0 : b.get1();  // LSF: implied by scalefac_compress
      g.scalefac_scale = b.get1();
      g.count1table = b.get1();
      if (b.err) return false;
    }
  }
  return !b.err;
}

// ---------------------------------------------------------------------------
// Huffman decode (two-level LUTs built once from the extracted tables)


// Two-level lookup decode: 10-bit primary, 9-bit secondary (max code
// length is 19). Entry len==0 -> invalid; len==0xFF -> secondary table
// index in sym.
struct LutEntry { uint8_t sym, len; };
struct HuffLut {
  std::vector<LutEntry> prim;                 // 1024
  std::vector<std::vector<LutEntry>> secs;    // per long prefix: 512
};
static HuffLut g_lut[32];
static LutEntry g_quadA_lut[64];              // count1-A codes are <= 6 bits

static void lut_build(HuffLut& L, const Mp3HuffTable& ht) {
  L.prim.assign(1024, LutEntry{0, 0});
  for (int e = 0; e < ht.n; e++) {
    int len = ht.e[e].len;
    uint32_t code = ht.e[e].code;
    uint8_t sym = (uint8_t)((ht.e[e].x << 4) | ht.e[e].y);
    if (len <= 10) {
      uint32_t base = code << (10 - len);
      for (uint32_t k = 0; k < (1u << (10 - len)); k++)
        L.prim[base + k] = LutEntry{sym, (uint8_t)len};
    } else {
      uint32_t hi = code >> (len - 10);
      LutEntry& p = L.prim[hi];
      if (p.len != 0xFF) {
        p.len = 0xFF;
        p.sym = (uint8_t)L.secs.size();
        L.secs.emplace_back(512, LutEntry{0, 0});
      }
      auto& sec = L.secs[p.sym];
      int rem = len - 10;
      uint32_t lo = code & ((1u << rem) - 1);
      uint32_t base = lo << (9 - rem);
      for (uint32_t k = 0; k < (1u << (9 - rem)); k++)
        sec[base + k] = LutEntry{sym, (uint8_t)rem};
    }
  }
}

static inline int lut_decode(const HuffLut& L, Bits& b) {
  uint32_t w = b.peek24();
  LutEntry e = L.prim[w >> 14];
  if (e.len == 0) return -1;
  if (e.len != 0xFF) {
    b.consume(e.len);
    return e.sym;
  }
  LutEntry s = L.secs[e.sym][(w >> 5) & 0x1FF];
  if (s.len == 0) return -1;
  b.consume(10 + s.len);
  return s.sym;
}

static void build_trees() {
  // ctypes releases the GIL during ss_decode_mp3, so concurrent decodes
  // are possible; a C++11 magic static makes the one-time table build
  // thread-safe (a plain bool guard would race)
  static const bool done = [] {
    for (int i = 0; i < 32; i++)
      if (kHuffTables[i].n) lut_build(g_lut[i], kHuffTables[i]);
    memset(g_quadA_lut, 0, sizeof(g_quadA_lut));
    for (size_t e = 0; e < sizeof(kCount1A) / sizeof(kCount1A[0]); e++) {
      int len = kCount1A[e].len;
      uint32_t base = (uint32_t)kCount1A[e].code << (6 - len);
      for (uint32_t k = 0; k < (1u << (6 - len)); k++)
        g_quadA_lut[base + k] = LutEntry{kCount1A[e].vwxy, (uint8_t)len};
    }
    return true;
  }();
  (void)done;
}

// ---------------------------------------------------------------------------
// DSP constants

struct Dsp {
  float nmat[64][32];      // synthesis matrixing cos((16+i)(2k+1)pi/64)
  float imdct36[36][18];
  float imdct12[12][6];
  float win[4][36];        // block types 0..3 (type 2 slot holds zeros)
  float win_short[12];
  float cs[8], ca[8];
  float pow43[8207 + 16];

  Dsp() {
    for (int i = 0; i < 64; i++)
      for (int k = 0; k < 32; k++)
        nmat[i][k] = (float)cos((16 + i) * (2 * k + 1) * M_PI / 64.0);
    for (int i = 0; i < 36; i++)
      for (int k = 0; k < 18; k++)
        imdct36[i][k] = (float)cos(M_PI / 72.0 * (2 * i + 1 + 18) * (2 * k + 1));
    for (int i = 0; i < 12; i++)
      for (int k = 0; k < 6; k++)
        imdct12[i][k] = (float)cos(M_PI / 24.0 * (2 * i + 1 + 6) * (2 * k + 1));
    for (int i = 0; i < 36; i++) {
      double v = sin(M_PI / 36.0 * (i + 0.5));
      win[0][i] = (float)v;
      win[1][i] = (float)(i < 18 ? v : (i < 24 ? 1.0
                    : (i < 30 ? sin(M_PI / 12.0 * (i - 18 + 0.5)) : 0.0)));
      win[3][i] = (float)(i < 6 ? 0.0 : (i < 12 ? sin(M_PI / 12.0 * (i - 6 + 0.5))
                    : (i < 18 ? 1.0 : v)));
      win[2][i] = 0.0f;
    }
    for (int i = 0; i < 12; i++)
      win_short[i] = (float)sin(M_PI / 12.0 * (i + 0.5));
    static const double ci[8] = {-0.6, -0.535, -0.33, -0.185,
                                 -0.095, -0.041, -0.0142, -0.0037};
    for (int i = 0; i < 8; i++) {
      cs[i] = (float)(1.0 / sqrt(1.0 + ci[i] * ci[i]));
      ca[i] = (float)(ci[i] / sqrt(1.0 + ci[i] * ci[i]));
    }
    for (int i = 0; i < 8207 + 16; i++) pow43[i] = (float)pow(i, 4.0 / 3.0);
  }
};

static const Dsp& dsp() {
  static Dsp d;
  return d;
}

// ---------------------------------------------------------------------------
// per-granule decode

struct Scalefactors {
  int l[23] = {0};      // long bands 0..21
  int s[13][3] = {{0}}; // short bands 0..12 x window
};

// Shared LSF fill: read nr[grp] values of slen[grp] bits per group and
// distribute them over long / short / mixed band slots.
static void read_lsf_values(Bits& b, const GrInfo& g, const int slen[4],
                            const uint8_t nr[4], Scalefactors* sf) {
  int vals[54];
  int n = 0;
  for (int grp = 0; grp < 4; grp++)
    for (int i = 0; i < nr[grp]; i++) vals[n++] = (int)b.get(slen[grp]);
  int k = 0;
  bool short_blk = g.window_switching && g.block_type == 2;
  if (!short_blk) {
    for (int band = 0; band < n && band < 22; band++) sf->l[band] = vals[band];
    for (int band = n; band < 23; band++) sf->l[band] = 0;
  } else {
    if (g.mixed) {
      for (int band = 0; band < 6 && k < n; band++) sf->l[band] = vals[k++];
      for (int band = 3; band < 12; band++)
        for (int w = 0; w < 3; w++)
          sf->s[band][w] = k < n ? vals[k++] : 0;
    } else {
      for (int band = 0; band < 12; band++)
        for (int w = 0; w < 3; w++)
          sf->s[band][w] = k < n ? vals[k++] : 0;
    }
    sf->s[12][0] = sf->s[12][1] = sf->s[12][2] = 0;
  }
}

// LSF scalefactors: slen groups + group sizes measured by oracle
// probing (tools/mp3_extract/extract_lsf.py). `preflag_out` reports the
// implicit preflag (scalefac_compress >= 500).
static void read_scalefactors_lsf(Bits& b, const GrInfo& g,
                                  Scalefactors* sf, int* preflag_out) {
  int sc = g.scalefac_compress;
  int slen[4], row;
  if (sc < 400) {
    slen[0] = (sc >> 4) / 5; slen[1] = (sc >> 4) % 5;
    slen[2] = (sc & 15) >> 2; slen[3] = sc & 3;
    row = 0;
    *preflag_out = 0;
  } else if (sc < 500) {
    int s = sc - 400;
    slen[0] = (s >> 2) / 5; slen[1] = (s >> 2) % 5;
    slen[2] = s & 3; slen[3] = 0;
    row = 1;
    *preflag_out = 0;
  } else {
    int s = sc - 500;
    slen[0] = s / 3; slen[1] = s % 3;
    slen[2] = slen[3] = 0;
    row = 2;
    *preflag_out = 1;
  }
  bool short_blk = g.window_switching && g.block_type == 2;
  int kind = short_blk ? (g.mixed ? 2 : 1) : 0;
  read_lsf_values(b, g, slen, kLsfNr[row][kind], sf);
}

// Scalefactors of the intensity channel (right channel of an LSF
// joint-intensity stream): its own three-region layout on
// int_sc = scalefac_compress >> 1 (the LSB selects the intensity base
// io), measured per-sc by the part2_3 threshold scan and single-bit
// band maps in tools/mp3_extract/extract_lsf_is.py. The parsed values
// double as the is_pos positions in stereo_process.
static void read_scalefactors_lsf_is(Bits& b, const GrInfo& g,
                                     Scalefactors* sf, int* preflag_out) {
  int isc = g.scalefac_compress >> 1;
  int slen[4] = {0, 0, 0, 0}, row;
  if (isc < 180) {
    slen[0] = isc / 36; slen[1] = (isc % 36) / 6; slen[2] = isc % 6;
    row = 0;
  } else if (isc < 244) {
    int j = isc - 180;
    slen[0] = (j >> 4) & 3; slen[1] = (j >> 2) & 3; slen[2] = j & 3;
    row = 1;
  } else {
    int j = isc - 244;
    slen[0] = j / 3; slen[1] = j % 3;
    row = 2;
  }
  *preflag_out = 0;
  bool short_blk = g.window_switching && g.block_type == 2;
  int kind = short_blk ? (g.mixed ? 2 : 1) : 0;
  read_lsf_values(b, g, slen, kLsfNrIs[row][kind], sf);
}

// Read scalefactors; returns bits consumed. `prev` holds granule-0
// factors of the same channel for scfsi reuse.
static void read_scalefactors(Bits& b, const GrInfo& g, const int scfsi[4],
                              int granule, Scalefactors* sf,
                              Scalefactors* prev) {
  int slen1 = kSlen[g.scalefac_compress][0];
  int slen2 = kSlen[g.scalefac_compress][1];
  if (g.window_switching && g.block_type == 2) {
    if (g.mixed) {
      for (int band = 0; band < 8; band++) sf->l[band] = b.get(slen1);
      for (int band = 3; band < 6; band++)
        for (int w = 0; w < 3; w++) sf->s[band][w] = b.get(slen1);
    } else {
      for (int band = 0; band < 6; band++)
        for (int w = 0; w < 3; w++) sf->s[band][w] = b.get(slen1);
    }
    for (int band = 6; band < 12; band++)
      for (int w = 0; w < 3; w++) sf->s[band][w] = b.get(slen2);
    sf->s[12][0] = sf->s[12][1] = sf->s[12][2] = 0;
  } else {
    static const int kGroups[5] = {0, 6, 11, 16, 21};
    for (int grp = 0; grp < 4; grp++) {
      int slen = grp < 2 ? slen1 : slen2;
      if (granule == 1 && scfsi[grp]) {
        for (int band = kGroups[grp]; band < kGroups[grp + 1]; band++)
          sf->l[band] = prev->l[band];
      } else {
        for (int band = kGroups[grp]; band < kGroups[grp + 1]; band++)
          sf->l[band] = b.get(slen);
      }
    }
    sf->l[21] = sf->l[22] = 0;
  }
}

// Huffman-decode the spectrum into `ix` (signed integers) in Huffman
// order; returns number of lines with data (zero padding after).
static int read_huffman(Bits& b, const GrInfo& g, const Header& h,
                        size_t part2_3_end, int32_t ix[576]) {
  memset(ix, 0, 576 * sizeof(int32_t));
  const uint16_t* sfb = sfb_long(h);
  int region1_start, region2_start;
  if (g.window_switching) {
    // boundaries measured by oracle probing (see extract rig): start/stop
    // blocks and MPEG-1/2.5 mixed use sfb_long[8]; short non-mixed uses
    // 3*sfb_short[3]; MPEG-2 mixed is the measured oddball at 36
    if (g.block_type == 2 && !g.mixed)
      region1_start = 3 * sfb_short(h)[3];
    else if (g.block_type == 2 && g.mixed && h.version == 2)
      region1_start = 36;
    else
      region1_start = sfb[8];
    region2_start = 576;
  } else {
    int r0 = g.region0 + 1;
    int r1 = r0 + g.region1 + 1;
    region1_start = sfb[r0 > 22 ? 22 : r0];
    region2_start = sfb[r1 > 22 ? 22 : r1];
  }
  int big = g.big_values * 2;
  if (big > 576) big = 576;
  for (int i = 0; i < big; i += 2) {
    int tsel = i < region1_start ? g.table_select[0]
               : (i < region2_start ? g.table_select[1] : g.table_select[2]);
    if (tsel == 0) continue;  // table 0: all zeros, no bits
    if (kHuffTables[tsel].n == 0) return -1;  // tables 4/14 are invalid
    int symbol = lut_decode(g_lut[tsel], b);
    if (symbol < 0) return -1;
    int x = symbol >> 4, y = symbol & 15;
    int lb = kHuffTables[tsel].linbits;
    if (x == 15 && lb) x += b.get(lb);
    if (x) x = b.get1() ? -x : x;
    if (y == 15 && lb) y += b.get(lb);
    if (y) y = b.get1() ? -y : y;
    ix[i] = x;
    ix[i + 1] = y;
    if (b.pos > part2_3_end || b.err) return -1;
  }
  int i = big;
  while (b.pos < part2_3_end && i <= 572) {
    int quad;
    if (g.count1table) {
      quad = 15 - (int)b.get(4);
    } else {
      LutEntry e = g_quadA_lut[(b.peek24() >> 18) & 63];
      if (e.len == 0) break;
      b.consume(e.len);
      quad = e.sym;
    }
    int vals[4] = {(quad >> 3) & 1, (quad >> 2) & 1, (quad >> 1) & 1, quad & 1};
    for (int k = 0; k < 4; k++)
      if (vals[k] && b.get1()) vals[k] = -1;
    // a quad whose value/sign reads cross part2_3_end is DROPPED —
    // libav (and the minimp3 family) agree; mpg123 instead keeps it,
    // reading its missing sign bits from the ancillary data (measured
    // on crafted streams; the two references disagree, so we follow
    // the saner drop)
    if (b.pos > part2_3_end) break;
    for (int k = 0; k < 4; k++) ix[i + k] = vals[k];
    i += 4;
  }
  return i > big ? i : big;
}

// Requantize + (for short blocks) reorder into xr[576] laid out as
// [subband][w*6+slot] for short windows and [subband][line] for long.
static void requantize(const GrInfo& g, const Scalefactors& sf,
                       const Header& h, int preflag,
                       const int32_t ix[576], int lines, float xr[576]) {
  const Dsp& D = dsp();
  memset(xr, 0, 576 * sizeof(float));
  float gain = 0.25f * (float)(g.global_gain - 210);
  float sfstep = 0.5f * (float)(1 + g.scalefac_scale);
  const uint16_t* lsfb = sfb_long(h);
  const uint16_t* ssfb = sfb_short(h);

  auto val = [&](int i, float mult) -> float {
    int32_t v = ix[i];
    if (v == 0) return 0.0f;
    float m = v < 0 ? -D.pow43[-v] : D.pow43[v];
    return m * mult;
  };

  bool short_blk = g.window_switching && g.block_type == 2;
  if (!short_blk) {
    int band = 0;
    float mult = exp2f(gain - sfstep * (float)(sf.l[0] +
                        (preflag ? kPretab[0] : 0)));
    for (int i = 0; i < lines; i++) {
      if (band < 22 && i >= lsfb[band + 1]) {
        while (band < 22 && i >= lsfb[band + 1]) band++;
        mult = exp2f(gain - sfstep * (float)(sf.l[band] +
                      (preflag ? kPretab[band] : 0)));
      }
      xr[i] = val(i, mult);
    }
    return;
  }

  int ix_pos = 0;
  int start_band = 0;
  if (g.mixed) {
    // long region: 3*ssfb[3] lines under the long band table (36 lines
    // everywhere except MPEG-2.5 8 kHz, whose long bands span 72 —
    // measured against mpg123, tools/mp3_extract/extract_8k_mixed.py)
    int mixed_long = 3 * ssfb[3];
    int band = 0;
    for (int i = 0; i < mixed_long && i < lines; i++) {
      while (band < 8 && i >= lsfb[band + 1]) band++;
      float mult = exp2f(gain - sfstep * (float)(sf.l[band] +
                          (preflag ? kPretab[band] : 0)));
      xr[i] = val(i, mult);
    }
    ix_pos = mixed_long;
    start_band = 3;
  }
  // short/mixed spectra leave here in transmission order (window-major
  // per band); reorder_short_li() then interleaves them line-by-line
  // for stereo processing, li_to_hybrid() for the filterbank.
  for (int band = start_band; band < 13 && ix_pos < 576; band++) {
    int width = ssfb[band + 1] - ssfb[band];
    for (int w = 0; w < 3; w++) {
      float mult = exp2f(gain - 2.0f * (float)g.subblock_gain[w] -
                         sfstep * (float)sf.s[band][w]);
      for (int l = 0; l < width && ix_pos < 576; l++, ix_pos++) {
        if (ix_pos >= lines) continue;
        xr[ix_pos] = val(ix_pos, mult);
      }
    }
  }
}

// Short/mixed spectra pass through three layouts:
//   transmission order (Huffman/requant)  ->  line-interleaved 3L+w
//   (stereo processing; measured on mpg123 via the LSF intensity
//   single-bit probes, which hit left-channel lines 3L+w)  ->  the
//   6-chunk hybrid layout consumed by the filterbank.
static void reorder_short_li(const GrInfo& g, const Header& h,
                             float xr[576]) {
  if (!(g.window_switching && g.block_type == 2)) return;
  const uint16_t* ssfb = sfb_short(h);
  float tmp[576];
  memcpy(tmp, xr, sizeof(tmp));
  int pos = g.mixed ? 3 * ssfb[3] : 0;
  for (int band = g.mixed ? 3 : 0; band < 13 && pos < 576; band++) {
    int lo = ssfb[band];
    int width = ssfb[band + 1] - lo;
    for (int w = 0; w < 3; w++)
      for (int l = 0; l < width && pos < 576; l++, pos++)
        xr[3 * (lo + l) + w] = tmp[pos];
  }
}

static void li_to_hybrid(const GrInfo& g, const Header& h, float xr[576]) {
  (void)h;
  if (!(g.window_switching && g.block_type == 2)) return;
  float tmp[576];
  memcpy(tmp, xr, sizeof(tmp));
  // the hybrid long region of a mixed block is always 2 subbands; at
  // 8 kHz the lines between there and the first short band (36..71,
  // already identity in the li domain) still interleave into 6-chunks
  for (int L = g.mixed ? 12 : 0; L < 192; L++)
    for (int w = 0; w < 3; w++)
      xr[(L / 6) * 18 + w * 6 + L % 6] = tmp[3 * L + w];
}

// ---------------------------------------------------------------------------
// stereo processing (on requantized, reordered spectra)

static void stereo_process(const Header& h, const GrInfo& gright,
                           const Scalefactors& sfr,
                           float xl[576], float xr[576]) {
  bool ms = (h.mode_ext & 2) != 0;
  bool is = (h.mode_ext & 1) != 0;
  const float invsq = 0.70710678118654752f;

  // intensity bound: first line of the scalefactor band at/above the
  // right channel's last Huffman-coded line (in xr layout both channels
  // share band geometry; for short blocks the bound is per-band anyway)
  if (!is) {
    if (ms) {
      for (int i = 0; i < 576; i++) {
        float m = xl[i], s = xr[i];
        xl[i] = (m + s) * invsq;
        xr[i] = (m - s) * invsq;
      }
    }
    return;
  }

  bool short_blk = gright.window_switching && gright.block_type == 2;
  const uint16_t* lsfb = sfb_long(h);
  const uint16_t* ssfb = sfb_short(h);

  // LSF intensity base: io = 2^-1/4 or 2^-1/2 by the scalefac_compress
  // LSB; k = io^ceil(is_pos/2) on the left (odd) or right (even)
  // channel, sentinel is_pos == 7 means no intensity — all measured in
  // tools/mp3_extract/extract_lsf_is.py.
  float io_pow[20];
  if (h.lsf) {
    double io = (gright.scalefac_compress & 1) ? 0.7071067811865476
                                               : 0.8408964152537145;
    double p = 1.0;
    for (int k = 0; k < 20; k++) { io_pow[k] = (float)p; p *= io; }
  }

  auto apply_pair = [&](int i, bool intensity, int is_pos) {
    // MPEG-1 is_pos is only defined for 0..6 (7 = no intensity); raw
    // values above 7 put the tan formula on or past its pole, where
    // measured decoders emit unbounded garbage/NaN — treat them as the
    // sentinel instead. LSF positions are defined (and measured) up to
    // the 5-bit maximum, with 7 the sentinel there too.
    if (!h.lsf && is_pos > 7) is_pos = 7;
    if (!intensity || is_pos == 7) {
      if (ms) {
        float m = xl[i], s = xr[i];
        xl[i] = (m + s) * invsq;
        xr[i] = (m - s) * invsq;
      }
      return;
    }
    float l = xl[i];
    if (h.lsf) {
      if (is_pos & 1) {
        xl[i] = l * io_pow[(is_pos + 1) >> 1];
        xr[i] = l;
      } else {
        xl[i] = l;
        xr[i] = l * io_pow[is_pos >> 1];
      }
      return;
    }
    float ratio = tanf((float)is_pos * (float)M_PI / 12.0f);
    xl[i] = l * (ratio / (1.0f + ratio));
    xr[i] = l * (1.0f / (1.0f + ratio));
  };

  if (!short_blk) {
    // the zero part starts after the right channel's last NONZERO line
    // (measured against mpg123 and libav: trailing coded zeros still
    // count as zero part); intensity applies to the bands lying fully
    // at/above that bound
    int bound = 0;
    for (int i = 575; i >= 0; i--)
      if (xr[i] != 0.0f) { bound = i + 1; break; }
    for (int band = 0; band < 22; band++) {
      bool intensity = lsfb[band] >= bound;
      // the last band has no transmitted scalefactor; it inherits the
      // previous band's is_pos (measured on mpg123, MPEG-1 and LSF)
      int ip = sfr.l[band < 21 ? band : 20];
      for (int i = lsfb[band]; i < lsfb[band + 1]; i++)
        apply_pair(i, intensity, ip);
    }
  } else {
    // frequency-order spectra (reorder_short runs after this): per
    // (band, window) segment, intensity where the right channel's
    // segment is entirely zero
    if (gright.mixed && h.lsf) {
      // LSF mixed is_pos GEOMETRY differs from the value SERIALIZATION
      // (which stays vals[0..5] -> long 0..5, vals[6+3(b-3)+w] -> short
      // (b,w) and drives requantization — measured separately in
      // tools/mp3_extract/reqsweep): mpg123 applies is_pos over EIGHT
      // long bands (0..7, lsfb boundaries, in the line-interleaved
      // domain — bands 6..7 overlap short band 3's lines), then short
      // bands from 4 on, with vals[8..10] dead. Measured per line in
      // tools/mp3_extract/extract_lsf_is_win.py.
      auto val = [&](int k) {
        return k < 6 ? sfr.l[k] : sfr.s[3 + (k - 6) / 3][(k - 6) % 3];
      };
      // per-window borders: intensity applies to (band, w) iff band >=
      // border[w] = last short band with nonzero window-w content + 1
      // (measured: content ABOVE in the same window disables the zero
      // segments below it; content in other windows does not)
      int border[3] = {3, 3, 3};
      for (int band = 3; band < 13; band++) {
        int lo = ssfb[band], hi = ssfb[band + 1];
        for (int w = 0; w < 3; w++)
          for (int L = lo; L < hi; L++)
            if (xr[3 * L + w] != 0.0f) { border[w] = band + 1; break; }
      }
      // long bands 0..5 use the global last-nonzero bound (li domain)
      int bound = 0;
      for (int i = 575; i >= 0; i--)
        if (xr[i] != 0.0f) { bound = i + 1; break; }
      // long bands 0..5 (the dedicated long region) always follow the
      // global bound
      for (int band = 0; band < 6; band++) {
        bool intensity = lsfb[band] >= bound;
        for (int i = lsfb[band]; i < lsfb[band + 1]; i++)
          apply_pair(i, intensity, val(band));
      }
      // Band 3's lines (li lsfb[6]..lsfb[8]) carry TWO transmitted
      // is_pos layouts and the mode is picked by where the intensity
      // region starts (all measured per line in the rig):
      //  * bound <= lsfb[6] (right content confined to the long
      //    region): LONG geometry — fields 6..7 per li band, k map
      //    continuing through any is_pos EXCEPT 7 (which copies,
      //    k=(1,1), instead of acting as the sentinel), and under
      //    MS+IS both k scale by sqrt(2) (again except 7);
      //  * bound > lsfb[6]: SHORT geometry — fields 8..10 as band 3's
      //    per-window is_pos with NORMAL semantics.
      if (bound <= (int)lsfb[6]) {
        const float sq2 = 1.41421356237309515f;
        for (int band = 6; band < 8; band++) {
          for (int i = lsfb[band]; i < lsfb[band + 1]; i++) {
            if (border[i % 3] > 3) {
              apply_pair(i, false, 7);  // window has content: MS/copy
              continue;
            }
            int is_pos = val(band);
            float l = xl[i];
            float kl, kr;
            if (is_pos == 7) {
              kl = kr = 1.0f;
            } else {
              kl = (is_pos & 1) ? io_pow[(is_pos + 1) >> 1] : 1.0f;
              kr = (is_pos & 1) ? 1.0f : io_pow[is_pos >> 1];
              if (ms) { kl *= sq2; kr *= sq2; }
            }
            xl[i] = l * kl;
            xr[i] = l * kr;
          }
        }
      } else {
        int lo = ssfb[3], hi = ssfb[4];
        for (int w = 0; w < 3; w++) {
          bool intensity = 3 >= border[w];
          for (int L = lo; L < hi; L++)
            apply_pair(3 * L + w, intensity, val(8 + w));
        }
      }
      for (int band = 4; band < 13; band++) {
        int lo = ssfb[band], hi = ssfb[band + 1];
        for (int w = 0; w < 3; w++) {
          bool intensity = band >= border[w];
          // bands 11 (w1/w2) and 12 (w1/w2) have no field and sit at a
          // fixed is_pos 0; band 11/12 w0 share vals[32] (measured)
          int is_pos;
          if (band <= 10) is_pos = val(11 + (band - 4) * 3 + w);
          else is_pos = (w == 0) ? val(32) : 0;
          for (int L = lo; L < hi; L++)
            apply_pair(3 * L + w, intensity, is_pos);
        }
      }
      return;
    }
    if (gright.mixed) {
      // MPEG-1 mixed: the long region is 8 bands / 36 lines — same
      // geometry as requantize/reorder
      int mixed_long = 3 * ssfb[3];
      int bound = 0;
      for (int i = 575; i >= 0; i--)
        if (xr[i] != 0.0f) { bound = i + 1; break; }
      for (int band = 0; band < 8 && lsfb[band] < mixed_long; band++) {
        bool intensity = lsfb[band] >= bound;
        int hi = lsfb[band + 1] < mixed_long ? lsfb[band + 1] : mixed_long;
        for (int i = lsfb[band]; i < hi; i++)
          apply_pair(i, intensity, sfr.l[band]);
      }
    }
    // Short blocks (MPEG-1 and LSF): per-window border rule — intensity
    // for (band, w) iff band >= border[w] = last short band with nonzero
    // window-w content + 1. Measured in tools/mp3_extract: content
    // ABOVE in the same window disables the zero segments below it;
    // content in other windows does not.
    int first_b = gright.mixed ? 3 : 0;
    int border[3] = {first_b, first_b, first_b};
    for (int band = first_b; band < 13; band++) {
      int lo = ssfb[band], hi = ssfb[band + 1];
      for (int w = 0; w < 3; w++)
        for (int L = lo; L < hi; L++)
          if (xr[3 * L + w] != 0.0f) { border[w] = band + 1; break; }
    }
    for (int band = first_b; band < 13; band++) {
      int lo = ssfb[band], hi = ssfb[band + 1];
      for (int w = 0; w < 3; w++) {
        bool intensity = band >= border[w];
        // band 12 inherits band 11's is_pos (measured; not a sentinel)
        int is_pos = sfr.s[band < 12 ? band : 11][w];
        for (int L = lo; L < hi; L++)
          apply_pair(3 * L + w, intensity, is_pos);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// alias reduction, hybrid synthesis

static void alias_reduce(const GrInfo& g, float xr[576]) {
  const Dsp& D = dsp();
  bool short_blk = g.window_switching && g.block_type == 2;
  int bounds = short_blk ? (g.mixed ? 1 : 0) : 31;
  for (int sb = 1; sb <= bounds; sb++) {
    for (int i = 0; i < 8; i++) {
      int lo = 18 * sb - 1 - i, up = 18 * sb + i;
      float a = xr[lo], b2 = xr[up];
      xr[lo] = a * D.cs[i] - b2 * D.ca[i];
      xr[up] = b2 * D.cs[i] + a * D.ca[i];
    }
  }
}

struct ChannelState {
  float overlap[32][18] = {{0}};
  float v[1024] = {0};
  int vpos = 0;   // ring head, multiple of 64 (newest matrixing block)
};

// Lee's recursive DCT-II decomposition (closed-form; no tables beyond
// the 1/(2cos) twiddles computed at init). C[j] = sum_k s[k]
// cos(j(2k+1)pi/64); the 64-row matrixing folds onto it by symmetry.
struct SynthTwiddles {
  float ct[5][16];  // level L handles N = 32 >> L, uses N/2 entries
  SynthTwiddles() {
    for (int L = 0, N = 32; N >= 2; L++, N >>= 1)
      for (int k = 0; k < N / 2; k++)
        ct[L][k] = (float)(1.0 / (2.0 * cos((2 * k + 1) * M_PI / (2.0 * N))));
  }
};
static const SynthTwiddles& synth_tw() {
  static SynthTwiddles t;
  return t;
}

template <int N>
static inline void dct_ii(const float* in, float* out, const float (*ct)[16]) {
  if constexpr (N == 1) {
    out[0] = in[0];
  } else {
    constexpr int H = N / 2;
    const float* c = ct[0];
    float e[H], o[H], eo[H], oo[H];
    for (int k = 0; k < H; k++) {
      e[k] = in[k] + in[N - 1 - k];
      o[k] = (in[k] - in[N - 1 - k]) * c[k];
    }
    dct_ii<H>(e, eo, ct + 1);
    dct_ii<H>(o, oo, ct + 1);
    for (int k = 0; k < H; k++) out[2 * k] = eo[k];
    for (int k = 0; k < H - 1; k++) out[2 * k + 1] = oo[k] + oo[k + 1];
    out[N - 1] = oo[H - 1];
  }
}

// One polyphase synthesis step: 32 subband samples -> 32 PCM samples.
static void synth_step(ChannelState* st, const float s32[32], float* out) {
  float C[32];
  dct_ii<32>(s32, C, synth_tw().ct);
  st->vpos = (st->vpos - 64) & 1023;
  float* vh = st->v + st->vpos;
  // v[i] = cos((16+i)(2k+1)pi/64) row i -> +-C by cosine symmetry
  for (int i = 0; i < 16; i++) vh[i] = C[16 + i];
  vh[16] = 0.0f;
  for (int i = 17; i < 48; i++) vh[i] = -C[48 - i < 0 ? i - 48 : 48 - i];
  vh[48] = -C[0];
  for (int i = 49; i < 64; i++) vh[i] = -C[i - 48];
  float u[512];
  for (int i = 0; i < 8; i++) {
    // blocks start at multiples of 32, so they never wrap mid-block
    memcpy(u + 64 * i, st->v + ((st->vpos + 128 * i) & 1023),
           32 * sizeof(float));
    memcpy(u + 64 * i + 32, st->v + ((st->vpos + 128 * i + 96) & 1023),
           32 * sizeof(float));
  }
  // contiguous inner loop over j so the compiler can vectorize
  for (int j = 0; j < 32; j++) out[j] = u[j] * kSynthD[j];
  for (int i = 1; i < 16; i++) {
    const float* uu = u + 32 * i;
    const float* dd = kSynthD + 32 * i;
    for (int j = 0; j < 32; j++) out[j] += uu[j] * dd[j];
  }
}

// One granule: xr[576] -> 576 PCM samples appended to out.
static void hybrid_synth(const GrInfo& g, const Header& h, float xr[576],
                         ChannelState* st, std::vector<float>* out) {
  const Dsp& D = dsp();
  bool short_blk = g.window_switching && g.block_type == 2;
  (void)h;
  int nlong = 2;  // mixed long region: always 2 hybrid subbands
  float ts[32][18];  // time samples per subband

  for (int sb = 0; sb < 32; sb++) {
    const float* X = xr + sb * 18;
    float z[36];
    bool xzero = true;
    for (int k = 0; k < 18; k++)
      if (X[k] != 0.0f) { xzero = false; break; }
    if (xzero) {
      // zero spectrum: the IMDCT contributes nothing — ring out the
      // overlap and clear it (typical granules leave most of the 32
      // subbands empty, so this path dominates)
      for (int i = 0; i < 18; i++) {
        ts[sb][i] = st->overlap[sb][i];
        st->overlap[sb][i] = 0.0f;
      }
      continue;
    }
    bool use_short = short_blk && !(g.mixed && sb < nlong);
    if (use_short) {
      memset(z, 0, sizeof(z));
      for (int w = 0; w < 3; w++) {
        // IMDCT12 output symmetries: x[3+i] = -x[2-i], x[9+i] = x[8-i]
        float raw[12];
        for (int i = 0; i < 3; i++) {
          float a = 0.0f, b = 0.0f;
          for (int k = 0; k < 6; k++) {
            a += D.imdct12[i][k] * X[w * 6 + k];
            b += D.imdct12[6 + i][k] * X[w * 6 + k];
          }
          raw[i] = a;
          raw[6 + i] = b;
        }
        for (int i = 0; i < 3; i++) {
          raw[3 + i] = -raw[2 - i];
          raw[9 + i] = raw[8 - i];
        }
        for (int i = 0; i < 12; i++)
          z[6 + 6 * w + i] += raw[i] * D.win_short[i];
      }
    } else {
      int bt = short_blk ? 0 : g.block_type;  // mixed long subbands: type 0
      if (g.window_switching && g.block_type != 2) bt = g.block_type;
      if (!g.window_switching) bt = 0;
      const float* W = D.win[bt == 2 ? 0 : bt];
      // IMDCT36 output symmetries: x[9+i] = -x[8-i], x[27+i] = x[26-i]
      float raw[36];
      for (int i = 0; i < 9; i++) {
        float a = 0.0f, b = 0.0f;
        for (int k = 0; k < 18; k++) {
          a += D.imdct36[i][k] * X[k];
          b += D.imdct36[18 + i][k] * X[k];
        }
        raw[i] = a;
        raw[18 + i] = b;
      }
      for (int i = 0; i < 9; i++) {
        raw[9 + i] = -raw[8 - i];
        raw[27 + i] = raw[26 - i];
      }
      for (int i = 0; i < 36; i++) z[i] = raw[i] * W[i];
    }
    for (int i = 0; i < 18; i++) {
      ts[sb][i] = z[i] + st->overlap[sb][i];
      st->overlap[sb][i] = z[18 + i];
    }
  }
  // frequency inversion
  for (int sb = 1; sb < 32; sb += 2)
    for (int i = 1; i < 18; i += 2) ts[sb][i] = -ts[sb][i];

  // transpose for contiguous access in the matrixing inner loop
  float tst[18][32];
  for (int sb = 0; sb < 32; sb++)
    for (int i = 0; i < 18; i++) tst[i][sb] = ts[sb][i];

  // polyphase synthesis: 18 steps of 32 samples
  size_t base = out->size();
  out->resize(base + 576);
  float* o = out->data() + base;
  for (int t = 0; t < 18; t++)
    synth_step(st, tst[t], o + t * 32);
}

// ---------------------------------------------------------------------------
// decoder driver

// Layer I/II scalefactor multiplier: scf(i) = 2 * 2^(-i/3) (measured by
// the tools/mp3_extract attenuation probes; double-precision table).
static inline float l12_scf(int i) {
  struct Tab {
    float t[64];
    Tab() {
      for (int k = 0; k < 64; k++) t[k] = (float)(2.0 * exp2(-k / 3.0));
    }
  };
  static const Tab tab;  // magic static: thread-safe one-time init
  return tab.t[i & 63];
}

struct Decoder {
  Header h;
  bool have_format = false;
  int free_base = 0;   // free-format frame bytes without padding
  std::vector<uint8_t> reservoir;
  ChannelState st[2];
  std::vector<float> pcm[2];

  // Layer I: 384 samples/frame, 4-bit allocations, 6-bit scalefactors,
  // linear PCM codes; requant formula verified against mpg123
  // (tools/mp3_extract probes): s = scf * 2^b/(2^b-1) * (c*2^(1-b) - 1
  // + 2^(1-b)), scf(i) = 2 * 2^(-i/3). Shares the polyphase synthesis.
  bool decode_layer1(const uint8_t* fr, size_t n, const Header& hdr) {
    size_t off = 4 + (hdr.crc ? 2 : 0);
    Bits b(fr + off, n - off);
    int ch_n = hdr.channels;
    int bound = hdr.mode == 1 ? (hdr.mode_ext + 1) * 4 : 32;
    int alloc[2][32];
    int scf[2][32];
    for (int sbnd = 0; sbnd < 32; sbnd++) {
      int nch = (sbnd < bound) ? ch_n : 1;
      for (int c = 0; c < nch; c++) {
        alloc[c][sbnd] = b.get(4);
        if (alloc[c][sbnd] == 15) return false;  // forbidden
      }
      if (nch == 1 && ch_n == 2) alloc[1][sbnd] = alloc[0][sbnd];
    }
    for (int sbnd = 0; sbnd < 32; sbnd++)
      for (int c = 0; c < ch_n; c++)
        scf[c][sbnd] = alloc[c][sbnd] ? (int)b.get(6) : 0;
    if (b.err) return false;

    size_t base0 = pcm[0].size();
    for (int step = 0; step < 12; step++) {
      float s32[2][32];
      for (int sbnd = 0; sbnd < 32; sbnd++) {
        int nch = (sbnd < bound) ? ch_n : 1;
        float v[2] = {0.0f, 0.0f};
        for (int c = 0; c < nch; c++) {
          int a = alloc[c][sbnd];
          if (!a) continue;
          int nb = a + 1;
          uint32_t code = b.get(nb);
          float frac = (float)code * exp2f((float)(1 - nb)) - 1.0f +
                       exp2f((float)(1 - nb));
          v[c] = ((float)(1 << nb) / (float)((1 << nb) - 1)) * frac;
        }
        if (nch == 1 && ch_n == 2) v[1] = v[0];
        for (int c = 0; c < ch_n; c++)
          s32[c][sbnd] = v[c] * l12_scf(scf[c][sbnd]);
      }
      if (b.err) {
        for (int c = 0; c < ch_n; c++) pcm[c].resize(base0, 0.0f);
        return false;
      }
      for (int c = 0; c < ch_n; c++) {
        size_t base = pcm[c].size();
        pcm[c].resize(base + 32);
        synth_step(&st[c], s32[c], pcm[c].data() + base);
      }
    }
    return true;
  }

  // Layer II: 1152 samples/frame in 12 granules of 3 subband steps.
  // Allocation tables, scfsi thirds semantics, requant line
  // s(c) = (2c - q + 1)/q and grouped classes {3,5,9} all verified
  // per-(subband, alloc) against mpg123 (tools/mp3_extract/
  // extract_layer2.py); shares the polyphase synthesis with Layers I/III.
  bool decode_layer2(const uint8_t* fr, size_t n, const Header& hdr) {
    const Mp3L2Table* T = l2_select(hdr);
    size_t off = 4 + (hdr.crc ? 2 : 0);
    Bits b(fr + off, n - off);
    int ch_n = hdr.channels;
    int sbl = T->sblimit;
    int bound = hdr.mode == 1 ? (hdr.mode_ext + 1) * 4 : sbl;
    if (bound > sbl) bound = sbl;

    int alloc[2][32] = {{0}};
    for (int sb = 0; sb < sbl; sb++) {
      int nch = sb < bound ? ch_n : 1;
      for (int c = 0; c < nch; c++) alloc[c][sb] = (int)b.get(T->nbal[sb]);
      if (nch == 1 && ch_n == 2) alloc[1][sb] = alloc[0][sb];
    }
    int scfsi[2][32] = {{0}};
    for (int sb = 0; sb < sbl; sb++)
      for (int c = 0; c < ch_n; c++)
        if (alloc[c][sb]) scfsi[c][sb] = (int)b.get(2);
    float sf[2][32][3];
    for (int sb = 0; sb < sbl; sb++)
      for (int c = 0; c < ch_n; c++) {
        if (!alloc[c][sb]) continue;
        int idx[3] = {0, 0, 0};
        for (int k = 0; k < kL2ScfsiCount[scfsi[c][sb]]; k++)
          idx[k] = (int)b.get(6);
        for (int t = 0; t < 3; t++)
          sf[c][sb][t] = l12_scf(idx[kL2ScfsiThirds[scfsi[c][sb]][t]]);
      }
    if (b.err) return false;

    size_t base0[2] = {pcm[0].size(), pcm[1].size()};
    for (int gr = 0; gr < 12; gr++) {
      float s[2][3][32] = {{{0}}};
      for (int sb = 0; sb < sbl; sb++) {
        int nch = sb < bound ? ch_n : 1;
        for (int c = 0; c < nch; c++) {
          int a = alloc[c][sb];
          if (!a) continue;
          int q = T->classes[sb][a - 1];
          float v[3];
          if (q == 3 || q == 5 || q == 9) {
            // grouped: one base-q code covers the 3 steps, c0 first
            uint32_t g = b.get(q == 3 ? 5 : q == 5 ? 7 : 10);
            for (int k = 0; k < 3; k++) {
              v[k] = (float)(2 * (int)(g % q) - q + 1) / (float)q;
              g /= q;
            }
          } else {
            int nb = 1;
            while ((1 << nb) < q + 1) nb++;  // q = 2^nb - 1

            for (int k = 0; k < 3; k++)
              v[k] = (float)(2 * (int)b.get(nb) - q + 1) / (float)q;
          }
          int third = gr / 4;
          for (int k = 0; k < 3; k++) s[c][k][sb] = v[k] * sf[c][sb][third];
          if (nch == 1 && ch_n == 2)
            for (int k = 0; k < 3; k++)
              s[1][k][sb] = v[k] * sf[1][sb][third];
        }
      }
      if (b.err) {
        for (int c = 0; c < ch_n; c++) pcm[c].resize(base0[c], 0.0f);
        return false;
      }
      for (int c = 0; c < ch_n; c++) {
        size_t base = pcm[c].size();
        pcm[c].resize(base + 96);
        for (int k = 0; k < 3; k++)
          synth_step(&st[c], s[c][k], pcm[c].data() + base + 32 * k);
      }
    }
    return true;
  }

  // returns false if the frame had to be skipped
  bool decode_frame(const uint8_t* fr, size_t n, const Header& hdr) {
    if (hdr.layer != 3) {
      bool ok = hdr.layer == 1 ? decode_layer1(fr, n, hdr)
                               : decode_layer2(fr, n, hdr);
      if (!ok) {
        for (int c = 0; c < hdr.channels; c++) {
          size_t want =
              (pcm[c].size() / hdr.samples) * hdr.samples + hdr.samples;
          pcm[c].resize(want, 0.0f);
        }
        return false;
      }
      return true;
    }
    size_t off = 4 + (hdr.crc ? 2 : 0);
    size_t side_bytes = hdr.lsf ? (hdr.channels == 1 ? 9u : 17u)
                                 : (hdr.channels == 1 ? 17u : 32u);
    size_t frame_base = pcm[0].size();
    if (n < off + side_bytes) {
      // too short even for the side info: pad silence so time stays
      // aligned; there are no main-data bytes to feed the reservoir
      for (int ch = 0; ch < hdr.channels; ch++)
        pcm[ch].resize(frame_base + hdr.samples, 0.0f);
      return false;
    }
    Bits sb(fr + off, side_bytes);
    SideInfo si;
    bool ok = read_side_info(sb, hdr, &si);

    const uint8_t* main = fr + off + side_bytes;
    size_t main_len = n - off - side_bytes;

    if (ok && (size_t)si.main_data_begin > reservoir.size()) {
      ok = false;  // reservoir not filled yet (stream start / seek)
    }

    if (ok) {
      std::vector<uint8_t> data(reservoir.end() - si.main_data_begin,
                                reservoir.end());
      data.insert(data.end(), main, main + main_len);
      Bits b(data.data(), data.size());

      Scalefactors sf[2][2];
      int granules = hdr.lsf ? 1 : 2;
      for (int gr = 0; gr < granules && ok; gr++) {
        float xr[2][576];
        for (int ch = 0; ch < hdr.channels && ok; ch++) {
          const GrInfo& g = si.gr[gr][ch];
          size_t start = b.pos;
          size_t end = start + g.part2_3_length;
          if (end > b.nbits) { ok = false; break; }
          int preflag = g.preflag;
          bool lsf_is = hdr.lsf && ch == 1 && hdr.mode == 1 &&
                        (hdr.mode_ext & 1);
          if (lsf_is)
            read_scalefactors_lsf_is(b, g, &sf[gr][ch], &preflag);
          else if (hdr.lsf)
            read_scalefactors_lsf(b, g, &sf[gr][ch], &preflag);
          else
            read_scalefactors(b, g, si.scfsi[ch], gr, &sf[gr][ch], &sf[0][ch]);
          int32_t ix[576];
          int nl = read_huffman(b, g, hdr, end, ix);
          if (nl < 0 || b.err) { ok = false; break; }
          requantize(g, sf[gr][ch], hdr, preflag, ix, nl, xr[ch]);
          reorder_short_li(g, hdr, xr[ch]);
          b.pos = end;  // skip ancillary bits within part2_3
        }
        if (!ok) break;
        if (hdr.channels == 2 && hdr.mode == 1)
          stereo_process(hdr, si.gr[gr][1], sf[gr][1], xr[0], xr[1]);
        for (int ch = 0; ch < hdr.channels; ch++) {
          li_to_hybrid(si.gr[gr][ch], hdr, xr[ch]);
          alias_reduce(si.gr[gr][ch], xr[ch]);
          hybrid_synth(si.gr[gr][ch], hdr, xr[ch], &st[ch], &pcm[ch]);
        }
      }
    }
    if (!ok) {
      // pad with silence to exactly one frame so time stays aligned
      // even when a later granule failed after an earlier one decoded
      for (int ch = 0; ch < hdr.channels; ch++)
        pcm[ch].resize(frame_base + hdr.samples, 0.0f);
    }

    reservoir.insert(reservoir.end(), main, main + main_len);
    if (reservoir.size() > 511)
      reservoir.erase(reservoir.begin(), reservoir.end() - 511);
    return ok;
  }
};

static bool is_tag_frame(const uint8_t* fr, size_t n, const Header& h) {
  size_t off = 4 + (h.crc ? 2 : 0) +
               (h.lsf ? (h.channels == 1 ? 9 : 17) : (h.channels == 1 ? 17 : 32));
  for (size_t i = off; i + 4 <= n && i < off + 32; i++) {
    if (!memcmp(fr + i, "Xing", 4) || !memcmp(fr + i, "Info", 4) ||
        !memcmp(fr + i, "VBRI", 4))
      return true;
  }
  return false;
}

}  // namespace mp3

extern "C" {

// Decode an MPEG audio (Layer I/II/III) file to planar float32. Returns 0 on
// success; negative on failure (caller falls back to the codec bridge).
int ss_decode_mp3(const char* path, DecodedWavLayout* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (fsize < 4) { fclose(f); return -2; }
  std::vector<uint8_t> buf((size_t)fsize);
  if (fread(buf.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
    fclose(f);
    return -3;
  }
  fclose(f);

  size_t pos = 0;
  // skip ID3v2
  if (buf.size() >= 10 && !memcmp(buf.data(), "ID3", 3)) {
    uint32_t sz = ((uint32_t)(buf[6] & 0x7F) << 21) |
                  ((uint32_t)(buf[7] & 0x7F) << 14) |
                  ((uint32_t)(buf[8] & 0x7F) << 7) | (buf[9] & 0x7F);
    pos = 10 + sz;
  }

  mp3::build_trees();
  mp3::Decoder dec;
  int frames_done = 0;
  bool first_audio_frame = true;
  bool require_double_sync = true;
  size_t scan_start = pos;

rescan:
  while (pos + 4 <= buf.size()) {
    uint32_t hword = ((uint32_t)buf[pos] << 24) | ((uint32_t)buf[pos + 1] << 16) |
                     ((uint32_t)buf[pos + 2] << 8) | buf[pos + 3];
    mp3::Header h;
    if (!mp3::parse_header(hword, &h)) {
      if ((hword >> 21) == 0x7FF && frames_done == 0) {
        // valid sync but unparseable (free format / reserved fields):
        // not ours — let the codec bridge handle the file
        return -4;
      }
      pos++;  // resync
      continue;
    }
    if (dec.have_format &&
        (h.rate != dec.h.rate || h.channels != dec.h.channels ||
         h.layer != dec.h.layer || h.free != dec.h.free)) {
      pos++;  // mid-stream format change: treat as noise, resync
      continue;
    }
    if (h.free) {
      // free-format: the frame size is fixed per stream and found by
      // scanning for the nearest same-family sync (mpg123 semantics)
      int slot = h.layer == 1 ? 4 : 1;
      if (dec.free_base == 0) {
        size_t limit = buf.size() >= 4 ? buf.size() - 4 : 0;
        if (limit > pos + 5760) limit = pos + 5760;
        size_t found = 0;
        for (size_t q = pos + 16; q <= limit; q++) {
          uint32_t w2 = ((uint32_t)buf[q] << 24) |
                        ((uint32_t)buf[q + 1] << 16) |
                        ((uint32_t)buf[q + 2] << 8) | buf[q + 3];
          mp3::Header h2;
          if (mp3::parse_header(w2, &h2) && h2.free && h2.rate == h.rate &&
              h2.version == h.version && h2.layer == h.layer &&
              h2.mode == h.mode) {
            found = q;
            break;
          }
        }
        if (!found) { pos++; continue; }  // no second sync: noise
        int base = (int)(found - pos) - (h.padding ? slot : 0);
        if (base < 16) { pos++; continue; }
        dec.free_base = base;
      }
      h.frame_bytes = dec.free_base + (h.padding ? slot : 0);
      // effective bitrate (Layer II needs it for table selection)
      h.bitrate = (int)((int64_t)dec.free_base * h.rate / frame_coef(h));
    }
    if (pos + (size_t)h.frame_bytes > buf.size()) break;  // truncated tail
    if (require_double_sync && !dec.have_format &&
        pos + (size_t)h.frame_bytes + 4 <= buf.size()) {
      // double-sync: before locking on to a stream, the next frame slot
      // must also hold a same-family header (guards against random
      // bytes that happen to look like one header)
      size_t q = pos + (size_t)h.frame_bytes;
      uint32_t h2w = ((uint32_t)buf[q] << 24) | ((uint32_t)buf[q + 1] << 16) |
                     ((uint32_t)buf[q + 2] << 8) | buf[q + 3];
      mp3::Header h2;
      if (!mp3::parse_header(h2w, &h2) || h2.rate != h.rate ||
          h2.version != h.version || h2.layer != h.layer) {
        // a rejected free-format candidate must not poison the size
        // discovery for the real stream
        if (h.free) dec.free_base = 0;
        pos++;
        continue;
      }
    }
    const uint8_t* fr = buf.data() + pos;
    if (first_audio_frame && h.layer == 3 &&
        mp3::is_tag_frame(fr, h.frame_bytes, h)) {
      pos += h.frame_bytes;
      continue;  // Xing/Info/VBRI metadata frame: no audio
    }
    first_audio_frame = false;
    if (!dec.have_format) {
      if (!require_double_sync &&
          pos + (size_t)h.frame_bytes + 160 < buf.size()) {
        // fallback (single-frame) scan: the legitimate case is one lone
        // frame followed by a small tag tail (ID3v1/APE); a candidate
        // that ends far from EOF inside random bytes is noise
        pos++;
        continue;
      }
      dec.h = h;
      dec.have_format = true;
    }
    bool frame_ok = dec.decode_frame(fr, h.frame_bytes, h);
    if (!frame_ok && !require_double_sync && frames_done == 0) {
      // fallback scan locked onto bytes that do not even decode: keep
      // searching instead of reporting a silent pseudo-frame
      dec = mp3::Decoder();
      pos++;
      continue;
    }
    frames_done++;
    pos += h.frame_bytes;
  }

  if (!dec.have_format && require_double_sync) {
    // nothing locked: maybe a single audio frame followed by trailing
    // tag bytes (ID3v1/APE) defeated the double-sync guard — rescan
    // accepting single frames
    require_double_sync = false;
    pos = scan_start;
    first_audio_frame = true;
    goto rescan;
  }

  if (!dec.have_format || dec.pcm[0].empty()) return -5;

  int ch = dec.h.channels;
  int64_t frames = (int64_t)dec.pcm[0].size();
  float* data = (float*)malloc(sizeof(float) * (size_t)frames * ch);
  if (!data) return -6;
  for (int c = 0; c < ch; c++)
    memcpy(data + (size_t)c * frames, dec.pcm[c].data(),
           sizeof(float) * (size_t)frames);
  out->data = data;
  out->frames = frames;
  out->channels = ch;
  out->rate = dec.h.rate;
  return 0;
}

}  // extern "C"
