// Shared MP4 (ISO-BMFF) and CAF demuxers for the first-party codec
// decoders (ALAC now, AAC-LC later). The reference reaches these
// containers through symphonia's probe (audio_player.rs:169-267,
// Cargo.toml:21 symphonia-all); this is the rebuild's own demux layer.
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace demux {

struct Packet {
  uint64_t off;
  uint32_t size;
};

struct Track {
  uint32_t codec = 0;            // fourcc of the sample entry / CAF formatID
  std::vector<uint8_t> cookie;   // codec config (ALACSpecificConfig, esds...)
  std::vector<Packet> packets;   // byte ranges into the file
  double rate = 0.0;
  int channels = 0;
  int bits = 0;                  // meaningful for lpcm
  uint32_t lpcm_flags = 0;       // CAF: bit0 float, bit1 little-endian
  uint32_t bytes_per_packet = 0;   // CAF constant-bitrate formats
  uint32_t frames_per_packet = 0;
  int64_t valid_frames = -1;     // CAF pakt trim (-1 = unknown)
  int64_t priming_frames = 0;    // CAF pakt encoder-delay trim
};

constexpr uint32_t fourcc(const char (&s)[5]) {
  return ((uint32_t)(uint8_t)s[0] << 24) | ((uint32_t)(uint8_t)s[1] << 16) |
         ((uint32_t)(uint8_t)s[2] << 8) | (uint32_t)(uint8_t)s[3];
}

// Parse an MP4/M4A file held in memory; pick the first audio track whose
// sample entry is `want` (0 = any known audio entry). Returns false when
// no such track exists or the index tables are malformed.
bool parse_mp4(const uint8_t* data, size_t n, uint32_t want, Track* out);

// Parse a CAF file held in memory (desc/kuki/pakt/data chunks).
bool parse_caf(const uint8_t* data, size_t n, Track* out);

// Extract the 24-byte ALACSpecificConfig from a raw cookie (MP4 'alac'
// box payload or CAF kuki with frma/alac atom wrappers). Returns nullptr
// when no plausible config is present.
const uint8_t* alac_config(const std::vector<uint8_t>& cookie);

}  // namespace demux
