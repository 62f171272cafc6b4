// MP4 (ISO-BMFF) and CAF demux — written from the container
// specifications, no third-party code. Produces a packet table plus the
// codec cookie; the codec decoders (alac.cpp, later aac) consume it.
//
// Reference parity: symphonia's isomp4/caf demuxers fill this role for
// the Rust app (audio_player.rs:169-267). Layouts verified against
// libavformat-muxed fixtures (tests/test_alac.py).

#include "demux.h"

#include <cstring>

namespace demux {
namespace {

uint16_t be16(const uint8_t* p) { return ((uint16_t)p[0] << 8) | p[1]; }
uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | p[3];
}
uint64_t be64(const uint8_t* p) {
  return ((uint64_t)be32(p) << 32) | be32(p + 4);
}
double bef64(const uint8_t* p) {
  uint64_t u = be64(p);
  double d;
  memcpy(&d, &u, 8);
  return d;
}

struct Box {
  uint32_t type;
  size_t body;  // offset of payload
  size_t end;   // one past payload
};

// Iterate boxes in [pos, end); returns false when exhausted/corrupt.
bool next_box(const uint8_t* data, size_t end, size_t* pos, Box* out) {
  size_t p = *pos;
  if (p + 8 > end) return false;
  uint64_t size = be32(data + p);
  uint32_t type = be32(data + p + 4);
  size_t hdr = 8;
  if (size == 1) {
    if (p + 16 > end) return false;
    size = be64(data + p + 8);
    hdr = 16;
  } else if (size == 0) {
    size = end - p;
  }
  if (size < hdr || p + size > end || p + size < p) return false;
  out->type = type;
  out->body = p + hdr;
  out->end = p + (size_t)size;
  *pos = p + (size_t)size;
  return true;
}

bool find_child(const uint8_t* data, size_t pos, size_t end, uint32_t type,
                Box* out) {
  Box b;
  while (next_box(data, end, &pos, &b))
    if (b.type == type) { *out = b; return true; }
  return false;
}

bool is_audio_entry(uint32_t cc) {
  return cc == fourcc("alac") || cc == fourcc("mp4a") ||
         cc == fourcc("lpcm") || cc == fourcc("sowt") ||
         cc == fourcc("twos") || cc == fourcc("fLaC");
}

// Parse one trak box into `out`; returns false if it is not a usable
// audio track with the wanted sample entry. `file_size` bounds the
// index tables a crafted file can make us allocate.
bool parse_trak(const uint8_t* data, size_t file_size, const Box& trak,
                uint32_t want, uint32_t movie_ts, Track* out) {
  Box mdia, minf, stbl;
  if (!find_child(data, trak.body, trak.end, fourcc("mdia"), &mdia) ||
      !find_child(data, mdia.body, mdia.end, fourcc("minf"), &minf) ||
      !find_child(data, minf.body, minf.end, fourcc("stbl"), &stbl))
    return false;

  // --- edit list: encoder priming + valid duration (MP4's standard
  // delay signalling, written by every mainstream muxer) ---
  uint32_t media_ts = 0;
  Box mdhd;
  if (find_child(data, mdia.body, mdia.end, fourcc("mdhd"), &mdhd) &&
      mdhd.end - mdhd.body >= 20) {
    const uint8_t* h = data + mdhd.body;
    // version-1 boxes need 24 body bytes before the timescale read
    if (h[0] == 1) {
      if (mdhd.end - mdhd.body >= 24) media_ts = be32(h + 20);
    } else {
      media_ts = be32(h + 12);
    }
  }
  Box edts, elst;
  if (find_child(data, trak.body, trak.end, fourcc("edts"), &edts) &&
      find_child(data, edts.body, edts.end, fourcc("elst"), &elst) &&
      elst.end - elst.body >= 8) {
    const uint8_t* el = data + elst.body;
    int ver = el[0];
    uint32_t cnt = be32(el + 4);
    size_t ep = 8;
    size_t esz = ver == 1 ? 20 : 12;
    // skip leading empty edits (media_time == -1 inserts silence; the
    // players this mirrors start at the first real segment)
    for (uint32_t i = 0; i < cnt && ep + esz <= (size_t)(elst.end -
                                                         elst.body); i++) {
      uint64_t seg_dur = ver == 1 ? be64(el + ep) : be32(el + ep);
      int64_t media_t = ver == 1
          ? (int64_t)be64(el + ep + 8)
          : (int64_t)(int32_t)be32(el + ep + 4);
      ep += esz;
      if (media_t < 0) continue;  // empty edit
      out->priming_frames = media_t;
      if (movie_ts > 0 && media_ts > 0 && seg_dur > 0)
        out->valid_frames =
            (int64_t)((double)seg_dur * media_ts / movie_ts + 0.5);
      break;
    }
  }

  Box stsd, stsz, stsc, stco;
  bool co64 = false;
  if (!find_child(data, stbl.body, stbl.end, fourcc("stsd"), &stsd) ||
      !find_child(data, stbl.body, stbl.end, fourcc("stsz"), &stsz) ||
      !find_child(data, stbl.body, stbl.end, fourcc("stsc"), &stsc))
    return false;
  if (!find_child(data, stbl.body, stbl.end, fourcc("stco"), &stco)) {
    if (!find_child(data, stbl.body, stbl.end, fourcc("co64"), &stco))
      return false;
    co64 = true;
  }

  // --- sample description: first entry only (ALAC/AAC files have one) ---
  if (stsd.end - stsd.body < 8) return false;
  size_t p = stsd.body + 8;  // version/flags + entry_count
  Box entry;
  if (!next_box(data, stsd.end, &p, &entry)) return false;
  if (!is_audio_entry(entry.type)) return false;
  if (want && entry.type != want) return false;
  const uint8_t* e = data + entry.body;
  if (entry.end - entry.body < 28) return false;
  uint16_t version = be16(e + 8);
  out->codec = entry.type;
  out->channels = be16(e + 16);
  out->bits = be16(e + 18);
  out->rate = be32(e + 24) >> 16;  // 16.16 fixed
  size_t child = entry.body + 28;
  if (version == 1) child += 16;
  else if (version == 2) child = entry.body + 64;  // QT v2 sound description

  // children: 'alac' magic-cookie box, 'esds', possibly inside 'wave'
  for (int depth = 0; depth < 2; depth++) {
    size_t cp = child;
    Box cb;
    bool again = false;
    while (next_box(data, entry.end, &cp, &cb)) {
      if (cb.type == fourcc("alac") && cb.end - cb.body >= 28) {
        // payload: 4 bytes version/flags + 24-byte ALACSpecificConfig
        out->cookie.assign(data + cb.body + 4, data + cb.end);
      } else if (cb.type == fourcc("esds")) {
        out->cookie.assign(data + cb.body, data + cb.end);
      } else if (cb.type == fourcc("wave")) {
        child = cb.body;  // QT wrapper: rescan inside
        again = true;
      }
    }
    if (!again) break;
  }

  // --- sample sizes ---
  const uint8_t* z = data + stsz.body;
  if (stsz.end - stsz.body < 12) return false;
  uint32_t fixed = be32(z + 4), count = be32(z + 8);
  // every sample occupies >= 1 byte of mdat, so more samples than file
  // bytes is a lie — reject instead of allocating per the header
  if (count > file_size) return false;
  std::vector<uint32_t> sizes;
  sizes.reserve(count);
  if (fixed) {
    sizes.assign(count, fixed);
  } else {
    if (stsz.end - stsz.body < 12 + (size_t)count * 4) return false;
    for (uint32_t i = 0; i < count; i++) sizes.push_back(be32(z + 12 + 4 * i));
  }

  // --- chunk offsets ---
  const uint8_t* c = data + stco.body;
  if (stco.end - stco.body < 8) return false;
  uint32_t nchunks = be32(c + 4);
  size_t entry_sz = co64 ? 8 : 4;
  if (stco.end - stco.body < 8 + (size_t)nchunks * entry_sz) return false;
  std::vector<uint64_t> offs;
  offs.reserve(nchunks);
  for (uint32_t i = 0; i < nchunks; i++)
    offs.push_back(co64 ? be64(c + 8 + 8 * i) : be32(c + 8 + 4 * i));

  // --- sample-to-chunk ---
  const uint8_t* sc = data + stsc.body;
  if (stsc.end - stsc.body < 8) return false;
  uint32_t nsc = be32(sc + 4);
  if (stsc.end - stsc.body < 8 + (size_t)nsc * 12) return false;

  size_t si = 0;
  // stsc entries are required to be sorted by first_chunk; a linear
  // cursor keeps this O(nchunks + nsc) (a crafted file with huge
  // nchunks*nsc would otherwise make the old rescan quadratic)
  uint32_t sck = 0, spc_cur = 1;
  for (uint32_t ci = 0; ci < nchunks && si < sizes.size(); ci++) {
    while (sck < nsc && be32(sc + 8 + 12 * sck) <= ci + 1) {
      spc_cur = be32(sc + 8 + 12 * sck + 4);
      sck++;
    }
    uint32_t spc = spc_cur;
    uint64_t off = offs[ci];
    for (uint32_t s = 0; s < spc && si < sizes.size(); s++) {
      out->packets.push_back({off, sizes[si]});
      off += sizes[si];
      si++;
    }
  }
  return !out->packets.empty();
}

}  // namespace

bool parse_mp4(const uint8_t* data, size_t n, uint32_t want, Track* out) {
  size_t pos = 0;
  Box top;
  while (next_box(data, n, &pos, &top)) {
    if (top.type != fourcc("moov")) continue;
    size_t tp = top.body;
    uint32_t movie_ts = 0;
    {
      Box mvhd;
      if (find_child(data, top.body, top.end, fourcc("mvhd"), &mvhd) &&
          mvhd.end - mvhd.body >= 20) {
        const uint8_t* h = data + mvhd.body;
        if (h[0] == 1) {
          if (mvhd.end - mvhd.body >= 24) movie_ts = be32(h + 20);
        } else {
          movie_ts = be32(h + 12);
        }
      }
    }
    Box trak;
    while (next_box(data, top.end, &tp, &trak)) {
      if (trak.type != fourcc("trak")) continue;
      Track t;
      if (parse_trak(data, n, trak, want, movie_ts, &t)) {
        *out = std::move(t);
        return true;
      }
    }
  }
  return false;
}

bool parse_caf(const uint8_t* data, size_t n, Track* out) {
  if (n < 8 || memcmp(data, "caff", 4) != 0) return false;
  size_t pos = 8;
  uint64_t data_off = 0, data_len = 0;
  std::vector<uint64_t> pakt_sizes;
  bool have_desc = false;
  while (pos + 12 <= n) {
    uint32_t type = be32(data + pos);
    int64_t size = (int64_t)be64(data + pos + 4);
    size_t body = pos + 12;
    if (size < 0) size = (int64_t)(n - body);  // streamed: to EOF
    if (body + (uint64_t)size > n) size = (int64_t)(n - body);
    if (type == fourcc("desc") && size >= 32) {
      const uint8_t* d = data + body;
      out->rate = bef64(d);
      out->codec = be32(d + 8);
      out->lpcm_flags = be32(d + 12);
      out->bytes_per_packet = be32(d + 16);
      out->frames_per_packet = be32(d + 20);
      out->channels = (int)be32(d + 24);
      out->bits = (int)be32(d + 28);
      have_desc = true;
    } else if (type == fourcc("kuki")) {
      out->cookie.assign(data + body, data + body + size);
    } else if (type == fourcc("pakt") && size >= 24) {
      const uint8_t* d = data + body;
      out->valid_frames = (int64_t)be64(d + 8);
      out->priming_frames = (int32_t)be32(d + 16);
      // BER-coded packet byte sizes (7 bits per byte, MSB = continue)
      uint64_t npkts = be64(d);
      size_t bp = 24;
      for (uint64_t i = 0; i < npkts && bp < (size_t)size; i++) {
        uint64_t v = 0;
        while (bp < (size_t)size) {
          uint8_t byte = d[bp++];
          v = (v << 7) | (byte & 0x7F);
          if (!(byte & 0x80)) break;
        }
        pakt_sizes.push_back(v);
      }
    } else if (type == fourcc("data") && size >= 4) {
      data_off = body + 4;  // skip edit count
      data_len = (uint64_t)size - 4;
    }
    pos = body + (size_t)size;
  }
  if (!have_desc || data_off == 0) return false;
  if (!pakt_sizes.empty()) {
    uint64_t off = data_off;
    for (uint64_t s : pakt_sizes) {
      // overflow-safe bound: off is in [data_off, data_off+data_len],
      // s is attacker-controlled BER (up to 2^63) — off + s may wrap
      if (s > data_len - (off - data_off)) break;
      out->packets.push_back({off, (uint32_t)s});
      off += s;
    }
  } else if (out->bytes_per_packet > 0) {
    // constant packet size (LPCM): one packet covering everything
    out->packets.push_back({data_off, (uint32_t)data_len});
  }
  return !out->packets.empty();
}

const uint8_t* alac_config(const std::vector<uint8_t>& cookie) {
  // MP4 path: cookie is version/flags already stripped -> 24 raw bytes.
  // CAF kuki: a chain of atoms ([size 'frma' 'alac'] [size 'alac' flags
  // config]); scan for the 'alac' atom. Validation: bitDepth must be a
  // sane PCM width.
  auto plausible = [](const uint8_t* c) {
    uint32_t flen = be32(c);
    uint8_t depth = c[5], nch = c[9];
    return flen >= 16 && flen <= (1u << 20) && nch >= 1 && nch <= 8 &&
           (depth == 16 || depth == 20 || depth == 24 || depth == 32);
  };
  if (cookie.size() >= 24 && plausible(cookie.data())) return cookie.data();
  for (size_t i = 0; i + 4 <= cookie.size(); i++) {
    if (memcmp(cookie.data() + i, "alac", 4) == 0 &&
        i + 8 + 24 <= cookie.size() && plausible(cookie.data() + i + 8))
      return cookie.data() + i + 8;
  }
  return nullptr;
}

}  // namespace demux
