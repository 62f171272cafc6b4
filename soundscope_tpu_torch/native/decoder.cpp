// Native host-side audio runtime for soundscope_tpu.
//
// The reference's host runtime is native Rust (symphonia decode,
// audio_player.rs:169-267; shared ring buffer, main.rs:63-65). This is the
// C++ equivalent: a fast WAV decoder (PCM 8/16/24/32-bit + float32/64,
// WAVE_FORMAT_EXTENSIBLE) that emits planar float32, and a mutex-guarded
// ring buffer used by the capture feeder (30 s of samples, like the
// reference's AllocRingBuffer).
//
// Exposed through a plain C ABI consumed via ctypes
// (soundscope_tpu/native/__init__.py). No Python.h dependency.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <mutex>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- decoder --

struct DecodedWav {
  float* data;        // planar: channel c at data[c * frames .. ]
  int64_t frames;
  int32_t channels;
  int32_t rate;
};

static uint32_t rd_u32le(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16le(const uint8_t* p) {
  return (uint16_t)(p[0] | (p[1] << 8));
}

// Returns 0 on success; fills out. Caller frees with ss_free_decoded.
int ss_decode_wav(const char* path, DecodedWav* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (fsize < 44) { fclose(f); return -2; }
  std::vector<uint8_t> buf((size_t)fsize);
  if (fread(buf.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
    fclose(f);
    return -3;
  }
  fclose(f);

  if (memcmp(buf.data(), "RIFF", 4) || memcmp(buf.data() + 8, "WAVE", 4))
    return -4;

  uint16_t tag = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* pcm = nullptr;
  size_t pcm_len = 0;

  size_t pos = 12;
  while (pos + 8 <= (size_t)fsize) {
    const uint8_t* cid = buf.data() + pos;
    uint32_t size = rd_u32le(buf.data() + pos + 4);
    const uint8_t* body = buf.data() + pos + 8;
    if (pos + 8 + size > (size_t)fsize) size = (uint32_t)((size_t)fsize - pos - 8);
    if (!memcmp(cid, "fmt ", 4) && size >= 16) {
      tag = rd_u16le(body);
      channels = rd_u16le(body + 2);
      rate = rd_u32le(body + 4);
      bits = rd_u16le(body + 14);
      if (tag == 0xFFFE && size >= 40) tag = rd_u16le(body + 24);
    } else if (!memcmp(cid, "data", 4)) {
      pcm = body;
      pcm_len = size;
    }
    pos += 8 + size + (size & 1);
  }
  if (!pcm || channels == 0 || rate == 0) return -5;

  size_t bytes_per = (size_t)bits / 8;
  if (bytes_per == 0) return -6;
  int64_t frames = (int64_t)(pcm_len / (bytes_per * channels));
  float* dst = (float*)malloc(sizeof(float) * (size_t)frames * channels);
  if (!dst) return -7;

  // Convert interleaved -> planar float32.
  for (int c = 0; c < channels; c++) {
    float* d = dst + (size_t)c * frames;
    if (tag == 3 && bits == 32) {
      for (int64_t i = 0; i < frames; i++)
        memcpy(&d[i], pcm + (i * channels + c) * 4, 4);
    } else if (tag == 3 && bits == 64) {
      for (int64_t i = 0; i < frames; i++) {
        double v;
        memcpy(&v, pcm + (i * channels + c) * 8, 8);
        d[i] = (float)v;
      }
    } else if (tag == 1 && bits == 16) {
      for (int64_t i = 0; i < frames; i++) {
        int16_t v;
        memcpy(&v, pcm + (i * channels + c) * 2, 2);
        d[i] = (float)v / 32768.0f;
      }
    } else if (tag == 1 && bits == 24) {
      for (int64_t i = 0; i < frames; i++) {
        const uint8_t* p = pcm + (i * channels + c) * 3;
        int32_t v = (int32_t)(p[0] | (p[1] << 8) | (p[2] << 16));
        if (v >= (1 << 23)) v -= (1 << 24);
        d[i] = (float)v / 8388608.0f;
      }
    } else if (tag == 1 && bits == 32) {
      for (int64_t i = 0; i < frames; i++) {
        int32_t v;
        memcpy(&v, pcm + (i * channels + c) * 4, 4);
        d[i] = (float)((double)v / 2147483648.0);
      }
    } else if (tag == 1 && bits == 8) {
      for (int64_t i = 0; i < frames; i++) {
        uint8_t v = pcm[(i * channels + c)];
        d[i] = ((float)v - 128.0f) / 128.0f;
      }
    } else {
      free(dst);
      return -8;
    }
  }
  out->data = dst;
  out->frames = frames;
  out->channels = channels;
  out->rate = (int32_t)rate;
  return 0;
}

void ss_free_decoded(DecodedWav* d) {
  if (d && d->data) {
    free(d->data);
    d->data = nullptr;
  }
}

// ------------------------------------------------------------- ring buffer --

// Fixed-capacity overwrite-oldest ring of float32 (the capture buffer:
// reference main.rs:63-65 / tui.rs:1783-1786).
struct Ring {
  std::mutex mu;
  std::vector<float> buf;
  size_t pos = 0;      // next write index
  uint64_t total = 0;  // total samples ever pushed
};

void* ss_ring_new(int64_t capacity) {
  Ring* r = new Ring();
  r->buf.assign((size_t)capacity, 0.0f);
  return r;
}

void ss_ring_free(void* h) { delete (Ring*)h; }

void ss_ring_push(void* h, const float* x, int64_t n) {
  Ring* r = (Ring*)h;
  std::lock_guard<std::mutex> lock(r->mu);
  size_t cap = r->buf.size();
  if ((size_t)n >= cap) {
    memcpy(r->buf.data(), x + (n - cap), cap * sizeof(float));
    r->pos = 0;
  } else {
    size_t first = std::min((size_t)n, cap - r->pos);
    memcpy(r->buf.data() + r->pos, x, first * sizeof(float));
    memcpy(r->buf.data(), x + first, ((size_t)n - first) * sizeof(float));
    r->pos = (r->pos + (size_t)n) % cap;
  }
  r->total += (uint64_t)n;
}

// Snapshot in chronological order (oldest first), like the reference's
// `.to_vec()` under the mutex (tui.rs:1428).
void ss_ring_snapshot(void* h, float* out) {
  Ring* r = (Ring*)h;
  std::lock_guard<std::mutex> lock(r->mu);
  size_t cap = r->buf.size();
  memcpy(out, r->buf.data() + r->pos, (cap - r->pos) * sizeof(float));
  memcpy(out + (cap - r->pos), r->buf.data(), r->pos * sizeof(float));
}

// Snapshot and total under ONE lock (cursor-tracking consumers need both
// from the same instant).
uint64_t ss_ring_snapshot_total(void* h, float* out) {
  Ring* r = (Ring*)h;
  std::lock_guard<std::mutex> lock(r->mu);
  size_t cap = r->buf.size();
  memcpy(out, r->buf.data() + r->pos, (cap - r->pos) * sizeof(float));
  memcpy(out + (cap - r->pos), r->buf.data(), r->pos * sizeof(float));
  return r->total;
}

uint64_t ss_ring_total(void* h) {
  Ring* r = (Ring*)h;
  std::lock_guard<std::mutex> lock(r->mu);
  return r->total;
}

}  // extern "C"
