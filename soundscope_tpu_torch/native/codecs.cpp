// Compressed-codec bridge: decode any container/codec the system's
// libavformat/libavcodec stack understands (mp3/mp2/mp1, aac/m4a/m4b/mp4,
// alac, ogg/oga, caf, ...) to planar float32.
//
// Role: this is the rebuild's analog of the reference's symphonia
// dependency (audio_player.rs:169-267, Cargo.toml:21 symphonia-all) — an
// external codec library wired through the native runtime. FLAC and WAV
// have first-party decoders in this runtime (flac.cpp, decoder.cpp) and
// never take this path; the bridge covers the long tail of formats.
//
// Compiled into libssnative.so only when the libav* headers are present
// (native/__init__.py probes at build time); without them the symbol is
// a stub returning "unavailable" and Python falls back to its own
// decoders / the ffmpeg CLI hook.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

struct DecodedWavLayout {
  float* data;
  int64_t frames;
  int32_t channels;
  int32_t rate;
};

#ifdef SS_HAVE_LIBAV

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

// Quiet libav's stderr chatter (the reference silences ALSA's the same
// way, main.rs:93-109); errors still surface through return codes.
namespace {
struct LogSilencer {
  LogSilencer() { av_log_set_level(AV_LOG_ERROR); }
} log_silencer;
}  // namespace

extern "C" int ss_codecs_available(void) { return 1; }

// Decode any libav-supported audio file. Returns 0 on success; negative
// codes mirror the other native decoders. Caller frees via ss_free_decoded.
// `fmt_name` (nullable) forces the container format, bypassing the probe
// — crafted ADTS streams can embed fake sync words that defeat format
// detection (used by tools/aac_extract).
extern "C" int ss_decode_any_fmt(const char* path, const char* fmt_name,
                                 DecodedWavLayout* out) {
  AVFormatContext* fmt = nullptr;
  const AVInputFormat* ifmt =
      fmt_name && fmt_name[0] ? av_find_input_format(fmt_name) : nullptr;
  if (fmt_name && fmt_name[0] && !ifmt) return -9;
  if (avformat_open_input(&fmt, path, ifmt, nullptr) < 0) return -1;
  int rc = -2;
  AVCodecContext* dec = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  float* buf = nullptr;
  size_t cap = 0, len = 0;  // in samples (all channels, planar blocks later)
  int stream_idx = -1, channels = 0, rate = 0;

  do {
    if (avformat_find_stream_info(fmt, nullptr) < 0) break;
    const AVCodec* codec = nullptr;
    stream_idx = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
    if (stream_idx < 0 || !codec) { rc = -3; break; }
    AVStream* st = fmt->streams[stream_idx];
    dec = avcodec_alloc_context3(codec);
    if (!dec || avcodec_parameters_to_context(dec, st->codecpar) < 0) break;
    if (avcodec_open2(dec, codec, nullptr) < 0) { rc = -4; break; }

    channels = dec->ch_layout.nb_channels;
    rate = dec->sample_rate;
    if (channels <= 0 || rate <= 0) { rc = -5; break; }

    // resample-free conversion to interleaved float (same rate/layout)
    swr = swr_alloc();
    if (!swr) break;
    av_opt_set_chlayout(swr, "in_chlayout", &dec->ch_layout, 0);
    av_opt_set_chlayout(swr, "out_chlayout", &dec->ch_layout, 0);
    av_opt_set_int(swr, "in_sample_rate", rate, 0);
    av_opt_set_int(swr, "out_sample_rate", rate, 0);
    av_opt_set_sample_fmt(swr, "in_sample_fmt", dec->sample_fmt, 0);
    av_opt_set_sample_fmt(swr, "out_sample_fmt", AV_SAMPLE_FMT_FLT, 0);
    if (swr_init(swr) < 0) break;

    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    if (!pkt || !frame) break;

    auto push_frame = [&](AVFrame* fr) {
      int n = fr->nb_samples;
      size_t need = len + (size_t)n * channels;
      if (need > cap) {
        cap = need * 2 + 4096;
        float* nb = (float*)realloc(buf, cap * sizeof(float));
        if (!nb) return false;
        buf = nb;
      }
      uint8_t* dst = (uint8_t*)(buf + len);
      int got = swr_convert(swr, &dst, n, (const uint8_t**)fr->extended_data, n);
      if (got < 0) return false;
      len += (size_t)got * channels;
      return true;
    };

    bool fail = false;
    while (av_read_frame(fmt, pkt) >= 0 && !fail) {
      if (pkt->stream_index == stream_idx) {
        if (avcodec_send_packet(dec, pkt) >= 0) {
          while (avcodec_receive_frame(dec, frame) >= 0)
            if (!push_frame(frame)) { fail = true; break; }
        }
        // decode errors inside a file are skipped, like the reference
        // (audio_player.rs:261)
      }
      av_packet_unref(pkt);
    }
    if (!fail) {
      avcodec_send_packet(dec, nullptr);  // flush
      while (avcodec_receive_frame(dec, frame) >= 0)
        if (!push_frame(frame)) { fail = true; break; }
    }
    if (fail || len == 0) { rc = fail ? -6 : -7; break; }

    int64_t frames = (int64_t)(len / channels);
    float* planar = (float*)malloc(sizeof(float) * (size_t)frames * channels);
    if (!planar) { rc = -8; break; }
    for (int c = 0; c < channels; c++) {
      float* d = planar + (size_t)c * frames;
      for (int64_t i = 0; i < frames; i++) d[i] = buf[i * channels + c];
    }
    out->data = planar;
    out->frames = frames;
    out->channels = channels;
    out->rate = rate;
    rc = 0;
  } while (false);

  free(buf);
  if (frame) av_frame_free(&frame);
  if (pkt) av_packet_free(&pkt);
  if (swr) swr_free(&swr);
  if (dec) avcodec_free_context(&dec);
  avformat_close_input(&fmt);
  return rc;
}

extern "C" int ss_decode_any(const char* path, DecodedWavLayout* out) {
  return ss_decode_any_fmt(path, nullptr, out);
}

// Encode planar float32 to any container/codec libav can mux (ogg/vorbis,
// m4a/aac, m4a/alac, caf, mp3, ...), chosen from the file extension.
// Fixture generator for the decode tests and the framework's lossy-export
// path (the reference never encodes). Returns 0 on success.
extern "C" int ss_encode_audio(const char* path, const float* planar,
                               int64_t frames, int32_t channels, int32_t rate,
                               const char* codec_name /* nullable */,
                               int64_t bit_rate /* 0 = encoder default */) {
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 || !fmt)
    return -1;
  int rc = -2;
  AVCodecContext* enc = nullptr;
  SwrContext* swr = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  bool header_written = false;

  do {
    const AVCodec* codec =
        codec_name && codec_name[0] ? avcodec_find_encoder_by_name(codec_name)
                                    : avcodec_find_encoder(fmt->oformat->audio_codec);
    if (!codec) { rc = -3; break; }
    AVStream* st = avformat_new_stream(fmt, nullptr);
    if (!st) break;
    enc = avcodec_alloc_context3(codec);
    if (!enc) break;
    av_channel_layout_default(&enc->ch_layout, channels);
    enc->sample_rate = rate;
    enc->sample_fmt = codec->sample_fmts ? codec->sample_fmts[0] : AV_SAMPLE_FMT_FLTP;
    if (bit_rate > 0) enc->bit_rate = bit_rate;
    enc->time_base = AVRational{1, rate};
    enc->strict_std_compliance = FF_COMPLIANCE_EXPERIMENTAL;  // native vorbis
    if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
      enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(enc, codec, nullptr) < 0) { rc = -4; break; }
    if (avcodec_parameters_from_context(st->codecpar, enc) < 0) break;
    st->time_base = enc->time_base;

    if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
        avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) { rc = -5; break; }
    if (avformat_write_header(fmt, nullptr) < 0) { rc = -6; break; }
    header_written = true;

    swr = swr_alloc();
    if (!swr) break;
    av_opt_set_chlayout(swr, "in_chlayout", &enc->ch_layout, 0);
    av_opt_set_chlayout(swr, "out_chlayout", &enc->ch_layout, 0);
    av_opt_set_int(swr, "in_sample_rate", rate, 0);
    av_opt_set_int(swr, "out_sample_rate", rate, 0);
    av_opt_set_sample_fmt(swr, "in_sample_fmt", AV_SAMPLE_FMT_FLT, 0);
    av_opt_set_sample_fmt(swr, "out_sample_fmt", enc->sample_fmt, 0);
    if (swr_init(swr) < 0) break;

    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    if (!pkt || !frame) break;
    int fsz = enc->frame_size > 0 ? enc->frame_size : 4096;

    // interleave on the fly from the planar input
    std::vector<float> inter((size_t)fsz * channels);
    int64_t pos = 0;
    bool fail = false;

    auto drain = [&](bool flush) {
      int ret = avcodec_send_frame(enc, flush ? nullptr : frame);
      if (ret < 0) return false;
      while (true) {
        ret = avcodec_receive_packet(enc, pkt);
        if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return true;
        if (ret < 0) return false;
        av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
        pkt->stream_index = st->index;
        if (av_interleaved_write_frame(fmt, pkt) < 0) return false;
      }
    };

    while (pos < frames && !fail) {
      int n = (int)std::min<int64_t>(fsz, frames - pos);
      for (int i = 0; i < n; i++)
        for (int c = 0; c < channels; c++)
          inter[(size_t)i * channels + c] = planar[(size_t)c * frames + pos + i];
      frame->nb_samples = n;
      av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout);
      frame->format = enc->sample_fmt;
      frame->sample_rate = rate;
      if (av_frame_get_buffer(frame, 0) < 0) { fail = true; break; }
      const uint8_t* src = (const uint8_t*)inter.data();
      if (swr_convert(swr, frame->extended_data, n, &src, n) < 0) {
        fail = true;
        break;
      }
      frame->pts = pos;
      fail = !drain(false);
      av_frame_unref(frame);
      pos += n;
    }
    if (!fail) fail = !drain(true);
    if (fail) { rc = -7; break; }
    rc = 0;
  } while (false);

  if (header_written) av_write_trailer(fmt);
  if (frame) av_frame_free(&frame);
  if (pkt) av_packet_free(&pkt);
  if (swr) swr_free(&swr);
  if (enc) avcodec_free_context(&enc);
  if (fmt) {
    if (!(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb) avio_closep(&fmt->pb);
    avformat_free_context(fmt);
  }
  return rc;
}

#else  // !SS_HAVE_LIBAV

extern "C" int ss_codecs_available(void) { return 0; }
extern "C" int ss_decode_any(const char*, DecodedWavLayout*) { return -100; }
extern "C" int ss_decode_any_fmt(const char*, const char*, DecodedWavLayout*) {
  return -100;
}
extern "C" int ss_encode_audio(const char*, const float*, int64_t, int32_t,
                               int32_t, const char*, int64_t) { return -100; }

#endif
