// Native AV runtime: libavformat/libavcodec demux + decode for video frames
// and audio samples, exposed as a plain C ABI for ctypes.
//
// Reference parity: the Scanner engine's decode worker (SURVEY §1 L0 — the
// engine decodes video on dedicated threads with NVDEC/ffmpeg) and the C++
// Audio source (audio_source.cpp:31-412 — libav decode of any audio codec
// with sample-accurate frame assembly). TPU-native role: the host data
// plane's decoder. A ctypes call into this library releases the GIL, so the
// decode loop runs truly concurrent with the Python thread that drives the
// device — cv2's per-frame Python round-trips (grab/retrieve/ndarray
// slicing) disappear from the hot path and frames land directly in the
// staging-ring slot that the prefetcher hands us (st_io.cpp ring).
//
// Video model mirrors io/video.py's VideoDecoder: ascending frame indices,
// split into seek runs (sequential-decode gap <= SEEK_GAP beats a container
// seek), one av_seek_frame per run, RGB24 into caller memory via swscale.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <thread>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}

namespace {
constexpr int64_t kSeekGap = 32;  // keep in sync with io/video.py _SEEK_GAP

struct StAv {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwsContext* sws = nullptr;
  int sws_dst_fmt = -1;        // AVPixelFormat the cached sws converts to
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  int stream = -1;
  int width = 0;
  int height = 0;
  double fps = 0.0;
  int64_t nframes = -1;
  int64_t start_pts = 0;       // first frame's pts (stream time_base)
  AVRational tb{0, 1};
  int64_t next_index = 0;      // index the next decoded frame would have
  bool draining = false;
  char err[256] = {0};
};

void set_err(StAv* h, const char* msg) {
  std::snprintf(h->err, sizeof(h->err), "%s", msg);
}

// pts (stream time_base) -> frame index under constant-fps assumption.
int64_t pts_to_index(const StAv* h, int64_t pts) {
  double sec = (pts - h->start_pts) * av_q2d(h->tb);
  return (int64_t)(sec * h->fps + 0.5);
}

int64_t index_to_pts(const StAv* h, int64_t index) {
  double sec = index / h->fps;
  return h->start_pts + (int64_t)(sec / av_q2d(h->tb) + 0.5);
}

// Pull the next decoded frame into h->frame. Returns 1 on frame, 0 on EOF,
// <0 on error.
int next_frame(StAv* h) {
  while (true) {
    int r = avcodec_receive_frame(h->dec, h->frame);
    if (r == 0) return 1;
    if (r == AVERROR_EOF) return 0;
    if (r != AVERROR(EAGAIN)) return r;
    if (h->draining) return 0;
    // feed one more packet
    while (true) {
      r = av_read_frame(h->fmt, h->pkt);
      if (r == AVERROR_EOF) {
        h->draining = true;
        avcodec_send_packet(h->dec, nullptr);
        break;
      }
      if (r < 0) return r;
      if (h->pkt->stream_index != h->stream) {
        av_packet_unref(h->pkt);
        continue;
      }
      r = avcodec_send_packet(h->dec, h->pkt);
      av_packet_unref(h->pkt);
      if (r < 0 && r != AVERROR(EAGAIN)) return r;
      break;
    }
  }
}
// Output pixel modes for st_av_read_impl.
constexpr int kOutRGB24 = 0;  // interleaved RGB, 3 B/px (host swscale)
constexpr int kOutI420 = 1;   // planar Y + U + V, 1.5 B/px (plane copy)

// Write the current h->frame into dst in the requested mode. Returns 0 on
// success. I420 mode: when the decoded frame is already 4:2:0 planar the
// planes are row-copied (no pixel math on the host at all — the YUV->RGB
// conversion happens on the TPU inside the fused segment, see
// utils/framechunk.py); other source formats go through one sws convert to
// YUV420P (still cheaper than YUV->RGB: subsample, no matrix).
int emit_frame(StAv* h, uint8_t* dst, int mode) {
  const int W = h->width, H = h->height;
  if (mode == kOutI420) {
    const int cw = W / 2, ch = H / 2;
    uint8_t* dy = dst;
    uint8_t* du = dst + (size_t)W * H;
    uint8_t* dv = du + (size_t)cw * ch;
    int f = h->frame->format;
    if (f == AV_PIX_FMT_YUV420P || f == AV_PIX_FMT_YUVJ420P) {
      for (int r = 0; r < H; ++r)
        std::memcpy(dy + (size_t)r * W,
                    h->frame->data[0] + (size_t)r * h->frame->linesize[0], W);
      for (int r = 0; r < ch; ++r) {
        std::memcpy(du + (size_t)r * cw,
                    h->frame->data[1] + (size_t)r * h->frame->linesize[1], cw);
        std::memcpy(dv + (size_t)r * cw,
                    h->frame->data[2] + (size_t)r * h->frame->linesize[2], cw);
      }
      return 0;
    }
    if (!h->sws || h->sws_dst_fmt != AV_PIX_FMT_YUV420P) {
      if (h->sws) sws_freeContext(h->sws);
      h->sws = sws_getContext(W, H, (AVPixelFormat)f, W, H,
                              AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr,
                              nullptr, nullptr);
      h->sws_dst_fmt = AV_PIX_FMT_YUV420P;
      if (!h->sws) {
        set_err(h, "sws_getContext failed");
        return -1;
      }
    }
    uint8_t* planes[3] = {dy, du, dv};
    int strides[3] = {W, cw, cw};
    sws_scale(h->sws, h->frame->data, h->frame->linesize, 0, H, planes,
              strides);
    return 0;
  }
  if (!h->sws || h->sws_dst_fmt != AV_PIX_FMT_RGB24) {
    if (h->sws) sws_freeContext(h->sws);
    h->sws = sws_getContext(W, H, (AVPixelFormat)h->frame->format, W, H,
                            AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr,
                            nullptr);
    h->sws_dst_fmt = AV_PIX_FMT_RGB24;
    if (!h->sws) {
      set_err(h, "sws_getContext failed");
      return -1;
    }
  }
  uint8_t* d[1] = {dst};
  int stride[1] = {W * 3};
  sws_scale(h->sws, h->frame->data, h->frame->linesize, 0, H, d, stride);
  return 0;
}

int64_t st_av_read_impl(StAv* h, const int64_t* indices, int64_t n,
                        uint8_t* out, int mode) {
  const size_t frame_bytes = mode == kOutI420
                                 ? (size_t)h->width * h->height * 3 / 2
                                 : (size_t)h->width * h->height * 3;
  int64_t k = 0;
  for (int64_t i = 0; i < n;) {
    // run = indices[i..j): ascending, gaps <= kSeekGap
    int64_t j = i + 1;
    while (j < n && indices[j] > indices[j - 1] &&
           indices[j] - indices[j - 1] <= kSeekGap)
      ++j;
    int64_t first = indices[i];
    if (first < h->next_index || first - h->next_index > kSeekGap) {
      int64_t target = index_to_pts(h, first);
      if (av_seek_frame(h->fmt, h->stream, target, AVSEEK_FLAG_BACKWARD) < 0) {
        // fall back: rewind to start
        av_seek_frame(h->fmt, h->stream, h->start_pts,
                      AVSEEK_FLAG_BACKWARD | AVSEEK_FLAG_BYTE);
      }
      avcodec_flush_buffers(h->dec);
      h->draining = false;
      h->next_index = -1;  // unknown until the next decoded frame tells us
    }
    int64_t last = indices[j - 1];
    while (true) {
      int r = next_frame(h);
      if (r <= 0) {
        set_err(h, r == 0 ? "eof before requested frame" : "decode error");
        return k;
      }
      int64_t pts = h->frame->best_effort_timestamp;
      int64_t idx = pts == AV_NOPTS_VALUE ? h->next_index
                                          : pts_to_index(h, pts);
      if (h->next_index < 0) h->next_index = idx;  // post-seek resync
      // trust container pts when present; otherwise sequential counting
      if (pts == AV_NOPTS_VALUE) idx = h->next_index;
      h->next_index = idx + 1;
      if (idx < indices[i]) {
        av_frame_unref(h->frame);
        continue;  // pre-roll from the keyframe
      }
      // emit this frame for every requested index it matches (handles
      // requests that repeat or that pts rounding folds together)
      while (i < j && indices[i] <= idx) {
        if (indices[i] == idx) {
          if (emit_frame(h, out + k * frame_bytes, mode) < 0) {
            av_frame_unref(h->frame);
            return k;
          }
          ++k;
        }
        ++i;
      }
      av_frame_unref(h->frame);
      if (i >= j) break;
      if (idx > last) {  // overshoot: pts gap — give up on the rest of run
        set_err(h, "pts gap: requested frame not found");
        return k;
      }
    }
  }
  return k;
}
}  // namespace

extern "C" {

void* st_av_open_t(const char* path, int threads) {
  avformat_network_init();
  auto* h = new (std::nothrow) StAv();
  if (!h) return nullptr;
  if (avformat_open_input(&h->fmt, path, nullptr, nullptr) < 0) {
    delete h;
    return nullptr;
  }
  if (avformat_find_stream_info(h->fmt, nullptr) < 0) {
    avformat_close_input(&h->fmt);
    delete h;
    return nullptr;
  }
  const AVCodec* codec = nullptr;
  h->stream = av_find_best_stream(h->fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                  &codec, 0);
  if (h->stream < 0 || !codec) {
    avformat_close_input(&h->fmt);
    delete h;
    return nullptr;
  }
  AVStream* st = h->fmt->streams[h->stream];
  h->dec = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(h->dec, st->codecpar);
  // threads <= 0 selects min(4, hardware cores): bulk sequential decode
  // scales near-linearly with frame threading on multi-core hosts (the
  // 1-core host resolves to 1, where decode is the measured e2e wall
  // — docs/PERF_NOTES.md §8). Frame threading adds a few frames of
  // latency after a seek; the chunk planner reads runs, so it amortizes.
  if (threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    threads = (int)(hc < 1 ? 1 : (hc > 4 ? 4 : hc));
  }
  h->dec->thread_count = threads;
  h->dec->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
  if (avcodec_open2(h->dec, codec, nullptr) < 0) {
    avcodec_free_context(&h->dec);
    avformat_close_input(&h->fmt);
    delete h;
    return nullptr;
  }
  h->width = h->dec->width;
  h->height = h->dec->height;
  h->tb = st->time_base;
  AVRational fr = st->avg_frame_rate.num ? st->avg_frame_rate
                                         : st->r_frame_rate;
  h->fps = fr.den ? av_q2d(fr) : 30.0;
  h->nframes = st->nb_frames;
  if (h->nframes <= 0 && st->duration > 0)
    h->nframes = (int64_t)(st->duration * av_q2d(h->tb) * h->fps + 0.5);
  if (h->nframes <= 0 && h->fmt->duration > 0)
    h->nframes =
        (int64_t)((double)h->fmt->duration / AV_TIME_BASE * h->fps + 0.5);
  h->start_pts = st->start_time == AV_NOPTS_VALUE ? 0 : st->start_time;
  h->frame = av_frame_alloc();
  h->pkt = av_packet_alloc();
  h->next_index = 0;
  return h;
}

void* st_av_open(const char* path) { return st_av_open_t(path, 0); }

int st_av_meta(void* p, int* w, int* hh, double* fps, int64_t* nframes) {
  auto* h = static_cast<StAv*>(p);
  *w = h->width;
  *hh = h->height;
  *fps = h->fps;
  *nframes = h->nframes;
  return 0;
}

const char* st_av_error(void* p) { return static_cast<StAv*>(p)->err; }

// Decode ascending frame indices into out ([n, H, W, 3] RGB24 contiguous).
// Returns number of frames written (== n on success; fewer => error/EOF).
int64_t st_av_read(void* p, const int64_t* indices, int64_t n, uint8_t* out) {
  return st_av_read_impl(static_cast<StAv*>(p), indices, n, out, kOutRGB24);
}

// Decode ascending frame indices into out as packed I420 planes per frame
// (Y: H*W bytes, U: H/2*W/2, V: H/2*W/2 — 1.5 B/px, half the RGB24 uplink
// and zero host colorspace math for 4:2:0 sources). Returns frames written.
int64_t st_av_read_i420(void* p, const int64_t* indices, int64_t n,
                        uint8_t* out) {
  return st_av_read_impl(static_cast<StAv*>(p), indices, n, out, kOutI420);
}

// I420 readability + colorimetry for this stream. supported=1 when the
// frame dims are even (I420 chroma is 2x2 subsampled). full_range=1 for
// JPEG-range sources (yuvj420p / color_range tag); bt709=1 when the stream
// tags BT.709 matrix coefficients (untagged SD content defaults to BT.601,
// matching swscale's default).
int st_av_i420_info(void* p, int* supported, int* full_range, int* bt709) {
  auto* h = static_cast<StAv*>(p);
  int f = h->dec->pix_fmt;
  // YUV-planar sources only: sws YUV->YUV is a chroma resample (no matrix
  // change), so the stream's own range/colorspace tags stay valid. RGB or
  // exotic sources fall back to the RGB24 path.
  bool yuv_src =
      f == AV_PIX_FMT_YUV420P || f == AV_PIX_FMT_YUVJ420P ||
      f == AV_PIX_FMT_YUV422P || f == AV_PIX_FMT_YUVJ422P ||
      f == AV_PIX_FMT_YUV444P || f == AV_PIX_FMT_YUVJ444P ||
      f == AV_PIX_FMT_NV12 || f == AV_PIX_FMT_NV21;
  *supported =
      (yuv_src && h->width % 2 == 0 && h->height % 2 == 0) ? 1 : 0;
  *full_range = (h->dec->color_range == AVCOL_RANGE_JPEG ||
                 f == AV_PIX_FMT_YUVJ420P || f == AV_PIX_FMT_YUVJ422P ||
                 f == AV_PIX_FMT_YUVJ444P)
                    ? 1
                    : 0;
  *bt709 = (h->dec->colorspace == AVCOL_SPC_BT709) ? 1 : 0;
  return 0;
}

void st_av_close(void* p) {
  auto* h = static_cast<StAv*>(p);
  if (h->sws) sws_freeContext(h->sws);
  if (h->pkt) av_packet_free(&h->pkt);
  if (h->frame) av_frame_free(&h->frame);
  if (h->dec) avcodec_free_context(&h->dec);
  if (h->fmt) avformat_close_input(&h->fmt);
  delete h;
}

// ------------------------------------------------------------------ audio
//
// One-shot decode of the best audio stream to mono float32 at the native
// sample rate (the contract of storage/audio.py's DECODER hook; multi-
// channel downmix matches its WAV path: plain channel mean, via
// swresample's default mixing matrix). Returns a malloc'd buffer the
// caller frees with st_av_free.

int64_t st_av_audio_decode(const char* path, float** out, int* rate) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return -1;
  }
  const AVCodec* codec = nullptr;
  int si = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (si < 0 || !codec) {
    avformat_close_input(&fmt);
    return -1;
  }
  AVStream* st = fmt->streams[si];
  AVCodecContext* dec = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(dec, st->codecpar);
  if (avcodec_open2(dec, codec, nullptr) < 0) {
    avcodec_free_context(&dec);
    avformat_close_input(&fmt);
    return -1;
  }
  *rate = dec->sample_rate;

  SwrContext* swr = nullptr;
  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  if (swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_FLT, dec->sample_rate,
                          &dec->ch_layout, dec->sample_fmt,
                          dec->sample_rate, 0, nullptr) < 0 ||
      swr_init(swr) < 0) {
    if (swr) swr_free(&swr);
    avcodec_free_context(&dec);
    avformat_close_input(&fmt);
    return -1;
  }

  int64_t cap = 1 << 20;
  int64_t count = 0;
  float* buf = (float*)std::malloc(cap * sizeof(float));
  AVFrame* frame = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  bool draining = false;
  int rc = 0;
  while (true) {
    int r = avcodec_receive_frame(dec, frame);
    if (r == AVERROR_EOF) break;
    if (r == AVERROR(EAGAIN)) {
      if (draining) break;
      r = av_read_frame(fmt, pkt);
      if (r == AVERROR_EOF) {
        draining = true;
        avcodec_send_packet(dec, nullptr);
        continue;
      }
      if (r < 0) { rc = -1; break; }
      if (pkt->stream_index != si) {
        av_packet_unref(pkt);
        continue;
      }
      avcodec_send_packet(dec, pkt);
      av_packet_unref(pkt);
      continue;
    }
    if (r < 0) { rc = -1; break; }
    // convert to mono f32 (possibly buffered inside swr)
    int out_max = frame->nb_samples + 256;
    if (count + out_max > cap) {
      while (count + out_max > cap) cap *= 2;
      buf = (float*)std::realloc(buf, cap * sizeof(float));
    }
    uint8_t* dst[1] = {(uint8_t*)(buf + count)};
    int got = swr_convert(swr, dst, out_max,
                          (const uint8_t**)frame->extended_data,
                          frame->nb_samples);
    if (got > 0) count += got;
    av_frame_unref(frame);
  }
  // flush the resampler
  if (rc == 0) {
    if (count + 4096 > cap) {
      cap += 8192;
      buf = (float*)std::realloc(buf, cap * sizeof(float));
    }
    uint8_t* dst[1] = {(uint8_t*)(buf + count)};
    int got = swr_convert(swr, dst, 4096, nullptr, 0);
    if (got > 0) count += got;
  }
  av_packet_free(&pkt);
  av_frame_free(&frame);
  swr_free(&swr);
  avcodec_free_context(&dec);
  avformat_close_input(&fmt);
  if (rc < 0) {
    std::free(buf);
    return -1;
  }
  *out = buf;
  return count;
}

void st_av_free(void* p) { std::free(p); }

// Windowed decode with sample-accurate seek: decode exactly
// [start_sample, start_sample + n) of the mono downmix at native rate,
// zero-filling past EOF — the reference Audio source's per-element read
// (audio_source.cpp:104-210: av_seek_frame to the container timestamp,
// decode forward, trim to the requested sample range, zero-fill at EOF).
// Returns samples written (== n), or <0 on open/decode error.
int64_t st_av_audio_read_window(const char* path, int64_t start_sample,
                                int64_t n, float* out, int* rate_out) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return -1;
  }
  const AVCodec* codec = nullptr;
  int si = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (si < 0 || !codec) {
    avformat_close_input(&fmt);
    return -1;
  }
  AVStream* st = fmt->streams[si];
  AVCodecContext* dec = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(dec, st->codecpar);
  if (avcodec_open2(dec, codec, nullptr) < 0) {
    avcodec_free_context(&dec);
    avformat_close_input(&fmt);
    return -1;
  }
  int rate = dec->sample_rate;
  *rate_out = rate;

  int64_t base_pts = st->start_time == AV_NOPTS_VALUE ? 0 : st->start_time;

  // seek BEFORE the window start and discard the pre-roll: a lossy
  // decoder needs a few frames to rebuild its overlap-add state after a
  // flush (the reference's junk-packet workaround, audio_source.cpp:
  // 231-234, serves the same purpose). 8192 samples covers several AAC/
  // MP3 frames; the trim below drops them. A window touching the stream
  // head decodes from the fresh open instead (a backward seek to 0 can
  // land before the edit list and skew the first frame's timestamps).
  int64_t preroll = start_sample > 8192 ? 8192 : start_sample;
  bool from_head = (start_sample - preroll) == 0;
  if (!from_head) {
    double t0 = (double)(start_sample - preroll) / rate;
    int64_t ts = base_pts + (int64_t)(t0 / av_q2d(st->time_base));
    av_seek_frame(fmt, si, ts, AVSEEK_FLAG_BACKWARD);
    avcodec_flush_buffers(dec);
  }

  SwrContext* swr = nullptr;
  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  if (swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_FLT, rate,
                          &dec->ch_layout, dec->sample_fmt, rate, 0,
                          nullptr) < 0 ||
      swr_init(swr) < 0) {
    if (swr) swr_free(&swr);
    avcodec_free_context(&dec);
    avformat_close_input(&fmt);
    return -1;
  }

  std::memset(out, 0, n * sizeof(float));
  AVFrame* frame = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  float* tmp = (float*)std::malloc((8192 + 256) * sizeof(float));
  bool draining = false;
  bool decode_error = false;  // genuine mid-stream failure, distinct from
                              // EOF/draining (zero-fill is only legal there)
  int64_t pos = -1;  // absolute sample index of the next converted sample
  int64_t written_end = start_sample;
  while (written_end < start_sample + n) {
    int r = avcodec_receive_frame(dec, frame);
    if (r == AVERROR_EOF) break;
    if (r == AVERROR(EAGAIN)) {
      if (draining) break;
      r = av_read_frame(fmt, pkt);
      if (r == AVERROR_EOF) {
        draining = true;
        avcodec_send_packet(dec, nullptr);
        continue;
      }
      if (r < 0) { decode_error = true; break; }
      if (pkt->stream_index != si) {
        av_packet_unref(pkt);
        continue;
      }
      avcodec_send_packet(dec, pkt);
      av_packet_unref(pkt);
      continue;
    }
    if (r < 0) { decode_error = true; break; }
    if (pos < 0) {
      int64_t pts = frame->best_effort_timestamp;
      pos = (from_head || pts == AV_NOPTS_VALUE)
                ? 0
                : (int64_t)((pts - base_pts) * av_q2d(st->time_base) *
                                rate +
                            0.5);
      if (pos < 0) pos = 0;
    }
    int cap = frame->nb_samples + 256;
    if (cap > 8192 + 256)
      tmp = (float*)std::realloc(tmp, cap * sizeof(float));
    uint8_t* dst[1] = {(uint8_t*)tmp};
    int got = swr_convert(swr, dst, cap,
                          (const uint8_t**)frame->extended_data,
                          frame->nb_samples);
    av_frame_unref(frame);
    if (got <= 0) continue;
    int64_t seg_start = pos;
    pos += got;
    // copy the overlap of [seg_start, seg_start+got) with the window
    int64_t lo = seg_start > start_sample ? seg_start : start_sample;
    int64_t hi = pos < start_sample + n ? pos : start_sample + n;
    if (hi > lo) {
      std::memcpy(out + (lo - start_sample), tmp + (lo - seg_start),
                  (hi - lo) * sizeof(float));
      written_end = hi;
    }
  }
  std::free(tmp);
  av_packet_free(&pkt);
  av_frame_free(&frame);
  swr_free(&swr);
  avcodec_free_context(&dec);
  avformat_close_input(&fmt);
  // A corrupt/truncated stream must be distinguishable from the legal
  // EOF zero-fill: report how far real samples reached, as a negative
  // offset marker (-(written+1) <= -1), so callers' got<0 check fires.
  if (decode_error) return -(written_end - start_sample) - 1;
  return n;
}

// Encode mono float32 samples to a compressed audio file (codec inferred
// from the container extension via libavformat defaults, e.g. .m4a -> aac,
// .ogg -> vorbis). Used by tests to produce real compressed fixtures in a
// no-egress environment, and by Audio.extract as the writer.
int st_av_audio_encode(const char* path, const float* samples, int64_t n,
                       int rate) {
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0)
    return -1;
  const AVCodec* codec = avcodec_find_encoder(fmt->oformat->audio_codec);
  if (!codec) {
    avformat_free_context(fmt);
    return -1;
  }
  AVCodecContext* enc = avcodec_alloc_context3(codec);
  enc->sample_rate = rate;
  AVChannelLayout mono_layout = AV_CHANNEL_LAYOUT_MONO;
  av_channel_layout_copy(&enc->ch_layout, &mono_layout);
  enc->sample_fmt = codec->sample_fmts ? codec->sample_fmts[0]
                                       : AV_SAMPLE_FMT_FLTP;
  enc->bit_rate = 128000;
  enc->time_base = AVRational{1, rate};
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(enc, codec, nullptr) < 0) {
    avcodec_free_context(&enc);
    avformat_free_context(fmt);
    return -1;
  }
  AVStream* st = avformat_new_stream(fmt, nullptr);
  avcodec_parameters_from_context(st->codecpar, enc);
  st->time_base = enc->time_base;
  if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
    avcodec_free_context(&enc);
    avformat_free_context(fmt);
    return -1;
  }
  if (avformat_write_header(fmt, nullptr) < 0) {
    avcodec_free_context(&enc);
    avformat_free_context(fmt);
    return -1;
  }

  SwrContext* swr = nullptr;
  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  swr_alloc_set_opts2(&swr, &mono, enc->sample_fmt, rate, &mono,
                      AV_SAMPLE_FMT_FLT, rate, 0, nullptr);
  swr_init(swr);

  int fsz = enc->frame_size > 0 ? enc->frame_size : 1024;
  AVFrame* frame = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  int64_t pos = 0;
  int rc = 0;
  auto drain = [&](bool flush) {
    while (true) {
      int r = avcodec_receive_packet(enc, pkt);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
      if (r < 0) return -1;
      pkt->stream_index = 0;
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      if (av_interleaved_write_frame(fmt, pkt) < 0) return -1;
    }
    (void)flush;
  };
  while (pos < n && rc == 0) {
    int take = (int)((n - pos) < fsz ? (n - pos) : fsz);
    frame->nb_samples = take;
    frame->format = enc->sample_fmt;
    av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout);
    frame->sample_rate = rate;
    if (av_frame_get_buffer(frame, 0) < 0) { rc = -1; break; }
    const uint8_t* src[1] = {(const uint8_t*)(samples + pos)};
    swr_convert(swr, frame->extended_data, take, src, take);
    frame->pts = pos;
    pos += take;
    if (avcodec_send_frame(enc, frame) < 0) rc = -1;
    av_frame_unref(frame);
    if (rc == 0) rc = drain(false);
  }
  if (rc == 0) {
    avcodec_send_frame(enc, nullptr);
    rc = drain(true);
    while (rc == 0) {
      int r = avcodec_receive_packet(enc, pkt);
      if (r == AVERROR_EOF || r == AVERROR(EAGAIN)) break;
      if (r < 0) { rc = -1; break; }
      pkt->stream_index = 0;
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      av_interleaved_write_frame(fmt, pkt);
    }
  }
  av_write_trailer(fmt);
  av_packet_free(&pkt);
  av_frame_free(&frame);
  swr_free(&swr);
  avcodec_free_context(&enc);
  if (!(fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return rc;
}

}  // extern "C"
