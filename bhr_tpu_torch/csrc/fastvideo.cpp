// fastvideo: H.264/MP4 video assembly via libavformat/libavcodec.
//
// The port's own copy of bhr_tpu/native/fastvideo.cpp. It writes the
// orbit video on hosts where the ffmpeg shared libraries and their
// headers exist but neither the Python bindings nor an ffmpeg CLI do;
// without it the video mode ends in the MJPEG AVI fallback. Exposes a C
// ABI consumed via ctypes (bhr_tpu_torch/native.py):
//
//   fastvideo_open / fastvideo_write_frame / fastvideo_close  — encoder
//   fastvideo_abort                                           — drop a partial file's handle
//   fastvideo_probe                                           — container check
//   fastvideo_read_frame0                                     — decode for tests
//
// Encoder: libx264, yuv420p, preset veryfast, one thread, no mbtree,
// CRF from the caller. Input frames are interleaved RGB24 converted by swscale.
// No exceptions cross the boundary; every call returns an error code
// (0 = success) and close() is safe after partial failures.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>

#if defined(__x86_64__) || defined(__i386__)
#include <xmmintrin.h>
#define BHR_HAVE_MXCSR 1
#endif

namespace {

// Pin the SSE floating-point environment for the duration of any call
// that runs encoder float code. A numerics library can set FTZ/DAZ
// (flush-denormals) in MXCSR on the threads it uses (XLA's CPU client
// does; torch.set_flush_denormal does), and libx264's rate control and
// adaptive quantization use floats whose decisions can flip under a
// different FP environment: the same frames encoded before and after
// such a call gave different (each internally deterministic)
// bitstreams. Scoping every encoder entry point to the
// default MXCSR (0x1F80) makes the stream a pure function of the
// input bytes, whatever the host process has done to its FP state.
struct FpEnvGuard {
#ifdef BHR_HAVE_MXCSR
  unsigned int saved;
  FpEnvGuard() : saved(_mm_getcsr()) { _mm_setcsr(0x1F80); }
  ~FpEnvGuard() { _mm_setcsr(saved); }
#endif
};

struct FastVideo {
  AVFormatContext *fmt = nullptr;
  AVCodecContext *enc = nullptr;
  AVStream *stream = nullptr;
  SwsContext *sws = nullptr;
  AVFrame *frame = nullptr;
  AVPacket *pkt = nullptr;
  uint8_t *rgb_buf = nullptr;  // av_malloc-aligned staging copy
  int64_t pts = 0;
  int width = 0;
  int height = 0;
  bool header_written = false;
};

void destroy(FastVideo *v) {
  if (!v) return;
  if (v->rgb_buf) av_freep(&v->rgb_buf);
  if (v->sws) sws_freeContext(v->sws);
  if (v->frame) av_frame_free(&v->frame);
  if (v->pkt) av_packet_free(&v->pkt);
  if (v->enc) avcodec_free_context(&v->enc);
  if (v->fmt) {
    if (v->fmt->pb && !(v->fmt->oformat->flags & AVFMT_NOFILE))
      avio_closep(&v->fmt->pb);
    avformat_free_context(v->fmt);
  }
  delete v;
}

// Drain every pending packet from the encoder into the muxer.
// flush=true sends the EOF frame first. Returns 0 or a negative
// libav error.
int drain(FastVideo *v, bool flush) {
  int rc = avcodec_send_frame(v->enc, flush ? nullptr : v->frame);
  if (rc < 0) return rc;
  for (;;) {
    rc = avcodec_receive_packet(v->enc, v->pkt);
    if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
    if (rc < 0) return rc;
    av_packet_rescale_ts(v->pkt, v->enc->time_base, v->stream->time_base);
    v->pkt->stream_index = v->stream->index;
    rc = av_interleaved_write_frame(v->fmt, v->pkt);
    if (rc < 0) return rc;
  }
}

}  // namespace

extern "C" {

// 1 when an H.264 encoder is present in this libavcodec build.
int fastvideo_available(void) {
  return avcodec_find_encoder(AV_CODEC_ID_H264) ? 1 : 0;
}

// Open an H.264 writer. Container is guessed from the path's extension
// (.mp4 expected). Dimensions must be positive and even (yuv420p).
// Returns a handle, or NULL on any failure (nothing left on disk
// beyond what avio may have created; callers treat NULL as "fall back").
void *fastvideo_open(const char *path, int32_t width, int32_t height,
                     int32_t fps, int32_t crf) {
  if (!path || width <= 0 || height <= 0 || fps <= 0) return nullptr;
  if ((width | height) & 1) return nullptr;  // yuv420p needs even dims
  if (crf < 0 || crf > 51) crf = 18;
  FpEnvGuard fp_guard;
  av_log_set_level(AV_LOG_ERROR);

  FastVideo *v = new (std::nothrow) FastVideo();
  if (!v) return nullptr;
  v->width = width;
  v->height = height;

  if (avformat_alloc_output_context2(&v->fmt, nullptr, nullptr, path) < 0 ||
      !v->fmt) {
    destroy(v);
    return nullptr;
  }
  const AVCodec *codec = avcodec_find_encoder(AV_CODEC_ID_H264);
  if (!codec) {
    destroy(v);
    return nullptr;
  }
  v->stream = avformat_new_stream(v->fmt, nullptr);
  v->enc = avcodec_alloc_context3(codec);
  v->pkt = av_packet_alloc();
  v->frame = av_frame_alloc();
  if (!v->stream || !v->enc || !v->pkt || !v->frame) {
    destroy(v);
    return nullptr;
  }

  v->enc->width = width;
  v->enc->height = height;
  v->enc->pix_fmt = AV_PIX_FMT_YUV420P;
  v->enc->time_base = AVRational{1, fps};
  v->enc->framerate = AVRational{fps, 1};
  if (v->fmt->oformat->flags & AVFMT_GLOBALHEADER)
    v->enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  // veryfast trades ~10-20% bitrate for ~4x encode speed against the
  // default preset; CRF controls quality either way.
  // These are libx264 private options; another H.264 encoder (e.g. an
  // openh264 ffmpeg build) rejects them, so on failure fall back to an
  // explicit bitrate budget (~0.15 bits/pixel at the target framerate,
  // FHD@24 ≈ 7.5 Mbit/s) instead of that encoder's default rate
  // control, which can be far below visually-lossless.
  // One encoder thread, always: x264 auto-threading picks a count from
  // the CPU state it detects at open time, and the BITSTREAM depends
  // on that count (frame-threaded lookahead/rate control) — two
  // encodes of identical frames in the same process diverged once a
  // library load changed the detected state. A fixed count makes every
  // encode bit-reproducible (inline-vs-post-pass identity is a tested
  // invariant).
  v->enc->thread_count = 1;
  av_opt_set(v->enc->priv_data, "preset", "veryfast", 0);
  // Macroblock-tree rate control off: with it on, libx264 reads memory
  // it allocated and never wrote, so the stream's size followed whatever
  // the process's heap last held (seen by filling fresh allocations with
  // different bytes, glibc's M_PERTURB: 5 frames of 64x36, 192x90 and
  // most widths between gave 2-3 different streams, and none differed
  // with mbtree=0 or bframes=0). CRF rate control without the tree is a
  // pure function of the frames. Not a libx264 build: the option is
  // unknown and the call fails harmlessly.
  av_opt_set(v->enc->priv_data, "mbtree", "0", 0);
  char crf_s[8];
  std::snprintf(crf_s, sizeof crf_s, "%d", crf);
  if (av_opt_set(v->enc->priv_data, "crf", crf_s, 0) < 0) {
    v->enc->bit_rate =
        static_cast<int64_t>(0.15 * width * height * fps);
  }

  if (avcodec_open2(v->enc, codec, nullptr) < 0 ||
      avcodec_parameters_from_context(v->stream->codecpar, v->enc) < 0) {
    destroy(v);
    return nullptr;
  }
  v->stream->time_base = v->enc->time_base;

  v->frame->format = AV_PIX_FMT_YUV420P;
  v->frame->width = width;
  v->frame->height = height;
  if (av_frame_get_buffer(v->frame, 0) < 0) {
    destroy(v);
    return nullptr;
  }
  // BITEXACT + ACCURATE_RND: plain SWS_BILINEAR selects SIMD paths by
  // the SOURCE POINTER's alignment, and those paths round chroma
  // differently — two encodes of byte-identical frames diverged
  // whenever the numpy allocator handed the callers differently
  // aligned buffers (tracked down via the inline-vs-post-pass video
  // identity test). The bitexact path is alignment-independent, so
  // the encoded stream is a pure function of the input bytes.
  v->sws = sws_getContext(width, height, AV_PIX_FMT_RGB24, width, height,
                          AV_PIX_FMT_YUV420P,
                          SWS_BILINEAR | SWS_BITEXACT | SWS_ACCURATE_RND,
                          nullptr, nullptr, nullptr);
  if (!v->sws) {
    destroy(v);
    return nullptr;
  }
  // Staging copy for the caller's RGB bytes. swscale's SIMD RGB24
  // reader OVERREADS past the end of the source buffer (its API
  // expects av_malloc'd, padding-sized inputs), and those out-of-range
  // bytes leak into the converted chroma at the frame edge — so two
  // encodes of byte-identical numpy frames diverged whenever the
  // allocator placed different garbage after them (tracked down via
  // the inline-vs-post-pass video identity test). Copying into one
  // av_malloc'd buffer whose padding is zeroed ONCE makes the encoded
  // stream a pure function of the input bytes.
  {
    const size_t n = static_cast<size_t>(3) * width * height;
    v->rgb_buf = static_cast<uint8_t *>(
        av_malloc(n + AV_INPUT_BUFFER_PADDING_SIZE + 64));
    if (!v->rgb_buf) {
      destroy(v);
      return nullptr;
    }
    std::memset(v->rgb_buf, 0, n + AV_INPUT_BUFFER_PADDING_SIZE + 64);
  }

  if (!(v->fmt->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&v->fmt->pb, path, AVIO_FLAG_WRITE) < 0) {
    destroy(v);
    return nullptr;
  }
  if (avformat_write_header(v->fmt, nullptr) < 0) {
    destroy(v);
    return nullptr;
  }
  v->header_written = true;
  return v;
}

// Encode one interleaved RGB24 frame (height rows of 3*width bytes).
// Returns 0 on success.
int fastvideo_write_frame(void *handle, const uint8_t *rgb) {
  FastVideo *v = static_cast<FastVideo *>(handle);
  if (!v || !rgb) return 1;
  FpEnvGuard fp_guard;
  if (av_frame_make_writable(v->frame) < 0) return 2;
  std::memcpy(v->rgb_buf, rgb,
              static_cast<size_t>(3) * v->width * v->height);
  const uint8_t *src[1] = {v->rgb_buf};
  const int src_stride[1] = {3 * v->width};
  sws_scale(v->sws, src, src_stride, 0, v->height, v->frame->data,
            v->frame->linesize);
  v->frame->pts = v->pts++;
  return drain(v, false) < 0 ? 3 : 0;
}

// Free the handle WITHOUT flushing or writing the trailer: the file is
// left unfinalized (no moov box — unplayable), for abandoning a write
// after an error so a truncated-but-playable video can never sit at
// the advertised path.
void fastvideo_abort(void *handle) {
  destroy(static_cast<FastVideo *>(handle));
}

// Flush the encoder, write the trailer, and free the handle. Always
// frees; returns 0 only when the file finalized cleanly.
int fastvideo_close(void *handle) {
  FastVideo *v = static_cast<FastVideo *>(handle);
  if (!v) return 1;
  FpEnvGuard fp_guard;  // drain() still encodes queued frames
  int rc = 0;
  if (v->header_written) {
    if (drain(v, true) < 0) rc = 2;
    if (av_write_trailer(v->fmt) < 0 && rc == 0) rc = 3;
  }
  destroy(v);
  return rc;
}

// Probe a finished file: fills frame count (demuxed video packets),
// width, height. Returns 0 on success.
int fastvideo_probe(const char *path, int32_t *n_frames, int32_t *width,
                    int32_t *height) {
  if (!path || !n_frames || !width || !height) return 1;
  av_log_set_level(AV_LOG_ERROR);
  AVFormatContext *fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return 2;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return 3;
  }
  const int vi = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                     nullptr, 0);
  if (vi < 0) {
    avformat_close_input(&fmt);
    return 4;
  }
  *width = fmt->streams[vi]->codecpar->width;
  *height = fmt->streams[vi]->codecpar->height;
  int32_t count = 0;
  AVPacket *pkt = av_packet_alloc();
  while (pkt && av_read_frame(fmt, pkt) >= 0) {
    if (pkt->stream_index == vi) ++count;
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  avformat_close_input(&fmt);
  *n_frames = count;
  return 0;
}

// Decode the first video frame into caller-provided RGB24 storage of
// width*height*3 bytes (dims must match fastvideo_probe's). Used by
// tests to close the encode->decode loop without any Python codec.
int fastvideo_read_frame0(const char *path, uint8_t *rgb_out, int32_t width,
                          int32_t height) {
  if (!path || !rgb_out || width <= 0 || height <= 0) return 1;
  av_log_set_level(AV_LOG_ERROR);
  AVFormatContext *fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return 2;
  int rc = 3;
  AVCodecContext *dec = nullptr;
  AVPacket *pkt = nullptr;
  AVFrame *frame = nullptr;
  SwsContext *sws = nullptr;
  do {
    if (avformat_find_stream_info(fmt, nullptr) < 0) break;
    const AVCodec *codec = nullptr;
    const int vi =
        av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
    if (vi < 0 || !codec) break;
    AVStream *st = fmt->streams[vi];
    if (st->codecpar->width != width || st->codecpar->height != height) {
      rc = 4;
      break;
    }
    dec = avcodec_alloc_context3(codec);
    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    if (!dec || !pkt || !frame) break;
    if (avcodec_parameters_to_context(dec, st->codecpar) < 0) break;
    if (avcodec_open2(dec, codec, nullptr) < 0) break;

    bool got = false;
    // Feed packets until the first decoded frame; after the demuxer
    // runs dry, flush the decoder (x264 buffers lookahead frames).
    bool demux_done = false;
    while (!got) {
      if (!demux_done) {
        if (av_read_frame(fmt, pkt) < 0) {
          demux_done = true;
          avcodec_send_packet(dec, nullptr);
        } else if (pkt->stream_index == vi) {
          avcodec_send_packet(dec, pkt);
          av_packet_unref(pkt);
        } else {
          av_packet_unref(pkt);
          continue;
        }
      }
      const int r = avcodec_receive_frame(dec, frame);
      if (r == 0) {
        got = true;
      } else if (r == AVERROR(EAGAIN)) {
        if (demux_done) break;
      } else {
        break;
      }
    }
    if (!got) break;

    sws = sws_getContext(width, height,
                         static_cast<AVPixelFormat>(frame->format), width,
                         height, AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                         nullptr, nullptr);
    if (!sws) break;
    uint8_t *dst[1] = {rgb_out};
    const int dst_stride[1] = {3 * width};
    sws_scale(sws, frame->data, frame->linesize, 0, height, dst, dst_stride);
    rc = 0;
  } while (false);

  if (sws) sws_freeContext(sws);
  if (frame) av_frame_free(&frame);
  if (pkt) av_packet_free(&pkt);
  if (dec) avcodec_free_context(&dec);
  avformat_close_input(&fmt);
  return rc;
}

}  // extern "C"
