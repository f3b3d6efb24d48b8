// videodec — indexed video frame decoding on libav (ffmpeg), C API for ctypes.
//
// TPU-native replacement for the reference's decord/PyAV host decode layer
// (its eagle/mm_utils.py:43-79 and lmms_eval/models/videoitg.py:95-130;
// SURVEY §2.9). Same contract as decord's VideoReader:
//   * frames are indexed in PRESENTATION order (sorted pts),
//   * get_batch(indices) returns RGB24 frames at native resolution,
//   * frame count comes from the packet index (one demux pass, no decode),
//     covering containers without nb_frames (webm/mkv) — the case the
//     reference handles with its packet-demux fallback.
//
// Seeking: a packet index (pts + keyframe flags) is built at open; a fetch
// seeks to the last keyframe at-or-before the target only when that skips
// decode work, otherwise decodes forward — the decord strategy.
//
// Also exports a tiny test-video writer (solid color == frame index) so the
// test suite can synthesize fixtures without any external media.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <string>
#include <vector>

namespace {

struct PacketEntry {
  int64_t pts;       // presentation timestamp (dts fallback)
  bool keyframe;
};

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  SwsContext* sws_yuv = nullptr;  // lazy: only for non-yuv420p sources
  int stream_index = -1;
  int width = 0, height = 0;
  double fps = 0.0;
  std::vector<PacketEntry> index;       // sorted by pts (presentation order)
  std::vector<int> key_positions;       // indices into `index` of keyframes
  int64_t current_next_idx = -1;        // next presentation index the decoder
                                        // would emit if we keep reading; -1 =
                                        // unknown (must seek)
  AVFrame* last_frame = nullptr;        // most recently decoded frame (ref),
                                        // EOF fallback for streams whose last
                                        // packet yields no frame (seen with
                                        // mpeg4 not-coded VOPs)
  std::vector<uint8_t> scratch;         // aligned sws output (see convert_to_rgb)
  std::string error;
};

void set_error(Decoder* d, const std::string& msg, int averr = 0) {
  if (averr != 0) {
    char buf[256];
    av_strerror(averr, buf, sizeof buf);
    d->error = msg + ": " + buf;
  } else {
    d->error = msg;
  }
}

int build_index(Decoder* d) {
  AVPacket* pkt = av_packet_alloc();
  while (av_read_frame(d->fmt, pkt) >= 0) {
    if (pkt->stream_index == d->stream_index) {
      int64_t pts = pkt->pts != AV_NOPTS_VALUE ? pkt->pts : pkt->dts;
      d->index.push_back({pts, (pkt->flags & AV_PKT_FLAG_KEY) != 0});
    }
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  std::sort(d->index.begin(), d->index.end(),
            [](const PacketEntry& a, const PacketEntry& b) { return a.pts < b.pts; });
  for (size_t i = 0; i < d->index.size(); ++i)
    if (d->index[i].keyframe) d->key_positions.push_back((int)i);
  if (d->index.empty()) {
    set_error(d, "no video packets found");
    return -1;
  }
  return 0;
}

// Last keyframe position <= target presentation index (0 if none marked).
int last_keyframe_at_or_before(const Decoder* d, int target) {
  int best = 0;
  for (int kp : d->key_positions) {
    if (kp <= target) best = kp;
    else break;
  }
  return best;
}

int seek_to_presentation_index(Decoder* d, int idx) {
  int64_t pts = d->index[idx].pts;
  int ret = av_seek_frame(d->fmt, d->stream_index, pts, AVSEEK_FLAG_BACKWARD);
  if (ret < 0) {
    // fall back to byte-0 seek (some containers dislike pts seeks)
    ret = av_seek_frame(d->fmt, d->stream_index, 0,
                        AVSEEK_FLAG_BACKWARD | AVSEEK_FLAG_BYTE);
    if (ret < 0) {
      set_error(d, "seek failed", ret);
      return -1;
    }
  }
  avcodec_flush_buffers(d->codec);
  d->current_next_idx = -2;  // unknown until the first decoded frame tells us
  return 0;
}

void convert_to_rgb(Decoder* d, const AVFrame* frame, uint8_t* out) {
  // sws_scale writes RGB24 rows in SIMD-sized chunks: with a tightly packed
  // destination whose row stride (3*w) is not SIMD-aligned it tramples the
  // next row's head and overruns the final row (heap corruption at e.g.
  // w=102). Convert into an aligned scratch image, then row-copy out.
  const int w = d->width, h = d->height;
  const int tight = 3 * w;
  if (w % 16 == 0) {
    // No partial SIMD chunk at the row tail: safe to write tightly packed.
    uint8_t* dst[4] = {out, nullptr, nullptr, nullptr};
    int dst_linesize[4] = {tight, 0, 0, 0};
    sws_scale(d->sws, frame->data, frame->linesize, 0, frame->height, dst,
              dst_linesize);
    return;
  }
  // >=128 bytes of per-row slack absorbs any partial-chunk store; +256
  // tail: the final row's last SIMD store may extend past ls*h.
  const int ls = ((tight + 63) & ~63) + 128;
  d->scratch.resize((size_t)ls * h + 256);
  uint8_t* dst[4] = {d->scratch.data(), nullptr, nullptr, nullptr};
  int dst_linesize[4] = {ls, 0, 0, 0};
  sws_scale(d->sws, frame->data, frame->linesize, 0, frame->height, dst,
            dst_linesize);
  for (int r = 0; r < h; ++r)
    std::memcpy(out + (size_t)r * tight, d->scratch.data() + (size_t)r * ls,
                tight);
}

// Output slot for one decoded frame: either RGB24 (rgb set) or tightly
// packed YUV420 planes (y/u/v set). The YUV path ships the decoder's
// native limited-range BT.601 planes — half the bytes of RGB24 — so the
// colorspace conversion can run on the accelerator instead of this host
// (videoitg_tpu_torch/ops/preprocess.py yuv420_to_rgb).
struct FrameDst {
  uint8_t* rgb = nullptr;
  uint8_t* y = nullptr;
  uint8_t* u = nullptr;
  uint8_t* v = nullptr;
};

void emit_frame(Decoder* d, const AVFrame* frame, const FrameDst& out) {
  if (out.rgb) {
    convert_to_rgb(d, frame, out.rgb);
    return;
  }
  const int w = d->width, h = d->height;
  const int cw = (w + 1) / 2, ch = (h + 1) / 2;
  // Fast path: the stream already decodes to limited-range yuv420p (the
  // dominant H.264/H.265 case) — copy planes row-wise (linesize-aware).
  if (frame->format == AV_PIX_FMT_YUV420P &&
      frame->color_range != AVCOL_RANGE_JPEG) {
    for (int r = 0; r < h; ++r)
      std::memcpy(out.y + (size_t)r * w,
                  frame->data[0] + (size_t)r * frame->linesize[0], w);
    for (int r = 0; r < ch; ++r) {
      std::memcpy(out.u + (size_t)r * cw,
                  frame->data[1] + (size_t)r * frame->linesize[1], cw);
      std::memcpy(out.v + (size_t)r * cw,
                  frame->data[2] + (size_t)r * frame->linesize[2], cw);
    }
    return;
  }
  // Everything else (yuvj*/full-range, 10-bit, yuv444, ...) converts to
  // limited-range yuv420p via swscale, so device-side math sees ONE format.
  // Like convert_to_rgb, sws output strides must be SIMD-aligned: write into
  // an aligned scratch image and row-copy into the tight planes.
  d->sws_yuv = sws_getCachedContext(
      d->sws_yuv, w, h, (AVPixelFormat)frame->format, w, h,
      AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr, nullptr, nullptr);
  // 256-byte gaps between planes + tail: each plane's final row may be
  // written with SIMD stores extending past its tight end.
  const int lsy = ((w + 63) & ~63) + 128, lsc = ((cw + 63) & ~63) + 128;
  d->scratch.resize((size_t)lsy * h + 2 * (size_t)lsc * ch + 3 * 256);
  uint8_t* sy = d->scratch.data();
  uint8_t* su = sy + (size_t)lsy * h + 256;
  uint8_t* sv = su + (size_t)lsc * ch + 256;
  uint8_t* data[4] = {sy, su, sv, nullptr};
  int ls[4] = {lsy, lsc, lsc, 0};
  sws_scale(d->sws_yuv, frame->data, frame->linesize, 0, frame->height, data,
            ls);
  for (int r = 0; r < h; ++r)
    std::memcpy(out.y + (size_t)r * w, sy + (size_t)r * lsy, w);
  for (int r = 0; r < ch; ++r) {
    std::memcpy(out.u + (size_t)r * cw, su + (size_t)r * lsc, cw);
    std::memcpy(out.v + (size_t)r * cw, sv + (size_t)r * lsc, cw);
  }
}

// Decode forward until the frame whose pts equals index[target].pts; convert
// into out (RGB24 or YUV420 planes, native size). Returns 0 on success.
int decode_until(Decoder* d, int target, const FrameDst& out) {
  const int64_t want_pts = d->index[target].pts;
  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  int ret = 0;
  bool done = false, draining = false;

  while (!done) {
    if (!draining) {
      ret = av_read_frame(d->fmt, pkt);
      if (ret < 0) {
        draining = true;
        avcodec_send_packet(d->codec, nullptr);
      } else if (pkt->stream_index != d->stream_index) {
        av_packet_unref(pkt);
        continue;
      } else {
        ret = avcodec_send_packet(d->codec, pkt);
        av_packet_unref(pkt);
        if (ret < 0 && ret != AVERROR(EAGAIN)) {
          set_error(d, "send_packet failed", ret);
          break;
        }
      }
    }
    while ((ret = avcodec_receive_frame(d->codec, frame)) >= 0) {
      int64_t pts = frame->best_effort_timestamp != AV_NOPTS_VALUE
                        ? frame->best_effort_timestamp
                        : frame->pts;
      // Remember the newest decoded frame as the EOF fallback.
      if (!d->last_frame) d->last_frame = av_frame_alloc();
      av_frame_unref(d->last_frame);
      av_frame_ref(d->last_frame, frame);
      if (pts >= want_pts) {
        // Tolerate pts drift past target: take the first frame at-or-after,
        // which is the target unless timestamps repeat.
        emit_frame(d, frame, out);
        // Next decode would emit the following presentation index.
        auto it = std::upper_bound(
            d->index.begin(), d->index.end(), pts,
            [](int64_t v, const PacketEntry& e) { return v < e.pts; });
        d->current_next_idx = (int64_t)(it - d->index.begin());
        done = true;
        av_frame_unref(frame);
        break;
      }
      av_frame_unref(frame);
    }
    if (done) break;
    if (ret == AVERROR_EOF) {
      // Stream ended before the target pts (e.g. an index entry whose packet
      // produced no frame — mpeg4 not-coded VOPs). Fall back to the nearest
      // earlier frame, like decord.
      if (d->last_frame && d->last_frame->data[0]) {
        emit_frame(d, d->last_frame, out);
        d->current_next_idx = (int64_t)d->index.size();
        done = true;
      } else {
        set_error(d, "EOF before reaching target frame");
      }
      break;
    }
    if (ret < 0 && ret != AVERROR(EAGAIN)) {
      set_error(d, "receive_frame failed", ret);
      break;
    }
  }
  av_frame_free(&frame);
  av_packet_free(&pkt);
  return done ? 0 : -1;
}

}  // namespace

extern "C" {

void* vdec_open(const char* path) {
  av_log_set_level(AV_LOG_ERROR);
  Decoder* d = new Decoder();
  int ret = avformat_open_input(&d->fmt, path, nullptr, nullptr);
  if (ret < 0) { set_error(d, "open failed", ret); return d; }
  ret = avformat_find_stream_info(d->fmt, nullptr);
  if (ret < 0) { set_error(d, "stream info failed", ret); return d; }

  const AVCodec* dec = nullptr;
  d->stream_index = av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
  if (d->stream_index < 0 || !dec) { set_error(d, "no video stream"); return d; }
  AVStream* st = d->fmt->streams[d->stream_index];

  d->codec = avcodec_alloc_context3(dec);
  avcodec_parameters_to_context(d->codec, st->codecpar);
  d->codec->thread_count = 0;  // auto
  ret = avcodec_open2(d->codec, dec, nullptr);
  if (ret < 0) { set_error(d, "codec open failed", ret); return d; }

  d->width = d->codec->width;
  d->height = d->codec->height;
  AVRational fr = av_guess_frame_rate(d->fmt, st, nullptr);
  d->fps = fr.num > 0 && fr.den > 0 ? av_q2d(fr) : 0.0;

  if (build_index(d) < 0) return d;
  // Rewind after the index pass.
  seek_to_presentation_index(d, 0);

  d->sws = sws_getContext(d->width, d->height, d->codec->pix_fmt, d->width,
                          d->height, AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                          nullptr, nullptr);
  if (!d->sws) set_error(d, "swscale init failed");
  return d;
}

const char* vdec_error(void* handle) {
  Decoder* d = (Decoder*)handle;
  return d->error.c_str();
}

int vdec_ok(void* handle) {
  Decoder* d = (Decoder*)handle;
  return d->error.empty() ? 1 : 0;
}

int64_t vdec_num_frames(void* handle) { return ((Decoder*)handle)->index.size(); }
double vdec_fps(void* handle) { return ((Decoder*)handle)->fps; }
int vdec_width(void* handle) { return ((Decoder*)handle)->width; }
int vdec_height(void* handle) { return ((Decoder*)handle)->height; }

namespace {

// Shared batched-fetch core. For RGB, `p0` is out[n, H, W, 3]; for YUV,
// (p0, p1, p2) are tightly packed Y [n, H, W] and U/V [n, ceil(H/2),
// ceil(W/2)] planes.
int get_batch_impl(Decoder* d, const int64_t* indices, int n, bool yuv,
                   uint8_t* p0, uint8_t* p1, uint8_t* p2) {
  if (!d->error.empty()) return -1;
  const int cw = (d->width + 1) / 2, ch = (d->height + 1) / 2;
  const size_t rgb_bytes = (size_t)d->width * d->height * 3;
  const size_t y_bytes = (size_t)d->width * d->height;
  const size_t c_bytes = (size_t)cw * ch;

  // Process in sorted order, writing every requested slot for an index.
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(),
            [&](int a, int b) { return indices[a] < indices[b]; });

  int64_t last_idx = -1;
  std::vector<uint8_t> last0, last1, last2;
  for (int oi = 0; oi < n; ++oi) {
    const int slot = order[oi];
    const int64_t idx = indices[slot];
    if (idx < 0 || idx >= (int64_t)d->index.size()) {
      set_error(d, "frame index out of range");
      return -1;
    }
    FrameDst dst;
    if (yuv) {
      dst.y = p0 + y_bytes * slot;
      dst.u = p1 + c_bytes * slot;
      dst.v = p2 + c_bytes * slot;
    } else {
      dst.rgb = p0 + rgb_bytes * slot;
    }
    if (idx == last_idx) {  // duplicated request (e.g. pad-with-0 sampling)
      if (yuv) {
        std::memcpy(dst.y, last0.data(), y_bytes);
        std::memcpy(dst.u, last1.data(), c_bytes);
        std::memcpy(dst.v, last2.data(), c_bytes);
      } else {
        std::memcpy(dst.rgb, last0.data(), rgb_bytes);
      }
      continue;
    }
    const int key = last_keyframe_at_or_before(d, (int)idx);
    const bool can_continue =
        d->current_next_idx >= 0 && d->current_next_idx <= idx;
    // Seek when we can't continue forward, or when jumping to the keyframe
    // skips decode work we'd otherwise do.
    if (!can_continue || key > d->current_next_idx) {
      if (seek_to_presentation_index(d, key) < 0) return -1;
    }
    if (decode_until(d, (int)idx, dst) < 0) return -1;
    last_idx = idx;
    if (yuv) {
      last0.assign(dst.y, dst.y + y_bytes);
      last1.assign(dst.u, dst.u + c_bytes);
      last2.assign(dst.v, dst.v + c_bytes);
    } else {
      last0.assign(dst.rgb, dst.rgb + rgb_bytes);
    }
  }
  return 0;
}

}  // namespace

// Decode frames at `indices` (presentation order ids, may repeat / be
// unsorted) into out[n, H, W, 3] RGB24. Returns 0 on success.
int vdec_get_batch(void* handle, const int64_t* indices, int n, uint8_t* out) {
  return get_batch_impl((Decoder*)handle, indices, n, false, out, nullptr,
                        nullptr);
}

// Same fetch, but returns the decoder's native limited-range BT.601 YUV420
// planes (y [n, H, W]; u, v [n, ceil(H/2), ceil(W/2)]) — 1.5 bytes/pixel
// instead of RGB24's 3, and no host-side swscale colorspace pass. The
// consumer runs chroma upsample + YUV->RGB on the accelerator
// (ops/preprocess.py). Sources that are not limited-range yuv420p are
// normalized to it in emit_frame.
int vdec_get_batch_yuv(void* handle, const int64_t* indices, int n,
                       uint8_t* y, uint8_t* u, uint8_t* v) {
  return get_batch_impl((Decoder*)handle, indices, n, true, y, u, v);
}

void vdec_close(void* handle) {
  Decoder* d = (Decoder*)handle;
  if (d->last_frame) av_frame_free(&d->last_frame);
  if (d->sws) sws_freeContext(d->sws);
  if (d->sws_yuv) sws_freeContext(d->sws_yuv);
  if (d->codec) avcodec_free_context(&d->codec);
  if (d->fmt) avformat_close_input(&d->fmt);
  delete d;
}

// ---- test-fixture writer ----------------------------------------------
// Writes n_frames solid-color frames (R=i%200+20, G=(i*7)%200+20,
// B=(i*13)%200+20) so tests can identify decoded frames by color.

int vdec_write_test_video(const char* path, int w, int h, int n_frames,
                          int fps, int gop) {
  av_log_set_level(AV_LOG_ERROR);
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 || !fmt)
    return -1;
  // Prefer H.264 (the dominant real-world codec; exercises B-frame reorder
  // and keyframe seeking); fall back to mpeg4.
  const AVCodec* enc = avcodec_find_encoder_by_name("libx264");
  if (!enc) enc = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!enc) return -2;
  AVStream* st = avformat_new_stream(fmt, nullptr);
  AVCodecContext* c = avcodec_alloc_context3(enc);
  c->width = w; c->height = h;
  c->time_base = {1, fps};
  c->framerate = {fps, 1};
  c->pix_fmt = AV_PIX_FMT_YUV420P;
  c->gop_size = gop;
  c->max_b_frames = 1;
  c->bit_rate = 2'000'000;
  if (std::string(enc->name) == "libx264") {
    av_opt_set(c->priv_data, "preset", "ultrafast", 0);
    av_opt_set(c->priv_data, "crf", "18", 0);
  }
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    c->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(c, enc, nullptr) < 0) return -3;
  avcodec_parameters_from_context(st->codecpar, c);
  st->time_base = c->time_base;
  if (!(fmt->oformat->flags & AVFMT_NOFILE))
    if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) return -4;
  if (avformat_write_header(fmt, nullptr) < 0) return -5;

  SwsContext* sws = sws_getContext(w, h, AV_PIX_FMT_RGB24, w, h,
                                   AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr,
                                   nullptr, nullptr);
  AVFrame* yuv = av_frame_alloc();
  yuv->format = AV_PIX_FMT_YUV420P; yuv->width = w; yuv->height = h;
  av_frame_get_buffer(yuv, 0);
  // +64: sws may overread the tight last row with SIMD loads.
  const size_t rgb_bytes = (size_t)w * h * 3;
  std::vector<uint8_t> rgb(rgb_bytes + 64);
  AVPacket* pkt = av_packet_alloc();

  auto flush_enc = [&](AVFrame* f) {
    avcodec_send_frame(c, f);
    while (avcodec_receive_packet(c, pkt) >= 0) {
      av_packet_rescale_ts(pkt, c->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(fmt, pkt);
      av_packet_unref(pkt);
    }
  };

  for (int i = 0; i < n_frames; ++i) {
    uint8_t r = (uint8_t)(i % 200 + 20), g = (uint8_t)((i * 7) % 200 + 20),
            b = (uint8_t)((i * 13) % 200 + 20);
    for (size_t p = 0; p < rgb_bytes; p += 3) {
      rgb[p] = r; rgb[p + 1] = g; rgb[p + 2] = b;
    }
    const uint8_t* src[1] = {rgb.data()};
    int src_ls[1] = {3 * w};
    av_frame_make_writable(yuv);
    sws_scale(sws, src, src_ls, 0, h, yuv->data, yuv->linesize);
    yuv->pts = i;
    flush_enc(yuv);
  }
  flush_enc(nullptr);  // drain

  av_write_trailer(fmt);
  sws_freeContext(sws);
  av_frame_free(&yuv);
  av_packet_free(&pkt);
  avcodec_free_context(&c);
  if (!(fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return 0;
}

}  // extern "C"

extern "C" {
// Debug/test helper: pts and keyframe flag of presentation index i.
int64_t vdec_frame_pts(void* handle, int i) {
  Decoder* d = (Decoder*)handle;
  if (i < 0 || i >= (int)d->index.size()) return -1;
  return d->index[i].pts;
}
int vdec_frame_key(void* handle, int i) {
  Decoder* d = (Decoder*)handle;
  if (i < 0 || i >= (int)d->index.size()) return -1;
  return d->index[i].keyframe ? 1 : 0;
}
}
