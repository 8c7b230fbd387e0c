// The PyTorch port's native video decode: mp4/mkv/avi container demux +
// codec decode + RGB24 conversion via the system libav* (ffmpeg)
// libraries, a copy of the JAX package's, bound with ctypes from
// streamvln_tpu_torch/native/__init__.py. Built as its own shared object
// so hosts without libav dev files still get the JPEG/preprocess library.
//
// Two-pass design, matching decord's semantics:
//   pass 1 (svt_video_info)        count frames + fps (container
//                                  nb_frames hint when present, else a
//                                  demux-only packet count)
//   pass 2 (svt_video_read_frames) sequential decode, keeping only the
//                                  requested frame indices, sws_scale
//                                  to RGB24 at native resolution
// Sequential decode avoids keyframe-seek inaccuracy entirely; sampling
// N<=64 frames from co-training clips is demux-bound, not decode-bound.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

namespace {

struct Reader {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  int stream_index = -1;

  ~Reader() {
    if (codec) avcodec_free_context(&codec);
    if (fmt) avformat_close_input(&fmt);
  }

  int open(const char* path, bool need_decoder) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0)
      return -1;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return -2;
    stream_index = av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                       nullptr, 0);
    if (stream_index < 0) return -3;
    if (!need_decoder) return 0;
    AVStream* st = fmt->streams[stream_index];
    const AVCodec* dec = avcodec_find_decoder(st->codecpar->codec_id);
    if (!dec) return -4;
    codec = avcodec_alloc_context3(dec);
    if (!codec ||
        avcodec_parameters_to_context(codec, st->codecpar) < 0)
      return -5;
    codec->thread_count = 0;  // auto (PyAV's thread_type AUTO)
    if (avcodec_open2(codec, dec, nullptr) < 0) return -6;
    return 0;
  }

  AVStream* stream() { return fmt->streams[stream_index]; }
};

// Demux-only packet count for containers that don't record nb_frames.
int64_t count_packets(const char* path) {
  Reader r;
  if (r.open(path, /*need_decoder=*/false) != 0) return -1;
  AVPacket* pkt = av_packet_alloc();
  int64_t n = 0;
  while (av_read_frame(r.fmt, pkt) >= 0) {
    if (pkt->stream_index == r.stream_index) ++n;
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  return n;
}

}  // namespace

extern "C" {

// Probe a video file. Returns 0 on success and fills width/height/fps/
// frame count (exact when the container records it, else demux count).
int svt_video_info(const char* path, int* w, int* h, double* fps,
                   int64_t* n_frames) {
  Reader r;
  int rc = r.open(path, /*need_decoder=*/false);
  if (rc != 0) return rc;
  AVStream* st = r.stream();
  *w = st->codecpar->width;
  *h = st->codecpar->height;
  AVRational fr = st->avg_frame_rate.num > 0 ? st->avg_frame_rate
                                             : st->r_frame_rate;
  *fps = fr.den > 0 ? (double)fr.num / fr.den : 0.0;
  int64_t n = st->nb_frames;
  if (n <= 0) n = count_packets(path);
  if (n <= 0) return -7;
  *n_frames = n;
  return 0;
}

// Decode the frames at `wanted` (ascending, deduped by caller) into
// out[n][h][w][3] RGB24 u8 at the stream's native resolution.
// Returns the number of frames actually written (== n_wanted on
// success; fewer if the stream ends early).
int svt_video_read_frames(const char* path, const int64_t* wanted,
                          int n_wanted, uint8_t* out, int out_w,
                          int out_h) {
  if (n_wanted <= 0) return 0;
  Reader r;
  if (r.open(path, /*need_decoder=*/true) != 0) return -1;

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  SwsContext* sws = nullptr;
  int64_t decoded = 0;
  int written = 0;
  const size_t frame_bytes = (size_t)out_w * out_h * 3;

  auto take = [&](AVFrame* f) {
    while (written < n_wanted && wanted[written] == decoded) {
      if (!sws) {
        sws = sws_getContext(f->width, f->height,
                             (AVPixelFormat)f->format, out_w, out_h,
                             AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                             nullptr, nullptr);
      }
      uint8_t* dst[1] = {out + (size_t)written * frame_bytes};
      int dst_stride[1] = {out_w * 3};
      sws_scale(sws, f->data, f->linesize, 0, f->height, dst,
                dst_stride);
      ++written;
    }
    ++decoded;
  };

  bool done = false;
  while (!done && av_read_frame(r.fmt, pkt) >= 0) {
    if (pkt->stream_index == r.stream_index &&
        avcodec_send_packet(r.codec, pkt) >= 0) {
      while (avcodec_receive_frame(r.codec, frame) >= 0) {
        take(frame);
        if (written >= n_wanted) { done = true; break; }
      }
    }
    av_packet_unref(pkt);
  }
  if (!done) {  // flush delayed frames
    avcodec_send_packet(r.codec, nullptr);
    while (avcodec_receive_frame(r.codec, frame) >= 0) {
      take(frame);
      if (written >= n_wanted) break;
    }
  }

  if (sws) sws_freeContext(sws);
  av_frame_free(&frame);
  av_packet_free(&pkt);
  return written;
}

}  // extern "C"
