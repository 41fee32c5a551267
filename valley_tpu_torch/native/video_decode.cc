// Native video decode + preprocess for the input pipeline.
//
// Replaces the reference's decord C++ decoder + python transform chain
// (`valley/util/data_util.py:249-282`) with one pass: demux (libavformat),
// decode (libavcodec), uniform frame sampling, shorter-side resize
// (swscale bilinear), center crop, and CLIP normalization straight into a
// caller-provided float32 (3, T, crop, crop) buffer — no intermediate
// uint8 numpy hops on the host hot path.
//
// C ABI only; loaded from python via ctypes (valley_tpu_torch/native/__init__.py).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <cmath>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct VideoReader {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  int stream_index = -1;

  ~VideoReader() {
    if (codec) avcodec_free_context(&codec);
    if (fmt) avformat_close_input(&fmt);
  }

  int open(const char* path) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return -2;
    const AVCodec* dec = nullptr;
    stream_index =
        av_find_best_stream(fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
    if (stream_index < 0 || !dec) return -3;
    codec = avcodec_alloc_context3(dec);
    if (!codec) return -4;
    if (avcodec_parameters_to_context(
            codec, fmt->streams[stream_index]->codecpar) < 0)
      return -5;
    codec->thread_count = 1;  // one-decoder-per-worker model, like decord
    if (avcodec_open2(codec, dec, nullptr) < 0) return -6;
    return 0;
  }

  double fps() const {
    AVRational r = fmt->streams[stream_index]->avg_frame_rate;
    if (r.num <= 0 || r.den <= 0) return 30.0;
    return av_q2d(r);
  }

  // Best-effort frame count: container metadata, else duration * fps.
  long frame_count() const {
    AVStream* st = fmt->streams[stream_index];
    if (st->nb_frames > 0) return st->nb_frames;
    if (st->duration > 0)
      return (long)std::llround(st->duration * av_q2d(st->time_base) *
                                fps());
    if (fmt->duration > 0)
      return (long)std::llround((double)fmt->duration / AV_TIME_BASE *
                                fps());
    return 0;
  }
};

// Resize geometry: shorter side -> scale_size, aspect preserved
// (`video_transform.Resize` semantics).
void resize_dims(int w, int h, int scale_size, int* ow, int* oh) {
  if (w < h) {
    *ow = scale_size;
    *oh = (int)std::lround((double)scale_size * h / w);
  } else {
    *oh = scale_size;
    *ow = (int)std::lround((double)scale_size * w / h);
  }
}

}  // namespace

// Shared decode+resize+crop loop.  Exactly one of outf / outu is set:
// outf -> CLIP-normalized fp32 (the original path), outu -> raw uint8
// pixels (serving ships 1 byte/pixel over the host->device link and
// normalizes on device — see valley_tpu_torch/models/valley.py encode_images).
static int decode_impl(const char* path, int frame_mode, int num_frames,
                       double fps_number, int scale_size, int crop_size,
                       const float* mean3, const float* std3, float* outf,
                       uint8_t* outu, int* out_frames, int max_frames) {
  VideoReader vr;
  int rc = vr.open(path);
  if (rc != 0) return rc;

  long total = vr.frame_count();
  if (total <= 0) total = 1;

  // Wanted frame indices.
  std::vector<long> want;
  if (frame_mode == 0) {
    if (num_frames <= 0 || num_frames > max_frames) return -7;
    for (int i = 0; i < num_frames; ++i) {
      double pos = (num_frames == 1)
                       ? 0.0
                       : (double)i * (double)(total - 1) / (num_frames - 1);
      want.push_back((long)pos);  // trunc matches np.linspace().astype(int)
    }
  } else {
    long stride = std::max(1L, (long)std::lround(vr.fps()) /
                                   std::max(1L, (long)fps_number));
    if (fps_number > 0 && fps_number < 1)
      stride = (long)(std::lround(vr.fps()) / fps_number);
    for (long i = 0; i < total && (long)want.size() < max_frames;
         i += stride)
      want.push_back(i);
  }
  if (want.empty()) return -8;

  int rw = 0, rh = 0;
  resize_dims(vr.codec->width, vr.codec->height, scale_size, &rw, &rh);
  if (crop_size > rw || crop_size > rh) return -9;
  const int x0 = (int)std::lround((rh - crop_size) / 2.0);
  const int y0 = (int)std::lround((rw - crop_size) / 2.0);

  SwsContext* sws = sws_getContext(
      vr.codec->width, vr.codec->height, vr.codec->pix_fmt, rw, rh,
      AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr, nullptr);
  if (!sws) return -10;

  std::vector<uint8_t> rgb((size_t)rw * rh * 3);
  uint8_t* dst_data[4] = {rgb.data(), nullptr, nullptr, nullptr};
  int dst_linesize[4] = {rw * 3, 0, 0, 0};

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();

  const int T = (int)want.size();
  const size_t plane = (size_t)T * crop_size * crop_size;
  auto emit = [&](int t_slot) {
    // rgb (rh, rw, 3) -> out[c][t][y][x], crop window.
    for (int c = 0; c < 3; ++c) {
      const float inv_std = outf ? 1.0f / std3[c] : 0.0f;
      const float m = outf ? mean3[c] : 0.0f;
      const size_t base =
          (size_t)c * plane + (size_t)t_slot * crop_size * crop_size;
      for (int y = 0; y < crop_size; ++y) {
        const uint8_t* row = rgb.data() + ((size_t)(x0 + y) * rw + y0) * 3;
        if (outf) {
          float* dst = outf + base + (size_t)y * crop_size;
          for (int x = 0; x < crop_size; ++x) {
            dst[x] = ((float)row[(size_t)x * 3 + c] / 255.0f - m) * inv_std;
          }
        } else {
          uint8_t* dst = outu + base + (size_t)y * crop_size;
          for (int x = 0; x < crop_size; ++x) {
            dst[x] = row[(size_t)x * 3 + c];
          }
        }
      }
    }
  };

  long pos = 0;   // decode position
  size_t wi = 0;  // next wanted index
  int written = 0;
  int err = 0;
  bool done = false;
  int last_written_slot = -1;

  auto handle_frame = [&]() {
    bool wanted = false;
    while (wi < want.size() && want[wi] == pos) {
      wanted = true;
      ++wi;
    }
    if (wanted) {
      sws_scale(sws, frame->data, frame->linesize, 0, vr.codec->height,
                dst_data, dst_linesize);
      // every wanted index equal to this pos gets this frame
      size_t start = wi;
      // count how many slots consumed at this pos: recompute
      // (slots were advanced above; fill them all with the same frame)
      // We know slots [first..wi-1] had index == pos.
      // Find first slot with index == pos:
      size_t first = wi;
      while (first > 0 && want[first - 1] == pos) --first;
      for (size_t s = first; s < wi; ++s) {
        emit((int)s);
        last_written_slot = (int)s;
        ++written;
      }
      (void)start;
    }
    ++pos;
    if (wi >= want.size()) done = true;
  };

  while (!done && av_read_frame(vr.fmt, pkt) >= 0) {
    if (pkt->stream_index == vr.stream_index) {
      if (avcodec_send_packet(vr.codec, pkt) == 0) {
        while (avcodec_receive_frame(vr.codec, frame) == 0 && !done)
          handle_frame();
      }
    }
    av_packet_unref(pkt);
  }
  // flush decoder
  if (!done && avcodec_send_packet(vr.codec, nullptr) == 0) {
    while (avcodec_receive_frame(vr.codec, frame) == 0 && !done)
      handle_frame();
  }

  // Metadata overestimated the frame count: fill remaining wanted slots
  // with the last decoded frame (cv2-path parity).
  if (last_written_slot >= 0) {
    for (size_t s = wi; s < want.size(); ++s) {
      for (int c = 0; c < 3; ++c) {
        const size_t src_off = (size_t)c * plane +
            (size_t)last_written_slot * crop_size * crop_size;
        const size_t dst_off =
            (size_t)c * plane + (size_t)s * crop_size * crop_size;
        const size_t n = (size_t)crop_size * crop_size;
        if (outf)
          std::memcpy(outf + dst_off, outf + src_off, sizeof(float) * n);
        else
          std::memcpy(outu + dst_off, outu + src_off, n);
      }
      ++written;
    }
  } else {
    err = -11;  // nothing decoded at all
  }

  av_frame_free(&frame);
  av_packet_free(&pkt);
  sws_freeContext(sws);
  *out_frames = (err == 0) ? T : 0;
  return err;
}

extern "C" {

// Returns 0 on success.  out must hold 3 * max_frames * crop * crop floats.
// frame_mode: 0 = fixed (num_frames uniform via linspace), 1 = fps
// (stride round(fps)/fps_number).  *out_frames receives the number of
// frames written (always num_frames for fixed mode).
int valley_decode_video(const char* path, int frame_mode, int num_frames,
                        double fps_number, int scale_size, int crop_size,
                        const float* mean3, const float* std3, float* out,
                        int* out_frames, int max_frames) {
  return decode_impl(path, frame_mode, num_frames, fps_number, scale_size,
                     crop_size, mean3, std3, out, nullptr, out_frames,
                     max_frames);
}

// Raw-pixel variant: out holds 3 * max_frames * crop * crop uint8 —
// un-normalized resized/cropped RGB planes (device-side normalization).
int valley_decode_video_raw(const char* path, int frame_mode,
                            int num_frames, double fps_number,
                            int scale_size, int crop_size, uint8_t* out,
                            int* out_frames, int max_frames) {
  return decode_impl(path, frame_mode, num_frames, fps_number, scale_size,
                     crop_size, nullptr, nullptr, nullptr, out, out_frames,
                     max_frames);
}

int valley_video_info(const char* path, long* num_frames, double* fps) {
  VideoReader vr;
  int rc = vr.open(path);
  if (rc != 0) return rc;
  *num_frames = vr.frame_count();
  *fps = vr.fps();
  return 0;
}

}  // extern "C"
