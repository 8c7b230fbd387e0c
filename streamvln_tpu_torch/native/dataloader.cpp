// The PyTorch port's native host runtime: threaded JPEG decode and a fused
// resize/normalize preprocessing, a copy of the JAX package's (the port
// imports nothing of that package), bound with ctypes from
// streamvln_tpu_torch/native/__init__.py and built at first use into
// streamvln_tpu_torch/_build/.
//
// Pipeline per image: read file / take bytes -> libjpeg decode ->
// PIL-equivalent separable bicubic resize (Keys a=-0.5, antialiased on
// downscale exactly like Pillow's convolution resampler) -> fused
// rescale(1/255) + normalize((x-0.5)/0.5) into float32 NHWC.
// A persistent thread pool processes batches outside the Python
// interpreter lock. No device stands behind it: it runs on the host.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <setjmp.h>

namespace {

// ---------------------------------------------------------------------
// Thread pool
// ---------------------------------------------------------------------
class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    if (n <= 0) n = (int)std::thread::hardware_concurrency();
    if (n <= 0) n = 1;
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
        }
      });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

ThreadPool* pool() {
  static ThreadPool p(0);
  return &p;
}

// ---------------------------------------------------------------------
// JPEG decode (libjpeg) with error-recovery longjmp
// ---------------------------------------------------------------------
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Decode JPEG bytes to RGB8. Returns 0 on success.
int decode_jpeg_rgb(const uint8_t* data, size_t len, uint8_t** out,
                    int* width, int* height) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  uint8_t* buf = nullptr;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    free(buf);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int w = cinfo.output_width, h = cinfo.output_height;
  buf = (uint8_t*)malloc((size_t)w * h * 3);
  while ((int)cinfo.output_scanline < h) {
    uint8_t* row = buf + (size_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out = buf;
  *width = w;
  *height = h;
  return 0;
}

// ---------------------------------------------------------------------
// PIL-equivalent bicubic resampling (Keys kernel a = -0.5, antialiased
// on downscale: kernel stretched by the scale factor, like Pillow's
// ImagingResample)
// ---------------------------------------------------------------------
inline double cubic_filter(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct ResampleCoeffs {
  std::vector<int> bounds;      // [out_size * 2]: (xmin, count)
  std::vector<double> weights;  // [out_size * ksize]
  int ksize;
};

ResampleCoeffs precompute_coeffs(int in_size, int out_size) {
  double scale = (double)in_size / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 2.0 * filterscale;  // bicubic support = 2
  int ksize = (int)std::ceil(support) * 2 + 1;

  ResampleCoeffs rc;
  rc.ksize = ksize;
  rc.bounds.resize((size_t)out_size * 2);
  rc.weights.assign((size_t)out_size * ksize, 0.0);

  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    int count = xmax - xmin;
    double* w = &rc.weights[(size_t)xx * ksize];
    double wsum = 0.0;
    for (int i = 0; i < count; ++i) {
      double weight =
          cubic_filter((xmin + i - center + 0.5) / filterscale);
      w[i] = weight;
      wsum += weight;
    }
    if (wsum != 0.0)
      for (int i = 0; i < count; ++i) w[i] /= wsum;
    rc.bounds[(size_t)xx * 2] = xmin;
    rc.bounds[(size_t)xx * 2 + 1] = count;
  }
  return rc;
}

// Resize u8 HWC3 -> f64 work buffers -> normalized f32 HWC3.
void resize_normalize(const uint8_t* src, int in_h, int in_w,
                      float* dst, int out_h, int out_w,
                      float mean, float stddev) {
  ResampleCoeffs hc = precompute_coeffs(in_w, out_w);
  ResampleCoeffs vc = precompute_coeffs(in_h, out_h);

  // horizontal pass: [in_h, out_w, 3] doubles
  std::vector<double> tmp((size_t)in_h * out_w * 3);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = src + (size_t)y * in_w * 3;
    double* trow = &tmp[(size_t)y * out_w * 3];
    for (int x = 0; x < out_w; ++x) {
      int xmin = hc.bounds[(size_t)x * 2];
      int count = hc.bounds[(size_t)x * 2 + 1];
      const double* w = &hc.weights[(size_t)x * hc.ksize];
      double acc0 = 0, acc1 = 0, acc2 = 0;
      for (int i = 0; i < count; ++i) {
        const uint8_t* px = row + (size_t)(xmin + i) * 3;
        acc0 += px[0] * w[i];
        acc1 += px[1] * w[i];
        acc2 += px[2] * w[i];
      }
      // PIL's two-pass resampler stores the horizontal pass as
      // clipped+rounded uint8; mirror it for parity
      auto q8 = [](double v) {
        v = v < 0.0 ? 0.0 : (v > 255.0 ? 255.0 : v);
        return std::floor(v + 0.5);
      };
      trow[(size_t)x * 3 + 0] = q8(acc0);
      trow[(size_t)x * 3 + 1] = q8(acc1);
      trow[(size_t)x * 3 + 2] = q8(acc2);
    }
  }
  // vertical pass + fused normalize
  const double inv = 1.0 / 255.0;
  for (int y = 0; y < out_h; ++y) {
    int ymin = vc.bounds[(size_t)y * 2];
    int count = vc.bounds[(size_t)y * 2 + 1];
    const double* w = &vc.weights[(size_t)y * vc.ksize];
    float* drow = dst + (size_t)y * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      double acc0 = 0, acc1 = 0, acc2 = 0;
      for (int i = 0; i < count; ++i) {
        const double* px =
            &tmp[((size_t)(ymin + i) * out_w + x) * 3];
        acc0 += px[0] * w[i];
        acc1 += px[1] * w[i];
        acc2 += px[2] * w[i];
      }
      // clip bicubic overshoot to the u8 range like PIL before
      // rescale+normalize (parity with the reference preprocessing)
      auto clip = [](double v) {
        return v < 0.0 ? 0.0 : (v > 255.0 ? 255.0 : v);
      };
      drow[(size_t)x * 3 + 0] =
          (float)(((clip(acc0) * inv) - mean) / stddev);
      drow[(size_t)x * 3 + 1] =
          (float)(((clip(acc1) * inv) - mean) / stddev);
      drow[(size_t)x * 3 + 2] =
          (float)(((clip(acc2) * inv) - mean) / stddev);
    }
  }
}

// Resize u8 HWC3 -> u8 HWC3 (PIL-exact: both passes round to u8).
void resize_u8(const uint8_t* src, int in_h, int in_w, uint8_t* dst,
               int out_h, int out_w) {
  ResampleCoeffs hc = precompute_coeffs(in_w, out_w);
  ResampleCoeffs vc = precompute_coeffs(in_h, out_h);
  auto q8 = [](double v) {
    v = v < 0.0 ? 0.0 : (v > 255.0 ? 255.0 : v);
    return (uint8_t)std::floor(v + 0.5);
  };
  std::vector<double> tmp((size_t)in_h * out_w * 3);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = src + (size_t)y * in_w * 3;
    double* trow = &tmp[(size_t)y * out_w * 3];
    for (int x = 0; x < out_w; ++x) {
      int xmin = hc.bounds[(size_t)x * 2];
      int count = hc.bounds[(size_t)x * 2 + 1];
      const double* w = &hc.weights[(size_t)x * hc.ksize];
      double acc0 = 0, acc1 = 0, acc2 = 0;
      for (int i = 0; i < count; ++i) {
        const uint8_t* px = row + (size_t)(xmin + i) * 3;
        acc0 += px[0] * w[i];
        acc1 += px[1] * w[i];
        acc2 += px[2] * w[i];
      }
      trow[(size_t)x * 3 + 0] = (double)q8(acc0);
      trow[(size_t)x * 3 + 1] = (double)q8(acc1);
      trow[(size_t)x * 3 + 2] = (double)q8(acc2);
    }
  }
  for (int y = 0; y < out_h; ++y) {
    int ymin = vc.bounds[(size_t)y * 2];
    int count = vc.bounds[(size_t)y * 2 + 1];
    const double* w = &vc.weights[(size_t)y * vc.ksize];
    uint8_t* drow = dst + (size_t)y * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      double acc0 = 0, acc1 = 0, acc2 = 0;
      for (int i = 0; i < count; ++i) {
        const double* px = &tmp[((size_t)(ymin + i) * out_w + x) * 3];
        acc0 += px[0] * w[i];
        acc1 += px[1] * w[i];
        acc2 += px[2] * w[i];
      }
      drow[(size_t)x * 3 + 0] = q8(acc0);
      drow[(size_t)x * 3 + 1] = q8(acc1);
      drow[(size_t)x * 3 + 2] = q8(acc2);
    }
  }
}

struct Counter {
  std::mutex mu;
  std::condition_variable cv;
  int remaining;
};

}  // namespace

extern "C" {

// Preprocess a batch of raw RGB frames (u8, same H/W) into normalized
// f32 [n, out, out, 3]. Returns 0 on success.
int svt_preprocess_batch(const uint8_t* frames, int n, int in_h,
                         int in_w, float* out, int out_size,
                         float mean, float stddev) {
  Counter done{.remaining = n};
  std::atomic<int> failed{0};
  for (int i = 0; i < n; ++i) {
    pool()->submit([&, i] {
      resize_normalize(frames + (size_t)i * in_h * in_w * 3, in_h,
                       in_w,
                       out + (size_t)i * out_size * out_size * 3,
                       out_size, out_size, mean, stddev);
      std::lock_guard<std::mutex> lk(done.mu);
      if (--done.remaining == 0) done.cv.notify_one();
    });
  }
  std::unique_lock<std::mutex> lk(done.mu);
  done.cv.wait(lk, [&] { return done.remaining == 0; });
  return failed.load();
}

// Resize a batch of raw RGB frames to u8 [n, out, out, 3] without
// normalizing — the light half of preprocessing for hosts that want
// to ship compact uint8 to the device (device applies the normalize
// affine; ops/preprocess.py skips its resize for pre-sized input).
int svt_resize_batch_u8(const uint8_t* frames, int n, int in_h,
                        int in_w, uint8_t* out, int out_size) {
  Counter done{.remaining = n};
  for (int i = 0; i < n; ++i) {
    pool()->submit([&, i] {
      resize_u8(frames + (size_t)i * in_h * in_w * 3, in_h, in_w,
                out + (size_t)i * out_size * out_size * 3, out_size,
                out_size);
      std::lock_guard<std::mutex> lk(done.mu);
      if (--done.remaining == 0) done.cv.notify_one();
    });
  }
  std::unique_lock<std::mutex> lk(done.mu);
  done.cv.wait(lk, [&] { return done.remaining == 0; });
  return 0;
}

// Load + decode + preprocess a batch of JPEG files into f32
// [n, out, out, 3]. paths: array of C strings. Returns count of
// failures (0 = all good).
int svt_load_preprocess_jpegs(const char** paths, int n, float* out,
                              int out_size, float mean, float stddev) {
  Counter done{.remaining = n};
  std::atomic<int> failed{0};
  for (int i = 0; i < n; ++i) {
    pool()->submit([&, i] {
      FILE* f = fopen(paths[i], "rb");
      uint8_t* rgb = nullptr;
      do {
        if (!f) {
          failed++;
          break;
        }
        fseek(f, 0, SEEK_END);
        long len = ftell(f);
        fseek(f, 0, SEEK_SET);
        std::vector<uint8_t> bytes((size_t)len);
        if (fread(bytes.data(), 1, (size_t)len, f) != (size_t)len) {
          failed++;
          break;
        }
        int w = 0, h = 0;
        if (decode_jpeg_rgb(bytes.data(), bytes.size(), &rgb, &w,
                            &h) != 0) {
          failed++;
          break;
        }
        resize_normalize(rgb, h, w,
                         out + (size_t)i * out_size * out_size * 3,
                         out_size, out_size, mean, stddev);
      } while (false);
      if (f) fclose(f);
      free(rgb);
      std::lock_guard<std::mutex> lk(done.mu);
      if (--done.remaining == 0) done.cv.notify_one();
    });
  }
  std::unique_lock<std::mutex> lk(done.mu);
  done.cv.wait(lk, [&] { return done.remaining == 0; });
  return failed.load();
}

// Decode one JPEG (for tests / staging). Caller provides the output
// buffer sized via svt_jpeg_dims. Returns 0 on success.
int svt_jpeg_dims(const uint8_t* data, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  *w = (int)cinfo.image_width;
  *h = (int)cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int svt_decode_jpeg(const uint8_t* data, size_t len, uint8_t* out,
                    int expect_w, int expect_h) {
  uint8_t* buf = nullptr;
  int w = 0, h = 0;
  if (decode_jpeg_rgb(data, len, &buf, &w, &h) != 0) return -1;
  if (w != expect_w || h != expect_h) {
    free(buf);
    return -2;
  }
  memcpy(out, buf, (size_t)w * h * 3);
  free(buf);
  return 0;
}

}  // extern "C"
