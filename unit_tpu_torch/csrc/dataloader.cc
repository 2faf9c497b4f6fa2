// The port's host loader: JPEG decode, bilinear resize and BGR-float canvas
// fill in C++, one image or a batch, with the GIL released by the ctypes
// caller (unit_tpu_torch/data/native.py).  The stream, test and serving
// loaders hand it a file path or request bytes and get the canvas the model
// eats; a batch is decoded and resized in a std::thread pool.
//
// Host code for g++, built at first use with
//   g++ -O3 -fPIC -std=c++17 -Wall -pthread -shared dataloader.cc -ljpeg
// and nothing more: a -march, -ffast-math or -ffp-contract change would move
// the f32 arithmetic of ResizeToCanvas off unit_tpu's native/dataloader.cc,
// which this file equals bit for bit (tests/test_torch_native.py).
//
// Without <jpeglib.h> (or with UNIT_LOADER_NO_LIBJPEG defined) the decode
// entry points are left out and the library is linked without -ljpeg; the
// caller then decodes with PIL and fills the canvas through prepare_rgb,
// which runs the same resize.
//
// C ABI:
//   has_libjpeg()                                       -> 1 or 0
//   prepare_rgb(rgb, h, w, min_size, max_size, canvas_h, canvas_w, flip,
//               out_image, out_size, out_scale)          -> 0
// and with libjpeg:
//   decode_image_size(path, &h, &w)                     -> 0 on success
//   decode_image_size_mem(data, len, &h, &w)            -> 0 on success
//   prepare_image(path, min_size, max_size, canvas_h, canvas_w, flip,
//                 out_image, out_size, out_scale)       -> 0 on success
//   prepare_image_mem(data, len, ..., out_orig)         -> 0 on success
//   prepare_batch(paths, n, min_size, max_size, canvas_h, canvas_w,
//                 out_images, out_sizes, out_scales, n_threads) -> #errors

#include <cstddef>
#include <cstdio>

#if __has_include(<jpeglib.h>) && !defined(UNIT_LOADER_NO_LIBJPEG)
#define UNIT_LOADER_LIBJPEG 1
#include <jpeglib.h>
#else
#define UNIT_LOADER_LIBJPEG 0
#endif

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstring>
#include <thread>
#include <vector>

namespace {

#if UNIT_LOADER_LIBJPEG
struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// The scanline loop once a source manager is attached (the caller's setjmp
// catches a failure).
bool ReadJpegRows(jpeg_decompress_struct* cinfo,
                  std::vector<unsigned char>* out, int* h, int* w) {
  jpeg_read_header(cinfo, TRUE);
  cinfo->out_color_space = JCS_RGB;
  jpeg_start_decompress(cinfo);
  *w = cinfo->output_width;
  *h = cinfo->output_height;
  out->resize(static_cast<size_t>(*h) * (*w) * 3);
  while (cinfo->output_scanline < cinfo->output_height) {
    unsigned char* row = out->data() +
                         static_cast<size_t>(cinfo->output_scanline) * (*w) * 3;
    jpeg_read_scanlines(cinfo, &row, 1);
  }
  jpeg_finish_decompress(cinfo);
  return true;
}

// A JPEG file -> interleaved RGB uint8; false on failure.
bool DecodeJpeg(const char* path, std::vector<unsigned char>* out, int* h,
                int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  bool ok = ReadJpegRows(&cinfo, out, h, w);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return ok;
}

// An in-memory JPEG (a request's bytes, which never touch disk) -> RGB
// uint8; false on failure.
bool DecodeJpegMem(const unsigned char* data, size_t len,
                   std::vector<unsigned char>* out, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  bool ok = ReadJpegRows(&cinfo, out, h, w);
  jpeg_destroy_decompress(&cinfo);
  return ok;
}
#endif  // UNIT_LOADER_LIBJPEG

// Half-pixel bilinear resize of RGB uint8 into the top-left nh x nw of a
// (canvas_h, canvas_w, 3) BGR float32 canvas, in f32; ``flip`` mirrors the
// resized region (the Python path's img[:, ::-1] after the resize, before
// the pad).
void ResizeToCanvas(const unsigned char* src, int sh, int sw, float* canvas,
                    int canvas_h, int canvas_w, int nh, int nw,
                    bool flip = false) {
  const float sy = static_cast<float>(sh) / nh;
  const float sx = static_cast<float>(sw) / nw;
  for (int y = 0; y < nh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    fy = std::max(fy, 0.0f);
    int y0 = static_cast<int>(fy);
    y0 = std::min(y0, sh - 1);
    int y1 = std::min(y0 + 1, sh - 1);
    float wy = fy - y0;
    float* dst_row = canvas + static_cast<size_t>(y) * canvas_w * 3;
    const unsigned char* r0 = src + static_cast<size_t>(y0) * sw * 3;
    const unsigned char* r1 = src + static_cast<size_t>(y1) * sw * 3;
    for (int x = 0; x < nw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      fx = std::max(fx, 0.0f);
      int x0 = static_cast<int>(fx);
      x0 = std::min(x0, sw - 1);
      int x1 = std::min(x0 + 1, sw - 1);
      float wx = fx - x0;
      const int dx = flip ? (nw - 1 - x) : x;
      for (int c = 0; c < 3; ++c) {
        float top = r0[x0 * 3 + c] * (1 - wx) + r0[x1 * 3 + c] * wx;
        float bot = r1[x0 * 3 + c] * (1 - wx) + r1[x1 * 3 + c] * wx;
        // RGB -> BGR (INPUT.FORMAT=BGR, caffe-style pixel means)
        dst_row[dx * 3 + (2 - c)] = top * (1 - wy) + bot * wy;
      }
    }
  }
}

// The resized dims of data/transforms.py::resize_shortest_edge: a double
// scale and round half to even (Python's round()), clamped to the canvas.
void ResizedDims(int h, int w, int min_size, int max_size, int canvas_h,
                 int canvas_w, int* nh, int* nw, float* scale_out) {
  double scale = static_cast<double>(min_size) / std::min(h, w);
  if (std::max(h, w) * scale > max_size) {
    scale = static_cast<double>(max_size) / std::max(h, w);
  }
  *nh = std::max(std::min(static_cast<int>(std::nearbyint(h * scale)), canvas_h), 1);
  *nw = std::max(std::min(static_cast<int>(std::nearbyint(w * scale)), canvas_w), 1);
  *scale_out = static_cast<float>(scale);
}

// Zero the canvas, resize ``rgb`` into it and report (nh, nw) and the scale.
void FillCanvas(const unsigned char* rgb, int h, int w, int min_size,
                int max_size, int canvas_h, int canvas_w, bool flip,
                float* out_image, float* out_size, float* out_scale) {
  std::memset(out_image, 0,
              static_cast<size_t>(canvas_h) * canvas_w * 3 * sizeof(float));
  float scale;
  int nh, nw;
  ResizedDims(h, w, min_size, max_size, canvas_h, canvas_w, &nh, &nw, &scale);
  ResizeToCanvas(rgb, h, w, out_image, canvas_h, canvas_w, nh, nw, flip);
  out_size[0] = static_cast<float>(nh);
  out_size[1] = static_cast<float>(nw);
  out_scale[0] = scale;
}

#if UNIT_LOADER_LIBJPEG
// A failed decode leaves a zero canvas, size (0, 0) and scale 1.
void FailedCanvas(int canvas_h, int canvas_w, float* out_image,
                  float* out_size, float* out_scale) {
  std::memset(out_image, 0,
              static_cast<size_t>(canvas_h) * canvas_w * 3 * sizeof(float));
  out_size[0] = out_size[1] = 0;
  out_scale[0] = 1.0f;
}
#endif

}  // namespace

extern "C" {

int has_libjpeg() { return UNIT_LOADER_LIBJPEG; }

// An image decoded elsewhere (PIL, where the host has no libjpeg): RGB uint8
// [h, w, 3] -> the canvas, as prepare_image fills it.
int prepare_rgb(const unsigned char* rgb, int h, int w, int min_size,
                int max_size, int canvas_h, int canvas_w, int flip,
                float* out_image, float* out_size, float* out_scale) {
  FillCanvas(rgb, h, w, min_size, max_size, canvas_h, canvas_w, flip != 0,
             out_image, out_size, out_scale);
  return 0;
}

#if UNIT_LOADER_LIBJPEG
int decode_image_size(const char* path, int* h, int* w) {
  std::vector<unsigned char> buf;
  return DecodeJpeg(path, &buf, h, w) ? 0 : 1;
}

// Header-only dims of an in-memory JPEG: the server picks the portrait or
// landscape canvas with it before prepare_image_mem.
int decode_image_size_mem(const unsigned char* data, long len, int* h,
                          int* w) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// One image's full prep for the training and test streams: its own
// min_size (a training stream draws one a record) and an optional flip.
// out_image [canvas_h, canvas_w, 3] float32, out_size [2], out_scale [1].
int prepare_image(const char* path, int min_size, int max_size, int canvas_h,
                  int canvas_w, int flip, float* out_image, float* out_size,
                  float* out_scale) {
  std::vector<unsigned char> rgb;
  int h = 0, w = 0;
  if (!DecodeJpeg(path, &rgb, &h, &w)) {
    FailedCanvas(canvas_h, canvas_w, out_image, out_size, out_scale);
    return 1;
  }
  FillCanvas(rgb.data(), h, w, min_size, max_size, canvas_h, canvas_w,
             flip != 0, out_image, out_size, out_scale);
  return 0;
}

// prepare_image on a request's bytes; also reports the original dims
// (out_orig [2] = h, w), which map the boxes back to the client's frame.
int prepare_image_mem(const unsigned char* data, long len, int min_size,
                      int max_size, int canvas_h, int canvas_w, int flip,
                      float* out_image, float* out_size, float* out_scale,
                      float* out_orig) {
  std::vector<unsigned char> rgb;
  int h = 0, w = 0;
  if (!DecodeJpegMem(data, static_cast<size_t>(len), &rgb, &h, &w)) {
    FailedCanvas(canvas_h, canvas_w, out_image, out_size, out_scale);
    out_orig[0] = out_orig[1] = 0;
    return 1;
  }
  FillCanvas(rgb.data(), h, w, min_size, max_size, canvas_h, canvas_w,
             flip != 0, out_image, out_size, out_scale);
  out_orig[0] = static_cast<float>(h);
  out_orig[1] = static_cast<float>(w);
  return 0;
}

// n images on n_threads threads.  out_images [n, canvas_h, canvas_w, 3]
// float32, out_sizes [n, 2] (new_h, new_w), out_scales [n].
int prepare_batch(const char** paths, int n, int min_size, int max_size,
                  int canvas_h, int canvas_w, float* out_images,
                  float* out_sizes, float* out_scales, int n_threads) {
  std::atomic<int> errors{0};
  std::atomic<int> next{0};
  const size_t img_stride = static_cast<size_t>(canvas_h) * canvas_w * 3;

  auto worker = [&]() {
    std::vector<unsigned char> rgb;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int h = 0, w = 0;
      float* canvas = out_images + i * img_stride;
      if (!DecodeJpeg(paths[i], &rgb, &h, &w)) {
        errors.fetch_add(1);
        FailedCanvas(canvas_h, canvas_w, canvas, out_sizes + i * 2,
                     out_scales + i);
        continue;
      }
      FillCanvas(rgb.data(), h, w, min_size, max_size, canvas_h, canvas_w,
                 false, canvas, out_sizes + i * 2, out_scales + i);
    }
  };

  int threads = std::max(1, std::min(n_threads, n));
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return errors.load();
}
#endif  // UNIT_LOADER_LIBJPEG

}  // extern "C"
