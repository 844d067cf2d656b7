// cxloader — native multithreaded image decode + resize for the data
// pipeline of councilx_torch, a copy of councilx/data/native/cxloader.cc.
//
// The reference (Onr/Council-GAN) has no native code of its own; its data
// path is PIL decode inside torch DataLoader worker *processes*
// (utils.py::get_data_loader_folder). This is a C++ thread pool doing
// libjpeg/libpng decode + separable triangle-filter resize (Pillow-style
// antialiased bilinear) + center crop straight into caller-owned (numpy)
// buffers — no worker processes, no Python in the decode path, GIL
// released for the whole batch.
//
// Semantics mirror councilx_torch/data/dataset.py::_load_resize_crop:
//   decode RGB -> resize shorter side to new_size (triangle filter,
//   support scales with the downscale ratio like PIL) -> center crop to
//   (new_size x new_size) -> HWC uint8.
//
// C ABI (used from Python via ctypes):
//   void* cxl_open(const char** paths, int n, int new_size, int threads);
//   int   cxl_load_batch(void* ctx, const long* indices, int count,
//                        unsigned char* out);   // returns #failures
//   void  cxl_close(void* ctx);
//
// Build: see councilx_torch/data/native/__init__.py (g++ -O3 -shared -fPIC
//        -ljpeg -lpng -lz).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<unsigned char> rgb;  // HWC, 3 channels
  bool ok() const { return w > 0 && h > 0; }
};

// ---------------------------------------------------------------------
// JPEG decode (libjpeg with longjmp error handling)
// ---------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

Image decode_jpeg(FILE* f) {
  Image img;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return Image{};
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  img.w = cinfo.output_width;
  img.h = cinfo.output_height;
  img.rgb.resize(size_t(img.w) * img.h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = img.rgb.data() +
                         size_t(cinfo.output_scanline) * img.w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return img;
}

// ---------------------------------------------------------------------
// PNG decode (libpng, forced to 8-bit RGB)
// ---------------------------------------------------------------------

Image decode_png(FILE* f) {
  Image img;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return img;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return img;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return Image{};
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_set_expand(png);            // palette/gray/low-bit -> 8-bit
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  img.w = png_get_image_width(png, info);
  img.h = png_get_image_height(png, info);
  img.rgb.resize(size_t(img.w) * img.h * 3);
  std::vector<png_bytep> rows(img.h);
  for (int y = 0; y < img.h; ++y)
    rows[y] = img.rgb.data() + size_t(y) * img.w * 3;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return img;
}

Image decode_file(const std::string& path) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return Image{};
  unsigned char magic[8] = {0};
  size_t got = std::fread(magic, 1, 8, f);
  std::rewind(f);
  Image img;
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    img = decode_jpeg(f);
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    img = decode_png(f);
  }
  std::fclose(f);
  return img;
}

// ---------------------------------------------------------------------
// Separable triangle-filter resize (Pillow BILINEAR semantics: filter
// support is 1.0 * max(1, in/out) so downscales are antialiased).
// ---------------------------------------------------------------------

struct ResamplePlan {
  std::vector<int> first;            // first source index per output pixel
  std::vector<int> count;            // taps per output pixel
  std::vector<float> weights;        // flattened, max_taps stride
  int max_taps = 0;
};

ResamplePlan plan_triangle(int in_size, int out_size) {
  ResamplePlan p;
  double scale = double(in_size) / out_size;
  double support = scale < 1.0 ? 1.0 : scale;  // triangle radius
  int max_taps = int(std::ceil(support * 2)) + 2;
  p.first.resize(out_size);
  p.count.resize(out_size);
  p.weights.assign(size_t(out_size) * max_taps, 0.f);
  p.max_taps = max_taps;
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int lo = std::max(0, int(center - support + 0.5));
    int hi = std::min(in_size, int(center + support + 0.5));
    double inv = scale < 1.0 ? 1.0 : 1.0 / scale;
    double total = 0;
    std::vector<double> w(hi - lo);
    for (int j = lo; j < hi; ++j) {
      double x = std::abs((j + 0.5 - center) * inv);
      w[j - lo] = x < 1.0 ? 1.0 - x : 0.0;
      total += w[j - lo];
    }
    p.first[i] = lo;
    p.count[i] = hi - lo;
    for (int j = 0; j < hi - lo; ++j)
      p.weights[size_t(i) * max_taps + j] =
          float(total > 0 ? w[j] / total : 0.0);
  }
  return p;
}

// resize HWC u8 -> HWC u8 at (out_h, out_w) via float intermediates
void resize_triangle(const Image& src, int out_w, int out_h,
                     std::vector<unsigned char>* dst) {
  ResamplePlan px = plan_triangle(src.w, out_w);
  ResamplePlan py = plan_triangle(src.h, out_h);
  // horizontal pass: (h, out_w, 3) float
  std::vector<float> tmp(size_t(src.h) * out_w * 3);
  for (int y = 0; y < src.h; ++y) {
    const unsigned char* row = src.rgb.data() + size_t(y) * src.w * 3;
    float* orow = tmp.data() + size_t(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      float acc[3] = {0, 0, 0};
      int f = px.first[x], n = px.count[x];
      const float* w = &px.weights[size_t(x) * px.max_taps];
      for (int j = 0; j < n; ++j) {
        const unsigned char* pix = row + size_t(f + j) * 3;
        acc[0] += w[j] * pix[0];
        acc[1] += w[j] * pix[1];
        acc[2] += w[j] * pix[2];
      }
      orow[x * 3 + 0] = acc[0];
      orow[x * 3 + 1] = acc[1];
      orow[x * 3 + 2] = acc[2];
    }
  }
  // vertical pass
  dst->resize(size_t(out_h) * out_w * 3);
  for (int y = 0; y < out_h; ++y) {
    unsigned char* orow = dst->data() + size_t(y) * out_w * 3;
    int f = py.first[y], n = py.count[y];
    const float* w = &py.weights[size_t(y) * py.max_taps];
    for (int x = 0; x < out_w * 3; ++x) {
      float acc = 0;
      for (int j = 0; j < n; ++j)
        acc += w[j] * tmp[size_t(f + j) * out_w * 3 + x];
      int v = int(acc + 0.5f);
      orow[x] = (unsigned char)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

struct Loader {
  std::vector<std::string> paths;
  int new_size = 0;
  int threads = 4;
};

// decode one image into out (new_size^2 * 3); returns true on success
bool load_one(const Loader& L, long idx, unsigned char* out) {
  if (idx < 0 || size_t(idx) >= L.paths.size()) return false;
  Image img = decode_file(L.paths[idx]);
  if (!img.ok()) return false;
  int ns = L.new_size;
  // shorter-side resize; dims must match the PIL parity path
  // (dataset.py::_load_resize_crop), which uses Python round() —
  // ties-to-even — so use nearbyint (FE_TONEAREST), not int(x+0.5)
  int nw, nh;
  if (img.w <= img.h) {
    nw = ns;
    nh = std::max(1, int(std::nearbyint(double(img.h) * ns / img.w)));
  } else {
    nh = ns;
    nw = std::max(1, int(std::nearbyint(double(img.w) * ns / img.h)));
  }
  std::vector<unsigned char> resized;
  if (nw == img.w && nh == img.h) {
    resized = img.rgb;
  } else {
    resize_triangle(img, nw, nh, &resized);
  }
  // center crop ns x ns
  int left = (nw - ns) / 2, top = (nh - ns) / 2;
  for (int y = 0; y < ns; ++y) {
    std::memcpy(out + size_t(y) * ns * 3,
                resized.data() + (size_t(top + y) * nw + left) * 3,
                size_t(ns) * 3);
  }
  return true;
}

}  // namespace

extern "C" {

void* cxl_open(const char** paths, int n, int new_size, int threads) {
  Loader* L = new Loader();
  L->paths.reserve(n);
  for (int i = 0; i < n; ++i) L->paths.emplace_back(paths[i]);
  L->new_size = new_size;
  L->threads = std::max(1, threads);
  return L;
}

int cxl_load_batch(void* ctx, const long* indices, int count,
                   unsigned char* out) {
  Loader* L = static_cast<Loader*>(ctx);
  const size_t stride = size_t(L->new_size) * L->new_size * 3;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= count) return;
      if (!load_one(*L, indices[i], out + stride * i)) {
        std::memset(out + stride * i, 0, stride);
        failures.fetch_add(1);
      }
    }
  };
  int nt = std::min(L->threads, count);
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failures.load();
}

void cxl_close(void* ctx) { delete static_cast<Loader*>(ctx); }

}  // extern "C"
