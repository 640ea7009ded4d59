// Native host-side image decoding for the input pipeline.
//
// The port's copy of the JAX package's decoder (same source, same C ABI):
// the pipeline leaves only file decode on the host, and on a small host
// Python/PIL decode becomes the input ceiling. This library decodes
// PNG (libpng) and JPEG (libjpeg) straight into caller-provided, preallocated
// uint8/float buffers — no Python objects, no GIL, no intermediate copies —
// with optional box-filter resize to the dataset's canonical decode size and
// a thread pool for batch decode.
//
// Exposed C ABI (ctypes-friendly; see mcseg_tpu_torch/native/__init__.py):
//   mcseg_decode_rgb(path, out_u8, H, W)            -> 0 | errcode
//   mcseg_decode_gray(path, out_u8, H, W)           -> 0 | errcode
//   mcseg_decode_depth16(path, out_f32, H, W, scale)-> 0 | errcode
//   mcseg_decode_rgb_batch(paths, n, out, H, W, n_threads)    -> 0 | first err
//   mcseg_decode_gray_batch(paths, n, out, H, W, n_threads)   -> 0 | first err
//   mcseg_decode_depth16_batch(paths, n, out, H, W, s, n_thr) -> 0 | first err
//
// Errors: 1 open failure, 2 decode failure, 3 unsupported format.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>
#include <atomic>

#include <png.h>
#include <jpeglib.h>
#include <csetjmp>

namespace {

struct Image {
  std::vector<uint8_t> data;  // interleaved, 8-bit
  std::vector<uint16_t> data16;
  int h = 0, w = 0, c = 0;
  bool is16 = false;
};

// ---------------------------------------------------------------- PNG
// raw_palette: return palette PNGs as raw 8-bit palette INDICES (one channel)
// instead of expanding through the palette to RGB. Label maps (e.g. GTA5's
// official paletted label PNGs) store the class id as the palette index, so
// the index — not the palette color — is the datum.
bool read_png(FILE* f, Image* im, bool raw_palette) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);

  if (color_type == PNG_COLOR_TYPE_PALETTE) {
    if (raw_palette) {
      if (bit_depth < 8) png_set_packing(png);  // 1/2/4-bit idx -> 1 byte
    } else {
      png_set_palette_to_rgb(png);
    }
  }
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (!raw_palette) {
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    png_set_strip_alpha(png);
  }
  im->is16 = bit_depth == 16;
  if (im->is16) png_set_swap(png);  // PNG is big-endian; we want host order

  png_read_update_info(png, info);
  int channels = png_get_channels(png, info);
  im->h = (int)h;
  im->w = (int)w;
  im->c = channels;

  std::vector<png_bytep> rows(h);
  if (im->is16) {
    im->data16.resize((size_t)h * w * channels);
    for (png_uint_32 y = 0; y < h; y++)
      rows[y] = (png_bytep)(im->data16.data() + (size_t)y * w * channels);
  } else {
    im->data.resize((size_t)h * w * channels);
    for (png_uint_32 y = 0; y < h; y++)
      rows[y] = im->data.data() + (size_t)y * w * channels;
  }
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ---------------------------------------------------------------- JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};
void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = (JpegErr*)cinfo->err;
  longjmp(e->jb, 1);
}

bool read_jpeg(FILE* f, Image* im) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  im->h = cinfo.output_height;
  im->w = cinfo.output_width;
  im->c = cinfo.output_components;
  im->is16 = false;
  im->data.resize((size_t)im->h * im->w * im->c);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = im->data.data() + (size_t)cinfo.output_scanline * im->w * im->c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

int read_any(const char* path, Image* im, bool raw_palette = false) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  uint8_t magic[4] = {0};
  if (fread(magic, 1, 4, f) != 4) {
    fclose(f);
    return 2;
  }
  rewind(f);
  bool ok;
  if (magic[0] == 0x89 && magic[1] == 'P')
    ok = read_png(f, im, raw_palette);
  else if (magic[0] == 0xFF && magic[1] == 0xD8)
    ok = read_jpeg(f, im);
  else {
    fclose(f);
    return 3;
  }
  fclose(f);
  return ok ? 0 : 2;
}

// Box/bilinear resample uint8 CHW-interleaved -> fixed out size.
// Bilinear with half-pixel centers (matches common image-resize semantics).
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                        uint8_t* dst, int dh, int dw, int out_c) {
  const float sy = (float)sh / dh, sx = (float)sw / dw;
  for (int y = 0; y < dh; y++) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    if (fy > sh - 1) fy = (float)(sh - 1);
    int y0 = (int)fy, y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    for (int x = 0; x < dw; x++) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      if (fx > sw - 1) fx = (float)(sw - 1);
      int x0 = (int)fx, x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      for (int k = 0; k < out_c; k++) {
        int kk = k < c ? k : c - 1;  // gray -> replicated channels
        float v00 = src[((size_t)y0 * sw + x0) * c + kk];
        float v01 = src[((size_t)y0 * sw + x1) * c + kk];
        float v10 = src[((size_t)y1 * sw + x0) * c + kk];
        float v11 = src[((size_t)y1 * sw + x1) * c + kk];
        float v = (1 - wy) * ((1 - wx) * v00 + wx * v01) +
                  wy * ((1 - wx) * v10 + wx * v11);
        dst[((size_t)y * dw + x) * out_c + k] = (uint8_t)(v + 0.5f);
      }
    }
  }
}

void resize_nearest_u8(const uint8_t* src, int sh, int sw, int c,
                       uint8_t* dst, int dh, int dw) {
  for (int y = 0; y < dh; y++) {
    int yy = (int)(((int64_t)y * sh) / dh);
    for (int x = 0; x < dw; x++) {
      int xx = (int)(((int64_t)x * sw) / dw);
      dst[(size_t)y * dw + x] = src[((size_t)yy * sw + xx) * c];
    }
  }
}

}  // namespace

extern "C" {

// RGB decode (+bilinear resize when sizes differ), out: [H, W, 3] uint8.
int mcseg_decode_rgb(const char* path, uint8_t* out, int H, int W) {
  Image im;
  int rc = read_any(path, &im);
  if (rc) return rc;
  if (im.is16) return 3;
  if (im.h == H && im.w == W && im.c == 3) {
    memcpy(out, im.data.data(), (size_t)H * W * 3);
    return 0;
  }
  resize_bilinear_u8(im.data.data(), im.h, im.w, im.c, out, H, W, 3);
  return 0;
}

// Single-channel decode with NEAREST resize (labels!), out: [H, W] uint8.
// Paletted PNGs yield the palette INDEX per pixel (matches PIL's 'P'-mode
// array semantics), not the palette color.
int mcseg_decode_gray(const char* path, uint8_t* out, int H, int W) {
  Image im;
  int rc = read_any(path, &im, /*raw_palette=*/true);
  if (rc) return rc;
  if (im.is16) return 3;
  if (im.h == H && im.w == W && im.c == 1) {
    memcpy(out, im.data.data(), (size_t)H * W);
    return 0;
  }
  resize_nearest_u8(im.data.data(), im.h, im.w, im.c, out, H, W);
  return 0;
}

// 16-bit depth PNG (millimeters) -> float meters with nearest resize.
int mcseg_decode_depth16(const char* path, float* out, int H, int W,
                         float scale) {
  Image im;
  int rc = read_any(path, &im);
  if (rc) return rc;
  if (!im.is16) {
    // 8-bit depth fallback: treat value as meters*scale directly
    for (int y = 0; y < H; y++) {
      int yy = (int)(((int64_t)y * im.h) / H);
      for (int x = 0; x < W; x++) {
        int xx = (int)(((int64_t)x * im.w) / W);
        out[(size_t)y * W + x] =
            im.data[((size_t)yy * im.w + xx) * im.c] * scale;
      }
    }
    return 0;
  }
  for (int y = 0; y < H; y++) {
    int yy = (int)(((int64_t)y * im.h) / H);
    for (int x = 0; x < W; x++) {
      int xx = (int)(((int64_t)x * im.w) / W);
      out[(size_t)y * W + x] =
          im.data16[((size_t)yy * im.w + xx) * im.c] * scale;
    }
  }
  return 0;
}

// Threaded batch decode of RGB images into one [N, H, W, 3] buffer.
int mcseg_decode_rgb_batch(const char** paths, int n, uint8_t* out, int H,
                           int W, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), err(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = mcseg_decode_rgb(paths[i], out + (size_t)i * H * W * 3, H, W);
      if (rc && !err.load()) err.store(rc);
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads - 1; t++) ts.emplace_back(worker);
  worker();
  for (auto& t : ts) t.join();
  return err.load();
}

// Threaded batch decode of single-channel label maps into [N, H, W] uint8.
int mcseg_decode_gray_batch(const char** paths, int n, uint8_t* out, int H,
                            int W, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), err(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = mcseg_decode_gray(paths[i], out + (size_t)i * H * W, H, W);
      if (rc && !err.load()) err.store(rc);
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads - 1; t++) ts.emplace_back(worker);
  worker();
  for (auto& t : ts) t.join();
  return err.load();
}

// Threaded batch decode of 16-bit depth PNGs into [N, H, W] float meters.
int mcseg_decode_depth16_batch(const char** paths, int n, float* out, int H,
                               int W, float scale, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), err(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = mcseg_decode_depth16(paths[i], out + (size_t)i * H * W, H, W,
                                    scale);
      if (rc && !err.load()) err.store(rc);
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads - 1; t++) ts.emplace_back(worker);
  worker();
  for (auto& t : ts) t.join();
  return err.load();
}

}  // extern "C"
