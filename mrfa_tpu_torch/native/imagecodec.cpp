// Native image decode + resize + batch assembly for the host data path.
//
// A copy of the JAX package's codec (the same source, the same C ABI), so
// that the PyTorch port's loader decodes frames as the JAX package's does:
// a small C library (libpng/libjpeg + pthreads) driven from Python via
// ctypes (mrfa_tpu_torch/native/__init__.py, which builds it with g++ into
// build/ at first use), decoding frame files straight into preallocated
// float32 NHWC batch buffers in [0, 1].
//
// Exposed C ABI:
//   mrfa_decode_image(path, out_f32, max_h, max_w, &h, &w)  -> 0 on success
//   mrfa_decode_resize(path, out_f32, dst_h, dst_w)         -> 0 on success
//   mrfa_decode_batch(paths[], n, out_f32, dst_h, dst_w, n_threads) -> 0
//
// All outputs are tightly-packed RGB float32, HWC.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <string>
#include <thread>
#include <atomic>

#include <png.h>
#include <jpeglib.h>
#include <csetjmp>

namespace {

struct ImageU8 {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;  // HWC
};

bool has_suffix(const char* path, const char* suf) {
  size_t lp = strlen(path), ls = strlen(suf);
  if (ls > lp) return false;
  for (size_t i = 0; i < ls; i++) {
    char a = path[lp - ls + i], b = suf[i];
    if (tolower(a) != tolower(b)) return false;
  }
  return true;
}

bool decode_png(const char* path, ImageU8* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) { fclose(fp); return false; }
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); fclose(fp); return false; }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  png_byte color_type = png_get_color_type(png, info);
  png_byte bit_depth = png_get_bit_depth(png, info);

  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY || color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->h = (int)h; out->w = (int)w; out->c = 3;
  out->data.resize((size_t)h * w * 3);
  std::vector<png_bytep> rows(h);
  size_t stride = png_get_rowbytes(png, info);
  std::vector<uint8_t> rowbuf((size_t)h * stride);
  for (png_uint_32 y = 0; y < h; y++) rows[y] = rowbuf.data() + y * stride;
  png_read_image(png, rows.data());
  // stride may exceed w*3; copy densely
  for (png_uint_32 y = 0; y < h; y++)
    memcpy(out->data.data() + (size_t)y * w * 3, rows[y], (size_t)w * 3);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return true;
}

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = (JpegErr*)cinfo->err;
  longjmp(e->jb, 1);
}

bool decode_jpeg(const char* path, ImageU8* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->c = 3;
  out->data.resize((size_t)out->h * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + (size_t)cinfo.output_scanline * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return true;
}

bool decode_any(const char* path, ImageU8* out) {
  if (has_suffix(path, ".png")) return decode_png(path, out);
  if (has_suffix(path, ".jpg") || has_suffix(path, ".jpeg")) return decode_jpeg(path, out);
  // sniff magic
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  unsigned char magic[4] = {0};
  size_t n = fread(magic, 1, 4, fp);
  fclose(fp);
  if (n >= 4 && magic[0] == 0x89 && magic[1] == 'P') return decode_png(path, out);
  if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) return decode_jpeg(path, out);
  return false;
}

// area-average resize u8 HWC -> f32 HWC in [0, 1] (box filter, good for
// downscale; bilinear for upscale)
void resize_to_f32(const ImageU8& src, float* dst, int dh, int dw) {
  const float inv255 = 1.0f / 255.0f;
  if (src.h == dh && src.w == dw) {
    size_t n = (size_t)dh * dw * 3;
    for (size_t i = 0; i < n; i++) dst[i] = src.data[i] * inv255;
    return;
  }
  const bool down = (src.h >= dh && src.w >= dw);
  if (down) {
    // box filter over the source cell [y0,y1) x [x0,x1)
    for (int y = 0; y < dh; y++) {
      int y0 = (int)((int64_t)y * src.h / dh);
      int y1 = (int)((int64_t)(y + 1) * src.h / dh);
      if (y1 <= y0) y1 = y0 + 1;
      for (int x = 0; x < dw; x++) {
        int x0 = (int)((int64_t)x * src.w / dw);
        int x1 = (int)((int64_t)(x + 1) * src.w / dw);
        if (x1 <= x0) x1 = x0 + 1;
        float acc[3] = {0, 0, 0};
        int cnt = 0;
        for (int yy = y0; yy < y1; yy++) {
          const uint8_t* row = src.data.data() + ((size_t)yy * src.w + x0) * 3;
          for (int xx = x0; xx < x1; xx++) {
            acc[0] += row[0]; acc[1] += row[1]; acc[2] += row[2];
            row += 3;
            cnt++;
          }
        }
        float scale = inv255 / cnt;
        float* d = dst + ((size_t)y * dw + x) * 3;
        d[0] = acc[0] * scale; d[1] = acc[1] * scale; d[2] = acc[2] * scale;
      }
    }
  } else {
    // bilinear, half-pixel centers
    for (int y = 0; y < dh; y++) {
      float sy = ((y + 0.5f) * src.h / dh) - 0.5f;
      if (sy < 0) sy = 0;
      int y0 = (int)sy;
      int y1 = y0 + 1 < src.h ? y0 + 1 : src.h - 1;
      float fy = sy - y0;
      for (int x = 0; x < dw; x++) {
        float sx = ((x + 0.5f) * src.w / dw) - 0.5f;
        if (sx < 0) sx = 0;
        int x0 = (int)sx;
        int x1 = x0 + 1 < src.w ? x0 + 1 : src.w - 1;
        float fx = sx - x0;
        float* d = dst + ((size_t)y * dw + x) * 3;
        for (int ch = 0; ch < 3; ch++) {
          float v00 = src.data[((size_t)y0 * src.w + x0) * 3 + ch];
          float v01 = src.data[((size_t)y0 * src.w + x1) * 3 + ch];
          float v10 = src.data[((size_t)y1 * src.w + x0) * 3 + ch];
          float v11 = src.data[((size_t)y1 * src.w + x1) * 3 + ch];
          d[ch] = ((1 - fy) * ((1 - fx) * v00 + fx * v01) +
                   fy * ((1 - fx) * v10 + fx * v11)) * inv255;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Header-only size probe (no full decode).
int mrfa_image_size(const char* path, int* h, int* w) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  unsigned char magic[4] = {0};
  size_t n = fread(magic, 1, 4, fp);
  if (n >= 4 && magic[0] == 0x89 && magic[1] == 'P') {
    // PNG: IHDR width/height at offset 16, big-endian u32
    unsigned char hdr[24];
    fseek(fp, 0, SEEK_SET);
    if (fread(hdr, 1, 24, fp) == 24) {
      *w = (hdr[16] << 24) | (hdr[17] << 16) | (hdr[18] << 8) | hdr[19];
      *h = (hdr[20] << 24) | (hdr[21] << 16) | (hdr[22] << 8) | hdr[23];
      fclose(fp);
      return 0;
    }
    fclose(fp);
    return 1;
  }
  if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    fseek(fp, 0, SEEK_SET);
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
      jpeg_destroy_decompress(&cinfo);
      fclose(fp);
      return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, fp);
    jpeg_read_header(&cinfo, TRUE);
    *h = cinfo.image_height;
    *w = cinfo.image_width;
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return 0;
  }
  fclose(fp);
  return 1;
}

int mrfa_decode_image(const char* path, float* out, int max_h, int max_w,
                      int* h, int* w) {
  ImageU8 img;
  if (!decode_any(path, &img)) return 1;
  if (img.h > max_h || img.w > max_w) return 2;
  *h = img.h;
  *w = img.w;
  const float inv255 = 1.0f / 255.0f;
  size_t n = (size_t)img.h * img.w * 3;
  for (size_t i = 0; i < n; i++) out[i] = img.data[i] * inv255;
  return 0;
}

int mrfa_decode_resize(const char* path, float* out, int dst_h, int dst_w) {
  ImageU8 img;
  if (!decode_any(path, &img)) return 1;
  resize_to_f32(img, out, dst_h, dst_w);
  return 0;
}

// Decode n images into one (n, dst_h, dst_w, 3) f32 batch, multi-threaded.
int mrfa_decode_batch(const char** paths, int n, float* out, int dst_h,
                      int dst_w, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      ImageU8 img;
      if (!decode_any(paths[i], &img)) {
        failed.fetch_add(1);
        continue;
      }
      resize_to_f32(img, out + (size_t)i * dst_h * dst_w * 3, dst_h, dst_w);
    }
  };
  if (n_threads == 1) {
    work();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; t++) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }
  return failed.load();
}

}  // extern "C"
