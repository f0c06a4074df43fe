// Native image decode worker: JPEG (libjpeg) + PNG (libpng) → HWC uint8.
//
// The host input pipeline's decode stage (data/file_operations.py
// load_image) can run through this instead of PIL: a single C call per
// file, no Python object churn, GIL released for the whole decode
// (ctypes releases it around foreign calls), so the thread pool in
// data/dataset.py scales past the interpreter.
//
// C ABI (see data/native_decode.py):
//   bid_decode(path, want_channels, &w, &h, &c) -> malloc'd uint8 buffer
//     (caller frees with bid_free); NULL on failure (unsupported format /
//     IO error). want_channels: 1 (gray), 3 (RGB) or 4 (RGBA; JPEG gets
//     opaque alpha).
//   bid_free(ptr)

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---- channel conversion helpers -----------------------------------------

unsigned char* convert_channels(const unsigned char* src, int w, int h,
                                int src_c, int dst_c) {
  unsigned char* dst = static_cast<unsigned char*>(
      malloc(static_cast<size_t>(w) * h * dst_c));
  if (!dst) return nullptr;
  const size_t n = static_cast<size_t>(w) * h;
  for (size_t i = 0; i < n; ++i) {
    unsigned char r, g, b, a = 255;
    switch (src_c) {
      case 1: r = g = b = src[i]; break;
      case 3: r = src[3 * i]; g = src[3 * i + 1]; b = src[3 * i + 2]; break;
      default:
        r = src[4 * i]; g = src[4 * i + 1]; b = src[4 * i + 2];
        a = src[4 * i + 3];
        break;
    }
    switch (dst_c) {
      case 1:
        // PIL 'L' convert, bit-exact: (R·19595 + G·38470 + B·7471
        // + 0x8000) >> 16 (ImagingConvert L24/L composition)
        dst[i] = static_cast<unsigned char>(
            (r * 19595u + g * 38470u + b * 7471u + 0x8000u) >> 16);
        break;
      case 3:
        dst[3 * i] = r; dst[3 * i + 1] = g; dst[3 * i + 2] = b;
        break;
      default:
        dst[4 * i] = r; dst[4 * i + 1] = g; dst[4 * i + 2] = b;
        dst[4 * i + 3] = a;
        break;
    }
  }
  return dst;
}

// ---- JPEG ----------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

unsigned char* decode_jpeg(FILE* f, int want_c, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  unsigned char* out = nullptr;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    free(out);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  // always decode RGB; grayscale goes through the PIL-exact luma
  // conversion below (libjpeg's own grayscale path rounds differently)
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int W = static_cast<int>(cinfo.output_width);
  const int H = static_cast<int>(cinfo.output_height);
  const int C = cinfo.output_components;
  out = static_cast<unsigned char*>(
      malloc(static_cast<size_t>(W) * H * C));
  if (!out) { jpeg_destroy_decompress(&cinfo); return nullptr; }
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out + static_cast<size_t>(cinfo.output_scanline) * W * C;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *w = W; *h = H;
  if (C == want_c) return out;
  unsigned char* conv = convert_channels(out, W, H, C, want_c);
  free(out);
  return conv;
}

// ---- PNG -----------------------------------------------------------------

unsigned char* decode_png(FILE* f, int want_c, int* w, int* h) {
  png_byte header[8];
  if (fread(header, 1, 8, f) != 8 || png_sig_cmp(header, 0, 8)) return nullptr;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                           nullptr, nullptr, nullptr);
  if (!png) return nullptr;
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); return nullptr; }
  unsigned char* out = nullptr;
  png_bytep* rows = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    free(rows);
    free(out);
    return nullptr;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  // normalize to 8-bit RGB or RGBA
  png_set_expand(png);          // palette/gray<8/tRNS → full depth
  png_set_strip_16(png);        // 16-bit → 8-bit
  if (png_get_color_type(png, info) == PNG_COLOR_TYPE_GRAY ||
      png_get_color_type(png, info) == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_read_update_info(png, info);

  const int W = static_cast<int>(png_get_image_width(png, info));
  const int H = static_cast<int>(png_get_image_height(png, info));
  const int C = static_cast<int>(png_get_channels(png, info));
  out = static_cast<unsigned char*>(malloc(static_cast<size_t>(W) * H * C));
  rows = static_cast<png_bytep*>(malloc(sizeof(png_bytep) * H));
  if (!out || !rows) { longjmp(png_jmpbuf(png), 1); }
  for (int y = 0; y < H; ++y)
    rows[y] = out + static_cast<size_t>(y) * W * C;
  png_read_image(png, rows);
  png_destroy_read_struct(&png, &info, nullptr);
  free(rows);
  rows = nullptr;
  *w = W; *h = H;
  if (C == want_c) return out;
  unsigned char* conv = convert_channels(out, W, H, C, want_c);
  free(out);
  return conv;
}

}  // namespace

extern "C" {

unsigned char* bid_decode(const char* path, int want_channels,
                          int* w, int* h, int* c) {
  if (want_channels != 1 && want_channels != 3 && want_channels != 4)
    return nullptr;
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  unsigned char sig[2] = {0, 0};
  size_t got = fread(sig, 1, 2, f);
  rewind(f);
  unsigned char* out = nullptr;
  int W = 0, H = 0;
  if (got == 2 && sig[0] == 0xFF && sig[1] == 0xD8) {
    out = decode_jpeg(f, want_channels, &W, &H);
  } else if (got == 2 && sig[0] == 0x89 && sig[1] == 0x50) {
    out = decode_png(f, want_channels, &W, &H);
  }
  fclose(f);
  if (out) { *w = W; *h = H; *c = want_channels; }
  return out;
}

void bid_free(unsigned char* ptr) { free(ptr); }

}  // extern "C"
