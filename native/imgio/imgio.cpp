// imgio — native host-side image codec for the framework.
//
// Capability twin of the reference's vendored stb_image / stb_image_write
// layer (reference: monolithic/include/stb_image.h, stb_image_write.h;
// loaded at monolithic/src/main.c:21, written at :41): decode JPEG/PNG to
// interleaved u8 HWC, encode PNG. Implemented against the system libjpeg /
// libpng instead of a vendored single-header decoder, exposed to Python via
// a small C ABI (ctypes) and as a standalone CLI for codec round-trip tests.
//
// Thread-safety: error state is thread-local; the codec itself is reentrant.

#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

#include <jpeglib.h>
#include <png.h>

namespace {

thread_local std::string g_error;

void set_error(const std::string &msg) { g_error = msg; }

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  std::jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto *mgr = reinterpret_cast<JpegErrorMgr *>(cinfo->err);
  char buf[JMSG_LENGTH_MAX];
  (*cinfo->err->format_message)(cinfo, buf);
  set_error(std::string("jpeg: ") + buf);
  std::longjmp(mgr->jump, 1);
}

unsigned char *decode_jpeg(FILE *fp, int *w, int *h, int *channels) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  // volatile: modified between setjmp and longjmp; without it the cleanup
  // path reads an indeterminate value (C99 7.13.2.1).
  unsigned char *volatile out = nullptr;
  unsigned char *volatile cmyk_row = nullptr;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::free(cmyk_row);
    std::free(out);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  // CMYK/YCCK sources decode to RGB like the reference's stb_image layer
  // (stbi_load converts CMYK, branching on the Adobe APP14 transform).
  // libjpeg cannot emit RGB from these itself, but it CAN emit CMYK
  // (converting YCCK->CMYK internally); the CMYK->RGB step is done here
  // per row. Adobe writers store CMYK *inverted* (the overwhelmingly
  // common case, flagged by the APP14 marker): raw = 255 - ink, so
  // R = C_raw * K_raw / 255. Non-Adobe CMYK stores ink directly:
  // R = (255 - C) * (255 - K) / 255.
  const bool cmyk = (cinfo.jpeg_color_space == JCS_CMYK ||
                     cinfo.jpeg_color_space == JCS_YCCK);
  if (cmyk) cinfo.out_color_space = JCS_CMYK;
  jpeg_start_decompress(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  *channels = cmyk ? 3 : cinfo.output_components;
  size_t stride = static_cast<size_t>(*w) * *channels;
  out = static_cast<unsigned char *>(std::malloc(stride * *h));
  if (cmyk)
    cmyk_row = static_cast<unsigned char *>(
        std::malloc(static_cast<size_t>(*w) * 4));
  if (!out || (cmyk && !cmyk_row)) {
    set_error("jpeg: out of memory");
    std::longjmp(jerr.jump, 1);
  }
  const bool inverted = !cmyk || cinfo.saw_Adobe_marker;
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char *row = out + stride * cinfo.output_scanline;
    if (!cmyk) {
      jpeg_read_scanlines(&cinfo, &row, 1);
      continue;
    }
    unsigned char *craw = cmyk_row;
    jpeg_read_scanlines(&cinfo, &craw, 1);
    for (int x = 0; x < *w; ++x) {
      unsigned c0 = cmyk_row[4 * x + 0], m0 = cmyk_row[4 * x + 1];
      unsigned y0 = cmyk_row[4 * x + 2], k0 = cmyk_row[4 * x + 3];
      if (!inverted) {
        c0 = 255 - c0; m0 = 255 - m0; y0 = 255 - y0; k0 = 255 - k0;
      }
      // Rounded (a * b / 255) — same blend stb_image uses.
      row[3 * x + 0] = static_cast<unsigned char>((c0 * k0 + 128) / 255);
      row[3 * x + 1] = static_cast<unsigned char>((m0 * k0 + 128) / 255);
      row[3 * x + 2] = static_cast<unsigned char>((y0 * k0 + 128) / 255);
    }
  }
  std::free(cmyk_row);
  cmyk_row = nullptr;
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return out;
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

unsigned char *decode_png(FILE *fp, int *w, int *h, int *channels) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    set_error("png: create_read_struct failed");
    return nullptr;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    // With a null info libpng's read calls silently no-op instead of
    // longjmp-ing, yielding a 0x0 "successful" decode.
    set_error("png: create_info_struct failed");
    png_destroy_read_struct(&png, nullptr, nullptr);
    return nullptr;
  }
  // volatile: modified after setjmp (see decode_jpeg).
  unsigned char *volatile out = nullptr;
  png_bytep *volatile rows = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    set_error("png: decode failed");
    png_destroy_read_struct(&png, &info, nullptr);
    std::free(rows);
    std::free(out);
    return nullptr;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  // Normalize to 8-bit gray/GA/RGB/RGBA.
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_read_update_info(png, info);

  *w = static_cast<int>(png_get_image_width(png, info));
  *h = static_cast<int>(png_get_image_height(png, info));
  *channels = static_cast<int>(png_get_channels(png, info));
  size_t stride = png_get_rowbytes(png, info);
  out = static_cast<unsigned char *>(std::malloc(stride * *h));
  rows = static_cast<png_bytep *>(std::malloc(sizeof(png_bytep) * *h));
  if (!out || !rows) {
    set_error("png: out of memory");
    std::longjmp(png_jmpbuf(png), 1);
  }
  for (int y = 0; y < *h; ++y) rows[y] = out + stride * y;
  png_read_image(png, rows);
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::free(rows);
  return out;
}

bool encode_png(const char *path, const unsigned char *data, int w, int h,
                int channels, int stride_bytes, int compression) {
  int color;
  switch (channels) {
    case 1: color = PNG_COLOR_TYPE_GRAY; break;
    case 2: color = PNG_COLOR_TYPE_GRAY_ALPHA; break;
    case 3: color = PNG_COLOR_TYPE_RGB; break;
    case 4: color = PNG_COLOR_TYPE_RGBA; break;
    default:
      set_error("png: unsupported channel count");
      return false;
  }
  FILE *fp = std::fopen(path, "wb");
  if (!fp) {
    set_error(std::string("png: cannot open ") + path);
    return false;
  }
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    set_error("png: encode failed");
    if (png) png_destroy_write_struct(&png, &info);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  if (compression >= 0 && compression <= 9) png_set_compression_level(png, compression);
  png_set_IHDR(png, info, w, h, 8, color, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  // Local (not the parameter): assigning a parameter after setjmp trips
  // -Wclobbered; the longjmp path never reads it, but keep it clean.
  const size_t stride =
      stride_bytes ? static_cast<size_t>(stride_bytes)
                   : static_cast<size_t>(w) * channels;
  for (int y = 0; y < h; ++y)
    png_write_row(png, const_cast<png_bytep>(data + y * stride));
  png_write_end(png, nullptr);
  png_destroy_write_struct(&png, &info);
  std::fclose(fp);
  return true;
}

bool encode_jpeg(const char *path, const unsigned char *data, int w, int h,
                 int channels, int quality) {
  if (channels != 1 && channels != 3) {
    set_error("jpeg: encode supports 1 or 3 channels");
    return false;
  }
  FILE *fp = std::fopen(path, "wb");
  if (!fp) {
    set_error(std::string("jpeg: cannot open ") + path);
    return false;
  }
  jpeg_compress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    std::fclose(fp);
    return false;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, fp);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = channels;
  cinfo.in_color_space = channels == 3 ? JCS_RGB : JCS_GRAYSCALE;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  size_t stride = static_cast<size_t>(w) * channels;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(data + stride * cinfo.next_scanline);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  std::fclose(fp);
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

const char *imgio_last_error() { return g_error.c_str(); }

void imgio_free(unsigned char *p) { std::free(p); }

// Decode JPEG or PNG (sniffed by magic bytes) into interleaved u8 HWC.
// Returns NULL on failure (see imgio_last_error).
unsigned char *imgio_load(const char *path, int *w, int *h, int *channels) {
  FILE *fp = std::fopen(path, "rb");
  if (!fp) {
    set_error(std::string("cannot open ") + path);
    return nullptr;
  }
  unsigned char magic[8] = {0};
  size_t n = std::fread(magic, 1, sizeof magic, fp);
  std::rewind(fp);
  unsigned char *out = nullptr;
  if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    out = decode_jpeg(fp, w, h, channels);
  } else if (n >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    out = decode_png(fp, w, h, channels);
  } else {
    set_error("unrecognized image format (expected JPEG or PNG)");
  }
  std::fclose(fp);
  return out;
}

// Encode interleaved u8 HWC as PNG. Returns 1 on success, 0 on failure.
// compression: zlib level 0-9, or -1 for the library default. Serving paths
// use a low level — pixel content is identical, only file size/time differ.
int imgio_save_png(const char *path, const unsigned char *data, int w, int h,
                   int channels, int stride_bytes, int compression) {
  return encode_png(path, data, w, h, channels, stride_bytes, compression)
             ? 1
             : 0;
}

// Encode interleaved u8 HWC (1 or 3 channels) as JPEG at the given quality.
int imgio_save_jpeg(const char *path, const unsigned char *data, int w, int h,
                    int channels, int quality) {
  return encode_jpeg(path, data, w, h, channels, quality) ? 1 : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CLI: imgio <in> <out.png>   (codec round-trip; used by tests)
// ---------------------------------------------------------------------------

#ifdef IMGIO_MAIN
int main(int argc, char **argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s <input_img> <output_img.png>\n", argv[0]);
    return 1;
  }
  int w, h, c;
  unsigned char *img = imgio_load(argv[1], &w, &h, &c);
  if (!img) {
    std::fprintf(stderr, "decode error: %s\n", imgio_last_error());
    return 1;
  }
  std::printf("%dx%d c=%d\n", w, h, c);
  if (!imgio_save_png(argv[2], img, w, h, c, 0, -1)) {
    std::fprintf(stderr, "encode error: %s\n", imgio_last_error());
    imgio_free(img);
    return 1;
  }
  imgio_free(img);
  return 0;
}
#endif
