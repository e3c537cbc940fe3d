// auvnative — C++ host-side runtime of multimodal_auv_torch (the port's own
// copy of the JAX package's native/csrc/auvnative.cpp; host code, no
// framework): the native hot paths that feed the card:
//   * threaded bilinear resize of uint8 image batches (loader fast path),
//   * uint8 -> float32 NHWC normalize,
//   * mean-image accumulation (AverageSubtraction preprocessing),
//   * TIFF-variant LZW decode (GeoTIFF windowed reader hot loop),
//   * clipped window copy for raster patch extraction,
//   * with AUVNATIVE_DECODE defined (linked with -ljpeg -lpng): JPEG / PNG
//     decode + convert + resize in one call (decode_image_u8).
//
// Built by multimodal_auv_torch/native/__init__.py with g++ at first use
// (g++ -O3 -shared); loaded via ctypes (no pybind11).
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Bilinear resize, uint8 HWC -> uint8 HWC (align_corners=false convention,
// matching PIL/cv2 INTER_LINEAR).
// ---------------------------------------------------------------------------
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                        uint8_t* dst, int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(fy >= 0 ? fy : fy - 1);
    float wy = fy - y0;
    int y0c = std::clamp(y0, 0, sh - 1);
    int y1c = std::clamp(y0 + 1, 0, sh - 1);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(fx >= 0 ? fx : fx - 1);
      float wx = fx - x0;
      int x0c = std::clamp(x0, 0, sw - 1);
      int x1c = std::clamp(x0 + 1, 0, sw - 1);
      const uint8_t* p00 = src + (static_cast<int64_t>(y0c) * sw + x0c) * c;
      const uint8_t* p01 = src + (static_cast<int64_t>(y0c) * sw + x1c) * c;
      const uint8_t* p10 = src + (static_cast<int64_t>(y1c) * sw + x0c) * c;
      const uint8_t* p11 = src + (static_cast<int64_t>(y1c) * sw + x1c) * c;
      uint8_t* out = dst + (static_cast<int64_t>(y) * dw + x) * c;
      for (int k = 0; k < c; ++k) {
        float top = p00[k] * (1 - wx) + p01[k] * wx;
        float bot = p10[k] * (1 - wx) + p11[k] * wx;
        float v = top * (1 - wy) + bot * wy;
        out[k] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// Threaded batch resize: n images with identical geometry.
void resize_bilinear_u8_batch(const uint8_t* src, int n, int sh, int sw,
                              int c, uint8_t* dst, int dh, int dw,
                              int nthreads) {
  if (nthreads < 1) nthreads = 1;
  std::atomic<int> next(0);
  auto work = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      resize_bilinear_u8(src + static_cast<int64_t>(i) * sh * sw * c, sh, sw,
                         c, dst + static_cast<int64_t>(i) * dh * dw * c, dh,
                         dw);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < std::min(nthreads, n); ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
}

// ---------------------------------------------------------------------------
// uint8 HWC -> float32 HWC, x/255 then per-channel (x - mean) / std.
// ---------------------------------------------------------------------------
void normalize_u8_to_f32(const uint8_t* src, int64_t npix, int c,
                         const float* mean, const float* stddev, float* dst) {
  std::vector<float> scale(c), shift(c);
  for (int k = 0; k < c; ++k) {
    scale[k] = 1.0f / (255.0f * stddev[k]);
    shift[k] = -mean[k] / stddev[k];
  }
  for (int64_t i = 0; i < npix; ++i) {
    const uint8_t* p = src + i * c;
    float* q = dst + i * c;
    for (int k = 0; k < c; ++k) q[k] = p[k] * scale[k] + shift[k];
  }
}

// Accumulate uint8 HWC into a float64 buffer (mean-image pass).
void accumulate_u8_f64(const uint8_t* src, int64_t n, double* acc) {
  for (int64_t i = 0; i < n; ++i) acc[i] += src[i];
}

// ---------------------------------------------------------------------------
// Clipped window copy: src (H, W) elemsize-sized elements -> dst (h, w),
// window origin (row_off, col_off) may extend beyond src; out-of-range
// cells keep dst's existing (fill) content.
// ---------------------------------------------------------------------------
void window_copy(const uint8_t* src, int H, int W, int elem, uint8_t* dst,
                 int h, int w, int row_off, int col_off) {
  int r0 = std::max(row_off, 0), r1 = std::min(row_off + h, H);
  int c0 = std::max(col_off, 0), c1 = std::min(col_off + w, W);
  if (r1 <= r0 || c1 <= c0) return;
  int cols = c1 - c0;
  for (int r = r0; r < r1; ++r) {
    std::memcpy(dst + ((static_cast<int64_t>(r - row_off)) * w +
                       (c0 - col_off)) * elem,
                src + (static_cast<int64_t>(r) * W + c0) * elem,
                static_cast<size_t>(cols) * elem);
  }
}

// ---------------------------------------------------------------------------
// TIFF-variant LZW decode (MSB-first, early change). Returns bytes written
// or -1 on malformed input.
// ---------------------------------------------------------------------------
int64_t lzw_decode(const uint8_t* src, int64_t srclen, uint8_t* dst,
                   int64_t dstlen) {
  constexpr int CLEAR = 256, EOI = 257;
  // table entries as (prefix, suffix); strings materialised on output
  std::vector<int> prefix(4096, -1);
  std::vector<uint8_t> suffix(4096, 0);
  std::vector<uint8_t> stack(4096);

  auto reset_n = []() { return 258; };
  int next_code = reset_n();
  int nbits = 9;
  int64_t bitpos = 0;
  int64_t out = 0;
  int prev = -1;
  const int64_t total_bits = srclen * 8;

  auto emit = [&](int code) -> int {
    // materialise string for `code` onto stack, then copy to dst
    int sp = 0;
    int c = code;
    while (c >= 256) {
      if (sp >= 4096 || c >= next_code) return -1;
      stack[sp++] = suffix[c];
      c = prefix[c];
    }
    uint8_t first = static_cast<uint8_t>(c);
    if (out + sp + 1 > dstlen) {
      // clamp: fill what fits
      int64_t room = dstlen - out;
      if (room <= 0) return first;
      int64_t written = 0;
      if (written < room) dst[out++] = first, ++written;
      for (int i = sp - 1; i >= 0 && written < room; --i)
        dst[out++] = stack[i], ++written;
      return first;
    }
    dst[out++] = first;
    for (int i = sp - 1; i >= 0; --i) dst[out++] = stack[i];
    return first;
  };

  auto first_char = [&](int code) -> int {
    int c = code;
    while (c >= 256) c = prefix[c];
    return c;
  };

  while (bitpos + nbits <= total_bits && out < dstlen) {
    int64_t byte = bitpos >> 3;
    uint32_t chunk = 0;
    for (int i = 0; i < 4; ++i)
      chunk = (chunk << 8) | (byte + i < srclen ? src[byte + i] : 0);
    int code = (chunk >> (32 - nbits - (bitpos & 7))) & ((1 << nbits) - 1);
    bitpos += nbits;

    if (code == CLEAR) {
      next_code = reset_n();
      nbits = 9;
      prev = -1;
      continue;
    }
    if (code == EOI) break;

    if (prev < 0) {
      if (code >= 256) return -1;
      dst[out++] = static_cast<uint8_t>(code);
      prev = code;
    } else if (code < next_code) {
      int fc = emit(code);
      if (fc < 0) return -1;
      if (next_code < 4096) {
        prefix[next_code] = prev;
        suffix[next_code] = static_cast<uint8_t>(fc);
        ++next_code;
      }
      prev = code;
    } else if (code == next_code) {
      int fc = first_char(prev);
      if (next_code < 4096) {
        prefix[next_code] = prev;
        suffix[next_code] = static_cast<uint8_t>(fc);
        ++next_code;
      }
      int r = emit(next_code - 1);
      if (r < 0) return -1;
      prev = next_code - 1;
    } else {
      return -1;  // corrupt stream
    }
    // early change (decoder lags encoder by one entry) — must match the
    // Python fallback in dataprep/geotiff.py (libtiff-compatible: widen
    // at table size (1<<nbits)-1; -2 corrupted real libtiff streams)
    if (next_code >= (1 << nbits) - 1 && nbits < 12) ++nbits;
  }
  return out;
}

}  // extern "C"

#ifdef AUVNATIVE_DECODE
// ---------------------------------------------------------------------------
// Image decode: JPEG (libjpeg) / PNG (libpng) from memory + convert + resize,
// PIL-pixel-exact. PIL itself wraps libjpeg, decodes to RGB, converts "L"
// with the fixed-point ITU-R 601-2 luma of ImagingConvert.c (L24:
// (r*19595 + g*38470 + b*7471) >> 16) and only then resizes — we reproduce
// that exact order so the native fast path feeds bit-identical pixels to
// data/transforms.load_image_u8's PIL fallback. RGBA alpha is DROPPED (not
// composited), matching PIL convert("RGB"). Exotic inputs (CMYK JPEG,
// 16-bit PNG) return nonzero and the caller falls back to PIL.
// ---------------------------------------------------------------------------
#include <csetjmp>

#include <jpeglib.h>
#include <png.h>

namespace {

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

inline uint8_t l24(const uint8_t* p) {
  // PIL ImagingConvert.c L24: fixed-point 601-2 luma WITH the 0x8000
  // rounding term (omitting it is off by one on ~half of all pixels)
  return static_cast<uint8_t>(
      (p[0] * 19595u + p[1] * 38470u + p[2] * 7471u + 0x8000u) >> 16);
}

// rgb: (sh, sw, 3) decoded pixels -> dst: (dh, dw, ch) with ch in {1, 3};
// convert BEFORE resize (PIL's img.convert(mode) then img.resize order).
int finish_to_dst(const uint8_t* rgb, int sh, int sw,
                  uint8_t* dst, int dh, int dw, int ch) {
  const uint8_t* src = rgb;
  std::vector<uint8_t> gray;
  if (ch == 1) {
    gray.resize(static_cast<size_t>(sh) * sw);
    for (int64_t i = 0; i < static_cast<int64_t>(sh) * sw; ++i)
      gray[i] = l24(rgb + i * 3);
    src = gray.data();
  } else if (ch != 3) {
    return -4;
  }
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(dh) * dw * ch);
  } else {
    resize_bilinear_u8(src, sh, sw, ch, dst, dh, dw);
  }
  return 0;
}

int decode_jpeg_impl(const uint8_t* buf, int64_t len,
                     uint8_t* dst, int dh, int dw, int ch) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  std::vector<uint8_t> rgb;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // PIL decodes to RGB, converts after
  jpeg_start_decompress(&cinfo);
  const int sw = cinfo.output_width, sh = cinfo.output_height;
  if (cinfo.output_components != 3 || sh <= 0 || sw <= 0) {
    jpeg_destroy_decompress(&cinfo);
    return -5;
  }
  rgb.resize(static_cast<size_t>(sh) * sw * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb.data() +
        static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return finish_to_dst(rgb.data(), sh, sw, dst, dh, dw, ch);
}

int decode_png_impl(const uint8_t* buf, int64_t len,
                    uint8_t* dst, int dh, int dw, int ch) {
  png_image image;
  std::memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, buf,
                                        static_cast<size_t>(len)))
    return -2;
  // read RGBA and strip alpha ourselves: the simplified API COMPOSITES
  // alpha onto a background for alpha-less output formats, but PIL's
  // convert("RGB") just drops the channel
  image.format = PNG_FORMAT_RGBA;
  std::vector<uint8_t> rgba(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, rgba.data(), 0, nullptr)) {
    png_image_free(&image);
    return -3;
  }
  const int sh = image.height, sw = image.width;
  std::vector<uint8_t> rgb(static_cast<size_t>(sh) * sw * 3);
  for (int64_t i = 0; i < static_cast<int64_t>(sh) * sw; ++i) {
    rgb[i * 3 + 0] = rgba[i * 4 + 0];
    rgb[i * 3 + 1] = rgba[i * 4 + 1];
    rgb[i * 3 + 2] = rgba[i * 4 + 2];
  }
  return finish_to_dst(rgb.data(), sh, sw, dst, dh, dw, ch);
}

}  // namespace

extern "C" {

// 0 on success; nonzero -> caller falls back to PIL.
int decode_image_u8(const uint8_t* buf, int64_t len,
                    uint8_t* dst, int dh, int dw, int ch) {
  if (len >= 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF)
    return decode_jpeg_impl(buf, len, dst, dh, dw, ch);
  if (len >= 8 && !png_sig_cmp(buf, 0, 8))
    return decode_png_impl(buf, len, dst, dh, dw, ch);
  return -10;  // unknown container
}

}  // extern "C"

#endif  // AUVNATIVE_DECODE
