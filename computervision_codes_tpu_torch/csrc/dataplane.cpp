// Host data plane of the port: PNG pixels from inflated image data, the
// PIL-parity fixed-point bilinear resize and the ImageNet normalisation.
//
// The port's copy of native/dataplane.cpp in the JAX package, built with
// the standard headers only (no libpng, no libjpeg, no zlib). The Python
// half (data/native.py) reads the file, walks the PNG chunks and inflates
// the image data with the standard library's zlib; this file undoes the
// five row filters (both layouts: plain and Adam7-interlaced), expands the
// pixels to 8-bit RGB as the JAX plane's libpng transforms do
// (png_set_expand, png_set_strip_16, png_set_strip_alpha,
// png_set_gray_to_rgb), then resizes with the copy's fixed-point bilinear.
// JPEG stills and MJPEG containers need libjpeg: data/native.py refuses
// them.
//
// C ABI for ctypes. ctypes releases the GIL for the length of each call,
// so Python threads that each inflate a frame and call in here decode in
// parallel. Built by ops/_build.py (g++ -O3 -std=c++17 -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// PIL-parity bilinear resize, FIXED-POINT: int16 coefficients scaled by
// 1<<14 (weights per output pixel sum to exactly 1<<14, so the int32
// accumulator is bounded by 255<<14), uint8 intermediate rows like
// Pillow's own 8bpc pipeline, horizontal-then-vertical pass order to match
// Pillow's rounding. Copied from native/dataplane.cpp:205-290.
struct Coeffs {
  std::vector<int> xmin;            // first source index per output pixel
  std::vector<int> count;           // taps per output pixel
  std::vector<int16_t> weights;     // flattened fixed-point taps
  int max_taps = 0;
};

constexpr int kPrec = 14;

Coeffs precompute_coeffs(int in_size, int out_size) {
  Coeffs c;
  double scale = double(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;  // bilinear support = 1
  int max_taps = int(std::ceil(support)) * 2 + 1;
  c.xmin.resize(out_size);
  c.count.resize(out_size);
  c.weights.assign(size_t(out_size) * max_taps, 0);
  c.max_taps = max_taps;
  std::vector<double> w(max_taps);
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int xlo = int(center - support + 0.5);
    if (xlo < 0) xlo = 0;
    int xhi = int(center + support + 0.5);
    if (xhi > in_size) xhi = in_size;
    double sum = 0.0;
    for (int x = xlo; x < xhi; ++x) {
      double arg = (x - center + 0.5) / filterscale;
      double v = arg < 0 ? -arg : arg;
      double t = v < 1.0 ? 1.0 - v : 0.0;  // triangle filter
      w[x - xlo] = t;
      sum += t;
    }
    int16_t* wq = &c.weights[size_t(i) * max_taps];
    int acc = 0;
    for (int k = 0; k < xhi - xlo; ++k) {
      // round each weight; force the set to sum to exactly 1<<kPrec by
      // assigning the residual to the last tap (bounds the accumulator)
      int q = int(std::lround(w[k] / sum * (1 << kPrec)));
      wq[k] = int16_t(q);
      acc += q;
    }
    if (xhi > xlo) wq[xhi - xlo - 1] = int16_t(wq[xhi - xlo - 1] +
                                               ((1 << kPrec) - acc));
    c.xmin[i] = xlo;
    c.count[i] = xhi - xlo;
  }
  return c;
}

inline uint8_t clamp_u8(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : uint8_t(v));
}

// (h, w, 3) uint8 -> (oh, ow, 3) uint8, horizontal then vertical.
void resize_u8(const uint8_t* src, int h, int w, uint8_t* dst, int oh,
               int ow) {
  if (oh == h && ow == w) {  // the taps are (1, 0): the identity
    std::memcpy(dst, src, size_t(h) * w * 3);
    return;
  }
  Coeffs cx = precompute_coeffs(w, ow);
  Coeffs cy = precompute_coeffs(h, oh);
  const int round = 1 << (kPrec - 1);
  std::vector<uint8_t> tmp(size_t(h) * ow * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + size_t(y) * w * 3;
    uint8_t* trow = &tmp[size_t(y) * ow * 3];
    for (int x = 0; x < ow; ++x) {
      const int16_t* wq = &cx.weights[size_t(x) * cx.max_taps];
      const uint8_t* px = row + size_t(cx.xmin[x]) * 3;
      int n = cx.count[x];
      int a0 = round, a1 = round, a2 = round;
      for (int k = 0; k < n; ++k) {
        a0 += wq[k] * px[3 * k + 0];
        a1 += wq[k] * px[3 * k + 1];
        a2 += wq[k] * px[3 * k + 2];
      }
      trow[x * 3 + 0] = clamp_u8(a0 >> kPrec);
      trow[x * 3 + 1] = clamp_u8(a1 >> kPrec);
      trow[x * 3 + 2] = clamp_u8(a2 >> kPrec);
    }
  }
  // vertical: for each output row, taps over tmp rows; the inner loop is
  // contiguous over ow*3 and auto-vectorizes
  int row_elems = ow * 3;
  std::vector<int32_t> acc(row_elems);
  for (int y = 0; y < oh; ++y) {
    const int16_t* wq = &cy.weights[size_t(y) * cy.max_taps];
    int y0 = cy.xmin[y], n = cy.count[y];
    for (int e = 0; e < row_elems; ++e) acc[e] = round;
    for (int k = 0; k < n; ++k) {
      const uint8_t* trow = &tmp[size_t(y0 + k) * row_elems];
      int16_t wk = wq[k];
      for (int e = 0; e < row_elems; ++e) acc[e] += wk * trow[e];
    }
    uint8_t* drow = dst + size_t(y) * row_elems;
    for (int e = 0; e < row_elems; ++e) drow[e] = clamp_u8(acc[e] >> kPrec);
  }
}

// out = px * (1 / (255 std)) - mean / std, per channel, with one rounding
// (fma): the JAX plane, built with -march=native, contracts its px * a + b
// into an FMA, and this build (no -march) would round twice.
void normalize_u8(const uint8_t* src, float* out, int oh, int ow,
                  const float* mean, const float* stddev) {
  float a[3], b[3];
  for (int ci = 0; ci < 3; ++ci) {
    a[ci] = 1.0f / (255.0f * stddev[ci]);
    b[ci] = -mean[ci] / stddev[ci];
  }
  size_t n = size_t(oh) * ow * 3;
  for (size_t i = 0; i < n; ++i)
    out[i] = std::fma(float(src[i]), a[i % 3], b[i % 3]);
}

// ---------------------------------------------------------------------------
// PNG image data (ISO/IEC 15948 sections 7-9): rows of one filter byte and
// `rowbytes` filtered bytes, per Adam7 pass when interlaced.

int channels_of(int color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
    default: return 0;
  }
}

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  return pb <= pc ? uint8_t(b) : uint8_t(c);
}

// Undo one row's filter: `raw` (n bytes after the filter byte) -> `cur`,
// with `prev` the previous unfiltered row of the pass (zeros for its
// first). `bpp` is the filter's byte distance: bytes per pixel, at least 1.
bool unfilter_row(int type, const uint8_t* raw, const uint8_t* prev,
                  uint8_t* cur, size_t n, size_t bpp) {
  switch (type) {
    case 0:
      std::memcpy(cur, raw, n);
      return true;
    case 1:  // Sub
      for (size_t i = 0; i < n; ++i)
        cur[i] = uint8_t(raw[i] + (i >= bpp ? cur[i - bpp] : 0));
      return true;
    case 2:  // Up
      for (size_t i = 0; i < n; ++i) cur[i] = uint8_t(raw[i] + prev[i]);
      return true;
    case 3:  // Average
      for (size_t i = 0; i < n; ++i) {
        int left = i >= bpp ? cur[i - bpp] : 0;
        cur[i] = uint8_t(raw[i] + ((left + prev[i]) >> 1));
      }
      return true;
    case 4:  // Paeth
      for (size_t i = 0; i < n; ++i) {
        if (i < bpp) {
          cur[i] = uint8_t(raw[i] + prev[i]);  // paeth(0, b, 0) == b
        } else {
          cur[i] = uint8_t(raw[i] + paeth(cur[i - bpp], prev[i],
                                          prev[i - bpp]));
        }
      }
      return true;
    default:
      return false;
  }
}

struct Format {
  int w, h, bit_depth, color_type, channels;
  const uint8_t* palette;  // 256 RGB entries, zero past the PLTE's
};

// One unfiltered row of `width` pixels -> RGB8 pixels `step` pixels apart
// from `dst`: palette expanded, gray below 8 bits scaled to 0..255, 16-bit
// samples cut to their high byte, alpha dropped, gray replicated.
void row_to_rgb(const uint8_t* row, int width, const Format& f,
                uint8_t* dst, int step) {
  const int ch = f.channels, bd = f.bit_depth;
  for (int x = 0; x < width; ++x, dst += 3 * step) {
    if (bd < 8) {
      int bit = x * bd;
      int v = (row[bit >> 3] >> (8 - bd - (bit & 7))) & ((1 << bd) - 1);
      if (f.color_type == 3) {
        std::memcpy(dst, f.palette + 3 * v, 3);
      } else {
        uint8_t g = uint8_t(v * (255 / ((1 << bd) - 1)));
        dst[0] = dst[1] = dst[2] = g;
      }
      continue;
    }
    const int bytes = bd / 8;  // 1 or 2: the high byte comes first
    const uint8_t* px = row + size_t(x) * ch * bytes;
    if (f.color_type == 3) {
      std::memcpy(dst, f.palette + 3 * px[0], 3);
    } else if (ch <= 2) {  // gray, gray + alpha
      dst[0] = dst[1] = dst[2] = px[0];
    } else {  // RGB, RGBA
      dst[0] = px[0];
      dst[1] = px[bytes];
      dst[2] = px[2 * bytes];
    }
  }
}

struct Pass {
  int x0, y0, dx, dy;
};
constexpr Pass kAdam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                            {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                            {0, 1, 1, 2}};
constexpr Pass kWhole = {0, 0, 1, 1};

// Unfiltered RGB8 image (h, w, 3) into `rgb` from the inflated stream.
// Returns 0, 1 when the stream is short, 2 on an unknown filter type.
int png_to_rgb(const uint8_t* raw, size_t raw_len, const Format& f,
               int interlace, uint8_t* rgb) {
  const Pass* passes = interlace ? kAdam7 : &kWhole;
  const int n_passes = interlace ? 7 : 1;
  // non-interlaced 8-bit RGB: the unfiltered rows are the image's rows
  const bool direct = !interlace && f.color_type == 2 && f.bit_depth == 8;
  const size_t bpp = std::max(1, f.channels * f.bit_depth / 8);
  size_t pos = 0;
  std::vector<uint8_t> prev, cur;
  for (int p = 0; p < n_passes; ++p) {
    const Pass& ps = passes[p];
    if (f.w <= ps.x0 || f.h <= ps.y0) continue;  // an empty pass: no rows
    const int pw = (f.w - ps.x0 + ps.dx - 1) / ps.dx;
    const int ph = (f.h - ps.y0 + ps.dy - 1) / ps.dy;
    const size_t rowbytes =
        (size_t(pw) * f.channels * f.bit_depth + 7) / 8;
    if (raw_len < pos + size_t(ph) * (rowbytes + 1)) return 1;
    prev.assign(rowbytes, 0);
    cur.resize(rowbytes);
    for (int y = 0; y < ph; ++y) {
      const uint8_t* src = raw + pos + 1;
      const int type = raw[pos];
      pos += rowbytes + 1;
      if (direct) {
        uint8_t* row = rgb + size_t(y) * rowbytes;
        const uint8_t* above = y ? row - rowbytes : prev.data();
        if (!unfilter_row(type, src, above, row, rowbytes, bpp)) return 2;
        continue;
      }
      if (!unfilter_row(type, src, prev.data(), cur.data(), rowbytes, bpp))
        return 2;
      const int oy = ps.y0 + y * ps.dy;
      row_to_rgb(cur.data(), pw, f,
                 rgb + (size_t(oy) * f.w + ps.x0) * 3, ps.dx);
      prev.swap(cur);
    }
  }
  return 0;
}

int decode_rgb(const uint8_t* raw, size_t raw_len, int w, int h,
               int bit_depth, int color_type, int interlace,
               const uint8_t* plte, int plte_n, std::vector<uint8_t>& rgb) {
  uint8_t palette[256 * 3] = {0};
  if (plte_n > 256) plte_n = 256;
  if (plte_n > 0) std::memcpy(palette, plte, size_t(plte_n) * 3);
  Format f{w, h, bit_depth, color_type, channels_of(color_type), palette};
  if (f.channels == 0 || w <= 0 || h <= 0) return 3;
  rgb.resize(size_t(h) * w * 3);
  return png_to_rgb(raw, raw_len, f, interlace, rgb.data());
}

}  // namespace

extern "C" {

// One PNG's inflated image data -> resized (oh, ow, 3) uint8. `raw` is the
// inflated stream of the concatenated IDAT chunks; `plte` holds `plte_n`
// RGB triples (palette images). Returns 0 on success, 1 when the stream
// is short, 2 on an unknown row filter, 3 on a bad header.
int dp_png_u8(const uint8_t* raw, size_t raw_len, int w, int h,
              int bit_depth, int color_type, int interlace,
              const uint8_t* plte, int plte_n, uint8_t* out, int oh,
              int ow) {
  std::vector<uint8_t> rgb;
  int rc = decode_rgb(raw, raw_len, w, h, bit_depth, color_type, interlace,
                      plte, plte_n, rgb);
  if (rc) return rc;
  resize_u8(rgb.data(), h, w, out, oh, ow);
  return 0;
}

// As dp_png_u8, then ImageNet-normalised float32 (oh, ow, 3).
int dp_png(const uint8_t* raw, size_t raw_len, int w, int h, int bit_depth,
           int color_type, int interlace, const uint8_t* plte, int plte_n,
           float* out, int oh, int ow, const float* mean,
           const float* stddev) {
  std::vector<uint8_t> rgb;
  int rc = decode_rgb(raw, raw_len, w, h, bit_depth, color_type, interlace,
                      plte, plte_n, rgb);
  if (rc) return rc;
  std::vector<uint8_t> resized(size_t(oh) * ow * 3);
  resize_u8(rgb.data(), h, w, resized.data(), oh, ow);
  normalize_u8(resized.data(), out, oh, ow, mean, stddev);
  return 0;
}

// (h, w, 3) uint8 -> (oh, ow, 3) uint8 through the fixed-point bilinear
// (the transforms' resizes, after a rotation too).
void dp_resize_u8(const uint8_t* src, int h, int w, uint8_t* dst, int oh,
                  int ow) {
  resize_u8(src, h, w, dst, oh, ow);
}

// What this build decodes (chip_smoke.py prints it).
const char* dp_route() {
  return "PNG only: chunks parsed and inflated in Python (zlib), rows "
         "unfiltered, expanded to RGB8 and resized in C++ (standard "
         "headers); no libpng, no libjpeg";
}

}  // extern "C"
