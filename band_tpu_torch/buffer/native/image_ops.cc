// Native image kernels: the libyuv analogue of the reference's data
// plane (band/buffer/libyuv_image_operator.cc).  Exported as a plain C
// ABI consumed through ctypes; each kernel is a tight loop the compiler
// auto-vectorizes.  Built on first use by band_tpu_torch/buffer/native/
// __init__.py (flags there).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// Bilinear resize, uint8 interleaved HxWxC -> OHxOWxC.
// half_pixel source mapping (matches the Python fallback).
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                        uint8_t* dst, int dh, int dw) {
  const float scale_h = static_cast<float>(sh) / dh;
  const float scale_w = static_cast<float>(sw) / dw;
  for (int oy = 0; oy < dh; ++oy) {
    float fy = (oy + 0.5f) * scale_h - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    if (y0 > sh - 1) y0 = sh - 1;
    int y1 = std::min(y0 + 1, sh - 1);
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int ox = 0; ox < dw; ++ox) {
      float fx = (ox + 0.5f) * scale_w - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      if (x0 > sw - 1) x0 = sw - 1;
      int x1 = std::min(x0 + 1, sw - 1);
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      const uint8_t* p00 = src + (y0 * sw + x0) * c;
      const uint8_t* p01 = src + (y0 * sw + x1) * c;
      const uint8_t* p10 = src + (y1 * sw + x0) * c;
      const uint8_t* p11 = src + (y1 * sw + x1) * c;
      uint8_t* out = dst + (oy * dw + ox) * c;
      for (int k = 0; k < c; ++k) {
        float top = p00[k] + (p01[k] - p00[k]) * wx;
        float bot = p10[k] + (p11[k] - p10[k]) * wx;
        float v = top + (bot - top) * wy;
        int iv = static_cast<int>(v + 0.5f);
        out[k] = static_cast<uint8_t>(iv < 0 ? 0 : (iv > 255 ? 255 : iv));
      }
    }
  }
}

// Nearest resize, uint8 interleaved.
void resize_nearest_u8(const uint8_t* src, int sh, int sw, int c,
                       uint8_t* dst, int dh, int dw) {
  for (int oy = 0; oy < dh; ++oy) {
    int sy = std::min(static_cast<int>(oy * static_cast<int64_t>(sh) / dh),
                      sh - 1);
    for (int ox = 0; ox < dw; ++ox) {
      int sx = std::min(static_cast<int>(ox * static_cast<int64_t>(sw) / dw),
                        sw - 1);
      std::memcpy(dst + (oy * dw + ox) * c, src + (sy * sw + sx) * c, c);
    }
  }
}

// BT.601 studio-swing YUV -> RGB for one pixel (libyuv-compatible
// fixed point: R = 1.164(Y-16) + 1.596(V-128), ...)
static inline void yuv_to_rgb_px(int y, int u, int v, uint8_t* out) {
  int c = y - 16, d = u - 128, e = v - 128;
  int r = (298 * c + 409 * e + 128) >> 8;
  int g = (298 * c - 100 * d - 208 * e + 128) >> 8;
  int b = (298 * c + 516 * d + 128) >> 8;
  out[0] = static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
  out[1] = static_cast<uint8_t>(g < 0 ? 0 : (g > 255 ? 255 : g));
  out[2] = static_cast<uint8_t>(b < 0 ? 0 : (b > 255 ? 255 : b));
}

// Shared row kernel for the planar/semiplanar converters.  The scalar
// per-pixel form (divides for the 4:2:0 chroma index + branchy clamps +
// interleaved stores) defeats auto-vectorization; restructured as three
// row passes the compiler vectorizes (the libyuv row-kernel structure):
//   A. expand the half-res chroma row to full-res int16 d/e rows
//      (pair-duplicate, unit-stride),
//   B. fixed-point math + clamp into planar int32 temporaries
//      (unit-stride, min/max clamps -> vector ops),
//   C. pure byte interleave into the RGB row.
// Bit-identical to yuv_to_rgb_px on every input.
static void yuv_row_to_rgb(const uint8_t* yrow, const int16_t* dful,
                           const int16_t* eful, int w, uint8_t* drow,
                           int32_t* rt, int32_t* gt, int32_t* bt) {
  for (int x = 0; x < w; ++x) {
    const int32_t c = 298 * (static_cast<int32_t>(yrow[x]) - 16);
    const int32_t d = dful[x], e = eful[x];
    int32_t r = (c + 409 * e + 128) >> 8;
    int32_t g = (c - 100 * d - 208 * e + 128) >> 8;
    int32_t b = (c + 516 * d + 128) >> 8;
    rt[x] = r < 0 ? 0 : (r > 255 ? 255 : r);
    gt[x] = g < 0 ? 0 : (g > 255 ? 255 : g);
    bt[x] = b < 0 ? 0 : (b > 255 ? 255 : b);
  }
  for (int x = 0; x < w; ++x) {
    drow[x * 3 + 0] = static_cast<uint8_t>(rt[x]);
    drow[x * 3 + 1] = static_cast<uint8_t>(gt[x]);
    drow[x * 3 + 2] = static_cast<uint8_t>(bt[x]);
  }
}

// NV12/NV21 (semiplanar) -> RGB. uv_order: 0 = UV (NV12), 1 = VU (NV21)
void nv_to_rgb_u8(const uint8_t* y_plane, const uint8_t* uv_plane, int h,
                  int w, int uv_order, uint8_t* dst) {
  const int uo = uv_order ? 1 : 0;
  std::vector<int16_t> dful(w), eful(w);
  std::vector<int32_t> tmp(3 * static_cast<size_t>(w));
  int32_t* rt = tmp.data();
  int32_t* gt = rt + w;
  int32_t* bt = gt + w;
  for (int yy = 0; yy < h; ++yy) {
    if ((yy & 1) == 0) {
      const uint8_t* uv_row = uv_plane + (yy / 2) * w;
      const int pairs = w / 2;
      for (int p = 0; p < pairs; ++p) {
        const int16_t d = static_cast<int16_t>(uv_row[2 * p + uo]) - 128;
        const int16_t e = static_cast<int16_t>(uv_row[2 * p + 1 - uo]) - 128;
        dful[2 * p] = d;
        dful[2 * p + 1] = d;
        eful[2 * p] = e;
        eful[2 * p + 1] = e;
      }
      if (w % 2) {  // odd width: last pixel uses the last pair's sample
        dful[w - 1] = static_cast<int16_t>(uv_row[(w / 2) * 2 + uo]) - 128;
        eful[w - 1] =
            static_cast<int16_t>(uv_row[(w / 2) * 2 + 1 - uo]) - 128;
      }
    }
    yuv_row_to_rgb(y_plane + static_cast<size_t>(yy) * w, dful.data(),
                   eful.data(), w, dst + static_cast<size_t>(yy) * w * 3,
                   rt, gt, bt);
  }
}

// I420/YV12 (planar) -> RGB
void i420_to_rgb_u8(const uint8_t* y_plane, const uint8_t* u_plane,
                    const uint8_t* v_plane, int h, int w, uint8_t* dst) {
  const int half_w = w / 2;
  std::vector<int16_t> dful(w), eful(w);
  std::vector<int32_t> tmp(3 * static_cast<size_t>(w));
  int32_t* rt = tmp.data();
  int32_t* gt = rt + w;
  int32_t* bt = gt + w;
  for (int yy = 0; yy < h; ++yy) {
    if ((yy & 1) == 0) {
      const uint8_t* urow = u_plane + (yy / 2) * half_w;
      const uint8_t* vrow = v_plane + (yy / 2) * half_w;
      for (int p = 0; p < half_w; ++p) {
        const int16_t d = static_cast<int16_t>(urow[p]) - 128;
        const int16_t e = static_cast<int16_t>(vrow[p]) - 128;
        dful[2 * p] = d;
        dful[2 * p + 1] = d;
        eful[2 * p] = e;
        eful[2 * p + 1] = e;
      }
      if (w % 2) {
        dful[w - 1] = static_cast<int16_t>(urow[half_w]) - 128;
        eful[w - 1] = static_cast<int16_t>(vrow[half_w]) - 128;
      }
    }
    yuv_row_to_rgb(y_plane + static_cast<size_t>(yy) * w, dful.data(),
                   eful.data(), w, dst + static_cast<size_t>(yy) * w * 3,
                   rt, gt, bt);
  }
}

// RGB -> GRAY (libyuv/BT.601 luma: (66R + 129G + 25B + 128) >> 8 + 16)
void rgb_to_gray_u8(const uint8_t* src, int n_px, uint8_t* dst) {
  for (int i = 0; i < n_px; ++i) {
    const uint8_t* p = src + i * 3;
    int yv = ((66 * p[0] + 129 * p[1] + 25 * p[2] + 128) >> 8) + 16;
    dst[i] = static_cast<uint8_t>(yv < 0 ? 0 : (yv > 255 ? 255 : yv));
  }
}

// Rotate interleaved uint8 by 90*k degrees counterclockwise.
//
// k=2 is a reversed copy with a unit-stride inner loop (flip-H of the
// row-reversed image).  k=1/3 are cache-blocked transposes: the dst
// row is the unit-stride axis and the src column reads stay inside one
// TILE x TILE block (TILE rows x TILE px x c <= 12 KB for c=3, L1-
// resident), replacing the round-2 per-pixel strided memcpy loop that
// measured 1559 MB/s (the slowest data-plane entry).
static const int kRotTile = 64;

}  // pause extern "C": templates need C++ linkage

#if defined(__SSE2__)
#include <emmintrin.h>

static inline void transpose4x4_u32(const uint32_t* a, int lda, uint32_t* b,
                                    int ldb) {
  __m128i r0 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(a));
  __m128i r1 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(a + lda));
  __m128i r2 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(a + 2 * lda));
  __m128i r3 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(a + 3 * lda));
  __m128i t0 = _mm_unpacklo_epi32(r0, r1);
  __m128i t1 = _mm_unpackhi_epi32(r0, r1);
  __m128i t2 = _mm_unpacklo_epi32(r2, r3);
  __m128i t3 = _mm_unpackhi_epi32(r2, r3);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(b),
                   _mm_unpacklo_epi64(t0, t2));
  _mm_storeu_si128(reinterpret_cast<__m128i*>(b + ldb),
                   _mm_unpackhi_epi64(t0, t2));
  _mm_storeu_si128(reinterpret_cast<__m128i*>(b + 2 * ldb),
                   _mm_unpacklo_epi64(t1, t3));
  _mm_storeu_si128(reinterpret_cast<__m128i*>(b + 3 * ldb),
                   _mm_unpackhi_epi64(t1, t3));
}

// Rotate-90 for c=3/c=4 through a u32 tile pipeline: stage the tile as
// RGBX u32 (unit-stride), transpose with SSE 4x4 u32 micro-kernels,
// emit dst rows unit-stride.  Replaces the scalar per-pixel loop
// (measured ~1.5 GB/s; the transpose micro-kernel path measures 4-5x
// that) — the libyuv TransposeWx8 idea with u32 lanes instead of byte
// shuffles.
template <int C>
static void rotate_quarter_simd(const uint8_t* src, int h, int w, int k,
                                uint8_t* dst) {
  const int ow = h;
  const int T = 64;
  alignas(16) uint32_t stage[64 * 64];
  alignas(16) uint32_t tt[64 * 64];
  for (int y0 = 0; y0 < h; y0 += T) {
    const int th = (y0 + T < h) ? T : h - y0;
    for (int x0 = 0; x0 < w; x0 += T) {
      const int tw = (x0 + T < w) ? T : w - x0;
      // stage: rows of src, u32 per pixel
      for (int i = 0; i < th; ++i) {
        const uint8_t* srow =
            src + (static_cast<size_t>(y0 + i) * w + x0) * C;
        uint32_t* prow = stage + i * T;
        if (C == 4) {
          std::memcpy(prow, srow, static_cast<size_t>(tw) * 4);
        } else {
          for (int j = 0; j < tw; ++j) {
            prow[j] = static_cast<uint32_t>(srow[j * 3]) |
                      (static_cast<uint32_t>(srow[j * 3 + 1]) << 8) |
                      (static_cast<uint32_t>(srow[j * 3 + 2]) << 16);
          }
        }
      }
      // transpose th x tw (4x4 SSE blocks; edge remainder scalar)
      const int th4 = th & ~3, tw4 = tw & ~3;
      for (int i = 0; i < th4; i += 4) {
        for (int j = 0; j < tw4; j += 4) {
          transpose4x4_u32(stage + i * T + j, T, tt + j * T + i, T);
        }
      }
      for (int i = th4; i < th; ++i) {
        for (int j = 0; j < tw; ++j) tt[j * T + i] = stage[i * T + j];
      }
      for (int i = 0; i < th4; ++i) {
        for (int j = tw4; j < tw; ++j) tt[j * T + i] = stage[i * T + j];
      }
      // emit: each transposed row j is one dst row segment
      for (int j = 0; j < tw; ++j) {
        const uint32_t* trow = tt + j * T;
        uint8_t* drow;
        if (k == 1) {  // dst[w-1-x][y]
          drow = dst + (static_cast<size_t>(w - 1 - (x0 + j)) * ow + y0) * C;
          if (C == 4) {
            std::memcpy(drow, trow, static_cast<size_t>(th) * 4);
          } else {
            for (int i = 0; i < th; ++i) {
              const uint32_t v = trow[i];
              drow[i * 3] = static_cast<uint8_t>(v);
              drow[i * 3 + 1] = static_cast<uint8_t>(v >> 8);
              drow[i * 3 + 2] = static_cast<uint8_t>(v >> 16);
            }
          }
        } else {  // k == 3: dst[x][h-1-y] (reversed along the row)
          drow = dst +
                 (static_cast<size_t>(x0 + j) * ow + (h - 1 - (y0 + th - 1)))
                 * C;
          for (int i = 0; i < th; ++i) {
            const uint32_t v = trow[i];
            uint8_t* p = drow + (th - 1 - i) * C;
            p[0] = static_cast<uint8_t>(v);
            p[1] = static_cast<uint8_t>(v >> 8);
            p[2] = static_cast<uint8_t>(v >> 16);
            if (C == 4) p[3] = static_cast<uint8_t>(v >> 24);
          }
        }
      }
    }
  }
}
#endif  // __SSE2__

template <int C>
static void rotate_quarter(const uint8_t* src, int h, int w, int k,
                           uint8_t* dst) {
#if defined(__SSE2__)
  if (C == 3 || C == 4) {
    rotate_quarter_simd<C>(src, h, w, k, dst);
    return;
  }
#endif
  const int ow = h;  // dst is (w, h, C)
  for (int x0 = 0; x0 < w; x0 += kRotTile) {
    const int x1 = (x0 + kRotTile < w) ? x0 + kRotTile : w;
    for (int y0 = 0; y0 < h; y0 += kRotTile) {
      const int y1 = (y0 + kRotTile < h) ? y0 + kRotTile : h;
      for (int x = x0; x < x1; ++x) {
        // dst row for this src column; dst x advances with src y
        uint8_t* drow = (k == 1)
            ? dst + (static_cast<size_t>(w - 1 - x) * ow + y0) * C
            : dst + (static_cast<size_t>(x) * ow + (h - 1 - (y1 - 1))) * C;
        const uint8_t* scol = src + (static_cast<size_t>(y0) * w + x) * C;
        const int n = y1 - y0;
        if (k == 1) {
          for (int i = 0; i < n; ++i) {
            for (int ch = 0; ch < C; ++ch) {
              drow[i * C + ch] = scol[static_cast<size_t>(i) * w * C + ch];
            }
          }
        } else {  // k == 3: dst x runs h-1-y, i.e. reversed
          for (int i = 0; i < n; ++i) {
            for (int ch = 0; ch < C; ++ch) {
              drow[(n - 1 - i) * C + ch] =
                  scol[static_cast<size_t>(i) * w * C + ch];
            }
          }
        }
      }
    }
  }
}

static void rotate_quarter_generic(const uint8_t* src, int h, int w, int c,
                                   int k, uint8_t* dst) {
  const int ow = h;
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y) {
      int oy = (k == 1) ? (w - 1 - x) : x;
      int ox = (k == 1) ? y : (h - 1 - y);
      std::memcpy(dst + (static_cast<size_t>(oy) * ow + ox) * c,
                  src + (static_cast<size_t>(y) * w + x) * c, c);
    }
  }
}

extern "C" {

void rotate_u8(const uint8_t* src, int h, int w, int c, int k, uint8_t* dst) {
  k = ((k % 4) + 4) % 4;
  if (k == 0) {
    std::memcpy(dst, src, static_cast<size_t>(h) * w * c);
    return;
  }
  if (k == 2) {
    // reverse rows and pixels; unit-stride vectorizable bodies
    if (c == 3) {
      for (int y = 0; y < h; ++y) {
        const uint8_t* srow = src + static_cast<size_t>(h - 1 - y) * w * 3;
        uint8_t* drow = dst + static_cast<size_t>(y) * w * 3;
        for (int x = 0; x < w; ++x) {
          const uint8_t* p = srow + (w - 1 - x) * 3;
          drow[x * 3 + 0] = p[0];
          drow[x * 3 + 1] = p[1];
          drow[x * 3 + 2] = p[2];
        }
      }
    } else {
      for (int y = 0; y < h; ++y) {
        const uint8_t* srow = src + static_cast<size_t>(h - 1 - y) * w * c;
        uint8_t* drow = dst + static_cast<size_t>(y) * w * c;
        for (int x = 0; x < w; ++x) {
          std::memcpy(drow + static_cast<size_t>(x) * c,
                      srow + static_cast<size_t>(w - 1 - x) * c, c);
        }
      }
    }
    return;
  }
  if (c == 1) rotate_quarter<1>(src, h, w, k, dst);
  else if (c == 3) rotate_quarter<3>(src, h, w, k, dst);
  else if (c == 4) rotate_quarter<4>(src, h, w, k, dst);
  else rotate_quarter_generic(src, h, w, c, k, dst);
}

// RGBA -> RGB (drop alpha; unit-stride vectorizable)
void rgba_to_rgb_u8(const uint8_t* src, int n_px, uint8_t* dst) {
  for (int i = 0; i < n_px; ++i) {
    dst[i * 3 + 0] = src[i * 4 + 0];
    dst[i * 3 + 1] = src[i * 4 + 1];
    dst[i * 3 + 2] = src[i * 4 + 2];
  }
}

// Horizontal / vertical flip.  Vertical is whole-row memcpy; horizontal
// has a vectorizable c=3 pixel loop.
void flip_u8(const uint8_t* src, int h, int w, int c, int horizontal,
             uint8_t* dst) {
  if (!horizontal) {
    const size_t row = static_cast<size_t>(w) * c;
    for (int y = 0; y < h; ++y) {
      std::memcpy(dst + y * row, src + (h - 1 - y) * row, row);
    }
    return;
  }
  if (c == 3) {
    for (int y = 0; y < h; ++y) {
      const uint8_t* srow = src + static_cast<size_t>(y) * w * 3;
      uint8_t* drow = dst + static_cast<size_t>(y) * w * 3;
      for (int x = 0; x < w; ++x) {
        const uint8_t* p = srow + (w - 1 - x) * 3;
        drow[x * 3 + 0] = p[0];
        drow[x * 3 + 1] = p[1];
        drow[x * 3 + 2] = p[2];
      }
    }
    return;
  }
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      std::memcpy(dst + (static_cast<size_t>(y) * w + x) * c,
                  src + (static_cast<size_t>(y) * w + (w - 1 - x)) * c, c);
    }
  }
}

// Normalize uint8 -> float32: (x - mean) / std
void normalize_u8_f32(const uint8_t* src, int n, float mean, float inv_std,
                      float* dst) {
  for (int i = 0; i < n; ++i) {
    dst[i] = (src[i] - mean) * inv_std;
  }
}

// Per-channel normalize (interleaved HWC): dst[i*c+k] =
// (src[i*c+k] - mean[k]) * inv_std[k].  Specialized c=3 body so the
// compiler vectorizes the pixel loop (the common RGB case).
void normalize_u8_f32_perchannel(const uint8_t* src, int n_px, int c,
                                 const float* mean, const float* inv_std,
                                 float* dst) {
  if (c == 3) {
    const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
    const float s0 = inv_std[0], s1 = inv_std[1], s2 = inv_std[2];
    for (int i = 0; i < n_px; ++i) {
      dst[i * 3 + 0] = (src[i * 3 + 0] - m0) * s0;
      dst[i * 3 + 1] = (src[i * 3 + 1] - m1) * s1;
      dst[i * 3 + 2] = (src[i * 3 + 2] - m2) * s2;
    }
    return;
  }
  for (int i = 0; i < n_px; ++i) {
    for (int k = 0; k < c; ++k) {
      dst[i * c + k] = (src[i * c + k] - mean[k]) * inv_std[k];
    }
  }
}

}  // extern "C"
