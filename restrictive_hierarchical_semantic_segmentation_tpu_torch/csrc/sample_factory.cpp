// Native host-side sample factory of the data pipeline: a copy of the JAX
// package's runtime/sample_factory.cpp, kept in the port so that the port
// builds nothing of the JAX package. data/native.py compiles it with g++ at
// first use and binds it with ctypes.
//
// Implements the per-channel target chain of Data/dataset.py:397-476 with
// EXACT semantics but a restructured algorithm:
//
//   reference order:  per-channel binary mask -> bilinear resize -> hflip ->
//                     nearest affine (ch0 fills with its max, others -1) ->
//                     threshold 0.5 -> ternary encode
//
//   here:             (1) RESIZE+THRESHOLD fused into one pass producing a
//                         per-pixel channel BITMASK: channel value at an
//                         output pixel is the 4-neighbor bilinear sum of the
//                         channel indicator, so bit_c = (sum >= 0.5). This is
//                         bit-identical to resizing each channel plane and
//                         thresholding, at O(4) per pixel instead of O(C)
//                         full planes. The bitmask is cacheable across epochs
//                         (it is augmentation-independent).
//                     (2) HFLIP+AFFINE as a single nearest gather on the
//                         bitmask — valid because nearest-neighbor gathering
//                         commutes with thresholding; the reference's fill
//                         conventions (-1 -> 0 after threshold; channel 0
//                         keeps its max) become per-channel fill bits.
//                     (3) TERNARY+EXPAND to float32 channels in one pass.
//
// C ABI for ctypes. The numpy target path of data/dataset.py is the
// reference it is held to (tests/test_torch_native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Stage 1: pixel-coded mask (h, w) -> channel bitmask (S, S) uint32.
//   channel_nvals/channel_vals: per-channel pixel-value sets (parents carry
//   their descendant leaves' values), flattened. n_channels <= 32.
int rhss_mask_bits(const uint8_t* mask, int h, int w, int S,
                   const int32_t* channel_nvals, const int32_t* channel_vals,
                   int n_channels, uint32_t* bits_out) {
  if (n_channels > 32) return 1;
  // per-pixel-value channel membership bitmask
  uint32_t member[256];
  std::memset(member, 0, sizeof(member));
  int off = 0;
  for (int c = 0; c < n_channels; ++c) {
    for (int k = 0; k < channel_nvals[c]; ++k)
      member[channel_vals[off + k] & 0xff] |= (1u << c);
    off += channel_nvals[c];
  }
  const float sy_scale = (float)h / S, sx_scale = (float)w / S;
#pragma omp parallel for schedule(static)
  for (int y = 0; y < S; ++y) {
    float sy = (y + 0.5f) * sy_scale - 0.5f;
    sy = std::min(std::max(sy, 0.0f), (float)(h - 1));
    const int y0 = (int)sy, y1 = std::min(y0 + 1, h - 1);
    const float fy = sy - y0;
    for (int x = 0; x < S; ++x) {
      float sx = (x + 0.5f) * sx_scale - 0.5f;
      sx = std::min(std::max(sx, 0.0f), (float)(w - 1));
      const int x0 = (int)sx, x1 = std::min(x0 + 1, w - 1);
      const float fx = sx - x0;
      const uint32_t m00 = member[mask[y0 * w + x0]];
      const uint32_t m01 = member[mask[y0 * w + x1]];
      const uint32_t m10 = member[mask[y1 * w + x0]];
      const uint32_t m11 = member[mask[y1 * w + x1]];
      const float w00 = (1 - fy) * (1 - fx), w01 = (1 - fy) * fx;
      const float w10 = fy * (1 - fx), w11 = fy * fx;
      uint32_t bits = 0;
      const uint32_t any = m00 | m01 | m10 | m11;
      for (int c = 0; c < n_channels; ++c) {
        const uint32_t b = 1u << c;
        if (!(any & b)) continue;
        const float v = (m00 & b ? w00 : 0.f) + (m01 & b ? w01 : 0.f) +
                        (m10 & b ? w10 : 0.f) + (m11 & b ? w11 : 0.f);
        if (v >= 0.5f) bits |= b;
      }
      bits_out[y * S + x] = bits;
    }
  }
  return 0;
}

// Stage 2: bitmask (S, S) -> augmented target (S, S, C).
//   do_hflip: horizontal flip first (matches resize->hflip->affine order).
//   affine:   forward 2x3 row-major matrix [a b tx; c d ty] or null;
//             applied with nearest gathering (torchvision TF.affine default).
//   parent_channel: direct-parent channel per channel, -1 for roots.
//   hier:     ternary restrictive encoding iff != 0 (dataset.py:227-265).
// Fill semantics out-of-frame (dataset.py:446-451 + threshold): channel 0
// gets its global max bit, others 0.
//
// Templated over the output element type: float32 (numpy-path parity) or
// int8 (ternary values are exactly {-1, 0, 1} — 4x less host memory traffic
// and a 4x smaller host->device transfer; the train step upcasts on device).
}  // extern "C" (templates below need C++ linkage)

namespace {

template <typename T>
void expand_bits_impl(const uint32_t* bits, int S, int n_channels,
                      const int32_t* parent_channel, int hier, int do_hflip,
                      const double* affine, uint32_t fill_bits,
                      const double* inv, T* out) {
  // Precompute the full bits-value -> output-row LUT (2^C rows of C values);
  // expansion becomes gather + row copy (8 bytes/row for int8 at C == 8).
  const bool use_lut = n_channels <= 12;
  std::vector<T> lut;
  if (use_lut) {
    const size_t rows = (size_t)1 << n_channels;
    lut.resize(rows * n_channels);
    for (size_t b = 0; b < rows; ++b) {
      T* o = &lut[b * n_channels];
      for (int c = 0; c < n_channels; ++c) {
        const int on = (int)((b >> c) & 1);
        if (hier && parent_channel[c] >= 0) {
          const int p = parent_channel[c];
          o[c] = on ? T(1) : (((b >> p) & 1) ? T(0) : T(-1));
        } else {
          o[c] = T(on);
        }
      }
    }
  }

#pragma omp parallel for schedule(static)
  for (int y = 0; y < S; ++y) {
    // incremental stepping: the inverse map is affine in x, so walk the row
    // with two adds per pixel instead of four multiplies (double drift over
    // S steps is ~1e-13 — far below the lround decision boundary)
    double sxf = inv[1] * y + inv[2];
    double syf = inv[4] * y + inv[5];
    for (int x = 0; x < S; ++x, sxf += inv[0], syf += inv[3]) {
      uint32_t b;
      if (affine) {
        const long xs = std::lround(sxf), ys = std::lround(syf);
        if (xs >= 0 && xs < S && ys >= 0 && ys < S) {
          const long xg = do_hflip ? (S - 1 - xs) : xs;
          b = bits[ys * S + xg];
        } else {
          b = fill_bits;
        }
      } else {
        const int xg = do_hflip ? (S - 1 - x) : x;
        b = bits[y * S + xg];
      }
      T* o = &out[((size_t)y * S + x) * n_channels];
      if (use_lut) {
        std::memcpy(o, &lut[(size_t)b * n_channels], sizeof(T) * n_channels);
        continue;
      }
      for (int c = 0; c < n_channels; ++c) {
        const int on = (b >> c) & 1;
        if (hier) {
          const int p = parent_channel[c];
          if (p < 0) {
            o[c] = T(on);
          } else {
            o[c] = on ? T(1) : (((b >> p) & 1) ? T(0) : T(-1));
          }
        } else {
          o[c] = T(on);
        }
      }
    }
  }
}

template <typename T>
int expand_bits_entry(const uint32_t* bits, int S, int n_channels,
                      const int32_t* parent_channel, int hier, int do_hflip,
                      const double* affine, T* out) {
  // channel-0 fill bit = does channel 0 appear anywhere?
  uint32_t fill_bits = 0;
  if (affine) {
    for (int i = 0; i < S * S; ++i)
      if (bits[i] & 1u) { fill_bits = 1u; break; }
  }
  double inv[6] = {1, 0, 0, 0, 1, 0};
  if (affine) {
    const double a = affine[0], b = affine[1], tx = affine[2];
    const double c2 = affine[3], d = affine[4], ty = affine[5];
    const double det = a * d - b * c2;
    inv[0] = d / det;  inv[1] = -b / det; inv[2] = (b * ty - d * tx) / det;
    inv[3] = -c2 / det; inv[4] = a / det; inv[5] = (c2 * tx - a * ty) / det;
  }
  expand_bits_impl<T>(bits, S, n_channels, parent_channel, hier, do_hflip,
                      affine, fill_bits, inv, out);
  return 0;
}

}  // namespace

extern "C" {

int rhss_expand_bits(const uint32_t* bits, int S, int n_channels,
                     const int32_t* parent_channel, int hier, int do_hflip,
                     const double* affine, float* out) {
  return expand_bits_entry<float>(bits, S, n_channels, parent_channel, hier,
                                  do_hflip, affine, out);
}

int rhss_expand_bits_i8(const uint32_t* bits, int S, int n_channels,
                        const int32_t* parent_channel, int hier, int do_hflip,
                        const double* affine, int8_t* out) {
  return expand_bits_entry<int8_t>(bits, S, n_channels, parent_channel, hier,
                                   do_hflip, affine, out);
}

// Convenience: both stages in one call (no caching).
int rhss_make_target(const uint8_t* mask, int h, int w, int S,
                     const int32_t* channel_nvals, const int32_t* channel_vals,
                     int n_channels, const int32_t* parent_channel, int hier,
                     int do_hflip, const double* affine, float* out) {
  std::vector<uint32_t> bits((size_t)S * S);
  int rc = rhss_mask_bits(mask, h, w, S, channel_nvals, channel_vals,
                          n_channels, bits.data());
  if (rc) return rc;
  return rhss_expand_bits(bits.data(), S, n_channels, parent_channel, hier,
                          do_hflip, affine, out);
}

int rhss_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
