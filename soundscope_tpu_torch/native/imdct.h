// Shared fast IMDCT: the standard MDCT synthesis
//   x[n] = sum_{k<N/2} X[k] cos(2pi/N (n + 0.5 + N/4)(k + 0.5))
// computed as a DCT-IV via an N/4-point complex FFT (pre/post twiddle +
// odd/even interleave + quarter-shift unfolding). Extracted from the
// Vorbis decoder (native/vorbis.cpp), where the derivation was
// validated against a direct evaluation of the sum; the AAC filterbank
// (native/aac.cpp) uses the identical synthesis form, so both decoders
// share this one implementation.
//
// N must be a power of two, >= 8. Double-precision internals: the
// result matches a direct double evaluation to ~1e-12 relative, far
// below the decoders' float output precision.
#pragma once

#include <cmath>
#include <cstdint>
#include <vector>

namespace ssdsp {

struct Imdct {
  int N = 0;
  std::vector<double> pre_r, pre_i;    // e^{-i pi (t+0.25)/M}
  std::vector<double> post_r, post_i;  // e^{-i pi s/M}
  std::vector<double> wr, wi;          // FFT twiddles
  std::vector<uint32_t> rev;
  std::vector<double> re, im, c;

  void init(int n) {
    N = n;
    int M = n / 2, H = M / 2;
    pre_r.resize(H); pre_i.resize(H);
    post_r.resize(H); post_i.resize(H);
    for (int t = 0; t < H; t++) {
      double a = -M_PI * (t + 0.25) / M;
      pre_r[t] = std::cos(a); pre_i[t] = std::sin(a);
      double bta = -M_PI * t / M;
      post_r[t] = std::cos(bta); post_i[t] = std::sin(bta);
    }
    int lg = 0;
    while ((1 << lg) < H) lg++;
    rev.resize(H);
    for (int i = 0; i < H; i++) {
      uint32_t r = 0;
      for (int j = 0; j < lg; j++) r |= ((i >> j) & 1u) << (lg - 1 - j);
      rev[i] = r;
    }
    wr.resize(H); wi.resize(H);
    for (int i = 0; i < H; i++) {
      double a = -2.0 * M_PI * i / H;  // forward FFT kernel
      wr[i] = std::cos(a); wi[i] = std::sin(a);
    }
    re.resize(H); im.resize(H); c.resize(M);
  }

  void fft() {
    int H = (int)re.size();
    for (int i = 0; i < H; i++) {
      uint32_t r = rev[i];
      if ((uint32_t)i < r) {
        std::swap(re[i], re[r]);
        std::swap(im[i], im[r]);
      }
    }
    for (int len = 2; len <= H; len <<= 1) {
      int half = len >> 1, stride = H / len;
      for (int i = 0; i < H; i += len) {
        for (int j = 0; j < half; j++) {
          double twr = wr[(size_t)j * stride], twi = wi[(size_t)j * stride];
          double xr = re[i + j + half] * twr - im[i + j + half] * twi;
          double xi = re[i + j + half] * twi + im[i + j + half] * twr;
          re[i + j + half] = re[i + j] - xr;
          im[i + j + half] = im[i + j] - xi;
          re[i + j] += xr;
          im[i + j] += xi;
        }
      }
    }
  }

  // X: N/2 spectral coefficients -> x: N time samples
  void run(const float* X, float* x) {
    int M = N / 2, H = M / 2, q = N / 4;
    for (int t = 0; t < H; t++) {
      double ur = X[2 * t];
      double ui = X[M - 1 - 2 * t];
      re[t] = ur * pre_r[t] - ui * pre_i[t];
      im[t] = ur * pre_i[t] + ui * pre_r[t];
    }
    fft();
    for (int s = 0; s < H; s++) {
      double vr = re[s] * post_r[s] - im[s] * post_i[s];
      double vi = re[s] * post_i[s] + im[s] * post_r[s];
      c[2 * s] = vr;
      c[M - 1 - 2 * s] = -vi;
    }
    for (int n = 0; n < q; n++) x[n] = (float)c[q + n];
    for (int n = q; n < 3 * q; n++) x[n] = (float)-c[3 * q - 1 - n];
    for (int n = 3 * q; n < N; n++) x[n] = (float)-c[n - 3 * q];
  }
};

}  // namespace ssdsp
