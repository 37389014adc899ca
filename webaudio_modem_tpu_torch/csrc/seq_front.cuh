// The demodulators' shared full-rate front end, used by K1 (fsk_seq.cu)
// and K6 (psk_seq.cu): AGC, band-pass pre-filter, NCO mix with a
// first-order renormalized rotation, I/Q low-pass biquads — the
// reference's ops/fsk_demod.py `_full_rate_step`.  Its 15 state floats
// are rows 0..14 of both kernels' front planes, in this order: AGC gain,
// pre (x1, x2, y1, y2), NCO (cos, sin), iq_i (x1, x2, y1, y2), iq_q (x1,
// x2, y1, y2).
//
// Numerics: every operation rounds as the plain PyTorch version
// (ops/kernels/fsk_seq.py `_full_rate_step`) does, in the same order,
// when built without fast math and with -fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

struct FskSeqCoef {
  float pre[5];   // b0 b1 b2 a1 a2
  float iq[5];
  float post[5];  // K1's post-detection low-pass (unused by K6)
  float agc_target, agc_attack, agc_release;
  float cw, sw;   // NCO rotation per sample
  float polarity;
  int agc_enabled, ratio, ds;
};

namespace wam {

constexpr int kFrontRows = 15;

__device__ __forceinline__ float biquad(const float c[5], float in, float x1,
                                        float x2, float y1, float y2) {
  // left to right, as the plain version: b0*x + b1*x1 + b2*x2 - a1*y1 - a2*y2
  float f = c[0] * in;
  f = f + c[1] * x1;
  f = f + c[2] * x2;
  f = f - c[3] * y1;
  f = f - c[4] * y2;
  return f;
}

struct Front {
  float g;
  float px1, px2, py1, py2;
  float nc, ns;
  float ix1, ix2, iy1, iy2;
  float qx1, qx2, qy1, qy2;

  // rows 0..14 of a [rows, B] plane, channel b
  __device__ __forceinline__ void load(const float* __restrict__ in,
                                       size_t Bs, int b) {
    float s[kFrontRows];
#pragma unroll
    for (int k = 0; k < kFrontRows; ++k) s[k] = in[k * Bs + b];
    g = s[0];
    px1 = s[1]; px2 = s[2]; py1 = s[3]; py2 = s[4];
    nc = s[5]; ns = s[6];
    ix1 = s[7]; ix2 = s[8]; iy1 = s[9]; iy2 = s[10];
    qx1 = s[11]; qx2 = s[12]; qy1 = s[13]; qy2 = s[14];
  }

  // rows first..14 (the warps of K1's pipeline each store their own)
  __device__ __forceinline__ void store(float* __restrict__ out, size_t Bs,
                                        int b, int first = 0) const {
    const float r[kFrontRows] = {g,   px1, px2, py1, py2, nc,  ns, ix1,
                                 ix2, iy1, iy2, qx1, qx2, qy1, qy2};
#pragma unroll
    for (int k = 0; k < kFrontRows; ++k)
      if (k >= first) out[k * Bs + b] = r[k];
  }

  // The AGC: returns the gained sample.  Its gain is the front end's
  // slowest recurrence (an IEEE divide on the chain).
  __device__ __forceinline__ float agc(const FskSeqCoef& c, float xt) {
    float y;
    if (c.agc_enabled) {
      y = xt * g;
      const float level = fabsf(y);
      const float tgt = c.agc_target / fmaxf(level, 1e-30f);
      const float rate = level > c.agc_target ? c.agc_attack : c.agc_release;
      if (level > 0.0f) {
        float gn = g + (tgt - g) * rate;
        gn = fminf(fmaxf(gn, 0.1f), 10.0f);
        g = gn;
      }
    } else {
      y = xt;
    }
    return y;
  }

  // The band-pass pre-filter, then the NCO mix with the phasor rotated
  // and renormalized to first order, then the I/Q low-pass biquads.  The
  // I/Q low-pass outputs are the new iy1 and qy1, and callers read them
  // there: handing them out through reference arguments cost K1 3.5 % on
  // an H100 (the compiler scheduled the unrolled loop worse), a return
  // value or none costs nothing.
  __device__ __forceinline__ void filter_mix(const FskSeqCoef& c, float y) {
    const float f = biquad(c.pre, y, px1, px2, py1, py2);
    px2 = px1; px1 = y; py2 = py1; py1 = f;
    const float i_r = f * nc;
    const float q_r = f * ns;
    const float nc2 = nc * c.cw - ns * c.sw;
    const float ns2 = ns * c.cw + nc * c.sw;
    const float kk = 1.5f - 0.5f * (nc2 * nc2 + ns2 * ns2);
    nc = nc2 * kk;
    ns = ns2 * kk;
    const float fi = biquad(c.iq, i_r, ix1, ix2, iy1, iy2);
    ix2 = ix1; ix1 = i_r; iy2 = iy1; iy1 = fi;
    const float fq = biquad(c.iq, q_r, qx1, qx2, qy1, qy2);
    qx2 = qx1; qx1 = q_r; qy2 = qy1; qy1 = fq;
  }

  // One full-rate sample (K6 runs the two parts in one thread).
  __device__ __forceinline__ void step(const FskSeqCoef& c, float xt) {
    filter_mix(c, agc(c, xt));
  }
};

}  // namespace wam
