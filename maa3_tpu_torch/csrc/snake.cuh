// Device code shared by the two anti-aliased snake kernels (aa_snake.cu,
// conv_snake.cu): BigVGAN's Activation1d(snake / snake-beta) with the 2x /
// 12-tap kaiser-sinc filters over one row of a (rows, T) signal, either as a
// run of consecutive outputs computed by one thread in registers (act_run,
// act_run_generic: K1, and K2's bf16 route) or by one thread block over a
// window in shared memory (snake_phases, down_at: K2's fp32 route).
//
// Semantics are those of FusedActivation1d (maa3_tpu/ops/resample.py:174 and
// maa3_tpu_torch/ops/resample.py): x is replicate-padded by 5, upsampled by
// two 6-tap polyphase FIRs (gain 2), passed through
//     s = v + sin^2(a v) / (b + 1e-9)          (fp32; a, b after exp when
//                                               the parameters are log-scale)
// and decimated by a 12-tap FIR over the interleaved phases, where an
// s-index < 0 clamps to s_even[0] and one > 2T-1 to s_odd[T-1] (across
// parity). The filter taps below are the fp32 values of
// kaiser_sinc_filter1d(0.25, 0.3, 12) (times 2 for the upsampler); a CPU test
// checks them against the Python filters bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace maa3 {

static __constant__ float kFUp[12] = {
    4.057933111e-03f, 1.877892762e-02f, -5.108692870e-02f, -1.153147519e-01f,
    2.571452260e-01f, 8.864195943e-01f, 8.864195943e-01f, 2.571452260e-01f,
    -1.153147519e-01f, -5.108692870e-02f, 1.877892762e-02f, 4.057933111e-03f};
static __constant__ float kFDn[12] = {
    2.028966555e-03f, 9.389463812e-03f, -2.554346435e-02f, -5.765737593e-02f,
    1.285726130e-01f, 4.432097971e-01f, 4.432097971e-01f, 1.285726130e-01f,
    -5.765737593e-02f, -2.554346435e-02f, 9.389463812e-03f, 2.028966555e-03f};
// cos(pi s) as an even polynomial in s^2 (maa3_tpu/ops/resample.py:28-33)
static __constant__ float kCosPi[8] = {
    1.000000000e+00f, -4.934802055e+00f, 4.058712006e+00f, -1.335260749e+00f,
    2.353221327e-01f, -2.578785457e-02f, 1.905911951e-03f, -8.916972729e-05f};
constexpr float kInvPi = 3.183098733e-01f;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// round to the storage type and back (the activation output a conv reads)
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// sin^2(u) = (1 - cos(2u)) / 2 with round-half-even range reduction
// (sin2_poly); the fp32 path uses libm-grade sinf instead.
__device__ __forceinline__ float sin2_poly(float u) {
  float v = u * kInvPi;
  float t = v - rintf(v);
  float w = (2.0f * t) * (2.0f * t);
  float c = kCosPi[7];
#pragma unroll
  for (int k = 6; k >= 0; --k) c = c * w + kCosPi[k];
  return 0.5f * (1.0f - c);
}

__device__ __forceinline__ float snake(float v, float a, float ib, bool fast) {
  float u = a * v;
  float s2;
  if (fast) {
    s2 = sin2_poly(u);
  } else {
    float s = sinf(u);
    s2 = s * s;
  }
  return v + ib * s2;
}

// Effective per-channel coefficients: a, and ib = 1 / (b + 1e-9) with b = beta
// (snake-beta) or alpha (snake), exp'ed when log-scale (snake_coeffs).
__device__ __forceinline__ void snake_coeffs(const float* alpha,
                                             const float* beta, int c,
                                             bool has_beta, bool logscale,
                                             float* a, float* ib) {
  float av = logscale ? expf(alpha[c]) : alpha[c];
  float bv = av;
  if (has_beta) bv = logscale ? expf(beta[c]) : beta[c];
  *a = av;
  *ib = 1.0f / (bv + 1e-9f);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Fill the snake phases for act outputs g in [g0, g0 + W) of one row:
//   xs[l] = x[clamp(g0 - 6 + l)],           l in [0, W + 12)
//   se[l], so[l] = s_even, s_odd at m = g0 - 3 + l with the edge clamps
//                  folded in,               l in [0, W + 6)
// Every thread of the block must call it (it synchronises twice).
template <typename T>
__device__ void snake_phases(const T* __restrict__ xrow, int n, int g0, int W,
                             float a, float ib, bool fast, float* xs,
                             float* se, float* so) {
  for (int l = threadIdx.x; l < W + 12; l += blockDim.x)
    xs[l] = load_f(xrow + clampi(g0 - 6 + l, 0, n - 1));
  __syncthreads();
  const int base = g0 - 6;
  for (int l = threadIdx.x; l < W + 6; l += blockDim.x) {
    int m = g0 - 3 + l;
    int mc = clampi(m, 0, n - 1);
    // up_even[m] = sum_{j odd} f[j] x[m + (15 - j)/2 - 5]
    // up_odd[m]  = sum_{j even} f[j] x[m + (16 - j)/2 - 5]
    float ue = 0.0f, uo = 0.0f;
#pragma unroll
    for (int j = 1; j < 12; j += 2)
      ue += kFUp[j] * xs[clampi(mc + (15 - j) / 2 - 5, 0, n - 1) - base];
#pragma unroll
    for (int j = 0; j < 12; j += 2)
      uo += kFUp[j] * xs[clampi(mc + (16 - j) / 2 - 5, 0, n - 1) - base];
    float sev = snake(ue, a, ib, fast);
    float sov = snake(uo, a, ib, fast);
    if (m < 0) sov = sev;       // s-index < 0 -> s_even[0]
    if (m > n - 1) sev = sov;   // s-index > 2T-1 -> s_odd[T-1]
    se[l] = sev;
    so[l] = sov;
  }
  __syncthreads();
}

// Decimated act output at g = g0 + l: y = sum_j fdn[j] s~[2g + j - 5].
__device__ __forceinline__ float down_at(const float* se, const float* so,
                                         int l) {
  float y = 0.0f;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    if (j & 1)
      y += kFDn[j] * se[l + 3 + (j - 5) / 2];
    else
      y += kFDn[j] * so[l + 3 + (j - 6) / 2];
  }
  return y;
}

// The pair of snake phases at m from w[k] = x[m - 3 + k], k = 0 .. 6:
// s_even = snake(up_even[m]), up_even[m] = sum_{j odd} f[j] x[m + (15 - j)/2 - 5];
// s_odd = snake(up_odd[m]), up_odd[m] = sum_{j even} f[j] x[m + (16 - j)/2 - 5].
__device__ __forceinline__ void snake_pair(const float* w, float a, float ib, bool fast,
                                           float* se, float* so) {
  float ue = 0.0f, uo = 0.0f;
#pragma unroll
  for (int j = 1; j < 12; j += 2) ue += kFUp[j] * w[(15 - j) / 2 - 2];
#pragma unroll
  for (int j = 0; j < 12; j += 2) uo += kFUp[j] * w[(16 - j) / 2 - 2];
  *se = snake(ue, a, ib, fast);
  *so = snake(uo, a, ib, fast);
}

// x[0 .. N) from p into fp32 registers in 16-byte pieces (p 16-byte
// aligned; a bf16 is the top half of its fp32).
template <int N>
__device__ __forceinline__ void load_run(const float* __restrict__ p, float (&xv)[N]) {
  static_assert(N % 4 == 0, "whole 16-byte pieces");
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + q);
    xv[4 * q] = f.x;
    xv[4 * q + 1] = f.y;
    xv[4 * q + 2] = f.z;
    xv[4 * q + 3] = f.w;
  }
}
template <int N>
__device__ __forceinline__ void load_run(const __nv_bfloat16* __restrict__ p,
                                         float (&xv)[N]) {
  static_assert(N % 8 == 0, "whole 16-byte pieces");
#pragma unroll
  for (int q = 0; q < N / 8; ++q) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + q);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xv[8 * q + 2 * e] = __uint_as_float(w[e] << 16);
      xv[8 * q + 2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
}

// The activation at g = gs .. gs + R - 1 of one row, handed to sink(l, y)
// for l = 0 .. R - 1 in order: the arithmetic of snake_phases / down_at in
// registers, for a run whose x[gs - 8 .. gs + R + 8) lies inside the row
// and starts on a 16-byte boundary (so no clamp and no edge rule binds).
// x comes in 16-byte pieces; pair i of snake phases (at m = gs - 3 + i)
// completes output i - 6, y[g] = sum_j fdn[j] s~[2g + j - 5], so the R + 6
// pairs and R outputs are one straight-line sweep that keeps only a window
// of phases live. kPoly picks sin2_poly, else libm's sinf.
template <int R, bool kPoly, typename T, typename Sink>
__device__ __forceinline__ void act_run(const T* __restrict__ xrow, int gs, float a,
                                        float ib, Sink& sink) {
  float xv[R + 16];  // x[gs - 8 + i]
  load_run(xrow + gs - 8, xv);
  float se[R + 6], so[R + 6];
#pragma unroll
  for (int i = 0; i < R + 6; ++i) {
    snake_pair(xv + i + 2, a, ib, kPoly, se + i, so + i);
    if (i >= 6) sink(i - 6, down_at(se, so, i - 6));
  }
}

// act_run for every other run: one that touches the row's ends (x read with
// clamped indices; an s-index below 0 takes s_even[0], one past 2n - 1
// takes s_odd[n - 1]), a row off 16-byte boundaries, or the sin the
// straight-line run was not built for. The same sums in the same order in a
// rolled loop over the pairs, with sliding windows in registers (x[m - 3 ..
// m + 3] for the pair at m, the phases of the last seven pairs) and no
// local arrays: these runs are a few per row (all of them only off the main
// path), so the code stays small, and its loads mostly hit L1. gs may lie
// outside [0, n); sink(l, y) gets every l = 0 .. R - 1 and drops or zeroes
// the outputs outside the row itself.
template <int R, typename T, typename Sink>
__device__ __noinline__ void act_run_generic(const T* __restrict__ xrow, int n, int gs,
                                             float a, float ib, bool fast, Sink sink) {
  float ue0 = 0.0f, uo1 = 0.0f;  // up_even at m = 0, up_odd at m = n - 1
#pragma unroll
  for (int j = 1; j < 12; j += 2) ue0 += kFUp[j] * load_f(xrow + clampi((15 - j) / 2 - 5, 0, n - 1));
#pragma unroll
  for (int j = 0; j < 12; j += 2)
    uo1 += kFUp[j] * load_f(xrow + clampi(n - 1 + (16 - j) / 2 - 5, 0, n - 1));
  const float first = snake(ue0, a, ib, fast), last = snake(uo1, a, ib, fast);
  // w[k] = x[m - 3 + k] for the pair at m (clamped); pe[k], po[k] = s_even,
  // s_odd of pair i - 6 + k after pair i
  float w[7], pe[7] = {}, po[7] = {};
#pragma unroll
  for (int k = 1; k < 7; ++k) w[k] = load_f(xrow + clampi(gs - 7 + k, 0, n - 1));
#pragma unroll 1
  for (int i = 0; i < R + 6; ++i) {
    const int m = gs - 3 + i;
#pragma unroll
    for (int k = 0; k < 6; ++k) w[k] = w[k + 1];
    w[6] = load_f(xrow + clampi(m + 3, 0, n - 1));
    float sev = first, sov = first;
    if (m > n - 1) {
      sev = sov = last;
    } else if (m >= 0) {
      snake_pair(w, a, ib, fast, &sev, &sov);
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      pe[k] = pe[k + 1];
      po[k] = po[k + 1];
    }
    pe[6] = sev;
    po[6] = sov;
    if (i >= 6) sink(i - 6, down_at(pe, po, 0));
  }
}

}  // namespace maa3
