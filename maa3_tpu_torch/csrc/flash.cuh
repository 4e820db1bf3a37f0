// Device code shared by the flash-attention kernels (flash_fwd.cu: K3a, K3b;
// flash_bwd.cu: K4a; flash_bwd_split.cu: K4b, K4c).
//
// Layout: q, o, do (BH, Lq, D) and k, v (BH, Lk, D), row-major, no padding
// in device memory; an optional key mask (B, Lk) int32 (nonzero = valid)
// shared by the H heads of a batch row. A block of kThreads = 128 threads
// works on 64 x 64 tiles: thread (ty, tx) = (tid / 8, tid % 8) owns tile rows
// ty*4 .. ty*4+3 and columns tx + 8*j, so the 8 threads of a row group are
// lanes of one warp and row reductions are three xor shuffles. Operand tiles
// sit in shared memory as fp32 values already rounded to the input type, in
// rows of pitch D_pad + 1 (or 64 + 1) so the strided reads of a product hit
// distinct banks; D_pad is a multiple of 8 >= D and the columns D .. D_pad-1
// are zero. Products are plain fp32 FMA loops: the backward kernels and the
// fp32 forward use them; the bf16 forward runs on the tensor cores with the
// pieces of flash_mma.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace maa3_flash {

constexpr int kTile = 64;       // query rows and keys per tile
constexpr int kThreads = 128;   // 16 row groups x 8 column lanes
constexpr int kSP = kTile + 1;  // pitch of a (64 x 64) score tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T's precision (round to nearest even), kept in fp32
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Rows [r0, r0 + 64) of a (n, d) matrix into s[64][dp + 1]; zero past n and
// in columns d .. dp-1. With `mul`, each value is multiplied by it in fp32
// and rounded back to T (the JAX `_scale_q`).
template <typename T>
__device__ void load_tile(float* s, const T* g, int r0, int n, int d, int dp,
                          bool scaled, float mul) {
  const int pitch = dp + 1;
  for (int i = threadIdx.x; i < kTile * dp; i += kThreads) {
    const int r = i / dp, c = i - (i / dp) * dp;
    float v = 0.0f;
    if (r0 + r < n && c < d) {
      v = to_f(g[static_cast<size_t>(r0 + r) * d + c]);
      if (scaled) v = round_as(v * mul, g);
    }
    s[r * pitch + c] = v;
  }
}

// acc[i][j] += sum_{kk < n} A[(ty*4 + i)*a_r + kk*a_k] * B[kk*b_k + (tx + 8j)*b_c]
template <int NJ>
__device__ __forceinline__ void mm_tile(float (&acc)[4][NJ], const float* A,
                                        int a_r, int a_k, const float* B,
                                        int b_k, int b_c, int n, int ty,
                                        int tx) {
  const float* a0 = A + ty * 4 * a_r;
  const float* b0 = B + tx * b_c;
  for (int kk = 0; kk < n; ++kk) {
    float a[4], b[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a0[i * a_r + kk * a_k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = b0[kk * b_k + 8 * j * b_c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) a[i][j] = 0.0f;
}

// max / sum over the 8 column lanes of a row group
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// valid[j]: key k0 + tx + 8j exists and is not masked out
__device__ __forceinline__ void key_valid(bool (&valid)[8], const int* mrow,
                                          int k0, int lk, int tx) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int key = k0 + tx + 8 * j;
    valid[j] = key < lk && (mrow == nullptr || mrow[key] != 0);
  }
}

// The backward's per-tile-pair step, shared by K4a, K4b and K4c. From the
// shared tiles qs (scaled q), dos, ks, vs ([64][DP + 1]) and the rows' lse
// (times log2 e) and delta: S = q_s . k^T and dP = do . v^T, then
// p = exp2(S - lse) (0 where !valid[j] or for tile rows >= rows), written to
// ps rounded to T unless ps is null, and ds = p * (dP - delta) rounded to T,
// written to dss ([64 q][kSP]). The caller synchronises before and after.
template <typename T, int DP>
__device__ __forceinline__ void bwd_p_ds(float* ps, float* dss, const float* qs,
                                         const float* dos, const float* ks,
                                         const float* vs, const float* lse_s,
                                         const float* delta_s,
                                         const bool (&valid)[8], int rows, int d,
                                         int ty, int tx) {
  constexpr int P = DP + 1;
  const T* tag = nullptr;
  float s[4][8], dp[4][8];
  zero(s);
  zero(dp);
  mm_tile<8>(s, qs, P, 1, ks, 1, P, d, ty, tx);
  mm_tile<8>(dp, dos, P, 1, vs, 1, P, d, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const bool row_in = r < rows;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = (row_in && valid[j]) ? exp2f(s[i][j] - lse_s[r]) : 0.0f;
      if (ps != nullptr) ps[r * kSP + tx + 8 * j] = round_as(p, tag);
      dss[r * kSP + tx + 8 * j] = round_as(p * (dp[i][j] - delta_s[r]), tag);
    }
  }
}

// lse (times log2 e) and delta of query rows [q0, q0 + 64) of pair bh; 0 past lq
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse, const float* delta,
                                          int bh, int q0, int lq) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool in = q0 + r < lq;
    const size_t i = static_cast<size_t>(bh) * lq + q0 + r;
    lse_s[r] = in ? lse[i] * kLog2e : 0.0f;
    delta_s[r] = in ? delta[i] : 0.0f;
  }
}

// The padded head dim a kernel is instantiated for (0: unsupported). The
// bf16 forward pads its products' depth further, to mma_k_dim (flash_mma.cuh:
// 32 -> 32, 72 -> 80), and keeps this one for its output columns.
inline int padded_dim(int d) {
  if (d <= 0) return 0;
  if (d <= 32) return 32;
  if (d <= 72) return 72;
  return 0;
}

}  // namespace maa3_flash
