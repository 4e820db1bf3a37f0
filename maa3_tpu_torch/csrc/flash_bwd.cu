// Fused flash-attention backward: dq, dk and dv from one recompute of the
// scores with the saved lse, and delta = rowsum(do * o) computed outside.
//
// Replaces the TPU kernel maa3_tpu/ops/flash_attention.py::_bwd_fused_kernel
// (:224, pallas_call :654, called from _flash_pallas_bwd :588).
//
// What bounds it on the H100: 10 * Lq * Lk * D operations (five products of a
// 64 x 64 tile pair) against (4 Lq + 4 Lk) * D elements in and out, so
// arithmetic at training lengths. The design: a block owns one (b, h) pair
// and one 64-key tile. It keeps k and v in shared memory and dk, dv in
// registers, and walks over every 64-row query tile: S = q_s . k^T and
// dP = do . v^T, p = exp2(S - lse * log2 e) (0 for keys past Lk or masked
// out, and for query rows past Lq), dv += p_T^T . do with p rounded to v's
// type, ds = p * (dP - delta) rounded to q's type, dk += ds^T . q_s, and
// dq += ds . k * scale added to an fp32 (BH, Lq, D) buffer with atomicAdd,
// the counterpart of the Pallas body's full-length dq block. dk is scaled by
// ln 2 at the end (q_s carries scale * log2 e). The maskless Pallas body
// clamps the exponent at 120 (:278) because its zero-padded keys see
// exp2(-lse * log2 e); here such keys do not exist, so there is no clamp.
// Atomics make dq's last bits depend on the order the blocks finish.
#include "flash.cuh"

namespace maa3_flash {
namespace {

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (BH, Lq)
  const float* delta;  // (BH, Lq)
  const int* mask;
  float* dq;           // (BH, Lq, D), zeroed by the caller
  float* dk;           // (BH, Lk, D)
  float* dv;           // (BH, Lk, D)
  int h, lq, lk, d;
  float qmul;          // scale * log2(e)
  float scale;
};

template <int DP>
__host__ __device__ constexpr size_t bwd_smem_floats() {
  return static_cast<size_t>(4) * kTile * (DP + 1) + 2 * kTile * kSP + 2 * kTile;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  constexpr int P = DP + 1;
  constexpr int NJ = DP / 8;
  float* qs = smem;             // [64][P] scaled q tile
  float* dos = qs + kTile * P;  // [64][P] do tile
  float* ks = dos + kTile * P;  // [64][P] resident k tile
  float* vs = ks + kTile * P;   // [64][P] resident v tile
  float* ps = vs + kTile * P;   // [64 q][kSP] p rounded to T
  float* dss = ps + kTile * kSP;  // [64 q][kSP] ds rounded to T
  float* lse_s = dss + kTile * kSP;  // [64] lse * log2 e
  float* delta_s = lse_s + kTile;    // [64]
  const int bh = blockIdx.y, k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const size_t qoff = static_cast<size_t>(bh) * a.lq * a.d;
  const size_t koff = static_cast<size_t>(bh) * a.lk * a.d;
  const T* qg = static_cast<const T*>(a.q) + qoff;
  const T* dog = static_cast<const T*>(a.dout) + qoff;
  const T* kg = static_cast<const T*>(a.k) + koff;
  const int* mrow = a.mask ? a.mask + static_cast<size_t>(bh / a.h) * a.lk : nullptr;

  load_tile(ks, kg, k0, a.lk, a.d, DP, false, 1.0f);
  load_tile(vs, static_cast<const T*>(a.v) + koff, k0, a.lk, a.d, DP, false, 1.0f);
  bool valid[8];
  key_valid(valid, mrow, k0, a.lk, tx);

  float dk[4][NJ], dv[4][NJ], s[4][8], dp[4][8];
  zero(dk);
  zero(dv);
  for (int q0 = 0; q0 < a.lq; q0 += kTile) {
    __syncthreads();  // the previous tile's shared operands are consumed
    load_tile(qs, qg, q0, a.lq, a.d, DP, true, a.qmul);
    load_tile(dos, dog, q0, a.lq, a.d, DP, false, 1.0f);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool in = q0 + r < a.lq;
      const size_t i = static_cast<size_t>(bh) * a.lq + q0 + r;
      lse_s[r] = in ? a.lse[i] * kLog2e : 0.0f;
      delta_s[r] = in ? a.delta[i] : 0.0f;
    }
    __syncthreads();
    zero(s);
    zero(dp);
    mm_tile<8>(s, qs, P, 1, ks, 1, P, a.d, ty, tx);
    mm_tile<8>(dp, dos, P, 1, vs, 1, P, a.d, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const bool row_in = q0 + r < a.lq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = (row_in && valid[j]) ? exp2f(s[i][j] - lse_s[r]) : 0.0f;
        ps[r * kSP + tx + 8 * j] = round_as(p, kg);
        dss[r * kSP + tx + 8 * j] = round_as(p * (dp[i][j] - delta_s[r]), qg);
      }
    }
    __syncthreads();
    // rows of these products are keys: A[key][q] = ps[q][key]
    mm_tile<NJ>(dv, ps, 1, kSP, dos, P, 1, kTile, ty, tx);
    mm_tile<NJ>(dk, dss, 1, kSP, qs, P, 1, kTile, ty, tx);
    float dq[4][NJ];
    zero(dq);
    mm_tile<NJ>(dq, dss, kSP, 1, ks, P, 1, kTile, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row >= a.lq) continue;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int col = tx + 8 * jj;
        if (col < a.d)
          atomicAdd(a.dq + qoff + static_cast<size_t>(row) * a.d + col, dq[i][jj] * a.scale);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= a.lk) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = tx + 8 * jj;
      if (col < a.d) {
        const size_t o = koff + static_cast<size_t>(key) * a.d + col;
        a.dk[o] = dk[i][jj] * kLn2;
        a.dv[o] = dv[i][jj];
      }
    }
  }
}

template <typename T, int DP>
int launch(const BwdArgs& a, int bh, cudaStream_t stream) {
  const size_t smem = sizeof(float) * bwd_smem_floats<DP>();
  auto kern = flash_bwd_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.lk + kTile - 1) / kTile, bh);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const BwdArgs& a, int bh, cudaStream_t s) {
  switch (padded_dim(a.d)) {
    case 32: return launch<T, 32>(a, bh, s);
    case 72: return launch<T, 72>(a, bh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace maa3_flash

// q/do (bh, lq, d), k/v (bh, lk, d) in the input type; lse, delta (bh, lq)
// fp32; mask (bh / h, lk) int32 or null; dq (bh, lq, d) fp32 zeroed by the
// caller, dk/dv (bh, lk, d) fp32. dtype: 0 = float32, 1 = bfloat16. Returns
// the cudaError_t of the launch.
extern "C" int maa3_flash_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* mask, void* dq,
                              void* dk, void* dv, int bh, int h, int lq, int lk,
                              int d, float qmul, float scale, int dtype,
                              void* stream) {
  using namespace maa3_flash;
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta), static_cast<const int*>(mask),
            static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
            h, lq, lk, d, qmul, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, bh, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, bh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
