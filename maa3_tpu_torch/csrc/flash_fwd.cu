// Flash-attention forward over (BH, Lq, D) queries and (BH, Lk, D) keys and
// values, with an optional (B, Lk) key mask: o (BH, Lq, D) in the input type
// and the per-row natural-log log-sum-exp lse (BH, Lq) fp32.
//
// Replaces the TPU kernels of maa3_tpu/ops/flash_attention.py:
//   K3a  _fwd_single_kernel (:78, pallas_call :527): direct softmax over the
//        whole key range (the route for round_up(Lk, 16) <= 1536);
//   K3b  _fwd_online_kernel (:118, pallas_call :562): online softmax over key
//        blocks (longer key ranges, or an explicit block_k).
//
// What bounds it on the H100: 4 * Lq * Lk * D operations against
// (2 Lq + 2 Lk) * D elements, so arithmetic, not memory, at training lengths
// (1248 keys: ~600 operations per byte). The design keeps the (Lq, Lk) scores
// out of device memory: a block owns one (b, h) pair and 64 query rows, holds
// its scaled q tile in shared memory and streams 64-key tiles of k and v
// through it. K3a runs two passes over the keys (the row max, then
// exp2(s - max) with the row sum and P.V), so its probabilities are those of
// the direct softmax of the Pallas body, not rescaled ones; K3b runs one pass
// with a running max and rescaling. Both round p to v's type before P.V, as
// the Pallas bodies do. Keys past Lk or masked out get p = 0, so there is no
// padding correction and a fully masked row gives o = 0. Products are fp32
// FMA loops over shared-memory tiles (no tensor cores: right first).
#include "flash.cuh"

namespace maa3_flash {
namespace {

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;
  void* o;
  float* lse;
  int h, lq, lk, d;
  float qmul;  // scale * log2(e)
};

template <int DP>
__host__ __device__ constexpr size_t fwd_smem_floats() {
  return static_cast<size_t>(3) * kTile * (DP + 1) + kTile * kSP;
}

// S = (q * scale * log2 e) . k^T for the 64 x 64 tile at key k0 (k tile in ks)
template <int DP>
__device__ __forceinline__ void scores(float (&s)[4][8], const float* qs,
                                       const float* ks, int d, int ty, int tx) {
  zero(s);
  mm_tile<8>(s, qs, DP + 1, 1, ks, 1, DP + 1, d, ty, tx);
}

template <typename T, int DP>
__device__ __forceinline__ void finish(const FwdArgs& a, float (&acc)[4][DP / 8],
                                       const float (&m)[4], const float (&l)[4],
                                       int bh, int q0, int ty, int tx) {
  T* o = static_cast<T*>(a.o) + static_cast<size_t>(bh) * a.lq * a.d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.lq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      const int col = tx + 8 * jj;
      if (col < a.d) store_f(o + static_cast<size_t>(row) * a.d + col, acc[i][jj] / den);
    }
    if (tx == 0) a.lse[static_cast<size_t>(bh) * a.lq + row] = (m[i] + log2f(den)) * kLn2;
  }
}

// K3a: direct softmax.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_direct_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  constexpr int P = DP + 1;
  float* qs = smem;            // [64][P] scaled q
  float* ks = qs + kTile * P;  // [64][P]
  float* vs = ks + kTile * P;  // [64][P]
  float* ps = vs + kTile * P;  // [64][kSP] p rounded to T
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const size_t qoff = static_cast<size_t>(bh) * a.lq * a.d;
  const size_t koff = static_cast<size_t>(bh) * a.lk * a.d;
  const T* kg = static_cast<const T*>(a.k) + koff;
  const T* vg = static_cast<const T*>(a.v) + koff;
  const int* mrow = a.mask ? a.mask + static_cast<size_t>(bh / a.h) * a.lk : nullptr;
  load_tile(qs, static_cast<const T*>(a.q) + qoff, q0, a.lq, a.d, DP, true, a.qmul);

  float m[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
  float s[4][8];
  bool valid[8];
  for (int k0 = 0; k0 < a.lk; k0 += kTile) {  // pass 1: row max
    __syncthreads();
    load_tile(ks, kg, k0, a.lk, a.d, DP, false, 1.0f);
    __syncthreads();
    scores<DP>(s, qs, ks, a.d, ty, tx);
    key_valid(valid, mrow, k0, a.lk, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (valid[j]) m[i] = fmaxf(m[i], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = row_max(m[i]);

  float l[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc[4][DP / 8];
  zero(acc);
  for (int k0 = 0; k0 < a.lk; k0 += kTile) {  // pass 2: p, row sum, P.V
    __syncthreads();
    load_tile(ks, kg, k0, a.lk, a.d, DP, false, 1.0f);
    load_tile(vs, vg, k0, a.lk, a.d, DP, false, 1.0f);
    __syncthreads();
    scores<DP>(s, qs, ks, a.d, ty, tx);
    key_valid(valid, mrow, k0, a.lk, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = valid[j] ? exp2f(s[i][j] - m[i]) : 0.0f;
        rs += p;
        ps[(ty * 4 + i) * kSP + tx + 8 * j] = round_as(p, kg);
      }
      l[i] += row_sum(rs);
    }
    __syncthreads();
    mm_tile<DP / 8>(acc, ps, kSP, 1, vs, P, 1, kTile, ty, tx);
  }
  finish<T, DP>(a, acc, m, l, bh, q0, ty, tx);
}

// K3b: online softmax over 64-key tiles.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_online_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  constexpr int P = DP + 1;
  float* qs = smem;
  float* ks = qs + kTile * P;
  float* vs = ks + kTile * P;
  float* ps = vs + kTile * P;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const size_t qoff = static_cast<size_t>(bh) * a.lq * a.d;
  const size_t koff = static_cast<size_t>(bh) * a.lk * a.d;
  const T* kg = static_cast<const T*>(a.k) + koff;
  const T* vg = static_cast<const T*>(a.v) + koff;
  const int* mrow = a.mask ? a.mask + static_cast<size_t>(bh / a.h) * a.lk : nullptr;
  load_tile(qs, static_cast<const T*>(a.q) + qoff, q0, a.lq, a.d, DP, true, a.qmul);

  float m[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
  float l[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc[4][DP / 8];
  zero(acc);
  float s[4][8];
  bool valid[8];
  for (int k0 = 0; k0 < a.lk; k0 += kTile) {
    __syncthreads();
    load_tile(ks, kg, k0, a.lk, a.d, DP, false, 1.0f);
    load_tile(vs, vg, k0, a.lk, a.d, DP, false, 1.0f);
    __syncthreads();
    scores<DP>(s, qs, ks, a.d, ty, tx);
    key_valid(valid, mrow, k0, a.lk, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (valid[j]) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = valid[j] ? exp2f(s[i][j] - m_new) : 0.0f;
        rs += p;
        ps[(ty * 4 + i) * kSP + tx + 8 * j] = round_as(p, kg);
      }
      l[i] = alpha * l[i] + row_sum(rs);
#pragma unroll
      for (int jj = 0; jj < DP / 8; ++jj) acc[i][jj] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
    mm_tile<DP / 8>(acc, ps, kSP, 1, vs, P, 1, kTile, ty, tx);
  }
  finish<T, DP>(a, acc, m, l, bh, q0, ty, tx);
}

template <typename T, int DP>
int launch(const FwdArgs& a, int bh, bool direct, cudaStream_t stream) {
  const size_t smem = sizeof(float) * fwd_smem_floats<DP>();
  auto kern = direct ? &flash_fwd_direct_kernel<T, DP> : &flash_fwd_online_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.lq + kTile - 1) / kTile, bh);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const FwdArgs& a, int bh, bool direct, cudaStream_t s) {
  switch (padded_dim(a.d)) {
    case 32: return launch<T, 32>(a, bh, direct, s);
    case 72: return launch<T, 72>(a, bh, direct, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace maa3_flash

// q (bh, lq, d), k/v (bh, lk, d), o (bh, lq, d) in the input type; mask
// (bh / h, lk) int32 or null; lse (bh, lq) fp32. dtype: 0 = float32,
// 1 = bfloat16. direct: 1 = K3a, 0 = K3b. Returns the cudaError_t of the launch.
extern "C" int maa3_flash_fwd(const void* q, const void* k, const void* v,
                              const void* mask, void* o, void* lse, int bh,
                              int h, int lq, int lk, int d, float qmul,
                              int dtype, int direct, void* stream) {
  using namespace maa3_flash;
  FwdArgs a{q, k, v, static_cast<const int*>(mask), o, static_cast<float*>(lse),
            h, lq, lk, d, qmul};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, bh, direct != 0, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, bh, direct != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
