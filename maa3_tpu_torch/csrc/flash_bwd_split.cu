// Split flash-attention backward: K4b gives dk and dv, K4c gives dq, each
// from its own recompute of the scores with the saved lse, and
// delta = rowsum(do * o) computed outside.
//
// Replaces the TPU kernels maa3_tpu/ops/flash_attention.py::_bwd_dkv_kernel
// (K4b, :170, pallas_call :689) and ::_bwd_dq_kernel (K4c, :299, pallas_call
// :718), the split branch of _flash_pallas_bwd (:676-742).
//
// What bounds them on the H100: K4b does four products of a 64 x 64 tile
// pair (S, dP, dv, dk: 8 * Lq * Lk * D operations), K4c three (S, dP, dq:
// 6 * Lq * Lk * D), against (4 Lq + 4 Lk) * D elements in and out, so
// arithmetic at training lengths, like K4a (five products, 10 * Lq * Lk * D).
// The design:
// - K4b: a block owns one (b, h) pair and one 64-key tile. It keeps k and v in
//   shared memory and dk, dv in fp32 registers, and walks every 64-row query
//   tile: p = exp2(S - lse * log2 e) (0 for keys past Lk or masked out, and for
//   query rows past Lq), dv += p_T^T . do with p rounded to v's type,
//   ds = p * (dP - delta) rounded to q's type, dk += ds^T . q_s. dk is scaled
//   by ln 2 at the end (q_s carries scale * log2 e); dk and dv are written once,
//   in k's and v's type. It is K4a without the dq atomics.
// - K4c: a block owns one (b, h) pair and one 64-query tile. It keeps q_s, do,
//   lse and delta of its rows in shared memory and dq in fp32 registers, and
//   walks every 64-key tile with the same S, p, dP and ds, then
//   dq += ds . k. dq is scaled by `scale` and written once, in q's type. No
//   atomics: dq is the same bits on every run.
// Both take the mask as it comes (null: every key valid); there is no padding
// and no exp2 clamp, and a query row whose keys are all masked gets p = 0,
// hence zero gradients. The products are plain fp32 FMA loops (flash.cuh).
#include "flash.cuh"

namespace maa3_flash {
namespace {

struct SplitArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (BH, Lq)
  const float* delta;  // (BH, Lq)
  const int* mask;
  void* out0;          // K4b: dk (BH, Lk, D); K4c: dq (BH, Lq, D); input type
  void* out1;          // K4b: dv (BH, Lk, D)
  int h, lq, lk, d;
  float qmul;          // scale * log2(e)
  float scale;
};

// four [64][DP + 1] operand tiles, two (K4b: p and ds) or one (K4c: ds)
// [64][kSP] score tiles, and the 64 rows' lse and delta
template <int DP>
constexpr size_t split_smem_floats(bool dkv) {
  return static_cast<size_t>(4) * kTile * (DP + 1) + (dkv ? 2 : 1) * kTile * kSP +
         2 * kTile;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(SplitArgs a) {
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
  const int* mrow = a.mask ? a.mask + static_cast<size_t>(bh / a.h) * a.lk : nullptr;

  load_tile(ks, static_cast<const T*>(a.k) + koff, k0, a.lk, a.d, DP, false, 1.0f);
  load_tile(vs, static_cast<const T*>(a.v) + koff, k0, a.lk, a.d, DP, false, 1.0f);
  bool valid[8];
  key_valid(valid, mrow, k0, a.lk, tx);

  float dk[4][NJ], dv[4][NJ];
  zero(dk);
  zero(dv);
  for (int q0 = 0; q0 < a.lq; q0 += kTile) {
    __syncthreads();  // the previous tile's shared operands are consumed
    load_tile(qs, qg, q0, a.lq, a.d, DP, true, a.qmul);
    load_tile(dos, dog, q0, a.lq, a.d, DP, false, 1.0f);
    load_rows(lse_s, delta_s, a.lse, a.delta, bh, q0, a.lq);
    __syncthreads();
    bwd_p_ds<T, DP>(ps, dss, qs, dos, ks, vs, lse_s, delta_s, valid, a.lq - q0, a.d,
                    ty, tx);
    __syncthreads();
    // rows of these products are keys: A[key][q] = ps[q][key]
    mm_tile<NJ>(dv, ps, 1, kSP, dos, P, 1, kTile, ty, tx);
    mm_tile<NJ>(dk, dss, 1, kSP, qs, P, 1, kTile, ty, tx);
  }
  T* dkg = static_cast<T*>(a.out0) + koff;
  T* dvg = static_cast<T*>(a.out1) + koff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= a.lk) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = tx + 8 * jj;
      if (col < a.d) {
        const size_t o = static_cast<size_t>(key) * a.d + col;
        store_f(dkg + o, dk[i][jj] * kLn2);
        store_f(dvg + o, dv[i][jj]);
      }
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(SplitArgs a) {
  extern __shared__ float smem[];
  constexpr int P = DP + 1;
  constexpr int NJ = DP / 8;
  float* qs = smem;             // [64][P] resident scaled q tile
  float* dos = qs + kTile * P;  // [64][P] resident do tile
  float* ks = dos + kTile * P;  // [64][P] k tile
  float* vs = ks + kTile * P;   // [64][P] v tile
  float* dss = vs + kTile * P;  // [64 q][kSP] ds rounded to T
  float* lse_s = dss + kTile * kSP;  // [64] lse * log2 e
  float* delta_s = lse_s + kTile;    // [64]
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const size_t qoff = static_cast<size_t>(bh) * a.lq * a.d;
  const size_t koff = static_cast<size_t>(bh) * a.lk * a.d;
  const T* kg = static_cast<const T*>(a.k) + koff;
  const T* vg = static_cast<const T*>(a.v) + koff;
  const int* mrow = a.mask ? a.mask + static_cast<size_t>(bh / a.h) * a.lk : nullptr;

  load_tile(qs, static_cast<const T*>(a.q) + qoff, q0, a.lq, a.d, DP, true, a.qmul);
  load_tile(dos, static_cast<const T*>(a.dout) + qoff, q0, a.lq, a.d, DP, false, 1.0f);
  load_rows(lse_s, delta_s, a.lse, a.delta, bh, q0, a.lq);

  float dq[4][NJ];
  zero(dq);
  for (int k0 = 0; k0 < a.lk; k0 += kTile) {
    __syncthreads();  // the previous tile's k, v and ds are consumed
    load_tile(ks, kg, k0, a.lk, a.d, DP, false, 1.0f);
    load_tile(vs, vg, k0, a.lk, a.d, DP, false, 1.0f);
    bool valid[8];
    key_valid(valid, mrow, k0, a.lk, tx);
    __syncthreads();
    bwd_p_ds<T, DP>(nullptr, dss, qs, dos, ks, vs, lse_s, delta_s, valid, a.lq - q0,
                    a.d, ty, tx);
    __syncthreads();
    mm_tile<NJ>(dq, dss, kSP, 1, ks, P, 1, kTile, ty, tx);
  }
  T* dqg = static_cast<T*>(a.out0) + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.lq) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = tx + 8 * jj;
      if (col < a.d) store_f(dqg + static_cast<size_t>(row) * a.d + col, dq[i][jj] * a.scale);
    }
  }
}

template <typename T, int DP>
int launch(const SplitArgs& a, int bh, bool dkv, cudaStream_t stream) {
  const size_t smem = sizeof(float) * split_smem_floats<DP>(dkv);
  void (*kern)(SplitArgs) =
      dkv ? &flash_bwd_dkv_kernel<T, DP> : &flash_bwd_dq_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(((dkv ? a.lk : a.lq) + kTile - 1) / kTile, bh);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const SplitArgs& a, int bh, bool dkv, cudaStream_t s) {
  switch (padded_dim(a.d)) {
    case 32: return launch<T, 32>(a, bh, dkv, s);
    case 72: return launch<T, 72>(a, bh, dkv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(const SplitArgs& a, int bh, bool dkv, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, bh, dkv, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, bh, dkv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace maa3_flash

// q/do (bh, lq, d), k/v (bh, lk, d) in the input type; lse, delta (bh, lq)
// fp32; mask (bh / h, lk) int32 or null. dtype: 0 = float32, 1 = bfloat16.
// Each returns the cudaError_t of the launch.

// K4b: dk, dv (bh, lk, d) in the input type.
extern "C" int maa3_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* mask, void* dk,
                                  void* dv, int bh, int h, int lq, int lk, int d,
                                  float qmul, int dtype, void* stream) {
  using namespace maa3_flash;
  SplitArgs a{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), static_cast<const int*>(mask),
              dk, dv, h, lq, lk, d, qmul, 1.0f};
  return run(a, bh, true, dtype, stream);
}

// K4c: dq (bh, lq, d) in the input type.
extern "C" int maa3_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* mask, void* dq,
                                 int bh, int h, int lq, int lk, int d, float qmul,
                                 float scale, int dtype, void* stream) {
  using namespace maa3_flash;
  SplitArgs a{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), static_cast<const int*>(mask),
              dq, nullptr, h, lq, lk, d, qmul, scale};
  return run(a, bh, false, dtype, stream);
}
