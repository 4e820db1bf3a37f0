// Fused flash-attention backward (K4a): dq, dk and dv from one recompute of
// the scores with the saved lse, and delta = rowsum(do * o) computed outside.
//
// Replaces the TPU kernel maa3_tpu/ops/flash_attention.py::_bwd_fused_kernel
// (:224, pallas_call :654, called from _flash_pallas_bwd :588).
//
// What bounds it on the H100: 10 * Lq * Lk * D operations (five products of
// a key tile and a query tile) against (4 Lq + 4 Lk) * D elements in and out,
// so arithmetic at training lengths. Both routes keep k, v and the sums of
// dk, dv of a key tile on the chip and walk every query tile; dq is summed
// over key tiles with fp32 atomics into a zeroed (BH, Lq, D) buffer, the
// counterpart of the Pallas body's full-length dq block, so its last bits
// depend on the order the blocks finish. dk is scaled by ln 2 at the end
// (q_s carries scale * log2 e). The maskless Pallas body clamps the exponent
// at 120 (:278) because its zero-padded keys see exp2(-lse * log2 e); here
// such keys do not exist, so there is no clamp.
// - bf16 runs on the tensor cores: flash_bwd_tc_fused_kernel in
//   flash_bwd_tc.cuh (two warpgroups own 128 keys; transposed scores on
//   wgmma, P^T and dS^T as register A operands of dV and dK, dQ as a shared x
//   shared wgmma split by columns between the warpgroups; q_s written by a
//   prologue kernel and streamed with do through a cp.async ring).
// - fp32 stays on the scalar kernel below (the tensor cores take fp32 only as
//   TF32, which would miss the fp32 gates): a block owns one (b, h) pair and
//   one 64-key tile, 128 threads, fp32 shared tiles and FMA loops (flash.cuh):
//   S = q_s . k^T and dP = do . v^T, p = exp2(S - lse * log2 e) (0 for keys
//   past Lk or masked out, and for query rows past Lq), dv += p^T . do,
//   ds = p * (dP - delta), dk += ds^T . q_s, dq += ds . k * scale.
#include "flash_bwd_tc.cuh"

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

int dispatch_fp32(const BwdArgs& a, int bh, cudaStream_t s) {
  switch (padded_dim(a.d)) {
    case 32: return launch<float, 32>(a, bh, s);
    case 72: return launch<float, 72>(a, bh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace maa3_flash

// q/do (bh, lq, d), k/v (bh, lk, d) in the input type; lse, delta (bh, lq)
// fp32; mask (bh / h, lk) int32 or null; dq (bh, lq, d) fp32 zeroed by the
// caller, dk/dv (bh, lk, d) fp32; qs: bf16 scratch of q's size (bf16 only,
// else null). dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of
// the launches.
extern "C" int maa3_flash_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* mask, void* dq,
                              void* dk, void* dv, void* qs, int bh, int h, int lq,
                              int lk, int d, float qmul, float scale, int dtype,
                              void* stream) {
  using namespace maa3_flash;
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta), static_cast<const int*>(mask),
            static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
            h, lq, lk, d, qmul, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_fp32(a, bh, s);
  if (dtype == 1) {
    BwdTcArgs t{nullptr, static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                static_cast<const bf16*>(dout), a.lse, a.delta, a.mask, a.dq, dk, dv,
                h, lq, lk, d, scale};
    return run_bwd_tc<kK4a>(t, static_cast<const bf16*>(q), static_cast<bf16*>(qs), bh, qmul,
                            s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
