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
// out of device memory: a block owns one (b, h) pair and a tile of query
// rows (64 in fp32, 128 in bf16) and streams 64-key tiles of k and v past
// them. K3a runs two passes over the
// keys (the row max from q_s . k^T alone, then exp2(s - max) with the row sum
// and P.V), so its probabilities are those of the direct softmax of the
// Pallas body, not rescaled ones; K3b runs one pass with a running max and
// rescaling. Both round p to v's type before P.V, as the Pallas bodies do.
// Keys past Lk or masked out get p = 0, so there is no padding correction and
// a fully masked row gives o = 0.
//
// bf16 runs on the tensor cores (flash_fwd_tc_*_kernel, with the pieces of
// flash_mma.cuh): a block of two warpgroups owns 128 query rows, 64 each;
// its scaled q tile stays in shared memory as the A operand; k and v tiles
// stay bf16 in a double-buffered shared ring filled by cp.async, so the next
// tile is in flight while the current one is multiplied; S = q_s . k^T and
// o += p . v are wgmma products with fp32 accumulators in registers; the
// softmax runs on the S accumulators, and p, rounded to bf16, is the
// register A operand of p . v. exp2 is one ex2.approx per score (about
// 2^-22 relative, below the bf16 rounding of p). K3a's first pass runs
// q_s . k^T alone, with no v copies. fp32 stays on the scalar kernels below
// (fp32 FMA loops over fp32 shared tiles): the tensor cores take fp32 only
// as TF32, whose 10-bit mantissa would miss the fp32 gates (1e-4 of the
// plain version, and the card against the CPU). Nothing here uses atomics,
// and every sum runs in a fixed order, so two launches on the same inputs
// give the same bits.
#include "flash_mma.cuh"

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

// K3a, fp32: direct softmax.
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

// K3b, fp32: online softmax over 64-key tiles.
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

// The bf16 forward on the tensor cores, K3a (DIRECT) or K3b, for kFwdRows
// query rows: two warpgroups of 64 rows share each k and v tile. DP is the
// output's padded head dim (32 or 72), DK = mma_k_dim(DP) the depth of
// q_s . k^T, VEC the copy width.
template <int DP, int VEC, bool DIRECT>
__device__ __forceinline__ void flash_fwd_tc(const FwdArgs& a) {
  constexpr int DK = mma_k_dim(DP), NO = DP / 8;
  constexpr int TILE = kTile * DK;           // elements of one 64-row tile
  constexpr uint32_t kSlice = kTile * 16;    // bytes between 8-column slices
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // scaled q, 2 tiles
  bf16* ring = qs + 2 * TILE;                    // kStages x {k, v}
  int* mring = reinterpret_cast<int*>(ring + 2 * kStages * TILE);  // kStages x [64]
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;  // warp of its warpgroup
  const int bh = blockIdx.y, q0 = blockIdx.x * kFwdRows + (threadIdx.x / 128) * kTile;
  const bf16* qw = qs + (threadIdx.x / 128) * TILE;  // this warpgroup's q tile
  const size_t koff = static_cast<size_t>(bh) * a.lk * a.d;
  const bf16* kg = static_cast<const bf16*>(a.k) + koff;
  const bf16* vg = static_cast<const bf16*>(a.v) + koff;
  const int* mrow = a.mask ? a.mask + static_cast<size_t>(bh / a.h) * a.lk : nullptr;
  const bool masked = mrow != nullptr;
  const int nt = (a.lk + kTile - 1) / kTile;

  // columns d .. DK-1 of every tile stay zero; the copies never touch them
  zero_pad<DK>(qs, 2 + 2 * kStages, a.d);
  load_q_scaled<VEC, TILE>(qs, static_cast<const bf16*>(a.q) + static_cast<size_t>(bh) * a.lq * a.d,
                           blockIdx.x * kFwdRows, a.lq, a.d, a.qmul);
  fence_proxy_async();

  // One pass over the key tiles: tile t is copied into slot t % kStages
  // while tile t - 1 is multiplied; body(t, k tile, v tile, mask tile).
  auto sweep = [&](bool with_v, auto&& body) {
    auto issue = [&](int t) {
      bf16* ks = ring + (t % kStages) * 2 * TILE;
      copy_tile<VEC>(ks, kg, t * kTile, a.lk, a.d);
      if (with_v) copy_tile<VEC>(ks + TILE, vg, t * kTile, a.lk, a.d);
      if (masked && threadIdx.x < kTile) {
        const int key = t * kTile + threadIdx.x;
        copy_async_i32(mring + (t % kStages) * kTile + threadIdx.x,
                       key < a.lk ? mrow + key : mrow, key < a.lk);
      }
      cp_async_commit();
    };
    __syncthreads();  // every warp is done with the slots of an earlier sweep
    issue(0);
    for (int t = 0; t < nt; ++t) {
      cp_async_wait_all();
      fence_proxy_async();  // the copies are read by wgmma
      __syncthreads();      // tile t is in; every warp is done with tile t - 1
      if (t + 1 < nt) issue(t + 1);
      const bf16* ks = ring + (t % kStages) * 2 * TILE;
      body(t, ks, ks + TILE, mring + (t % kStages) * kTile);
    }
  };

  // S = q_s . k^T of the tile in ks (s[j]: keys 8j .. 8j + 7)
  float s[8][4] = {};
  auto scores = [&](const bf16* ks) {
    float(&d)[32] = reinterpret_cast<float(&)[32]>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_ss_n64(d, wgmma_desc(qw + kk * 2 * kTile * 8, kSlice, 128),
                   wgmma_desc(ks + kk * 2 * kTile * 8, kSlice, 128), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
  };

  // m[i], l[i]: fragment row g = lane / 4 + 8 i of this warp
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float o[NO][4] = {};
  bool ok[8][2];
  // a tile needs its keys checked only if a mask is given or it ends past Lk
  auto full = [&](int t) { return !masked && (t + 1) * kTile <= a.lk; };

  if constexpr (DIRECT) {  // pass 1: the row max over every valid key
    sweep(false, [&](int t, const bf16* ks, const bf16*, const int* ms) {
      scores(ks);
      if (full(t)) {
        tile_max<false>(m, s, ok);
      } else {
        tile_valid(ok, ms, masked, t * kTile, a.lk, lane);
        tile_max<true>(m, s, ok);
      }
    });
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
  }
  sweep(true, [&](int t, const bf16* ks, const bf16* vs, const int* ms) {
    scores(ks);
    const bool check = !full(t);
    if (check) tile_valid(ok, ms, masked, t * kTile, a.lk, lane);
    if constexpr (!DIRECT) {  // running max and rescaling, as the plain online route
      float mx[2] = {kNegInf, kNegInf};
      if (check) {
        tile_max<true>(mx, s, ok);
      } else {
        tile_max<false>(mx, s, ok);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        const float alpha = fast_exp2(m[i] - m_new);
        l[i] *= alpha;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          o[j][2 * i] *= alpha;
          o[j][2 * i + 1] *= alpha;
        }
        m[i] = m_new;
      }
    }
    if (check) {
      tile_exp<true>(s, m, l, ok);
    } else {
      tile_exp<false>(s, m, l, ok);
    }
    // o += bf16(p) . v: the accumulator layout of p is the A fragment
    // layout of keys 16kk .. 16kk + 15, so p stays in registers
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    float(&od)[DP / 2] = reinterpret_cast<float(&)[DP / 2]>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DP>(od, pa[kk], wgmma_desc(vs + 16 * kk * 8, 128, kSlice));
    wgmma_commit();
    wgmma_wait_all();
  });

  bf16* og = static_cast<bf16*>(a.o) + static_cast<size_t>(bh) * a.lq * a.d;
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * i;
    const float den = fmaxf(quad_sum(l[i]), 1e-30f);
    if (row >= a.lq) continue;
    bf16* orow = og + static_cast<size_t>(row) * a.d;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = 8 * j + c0;
      const float lo = o[j][2 * i] / den, hi = o[j][2 * i + 1] / den;
      if ((a.d & 1) == 0 && col < a.d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(lo, hi);
      } else {
        if (col < a.d) orow[col] = __float2bfloat16(lo);
        if (col + 1 < a.d) orow[col + 1] = __float2bfloat16(hi);
      }
    }
    if ((lane & 3) == 0) a.lse[static_cast<size_t>(bh) * a.lq + row] = (m[i] + log2f(den)) * kLn2;
  }
}

template <int DP, int VEC>
__global__ void __launch_bounds__(kFwdThreads) flash_fwd_tc_direct_kernel(FwdArgs a) {
  flash_fwd_tc<DP, VEC, true>(a);
}
template <int DP, int VEC>
__global__ void __launch_bounds__(kFwdThreads) flash_fwd_tc_online_kernel(FwdArgs a) {
  flash_fwd_tc<DP, VEC, false>(a);
}

template <typename K>
int launch_kernel(K kern, size_t smem, int rows, int threads, const FwdArgs& a, int bh,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.lq + rows - 1) / rows, bh);
  kern<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_fp32(const FwdArgs& a, int bh, bool direct, cudaStream_t stream) {
  const size_t smem = sizeof(float) * fwd_smem_floats<DP>();
  return launch_kernel(direct ? &flash_fwd_direct_kernel<float, DP>
                              : &flash_fwd_online_kernel<float, DP>,
                       smem, kTile, kThreads, a, bh, stream);
}

template <int DP, int VEC>
int launch_tc(const FwdArgs& a, int bh, bool direct, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (2 + 2 * kStages) * kTile * mma_k_dim(DP) +
                      sizeof(int) * kStages * kTile;
  return launch_kernel(direct ? &flash_fwd_tc_direct_kernel<DP, VEC>
                              : &flash_fwd_tc_online_kernel<DP, VEC>,
                       smem, kFwdRows, kFwdThreads, a, bh, stream);
}

// The widest copy every row of q, k and v allows: VEC values of 2 bytes need
// d % VEC == 0 and base pointers aligned to 2 VEC bytes.
inline int copy_width(const FwdArgs& a) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v);
  for (int vec = 8; vec > 1; vec /= 2)
    if (a.d % vec == 0 && bits % (2 * vec) == 0) return vec;
  return 1;
}

template <int DP>
int launch_bf16(const FwdArgs& a, int bh, bool direct, cudaStream_t s) {
  switch (copy_width(a)) {
    case 8: return launch_tc<DP, 8>(a, bh, direct, s);
    case 4: return launch_tc<DP, 4>(a, bh, direct, s);
    case 2: return launch_tc<DP, 2>(a, bh, direct, s);
    default: return launch_tc<DP, 1>(a, bh, direct, s);
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
  const int dp = padded_dim(d);
  if (dtype == 0 && dp == 32) return launch_fp32<32>(a, bh, direct != 0, s);
  if (dtype == 0 && dp == 72) return launch_fp32<72>(a, bh, direct != 0, s);
  if (dtype == 1 && dp == 32) return launch_bf16<32>(a, bh, direct != 0, s);
  if (dtype == 1 && dp == 72) return launch_bf16<72>(a, bh, direct != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
