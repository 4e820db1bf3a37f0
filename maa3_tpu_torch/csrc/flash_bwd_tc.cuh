// The bf16 flash-attention backward on the tensor cores: one design for K4a
// (flash_bwd.cu: dq, dk, dv) and K4b (flash_bwd_split.cu: dk, dv), which walk
// the query tiles of a key block, and K4c (flash_bwd_split.cu: dq), which
// walks the key tiles of a query block, all built from the pieces of
// flash_mma.cuh.
//
// Replaces, in bf16, the TPU kernels maa3_tpu/ops/flash_attention.py::
// _bwd_fused_kernel (:224, pallas_call :654), ::_bwd_dkv_kernel (:170,
// pallas_call :689) and ::_bwd_dq_kernel (:299, pallas_call :718).
//
// What bounds them on the H100: five products of a key tile and a query
// tile (K4a; four for K4b, three for K4c) against each input read once,
// 10 (8, 6) * Lq * Lk * D operations against (4 Lq + 4 Lk) * D bf16
// elements, so the tensor cores at training lengths (about 500 operations
// per byte at 1248 tokens). The design of K4a and K4b (FlashAttention-3's
// transposed backward, without its warp specialisation):
// - A block of two warpgroups owns 128 keys of one (b, h) pair, 64 keys per
//   warpgroup. Its k and v tiles stay resident in shared memory, bf16, in the
//   interleave layout; dK and dV stay in fp32 registers and are written once.
// - The block walks the 64-row query tiles. q_s (q * scale * log2 e rounded
//   to bf16, written to a scratch by the prologue kernel below, the JAX
//   `_scale_q`), do and the tile's lse and delta rows arrive through a 2-slot
//   cp.async ring, so the next tile's copies overlap this tile's products.
// - Scores are computed transposed: S^T = k . q_s^T and dP^T = v . do^T
//   (m64n64k16, both operands K-major from shared memory, depth D padded to
//   mma_k_dim). Keys are the accumulator rows, so P^T = exp2(S^T - lse log2 e)
//   rounded to bf16 and dS^T = bf16(P^T (dP^T - delta)) are already the
//   register A operands of dV += P^T . do and dK += dS^T . q_s (m64n72k16,
//   m64n32k16 at D <= 32; B = do or q_s read MN-major with the transpose bit,
//   as v in the forward). lse and delta index the columns: each thread reads
//   its 16 columns' values from the ring. S^T and dP^T are committed as two
//   groups, so the exponentials of P^T run while dP^T is still in flight.
// - K4a's dQ: each warpgroup stores its dS^T (bf16, keys as rows) into one
//   shared 128-key tile; after a block barrier, dQ = dS . k over all 128 keys
//   runs as a shared x shared product with both operands read transposed.
//   The two warpgroups split its columns (40 + 32 at D = 72, 16 + 16 at
//   D <= 32), so each does half of the dQ product and half of the atomics,
//   and every dq element takes one fp32 atomic add per 128 keys (10 at the
//   XL shape, against 20 of the scalar kernel's 64-key blocks), as one
//   8-byte vector add (sm_90) per pair of columns where D is even. The
//   atomics are what K4a pays beyond K4b: the adds come in no fixed order,
//   so dq's last bits vary from run to run. K4b has no dQ product and no
//   atomics: its sums run in a fixed order and two launches give the same
//   bits.
// - Keys past Lk or masked out get p = 0 (so a query row whose keys are all
//   masked gets zero gradients); a warpgroup checks its keys only if a mask
//   is given or its 64 keys run past Lk, and the check is per accumulator
//   row, i.e. two flags per thread for the whole query loop. Query rows past
//   Lq need no check: their q_s, do, lse and delta are zero-filled, so P^T
//   is 1 there but multiplies a zero do row in dV, and dS^T is 0.
// K4c (flash_bwd_tc_dq_kernel) walks the forward's direction, so that dq
// needs no atomics:
// - A block of two warpgroups owns 128 query rows of one (b, h) pair, 64 per
//   warpgroup. Their q_s (from the same prologue) and do stay resident in
//   shared memory; each thread keeps lse log2 e and delta of its two
//   accumulator rows in registers, and dQ in fp32 registers.
// - 64-key tiles of k and v (and of the mask) stream through the 2-slot
//   cp.async ring, as in the forward. Per tile, S = q_s . k^T and
//   dP = do . v^T (m64n64k16, both operands K-major from shared memory) are
//   committed as two groups; p = exp2(S - lse log2 e) runs while dP is in
//   flight, then dS = bf16(p (dP - delta)) is the register A operand of
//   dQ += dS . k (m64n72k16, m64n32k16 at D <= 32; k read MN-major with the
//   transpose bit, as v in the forward's p . v). Keys are checked only on
//   tiles with a mask or past Lk.
// - dQ is scaled by `scale` and written once, in bf16. Every sum runs in a
//   fixed order and nothing is added atomically, so two launches give the
//   same bits. Query rows past Lq are zero-filled (dS = 0 there) and never
//   stored; a row whose keys are all masked gets p = 0, hence dq = 0.
// exp2 is one ex2.approx per score (about 2^-22 relative, below the bf16
// rounding of p).
#pragma once

#include "flash_mma.cuh"

namespace maa3_flash {
namespace {

constexpr int kBwdKeys = 128;  // keys per block, 64 per warpgroup

struct BwdTcArgs {
  const bf16* qs;      // (BH, Lq, D) scaled q (the prologue's scratch)
  const bf16* k;       // (BH, Lk, D)
  const bf16* v;
  const bf16* dout;    // (BH, Lq, D)
  const float* lse;    // (BH, Lq)
  const float* delta;  // (BH, Lq)
  const int* mask;     // (B, Lk) or null
  void* dq;            // K4a: (BH, Lq, D) fp32, zeroed by the caller; K4c: bf16; K4b: null
  void* dk;            // (BH, Lk, D): fp32 for K4a, bf16 for K4b
  void* dv;
  int h, lq, lk, d;
  float scale;
};

// The prologue: qs = bf16(q * mul) in fp32, elementwise over n values.
template <int VEC>
__global__ void __launch_bounds__(256) flash_bwd_scale_q_kernel(const bf16* q, bf16* qs,
                                                                size_t n, float mul) {
  const size_t step = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i * VEC < n;
       i += step) {
    const size_t e0 = i * VEC;
    if (e0 + VEC <= n) {
      Pack<VEC> v = *reinterpret_cast<const Pack<VEC>*>(q + e0);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v.x[e] = __float2bfloat16(__bfloat162float(v.x[e]) * mul);
      *reinterpret_cast<Pack<VEC>*>(qs + e0) = v;
    } else {
      for (size_t e = e0; e < n; ++e) qs[e] = __float2bfloat16(__bfloat162float(q[e]) * mul);
    }
  }
}

// P^T of one tile in place: s = S^T becomes p = exp2(s - lse log2 e) (fp32),
// 0 where the key is not valid when CHECK. Column 8j + 2 (lane % 4) + e % 2
// of the tile is a query row; ok[i]: this thread's key row g + 8 i exists
// and is valid.
template <bool CHECK>
__device__ __forceinline__ void tc_p(float (&s)[8][4], const float* lse, const bool (&ok)[2],
                                     int lane) {
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * j + c0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = fast_exp2(fmaf(e & 1 ? l.y : l.x, -kLog2e, s[j][e]));
      if (CHECK) p = ok[e >> 1] ? p : 0.0f;
      s[j][e] = p;
    }
  }
}

// dS^T in place: dp = dP^T becomes ds = p (dp - delta), p from tc_p.
__device__ __forceinline__ void tc_ds(float (&dp)[8][4], const float (&s)[8][4],
                                      const float* delta, int lane) {
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + c0);
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - (e & 1 ? dl.y : dl.x));
  }
}

// dq[rows of query tile q0, columns col0 .. col0 + N) += scale * dS . k: the
// block's 128 keys as the depth, dS^T (dst, a 128-row interleave tile of 64
// query columns) and k (kt, two 64-row tiles) both read MN-major.
template <int N>
__device__ __forceinline__ void tc_dq(const BwdTcArgs& a, const bf16* dst, const bf16* kt,
                                      int tile, int col0, size_t qoff, int q0, int warp,
                                      int lane) {
  constexpr uint32_t kSlice = kTile * 16;
  float acc[N / 8][4] = {};
  float(&ad)[N / 2] = reinterpret_cast<float(&)[N / 2]>(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBwdKeys / 16; ++kk)
    wgmma_ss_tt<N>(ad, wgmma_desc(dst + 16 * kk * 8, 128, kBwdKeys * 16),
                   wgmma_desc(kt + (kk / 4) * tile + 16 * (kk % 4) * 8 + col0 * kTile,
                              128, kSlice),
                   kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  const int c0 = col0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * i;
    if (row >= a.lq) continue;
    float* out = static_cast<float*>(a.dq) + qoff + static_cast<size_t>(row) * a.d;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = c0 + 8 * j;
      if ((a.d & 1) == 0) {  // one 8-byte vector add (sm_90) per column pair
        if (col < a.d)
          atomicAdd(reinterpret_cast<float2*>(out + col),
                    make_float2(acc[j][2 * i] * a.scale, acc[j][2 * i + 1] * a.scale));
      } else {
        if (col < a.d) atomicAdd(out + col, acc[j][2 * i] * a.scale);
        if (col + 1 < a.d) atomicAdd(out + col + 1, acc[j][2 * i + 1] * a.scale);
      }
    }
  }
}

template <int DP, bool DQ>
constexpr size_t bwd_tc_smem() {
  return sizeof(bf16) * ((4 + 2 * kStages) * kTile * mma_k_dim(DP) +
                         (DQ ? kBwdKeys * kTile : 0)) +
         sizeof(float) * kStages * 2 * kTile;
}

// The body: DP is the padded head dim of the outputs (32 or 72), VEC the copy
// width, DQ: K4a (with dq) or K4b.
template <int DP, int VEC, bool DQ>
__device__ __forceinline__ void flash_bwd_tc(const BwdTcArgs& a) {
  constexpr int DK = mma_k_dim(DP), ND = DP / 8;
  constexpr int TILE = kTile * DK;         // elements of one 64-row tile
  constexpr uint32_t kSlice = kTile * 16;  // bytes between 8-column slices
  constexpr int N0 = DP == 72 ? 40 : 16;   // dq columns of warpgroup 0
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* kt = reinterpret_cast<bf16*>(smem_raw);  // k: keys 0-63, 64-127 of the block
  bf16* vt = kt + 2 * TILE;                      // v: the same
  bf16* ring = vt + 2 * TILE;                    // kStages x {q_s, do}
  bf16* dst = ring + 2 * kStages * TILE;         // K4a: dS^T, 128 keys x 64 queries
  float* rows = reinterpret_cast<float*>(dst + (DQ ? kBwdKeys * kTile : 0));  // {lse, delta}
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, k0 = blockIdx.x * kBwdKeys;
  const size_t qoff = static_cast<size_t>(bh) * a.lq * a.d;
  const size_t koff = static_cast<size_t>(bh) * a.lk * a.d;
  const bf16* qg = a.qs + qoff;
  const bf16* dog = a.dout + qoff;
  const float* lseg = a.lse + static_cast<size_t>(bh) * a.lq;
  const float* deltag = a.delta + static_cast<size_t>(bh) * a.lq;
  const int nt = (a.lq + kTile - 1) / kTile;

  // columns d .. DK-1 of every operand tile stay zero; the copies never touch them
  zero_pad<DK>(kt, 4 + 2 * kStages, a.d);
  for (int half = 0; half < 2; ++half) {
    copy_tile<VEC>(kt + half * TILE, a.k + koff, k0 + half * kTile, a.lk, a.d);
    copy_tile<VEC>(vt + half * TILE, a.v + koff, k0 + half * kTile, a.lk, a.d);
  }
  // query tile t (q_s, do, lse, delta) into slot t % kStages
  auto issue = [&](int t) {
    bf16* slot = ring + (t % kStages) * 2 * TILE;
    copy_tile<VEC>(slot, qg, t * kTile, a.lq, a.d);
    copy_tile<VEC>(slot + TILE, dog, t * kTile, a.lq, a.d);
    if (threadIdx.x < 2 * kTile) {
      const int row = t * kTile + threadIdx.x % kTile;
      const float* src = threadIdx.x < kTile ? lseg : deltag;
      copy_async_4(rows + (t % kStages) * 2 * kTile + threadIdx.x,
                   row < a.lq ? src + row : src, row < a.lq);
    }
    cp_async_commit();
  };
  issue(0);  // one group with the k and v copies

  // this thread's key rows: key0 and key0 + 8
  const int key0 = k0 + wg * kTile + 16 * warp + lane / 4;
  const int* mrow = a.mask ? a.mask + static_cast<size_t>(bh / a.h) * a.lk : nullptr;
  bool ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    ok[i] = key < a.lk && (mrow == nullptr || mrow[key] != 0);
  }
  const bool check = mrow != nullptr || k0 + (wg + 1) * kTile > a.lk;
  const bf16* kw = kt + wg * TILE;
  const bf16* vw = vt + wg * TILE;

  float s[8][4] = {}, dp[8][4] = {};
  float dk[ND][4] = {}, dv[ND][4] = {};
  for (int t = 0; t < nt; ++t) {
    cp_async_wait_all();
    fence_proxy_async();  // the copies are read by wgmma
    __syncthreads();      // tile t is in; every warp is done with tile t - 1
    if (t + 1 < nt) issue(t + 1);
    const bf16* qs = ring + (t % kStages) * 2 * TILE;
    const bf16* dos = qs + TILE;
    const float* lse = rows + (t % kStages) * 2 * kTile;

    // S^T = k . q_s^T, dP^T = v . do^T (keys as rows)
    uint32_t pa[4][4], da[4][4];
    {
      float(&sd)[32] = reinterpret_cast<float(&)[32]>(s);
      float(&pd)[32] = reinterpret_cast<float(&)[32]>(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        wgmma_ss_n64(sd, wgmma_desc(kw + kk * 2 * kTile * 8, kSlice, 128),
                     wgmma_desc(qs + kk * 2 * kTile * 8, kSlice, 128), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        wgmma_ss_n64(pd, wgmma_desc(vw + kk * 2 * kTile * 8, kSlice, 128),
                     wgmma_desc(dos + kk * 2 * kTile * 8, kSlice, 128), kk > 0);
      wgmma_commit();
    }
    wgmma_wait<1>();  // S^T is in; p runs while dP^T is in flight
    if (check) {
      tc_p<true>(s, lse, ok, lane);
    } else {
      tc_p<false>(s, lse, ok, lane);
    }
    to_a_frags(pa, s);
    wgmma_wait<0>();
    tc_ds(dp, s, lse + kTile, lane);
    to_a_frags(da, dp);

    // dV += bf16(P^T) . do, dK += dS^T . q_s (queries as the depth)
    float(&dvd)[DP / 2] = reinterpret_cast<float(&)[DP / 2]>(dv);
    float(&dkd)[DP / 2] = reinterpret_cast<float(&)[DP / 2]>(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DP>(dvd, pa[kk], wgmma_desc(dos + 16 * kk * 8, 128, kSlice));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DP>(dkd, da[kk], wgmma_desc(qs + 16 * kk * 8, 128, kSlice));
    wgmma_commit();

    if constexpr (DQ) {
      // dS^T into the shared 128-key tile, one 4-byte pair per fragment
      const int kr = wg * kTile + 16 * warp + lane / 4, c0 = 2 * (lane & 3);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<uint32_t*>(
              dst + core_off<kBwdKeys>(kr + 8 * (e & 1), 16 * kk + 8 * (e >> 1) + c0)) =
              da[kk][e];
      fence_proxy_async();  // the stores are read by wgmma
      __syncthreads();      // both warpgroups' dS^T are in
      if (wg == 0) {
        tc_dq<N0>(a, dst, kt, TILE, 0, qoff, t * kTile, warp, lane);
      } else {
        tc_dq<DP - N0>(a, dst, kt, TILE, N0, qoff, t * kTile, warp, lane);
      }
    } else {
      wgmma_wait<0>();
    }
  }

  // dk (times ln 2: q_s carries log2 e) and dv, written once
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= a.lk) continue;
    const size_t o = koff + static_cast<size_t>(key) * a.d;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int col = 8 * j + c0;
      const float k_lo = dk[j][2 * i] * kLn2, k_hi = dk[j][2 * i + 1] * kLn2;
      const float v_lo = dv[j][2 * i], v_hi = dv[j][2 * i + 1];
      if constexpr (DQ) {  // fp32 outputs
        float* dkg = static_cast<float*>(a.dk) + o;
        float* dvg = static_cast<float*>(a.dv) + o;
        if ((a.d & 1) == 0 && col < a.d) {
          *reinterpret_cast<float2*>(dkg + col) = make_float2(k_lo, k_hi);
          *reinterpret_cast<float2*>(dvg + col) = make_float2(v_lo, v_hi);
        } else {
          if (col < a.d) {
            dkg[col] = k_lo;
            dvg[col] = v_lo;
          }
          if (col + 1 < a.d) {
            dkg[col + 1] = k_hi;
            dvg[col + 1] = v_hi;
          }
        }
      } else {  // bf16 outputs
        bf16* dkg = static_cast<bf16*>(a.dk) + o;
        bf16* dvg = static_cast<bf16*>(a.dv) + o;
        if ((a.d & 1) == 0 && col < a.d) {
          *reinterpret_cast<__nv_bfloat162*>(dkg + col) = __floats2bfloat162_rn(k_lo, k_hi);
          *reinterpret_cast<__nv_bfloat162*>(dvg + col) = __floats2bfloat162_rn(v_lo, v_hi);
        } else {
          if (col < a.d) {
            dkg[col] = __float2bfloat16(k_lo);
            dvg[col] = __float2bfloat16(v_lo);
          }
          if (col + 1 < a.d) {
            dkg[col + 1] = __float2bfloat16(k_hi);
            dvg[col + 1] = __float2bfloat16(v_hi);
          }
        }
      }
    }
  }
}

// p = exp2(s - lse log2 e) in place over one S tile (queries as rows): lse
// of the thread's rows g and g + 8; 0 where the key is not valid when CHECK
template <bool CHECK>
__device__ __forceinline__ void dq_p(float (&s)[8][4], const float (&lse)[2],
                                     const bool (&ok)[8][2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(s[j][e] - lse[e >> 1]);
      s[j][e] = (!CHECK || ok[j][e & 1]) ? p : 0.0f;
    }
}

// K4c: dq of kFwdRows query rows (DP: padded head dim, 32 or 72; VEC: copy
// width).
template <int DP, int VEC>
__device__ __forceinline__ void flash_bwd_tc_dq(const BwdTcArgs& a) {
  constexpr int DK = mma_k_dim(DP), ND = DP / 8;
  constexpr int TILE = kTile * DK;         // elements of one 64-row tile
  constexpr uint32_t kSlice = kTile * 16;  // bytes between 8-column slices
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // q_s: rows 0-63, 64-127 of the block
  bf16* dos = qs + 2 * TILE;                     // do: the same
  bf16* ring = dos + 2 * TILE;                   // kStages x {k, v}
  int* mring = reinterpret_cast<int*>(ring + 2 * kStages * TILE);  // kStages x [64]
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * kFwdRows;
  const size_t qoff = static_cast<size_t>(bh) * a.lq * a.d;
  const size_t koff = static_cast<size_t>(bh) * a.lk * a.d;
  const bf16* kg = a.k + koff;
  const bf16* vg = a.v + koff;
  const int* mrow = a.mask ? a.mask + static_cast<size_t>(bh / a.h) * a.lk : nullptr;
  const bool masked = mrow != nullptr;
  const int nt = (a.lk + kTile - 1) / kTile;

  // columns d .. DK-1 of every tile stay zero; the copies never touch them
  zero_pad<DK>(qs, 4 + 2 * kStages, a.d);
  for (int half = 0; half < 2; ++half) {
    copy_tile<VEC>(qs + half * TILE, a.qs + qoff, q0 + half * kTile, a.lq, a.d);
    copy_tile<VEC>(dos + half * TILE, a.dout + qoff, q0 + half * kTile, a.lq, a.d);
  }
  // key tile t (k, v and the mask) into slot t % kStages
  auto issue = [&](int t) {
    bf16* ks = ring + (t % kStages) * 2 * TILE;
    copy_tile<VEC>(ks, kg, t * kTile, a.lk, a.d);
    copy_tile<VEC>(ks + TILE, vg, t * kTile, a.lk, a.d);
    if (masked && threadIdx.x < kTile) {
      const int key = t * kTile + threadIdx.x;
      copy_async_4(mring + (t % kStages) * kTile + threadIdx.x,
                   key < a.lk ? mrow + key : mrow, key < a.lk);
    }
    cp_async_commit();
  };
  issue(0);  // one group with the q_s and do copies

  // this thread's query rows row0 and row0 + 8: lse (times log2 e) and
  // delta, 0 past Lq (q_s and do are zero there too, so dS = 0)
  const int row0 = q0 + wg * kTile + 16 * warp + lane / 4;
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const size_t r = static_cast<size_t>(bh) * a.lq + row;
    lse[i] = row < a.lq ? a.lse[r] * kLog2e : 0.0f;
    delta[i] = row < a.lq ? a.delta[r] : 0.0f;
  }
  const bf16* qw = qs + wg * TILE;
  const bf16* dw = dos + wg * TILE;

  float s[8][4] = {}, dp[8][4] = {};
  float dq[ND][4] = {};
  bool ok[8][2];
  for (int t = 0; t < nt; ++t) {
    cp_async_wait_all();
    fence_proxy_async();  // the copies are read by wgmma
    __syncthreads();      // tile t is in; every warp is done with tile t - 1
    if (t + 1 < nt) issue(t + 1);
    const bf16* ks = ring + (t % kStages) * 2 * TILE;
    const bf16* vs = ks + TILE;

    // S = q_s . k^T, dP = do . v^T (queries as rows)
    {
      float(&sd)[32] = reinterpret_cast<float(&)[32]>(s);
      float(&pd)[32] = reinterpret_cast<float(&)[32]>(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        wgmma_ss_n64(sd, wgmma_desc(qw + kk * 2 * kTile * 8, kSlice, 128),
                     wgmma_desc(ks + kk * 2 * kTile * 8, kSlice, 128), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        wgmma_ss_n64(pd, wgmma_desc(dw + kk * 2 * kTile * 8, kSlice, 128),
                     wgmma_desc(vs + kk * 2 * kTile * 8, kSlice, 128), kk > 0);
      wgmma_commit();
    }
    wgmma_wait<1>();  // S is in; p runs while dP is in flight
    if (masked || (t + 1) * kTile > a.lk) {
      tile_valid(ok, mring + (t % kStages) * kTile, masked, t * kTile, a.lk, lane);
      dq_p<true>(s, lse, ok);
    } else {
      dq_p<false>(s, lse, ok);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - delta[e >> 1]);
    uint32_t da[4][4];
    to_a_frags(da, dp);

    // dQ += bf16(dS) . k (keys as the depth)
    float(&dqd)[DP / 2] = reinterpret_cast<float(&)[DP / 2]>(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DP>(dqd, da[kk], wgmma_desc(ks + 16 * kk * 8, 128, kSlice));
    wgmma_commit();
    wgmma_wait<0>();
  }

  // dq = scale * dQ, written once in bf16
  bf16* dqg = static_cast<bf16*>(a.dq) + qoff;
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= a.lq) continue;
    bf16* out = dqg + static_cast<size_t>(row) * a.d;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int col = 8 * j + c0;
      const float lo = dq[j][2 * i] * a.scale, hi = dq[j][2 * i + 1] * a.scale;
      if ((a.d & 1) == 0 && col < a.d) {
        *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(lo, hi);
      } else {
        if (col < a.d) out[col] = __float2bfloat16(lo);
        if (col + 1 < a.d) out[col + 1] = __float2bfloat16(hi);
      }
    }
  }
}

template <int DP, int VEC>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_tc_fused_kernel(BwdTcArgs a) {
  flash_bwd_tc<DP, VEC, true>(a);
}
template <int DP, int VEC>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_tc_dkv_kernel(BwdTcArgs a) {
  flash_bwd_tc<DP, VEC, false>(a);
}
// two blocks per SM (128 registers): one block's exponentials and epilogue
// overlap the other's products
template <int DP, int VEC>
__global__ void __launch_bounds__(kTcThreads, 2) flash_bwd_tc_dq_kernel(BwdTcArgs a) {
  flash_bwd_tc_dq<DP, VEC>(a);
}

// The prologue's launch: q (n values) -> qs = bf16(q * mul).
inline int scale_q(const bf16* q, bf16* qs, size_t n, float mul, cudaStream_t stream) {
  const int vec = copy_vec(8, reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(qs));
  const size_t want = (n / vec + 255) / 256 + 1;
  const unsigned blocks = static_cast<unsigned>(want < 4096 ? want : 4096);
  switch (vec) {
    case 8: flash_bwd_scale_q_kernel<8><<<blocks, 256, 0, stream>>>(q, qs, n, mul); break;
    case 4: flash_bwd_scale_q_kernel<4><<<blocks, 256, 0, stream>>>(q, qs, n, mul); break;
    case 2: flash_bwd_scale_q_kernel<2><<<blocks, 256, 0, stream>>>(q, qs, n, mul); break;
    default: flash_bwd_scale_q_kernel<1><<<blocks, 256, 0, stream>>>(q, qs, n, mul); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// Which backward a launch runs.
enum BwdKind { kK4a, kK4b, kK4c };

template <int DP, int VEC, BwdKind KIND>
int launch_bwd_tc(const BwdTcArgs& a, int bh, cudaStream_t stream) {
  void (*kern)(BwdTcArgs);
  size_t smem;
  dim3 grid;
  if constexpr (KIND == kK4c) {  // query blocks
    kern = &flash_bwd_tc_dq_kernel<DP, VEC>;
    smem = sizeof(bf16) * (4 + 2 * kStages) * kTile * mma_k_dim(DP) +
           sizeof(int) * kStages * kTile;
    grid = dim3((a.lq + kFwdRows - 1) / kFwdRows, bh);
  } else {  // key blocks
    if constexpr (KIND == kK4a) {
      kern = &flash_bwd_tc_fused_kernel<DP, VEC>;
    } else {
      kern = &flash_bwd_tc_dkv_kernel<DP, VEC>;
    }
    smem = bwd_tc_smem<DP, KIND == kK4a>();
    grid = dim3((a.lk + kBwdKeys - 1) / kBwdKeys, bh);
  }
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kTcThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, BwdKind KIND>
int launch_bwd_tc_vec(const BwdTcArgs& a, int bh, cudaStream_t s) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a.qs) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout);
  switch (copy_vec(a.d, bits)) {
    case 8: return launch_bwd_tc<DP, 8, KIND>(a, bh, s);
    case 4: return launch_bwd_tc<DP, 4, KIND>(a, bh, s);
    case 2: return launch_bwd_tc<DP, 2, KIND>(a, bh, s);
    default: return launch_bwd_tc<DP, 1, KIND>(a, bh, s);
  }
}

// K4a, K4b or K4c in bf16: the prologue writes q_s = bf16(q * qmul) to the
// scratch qs (the size of q), then the kernel runs on it.
template <BwdKind KIND>
int run_bwd_tc(BwdTcArgs a, const bf16* q, bf16* qs, int bh, float qmul, cudaStream_t s) {
  if (qs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int err = scale_q(q, qs, static_cast<size_t>(bh) * a.lq * a.d, qmul, s);
  if (err != 0) return err;
  a.qs = qs;
  switch (padded_dim(a.d)) {
    case 32: return launch_bwd_tc_vec<32, KIND>(a, bh, s);
    case 72: return launch_bwd_tc_vec<72, KIND>(a, bh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace maa3_flash
