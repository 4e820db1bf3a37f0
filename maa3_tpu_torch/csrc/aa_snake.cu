// Anti-aliased snake activation over (B, C, T): one pass, x read once and y
// written once.
//
// Replaces the TPU kernel maa3_tpu/ops/pallas_aa_snake.py::_aa_snake_fused
// (:381, pallas_call at :515; bodies _kernel :76 and _kernel_mxu :186).
//
// What bounds it on the H100: per output sample it moves one input and one
// output element (8 bytes in fp32, 4 in bf16) and does 96 fp32 operations
// (two 6-tap FIRs, two snakes of 24 with the sin^2 polynomial, one 12-tap
// FIR), about 24 per byte in bf16 against the card's ~20 fp32 FLOP per byte
// of DRAM bandwidth: in bf16 the operations bound it by a little, in fp32
// the bytes. So the design keeps every intermediate in registers and spends
// no instruction it can avoid:
// - One thread computes one run of kRun consecutive outputs of one row
//   (maa3::act_run in snake.cuh): x[gs - 8 .. gs + kRun + 8) in 16-byte
//   loads, kRun + 6 pairs of snake phases, kRun decimated outputs, written
//   in 16-byte stores; straight-line code, no shared memory, no barrier.
//   The recomputed halo costs 38 pairs per 32 outputs.
// - Lanes of a warp take consecutive runs of one row, so a warp's loads and
//   stores are contiguous and the 8-sample halos that neighbouring lanes
//   share come from L1.
// - The grid is 1-D over tasks with 64-bit task numbers: first the runs
//   that touch a row's end (or, for rows off 16-byte boundaries or the
//   other sin, every run), cut into pieces of kEdgeRun outputs, in the
//   compact rolled maa3::act_run_generic (clamped loads, the edge rules,
//   sliding windows in registers); then the interior runs. So no warp
//   mixes the two paths, and the edge warps start first. Their rolled loop
//   is a chain of dependent steps, so each takes a short piece: a whole
//   32-output run through it outlasts the interior work of the vocoder's
//   shortest stage.
// bf16 takes the straight-line run with the sin^2 polynomial, fp32 with
// libm's sinf (a correctness route, not a speed target). No tensor cores:
// the FIR taps and the upsampled values are fp32 in the plain version, and
// the TPU's banded-matrix MXU FIRs and 128-lane halos are not carried over.
#include <climits>
#include <cstdint>

#include "snake.cuh"

namespace {

constexpr int kRun = 32;      // outputs per thread of an interior run
constexpr int kEdgeRun = 8;   // outputs per thread of the other runs
constexpr int kThreads = 256;

// The sin of the straight-line run: the polynomial in bf16, sinf in fp32.
template <typename T> constexpr bool kPoly = false;
template <> constexpr bool kPoly<__nv_bfloat16> = true;

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16;
}

// y[0 .. 8) to p, 16-byte aligned, in 16-byte pieces.
__device__ __forceinline__ void store8(float* p, const float (&y)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(y[0], y[1], y[2], y[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(y[4], y[5], y[6], y[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&y)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pair(y[0], y[1]), bf16_pair(y[2], y[3]),
                                            bf16_pair(y[4], y[5]), bf16_pair(y[6], y[7]));
}

// Where act_run's outputs go: kept in registers and stored to the row in
// 16-byte pieces of 8 outputs as each piece completes.
template <typename T>
struct RowPieces {
  T* dst;  // y + row offset + gs, 16-byte aligned
  float v[8];
  __device__ __forceinline__ void operator()(int l, float y) {
    v[l % 8] = y;
    if (l % 8 == 7) store8(dst + l - 7, v);
  }
};

// Where act_run_generic's outputs go: one store each, inside the row only.
template <typename T>
struct RowTail {
  T* row;
  int gs, n;
  __device__ __forceinline__ void operator()(int l, float y) const {
    if (gs + l < n) maa3::store_f(row + gs + l, y);
  }
};

// q = a / b and r = a - q b, in 32 bits where a fits.
__device__ __forceinline__ long long divmod(long long a, int b, int* r) {
  if (a <= 0xffffffffLL) {
    const unsigned q = static_cast<unsigned>(a) / static_cast<unsigned>(b);
    *r = static_cast<int>(static_cast<unsigned>(a) - q * static_cast<unsigned>(b));
    return q;
  }
  const long long q = a / b;
  *r = static_cast<int>(a - q * b);
  return q;
}

// Tasks [0, edge_tasks): the kEdgeRun-output pieces of run 0 and of runs
// inner + 1 .. runs - 1 of each row (every run when inner is 0); tasks
// [edge_tasks, tasks): runs 1 .. inner.
template <typename T>
__global__ void __launch_bounds__(kThreads)
aa_snake_kernel(const T* __restrict__ x, T* __restrict__ y,
                const float* __restrict__ alpha, const float* __restrict__ beta,
                int C, int n, int runs, int inner, long long edge_tasks,
                long long tasks, bool has_beta, bool logscale, bool fast) {
  const long long task = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (task >= tasks) return;
  const bool edge = task < edge_tasks;
  int k;
  constexpr int kPieces = kRun / kEdgeRun;
  const int row = edge ? static_cast<int>(divmod(task, (runs - inner) * kPieces, &k))
                       : static_cast<int>(divmod(task - edge_tasks, inner, &k));
  float a, ib;
  maa3::snake_coeffs(alpha, beta, row % C, has_beta, logscale, &a, &ib);
  const size_t off = static_cast<size_t>(row) * n;
  if (edge) {
    const int run = k / kPieces;
    const int gs = kRun * (run == 0 ? 0 : inner + run) + kEdgeRun * (k % kPieces);
    if (gs >= n) return;
    maa3::act_run_generic<kEdgeRun>(x + off, n, gs, a, ib, fast, RowTail<T>{y + off, gs, n});
  } else {
    const int gs = kRun * (1 + k);
    RowPieces<T> out{y + off + gs};
    maa3::act_run<kRun, kPoly<T>>(x + off, gs, a, ib, out);
  }
}

template <typename T>
int launch(const void* x, void* y, const float* alpha, const float* beta,
           int rows, int C, int n, int has_beta, int logscale, int fast,
           cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return 0;
  // runs 1 .. inner take the straight-line path: x[gs - 8 .. gs + kRun + 8)
  // inside the row, every row on 16-byte boundaries, the sin it was built for
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   n % (16 / sizeof(T)) == 0 && (fast != 0) == kPoly<T>;
  const int runs = (n + kRun - 1) / kRun;
  const int inner = vec && n >= 2 * kRun + 8 ? (n - kRun - 8) / kRun : 0;
  const long long edge_tasks =
      static_cast<long long>(rows) * (runs - inner) * (kRun / kEdgeRun);
  const long long tasks = edge_tasks + static_cast<long long>(rows) * inner;
  const long long blocks = (tasks + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  aa_snake_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), alpha, beta, C, n, runs, inner,
      edge_tasks, tasks, has_beta != 0, logscale != 0, fast != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int maa3_aa_snake(const void* x, void* y, const void* alpha,
                             const void* beta, int rows, int C, int n,
                             int dtype, int has_beta, int logscale, int fast,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(alpha);
  auto b = static_cast<const float*>(beta);
  if (dtype == 0)
    return launch<float>(x, y, a, b, rows, C, n, has_beta, logscale, fast, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, a, b, rows, C, n, has_beta, logscale,
                                 fast, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
