// The eval PillarFeatureNet in one pass over the cell-sorted points, float32,
// for Hopper (sm_90a): per kept point its D + 5 features (the point, its
// offset to its pillar's point mean, its offset to the pillar centre),
// Linear (D + 5) -> F without bias, eval BatchNorm, ReLU; per row the max over
// its kept points, with relu(bn(0)) where the row holds fewer than N points;
// zero for rows that take nothing.
//
// Replaces no TPU kernel: the JAX package leaves the PFN to XLA
// (pillars_tpu/models/pfn.py PointwisePFN and DenseCellPFN), which fuses the
// features, the Dense, the BN and the ReLU into the segment max. In the port
// both modules (pillars_torch/models/pfn.py) wrote [M, F] float32
// intermediates through about 35 library kernels (cat, where, GEMM, four BN
// ops, relu, the -inf fill, scatter_reduce_ "amax", maximum, isfinite, where)
// and sent every one of the M rows through the scatter, whose float atomic
// max is a compare-and-swap loop: every point that is not kept carries one
// row id (the point-major path's count of real pillars, the dense cell's
// sentinel), so on the KITTI sweep about 115k of 131,072 rows serialised
// 64 CAS loops each on one row.
//
// What bounds it on this card. The bytes: an [M] flag for every point, the
// point, its mean, its cell and its row for each kept point, and the
// [rows, F] output once. At kitti3's shape (M = 131,072, about 7k kept
// points and pillars, P = 12,000, F = 64) about 0.5 MB read and 3.1 MB
// written, 1.1 us at 3.35 TB/s; at d435i's dense cell (M = 19,968 a cloud,
// about 11.5k kept, 10,240 rows, F = 128) 5.7 MB, 1.7 us at B = 1 and
// 45.7 MB, 13.6 us at B = 8, the [rows, F] output most of it. The
// arithmetic, 2 (D + 5) F + 6 F operations a kept point, takes a fraction
// of that at the float32 peak. What a launch cannot avoid beyond the bytes
// is latency: the kept points are few and the rows they write short.
//
// Design.
// - A warp takes 32 consecutive points, a lane each; a warp without a kept
//   point does nothing more. A lane whose point is kept loads it, computes
//   its D + 5 features in registers and reads what its row takes. Each lane
//   holds the Linear's rows and the BN values of its outputs (feature f =
//   lane + 32 j) in registers, read from device memory at every launch, so
//   a captured graph reads whatever was last copied into them. The warp
//   then walks its kept points in order (a ballot), the point's features
//   broadcast by shuffles, every lane computing its F / 32 outputs of it.
//   D is 3 or 4 and the number of outputs a lane holds at most 8, each a
//   template argument, so the loops unroll without predicates.
// - Rows are non-decreasing over the sorted points, so a row's kept points
//   are contiguous: the warp keeps a running max per output while the row
//   stays the same and writes the run when the row changes. A run is written
//   with one integer max a value (red.global.max, which no thread waits for)
//   on the float's bits into an output the launch zeroes first
//   (cudaMemsetAsync): for values >= +0, every value after ReLU, the integer
//   order is the float order, and a max does not depend on the order the
//   writes land in, so the bits are the same in every run. A NaN is written
//   as 0x7fffffff, above every other value's bits, so that it wins as
//   torch's max lets it; +0 is not written. A row that spans warps takes one
//   write from each (at most ceil(N / 32) + 1 for N points); nothing else is
//   shared between warps.
// - Points that are not kept make no load beyond their flag and no store or
//   atomic, which removes the funnel of padding onto one row.
// - relu(bn(0)) enters a run's max where its row holds fewer than N points:
//   on the point-major layout where num_points[row] < N (and only rows whose
//   pillar_mask is set are written), on the dense cell where the point's own
//   count is (the count of its cell, the same on each of its points).
// - The point-major module keeps its rule that a non-finite value of a row
//   makes that value 0. A run with a non-finite value appends its row to a
//   list; the last block to finish (a ticket taken after a fence) sets the
//   non-finite values of the listed rows to 0. On finite inputs the list is
//   empty.
// - No [M, F] tensor touches device memory. One launch a call, after one
//   memset node of the output, the dense cell's counts or the point-major
//   ticket and list length.
//
// The host function returns the first CUDA error of the memset and the
// launch, and the wrapper (pillars_torch/ops/pfn_cuda.py) raises when it is
// not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxF = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNaNBits = 0x7fffffff;

}  // namespace

// Field order and types are mirrored by ops/pfn_cuda.py::_Args.
struct PfnArgs {
  const float* points;         // [m, dim] cell-sorted
  const float* mean;           // [m, mean_stride]: the pillar's xyz mean first
  const int* cell;             // point-major: zyx [m, 3]; dense: cell id [m]
  const int* row;              // [m] output row of each point
  const unsigned char* kept;   // [m]
  const int* count;            // point-major: num_points [rows]; dense: [m]
  const unsigned char* pillar_mask;  // point-major: [rows]; dense: null
  const float* weight;         // [features, dim + 5], the Linear's
  const float* bn_mean;        // [features] each, the BN's running
  const float* bn_var;         //   statistics, scale and shift
  const float* bn_weight;
  const float* bn_bias;
  float* out;                  // [rows, features]; right after it in the same
  int* tail;                   //   allocation: dense [rows] num_points,
                               //   point-major [2 + m] ticket, list length, list
  long long m;
  int rows, features, dim, mean_stride;
  int dense, nx, nxy, n_max;
  float eps, vx, vy, x_off, y_off;
};

namespace {

__device__ __forceinline__ float max_nan(float acc, float v) {
  return (v > acc || v != v) ? v : acc;  // a NaN wins, as in torch's max
}

__device__ __forceinline__ bool finite(float v) {
  return fabsf(v) <= 3.402823466e38f;  // false for NaN and the infinities
}

__device__ __forceinline__ void red_max(int* p, int v) {
  asm volatile("red.relaxed.gpu.global.max.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// One warp's 32 points (at least one kept): lane l loads point l and the
// parameters of outputs l, l + 32, ...; then the warp walks its kept points
// in order, every lane computing its outputs of each, and writes a run of
// one row when the row changes.
template <bool kDense, int FW, int K>
__device__ __forceinline__ void warp_points(const PfnArgs& a, long long i,
                                            bool kept, unsigned todo,
                                            int lane) {
  constexpr int D = K - 5;
  const int F = a.features;
  // the point: its features, its row, and what its row takes (dense: the
  // cell's count; point-major: bit 0 the row is written, bit 1 it holds
  // fewer than N points)
  float feat[K];
  int my_row = -1, my_meta = 0;
  if (kept) {
    my_row = a.row[i];
    const float* p = a.points + i * D;
    const float* mu = a.mean + i * a.mean_stride;
    int cxi, cyi;
    if (kDense) {
      my_meta = a.count[i];
      const int rem = a.cell[i] % a.nxy;  // a kept point's cell is >= 0
      cyi = rem / a.nx;
      cxi = rem - cyi * a.nx;
    } else {
      cxi = a.cell[3 * i + 2];
      cyi = a.cell[3 * i + 1];
      if (my_row >= 0 && my_row < a.rows)
        my_meta = (a.pillar_mask[my_row] ? 1 : 0) |
                  (a.count[my_row] < a.n_max ? 2 : 0);
    }
    // the modules' order: (cell * size) + offset, each rounded
    const float cx = __fadd_rn(__fmul_rn((float)cxi, a.vx), a.x_off);
    const float cy = __fadd_rn(__fmul_rn((float)cyi, a.vy), a.y_off);
#pragma unroll
    for (int k = 0; k < D; ++k) feat[k] = p[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) feat[D + k] = __fsub_rn(feat[k], mu[k]);
    feat[D + 3] = __fsub_rn(feat[0], cx);
    feat[D + 4] = __fsub_rn(feat[1], cy);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) feat[k] = 0.0f;
  }
  // this lane's outputs f = lane + 32 j: the Linear's row and the eval BN
  // ((x - mean) * rsqrt(var + eps)) * w + b, read at every launch
  float w[FW][K], m[FW], inv[FW], g[FW], b[FW], z[FW];
#pragma unroll
  for (int j = 0; j < FW; ++j) {
    const int f = lane + 32 * j;
    if (f < F) {
#pragma unroll
      for (int k = 0; k < K; ++k) w[j][k] = __ldg(a.weight + f * K + k);
      m[j] = __ldg(a.bn_mean + f);
      inv[j] = rsqrtf(__fadd_rn(__ldg(a.bn_var + f), a.eps));
      g[j] = __ldg(a.bn_weight + f);
      b[j] = __ldg(a.bn_bias + f);
      const float zj = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(0.0f, m[j]), inv[j]), g[j]), b[j]);
      z[j] = zj < 0.0f ? 0.0f : zj;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) w[j][k] = 0.0f;
      m[j] = inv[j] = g[j] = b[j] = z[j] = 0.0f;
    }
  }

  float acc[FW];
  int run_row = -1, run_meta = 0;
  // writes the open run: the max of each output, with relu(bn(0)) where its
  // row holds fewer than N points
  auto flush = [&]() {
    const bool on = run_row >= 0 && run_row < a.rows &&
                    (kDense ? run_meta > 0 : (run_meta & 1) != 0);
    if (!on) return;  // warp-uniform
    const bool pad = kDense ? run_meta < a.n_max : (run_meta & 2) != 0;
    int* dst = reinterpret_cast<int*>(a.out) + (long long)run_row * F;
    bool bad = false;
#pragma unroll
    for (int j = 0; j < FW; ++j) {
      const int f = lane + 32 * j;
      const float v = pad ? max_nan(acc[j], z[j]) : acc[j];
      bad |= f < F && !finite(v);
      const int bits = v != v ? kNaNBits : __float_as_int(v);
      if (f < F && bits > 0) red_max(dst + f, bits);  // +-0: the zero fill
    }
    if (kDense) {
      if (lane == 0) red_max(a.tail + run_row, run_meta);
    } else if (__any_sync(kFull, bad) && lane == 0) {
      const int slot = atomicAdd(a.tail + 1, 1);
      a.tail[2 + slot] = run_row;
    }
  };

  bool open = false;
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int r = __shfl_sync(kFull, my_row, src);
    const int meta = __shfl_sync(kFull, my_meta, src);
    if (!open || r != run_row) {
      if (open) flush();
      open = true;
      run_row = r;
      run_meta = meta;
#pragma unroll
      for (int j = 0; j < FW; ++j) acc[j] = 0.0f;
    }
    float x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = __shfl_sync(kFull, feat[k], src);
#pragma unroll
    for (int j = 0; j < FW; ++j) {
      float y = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) y = fmaf(x[k], w[j][k], y);
      y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(y, m[j]), inv[j]), g[j]),
                    b[j]);
      acc[j] = max_nan(acc[j], y < 0.0f ? 0.0f : y);
    }
  }
  if (open) flush();
}

template <bool kDense, int FW, int K>
__global__ void __launch_bounds__(kThreads) pfn_max_kernel(const PfnArgs a) {
  __shared__ bool last_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool kept = i < a.m && a.kept[i];
  const unsigned todo = __ballot_sync(kFull, kept);
  if (todo) warp_points<kDense, FW, K>(a, i, kept, todo, lane);

  if (!kDense) {
    // the last block sets the listed rows' non-finite values to 0
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last_s = atomicAdd(a.tail, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (last_s) {
      __threadfence();
      const volatile int* tail = a.tail;
      const int listed = tail[1];
      const int F = a.features;
      for (int t = warp; t < listed; t += kWarps) {
        float* row = a.out + (long long)tail[2 + t] * F;
        for (int f = lane; f < F; f += 32)
          if (!finite(__ldcg(row + f))) row[f] = 0.0f;
      }
    }
  }
}

template <bool kDense, int K>
void launch_k(const PfnArgs& a, unsigned blocks, cudaStream_t stream) {
  switch ((a.features + 31) / 32) {
#define PFN_MAX_CASE(fw)                                                \
  case fw:                                                              \
    pfn_max_kernel<kDense, fw, K><<<blocks, kThreads, 0, stream>>>(a);  \
    break;
    PFN_MAX_CASE(1) PFN_MAX_CASE(2) PFN_MAX_CASE(3) PFN_MAX_CASE(4)
    PFN_MAX_CASE(5) PFN_MAX_CASE(6) PFN_MAX_CASE(7) PFN_MAX_CASE(8)
#undef PFN_MAX_CASE
  }
}

template <bool kDense>
void launch(const PfnArgs& a, unsigned blocks, cudaStream_t stream) {
  if (a.dim == 3)
    launch_k<kDense, 8>(a, blocks, stream);
  else
    launch_k<kDense, 9>(a, blocks, stream);
}

}  // namespace

extern "C" {

// Zeroes out and its tail (dense: the [rows] counts; point-major: the ticket
// and the list length), then launches the kernel, on `stream`. Returns the
// first CUDA error (0: launched); refuses 1 <= features <= 256, dim 3 or 4
// unmet, or an inconsistent size, with cudaErrorInvalidValue.
int pfn_max(const PfnArgs* args, cudaStream_t stream) {
  const PfnArgs& a = *args;
  if (a.features < 1 || a.features > kMaxF || a.dim < 3 || a.dim > 4 ||
      a.mean_stride < 3 || a.m < 0 || a.rows < 0 || a.n_max < 1 ||
      (a.dense && (a.nx < 1 || a.nxy < a.nx)))
    return (int)cudaErrorInvalidValue;
  const size_t zero = sizeof(float) * (size_t)a.rows * a.features +
                      sizeof(int) * (a.dense ? (size_t)a.rows : 2);
  cudaError_t err = cudaMemsetAsync(a.out, 0, zero, stream);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (a.m + kThreads - 1) / kThreads;
  if (blocks == 0) return (int)cudaGetLastError();
  if (a.dense)
    launch<true>(a, (unsigned)blocks, stream);
  else
    launch<false>(a, (unsigned)blocks, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
