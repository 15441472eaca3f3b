// Greedy standup-box NMS keep-mask for Hopper (sm_90a).
//
// Replaces the TPU kernel pillars_tpu/ops/nms_pallas.py::_nms_kernel
// (pallas_call in nms_keep_mask_pallas) and computes the same function:
// boxes arrive score-sorted; box i is kept iff it is valid and no earlier
// KEPT box overlaps it with IoU > threshold, the IoU using the reference's
// +1-pixel convention on both boxes valid.
//
// What bounds it on this card. At the d435i shape (K = 100, B = 1) the work
// is about 5000 IoUs and 1.8 KB: nothing against the card's rates. What it
// costs is latency: the launch itself, the boxes' trip from device memory,
// an IEEE division per pair, and the greedy sweep, whose row i cannot be
// decided before the rows below it.
//
// Design. One block of 1024 threads per sample (the batch dimension
// replaces the JAX vmap).
// - Phase 1, the strictly-lower-triangular overlap matrix as a bitmask in
//   shared memory: a work item is one 32-bit word (row i, columns 32w ..
//   32w + 31), a warp takes an item, each lane one pair, and a ballot makes
//   the word. Warp r takes rows r, r + 32, ..., so every warp has the same
//   number of items and no lane runs more than one IoU per item.
// - Phase 2, the sweep, 32 rows at a time in one warp: lane l owns row 32c
//   + l; suppression by the chunks below is an AND per earlier word for all
//   32 rows at once, and only the 32 x 32 triangle inside the chunk is
//   serial: 32 steps of register arithmetic on words passed by shuffle,
//   with no shared-memory load and no vote on the dependent chain.
//   K <= 1024 keeps a row's words within one warp's 32 lanes.
//
// The IoU arithmetic uses explicit round-to-nearest intrinsics so no FMA
// contraction can move a box across the threshold: the result is
// bit-identical to the plain PyTorch twin (pillars_torch/ops/nms.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float pixel_area(float x0, float y0, float x1,
                                            float y1) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x1, x0), 1.0f),
                   __fadd_rn(__fsub_rn(y1, y0), 1.0f));
}

// row stride of the mask in words: odd, so that the 32 rows of a chunk fall
// into different banks
__host__ __device__ inline int mask_stride(int k) { return ((k + 31) / 32) | 1; }

__global__ void __launch_bounds__(kThreads)
nms_keep_mask_kernel(const float* __restrict__ boxes,
                     const uint8_t* __restrict__ valid,
                     bool* __restrict__ keep, int k, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) / 32;
  const int stride = mask_stride(k);
  float4* sbox = reinterpret_cast<float4*>(smem);               // [k]
  uint32_t* mask = reinterpret_cast<uint32_t*>(sbox + k);       // [k][stride]
  float* sarea = reinterpret_cast<float*>(mask + k * stride);   // [k]
  uint8_t* svalid = reinterpret_cast<uint8_t*>(sarea + k);      // [k]

  const float4* gbox =
      reinterpret_cast<const float4*>(boxes) + (size_t)blockIdx.x * k;
  const uint8_t* gvalid = valid + (size_t)blockIdx.x * k;
  bool* gkeep = keep + (size_t)blockIdx.x * k;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < k; i += kThreads) {
    const float4 b = gbox[i];
    sbox[i] = b;
    sarea[i] = pixel_area(b.x, b.y, b.z, b.w);
    svalid[i] = gvalid[i] != 0;
  }
  __syncthreads();

  // phase 1: word w of row i, one pair per lane
  for (int i = warp; i < k; i += kWarps) {
    const bool vi = svalid[i];
    const float4 bi = sbox[i];
    const float ai = sarea[i];
    for (int w = 0; 32 * w < i; ++w) {
      const int j = 32 * w + lane;
      bool over = false;
      if (vi && j < i && svalid[j]) {
        const float4 bj = sbox[j];
        const float width = fmaxf(
            __fadd_rn(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 1.0f),
            0.0f);
        const float height = fmaxf(
            __fadd_rn(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 1.0f),
            0.0f);
        const float inter = __fmul_rn(width, height);
        const float iou =
            __fdiv_rn(inter, __fsub_rn(__fadd_rn(ai, sarea[j]), inter));
        over = iou > thr;
      }
      const uint32_t bits = __ballot_sync(kFull, over);
      if (lane == 0) mask[i * stride + w] = bits;
    }
  }
  __syncthreads();

  // phase 2: the greedy sweep, one warp, a chunk of 32 rows per step; lane
  // w keeps word w of the kept set
  if (warp == 0) {
    uint32_t my_kept = 0;
    for (int c = 0; c < words; ++c) {
      const int i = 32 * c + lane;
      const bool in_range = i < k;
      uint32_t hit = 0;  // overlaps with boxes kept in the chunks below
      for (int w = 0; w < c; ++w) {
        const uint32_t kept_w = __shfl_sync(kFull, my_kept, w);
        if (in_range) hit |= mask[i * stride + w] & kept_w;
      }
      const bool alive = in_range && svalid[i] && hit == 0;
      // word c of row i: the rows of this chunk below i (none for lane 0,
      // whose word phase 1 never wrote)
      const uint32_t row = in_range && lane > 0 ? mask[i * stride + c] : 0u;
      const uint32_t candidates = __ballot_sync(kFull, alive);
      uint32_t kept = 0;  // the same in every lane
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        const uint32_t row_l = __shfl_sync(kFull, row, l);
        if (((candidates >> l) & 1u) && (row_l & kept) == 0u) kept |= 1u << l;
      }
      if (lane == c) my_kept = kept;
      if (in_range) gkeep[i] = (kept >> lane) & 1u;
    }
  }
}

__global__ void empty_kernel() {}

size_t smem_bytes(int k) {
  return sizeof(uint32_t) * k * mask_stride(k) + sizeof(float4) * k +
         sizeof(float) * k + k;
}

}  // namespace

// boxes [b, k, 4] f32, valid [b, k] uint8, keep [b, k] bool; all contiguous
// on the device. Launches on ``stream`` and returns cudaGetLastError().
extern "C" int nms_keep_mask(const void* boxes, const void* valid, void* keep,
                             int b, int k, float thr, void* stream) {
  if (b <= 0 || k <= 0 || k > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(k);  // 157 KB at K = 1024
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_keep_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_keep_mask_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<bool*>(keep), k, thr);
  return (int)cudaGetLastError();
}

// An empty kernel of one block of the same size: what a launch costs on this
// card before any work, the floor under the keep-mask's time.
extern "C" int nms_launch_floor(void* stream) {
  empty_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
