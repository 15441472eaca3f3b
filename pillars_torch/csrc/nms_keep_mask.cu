// Greedy standup-box NMS keep-mask for Hopper (sm_90a).
//
// Replaces the TPU kernel pillars_tpu/ops/nms_pallas.py::_nms_kernel
// (pallas_call in nms_keep_mask_pallas) and computes the same function:
// boxes arrive score-sorted; box i is kept iff it is valid and no earlier
// KEPT box overlaps it with IoU > threshold, the IoU using the reference's
// +1-pixel convention on both boxes valid.
//
// Design. One thread block per sample (the batch dimension replaces the JAX
// vmap). Phase 1: the block's threads build the strictly-lower-triangular
// overlap matrix as a bitmask in shared memory, mask[i][w] bit b set iff
// j = 32*w + b < i, both valid and iou(i, j) > thr. Phase 2: one warp sweeps
// i = 0..K-1; lane l holds word l of the kept bitset, so "does an earlier
// kept box overlap i" is one AND per lane plus __any_sync. K <= 1024 keeps
// the kept bitset inside one warp's 32 words.
//
// Bound on this card: at the d435i shapes (K = 100, B = 1) the work is
// ~5k IoUs and a 100-step sweep, a few microseconds of launch latency and
// dependent shared-memory loads; bytes and FLOPs are negligible. Making it
// faster (for example fusing it into the postprocess) is later work.
//
// The IoU arithmetic uses explicit round-to-nearest intrinsics so no FMA
// contraction can move a box across the threshold: the result is
// bit-identical to the plain PyTorch twin (pillars_torch/ops/nms.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float pixel_area(float x0, float y0, float x1,
                                            float y1) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x1, x0), 1.0f),
                   __fadd_rn(__fsub_rn(y1, y0), 1.0f));
}

__global__ void __launch_bounds__(kThreads)
nms_keep_mask_kernel(const float* __restrict__ boxes,
                     const uint8_t* __restrict__ valid,
                     bool* __restrict__ keep, int k, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) / 32;
  float4* sbox = reinterpret_cast<float4*>(smem);               // [k]
  uint32_t* mask = reinterpret_cast<uint32_t*>(sbox + k);       // [k][words]
  float* sarea = reinterpret_cast<float*>(mask + k * words);    // [k]
  uint8_t* svalid = reinterpret_cast<uint8_t*>(sarea + k);      // [k]

  const float4* gbox =
      reinterpret_cast<const float4*>(boxes) + (size_t)blockIdx.x * k;
  const uint8_t* gvalid = valid + (size_t)blockIdx.x * k;
  bool* gkeep = keep + (size_t)blockIdx.x * k;

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float4 b = gbox[i];
    sbox[i] = b;
    sarea[i] = pixel_area(b.x, b.y, b.z, b.w);
    svalid[i] = gvalid[i] != 0;
  }
  __syncthreads();

  // phase 1: one 32-bit word of the overlap mask per work item
  for (int item = threadIdx.x; item < k * words; item += blockDim.x) {
    const int i = item / words;
    const int w = item - i * words;
    uint32_t bits = 0;
    if (svalid[i]) {
      const float4 bi = sbox[i];
      const float ai = sarea[i];
      const int j_end = min(32 * w + 32, i);
      for (int j = 32 * w; j < j_end; ++j) {
        if (!svalid[j]) continue;
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
        if (iou > thr) bits |= 1u << (j - 32 * w);
      }
    }
    mask[item] = bits;
  }
  __syncthreads();

  // phase 2: the greedy sweep, one warp
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint32_t kept = 0;
    for (int i = 0; i < k; ++i) {
      const uint32_t row = lane < words ? mask[i * words + lane] : 0u;
      const bool suppressed = __any_sync(0xffffffffu, (row & kept) != 0u);
      if (lane == (i >> 5) && svalid[i] && !suppressed)
        kept |= 1u << (i & 31);
    }
    for (int b = 0; b < 32; ++b) {
      const int i = 32 * lane + b;
      if (i < k) gkeep[i] = (kept >> b) & 1u;
    }
  }
}

size_t smem_bytes(int k) {
  const size_t words = (k + 31) / 32;
  return sizeof(uint32_t) * k * words + sizeof(float4) * k +
         sizeof(float) * k + k;
}

}  // namespace

// boxes [b, k, 4] f32, valid [b, k] uint8, keep [b, k] bool; all contiguous
// on the device. Launches on ``stream`` and returns cudaGetLastError().
extern "C" int nms_keep_mask(const void* boxes, const void* valid, void* keep,
                             int b, int k, float thr, void* stream) {
  if (b <= 0 || k <= 0 || k > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(k);  // 149 KB at K = 1024
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
