// One RPN downsample block fused for inference, for Hopper (sm_90a).
//
// Replaces the TPU kernel pillars_tpu/ops/rpn_pallas.py::_make_block_kernel
// (pallas_call in fused_sep_block) and computes the same function: 1 +
// num_layers separable layers, each a SAME 3x3 depthwise conv (stride 2:
// only the even centres), a 1x1 pointwise product with eval-mode BN folded
// into its weights and bias, then ReLU. NHWC float32 throughout; full f32
// FMAs on the CUDA cores (no TF32, no tensor cores).
//
// Design. One cooperative launch per block, as the TPU kernel is one call
// per block: a grid-wide barrier (cooperative_groups grid sync) separates
// the layers, and the activations ping-pong between the output and one
// scratch buffer of the same size (at most 1.3 MB per sample at the d435i
// shapes, so they stay in the 50 MB L2). The grid is the co-resident
// capacity (SMs x blocks per SM), cut to the number of tiles. In each layer
// a block walks tiles of 16 output pixels x 64 output channels: the 3x3
// depthwise of the tile's pixels over all input channels goes to shared
// memory, then each thread sums one pixel x 4 channels of the pointwise
// product, adds the bias, applies ReLU and stores a float4.
//
// Bound on this card, per d435i cloud (three blocks, B = 1): 730 M f32
// operations (pointwise 670 M, depthwise 62 M, bias and ReLU) against 8.9
// MB of compulsory traffic, so operations bound it: 10.9 us at 67 TFLOP/s.
// This first version aims at parity, not that bound: at B = 1 block 3 has
// only 80 tiles for 132 SMs, and every pointwise step issues a shared load
// and a 16-byte weight load per four FMAs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 16;                   // output pixels per tile
constexpr int kTileC = 64;                   // output channels per tile
constexpr int kVec = 4;                      // output channels per thread
constexpr int kColThreads = kTileC / kVec;   // 16; kTileP * 16 = kThreads

struct Params {
  const float* x;  // [b, h, w, cin]
  float* out;      // [b, oh, ow, cout]
  float* scratch;  // [b, oh, ow, cout]
  const float* w;  // packed per layer: wd [3, 3, ci], wp [ci, cout], bias
  int b, h, w_in, cin, cout, num_layers, stride;
};

// One separable layer over every tile of [b, oh, ow, cout]. ``src`` may
// have been written earlier in this launch, so it is read with plain
// (coherent) loads; the weights are read-only for the whole launch.
__device__ void run_layer(const float* src, float* dst,
                          const float* __restrict__ wd,
                          const float* __restrict__ wp,
                          const float* __restrict__ bias, int b, int ih,
                          int iw, int cin, int oh, int ow, int cout,
                          int stride, float* dw_s) {
  const int npix = oh * ow;
  const int ptiles = (npix + kTileP - 1) / kTileP;
  const int ctiles = (cout + kTileC - 1) / kTileC;
  const int ntiles = b * ptiles * ctiles;
  const int ld = cin + 1;  // padded row: the two pixels a warp reads
                           // sit in different banks
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int ct = t % ctiles;
    const int pt = (t / ctiles) % ptiles;
    const int bi = t / (ctiles * ptiles);
    const int p0 = pt * kTileP;
    const float* src_b = src + (size_t)bi * ih * iw * cin;

    // depthwise: (pixel, channel) items, channel fastest (coalesced)
    for (int i = threadIdx.x; i < kTileP * cin; i += kThreads) {
      const int p = i / cin;
      const int c = i - p * cin;
      const int pix = p0 + p;
      float acc = 0.0f;
      if (pix < npix) {
        const int oy = pix / ow;
        const int ox = pix - oy * ow;
        for (int dy = 0; dy < 3; ++dy) {
          const int iy = oy * stride + dy - 1;
          if (iy < 0 || iy >= ih) continue;
          for (int dx = 0; dx < 3; ++dx) {
            const int ix = ox * stride + dx - 1;
            if (ix < 0 || ix >= iw) continue;
            acc = fmaf(src_b[((size_t)iy * iw + ix) * cin + c],
                       __ldg(wd + (dy * 3 + dx) * cin + c), acc);
          }
        }
      }
      dw_s[p * ld + c] = acc;
    }
    __syncthreads();

    // pointwise + bias + ReLU: one pixel x kVec channels per thread
    const int p = threadIdx.x / kColThreads;
    const int co = ct * kTileC + (threadIdx.x % kColThreads) * kVec;
    const int pix = p0 + p;
    if (co < cout && pix < npix) {
      const float* a = dw_s + p * ld;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int c = 0; c < cin; ++c) {
        const float v = a[c];
        const float4 wv =
            __ldg(reinterpret_cast<const float4*>(wp + (size_t)c * cout + co));
        acc.x = fmaf(v, wv.x, acc.x);
        acc.y = fmaf(v, wv.y, acc.y);
        acc.z = fmaf(v, wv.z, acc.z);
        acc.w = fmaf(v, wv.w, acc.w);
      }
      const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + co));
      float4 r;
      r.x = fmaxf(acc.x + bv.x, 0.0f);
      r.y = fmaxf(acc.y + bv.y, 0.0f);
      r.z = fmaxf(acc.z + bv.z, 0.0f);
      r.w = fmaxf(acc.w + bv.w, 0.0f);
      *reinterpret_cast<float4*>(dst + ((size_t)bi * npix + pix) * cout + co) =
          r;
    }
    __syncthreads();  // dw_s is refilled by the next tile
  }
}

__global__ void __launch_bounds__(kThreads)
rpn_sep_block_kernel(const Params prm) {
  extern __shared__ __align__(16) float dw_s[];
  cg::grid_group grid = cg::this_grid();
  const int oh = prm.stride == 2 ? prm.h / 2 : prm.h;
  const int ow = prm.stride == 2 ? prm.w_in / 2 : prm.w_in;
  const size_t size0 = 9 * (size_t)prm.cin + (size_t)prm.cin * prm.cout +
                       prm.cout;
  const size_t size_n = 9 * (size_t)prm.cout + (size_t)prm.cout * prm.cout +
                        prm.cout;
  for (int l = 0; l <= prm.num_layers; ++l) {
    const bool first = l == 0;
    const int cin = first ? prm.cin : prm.cout;
    const float* wd = prm.w + (first ? 0 : size0 + (l - 1) * size_n);
    const float* wp = wd + 9 * cin;
    const float* bias = wp + (size_t)cin * prm.cout;
    // the last layer writes ``out``; the ones before alternate with scratch
    float* dst = (prm.num_layers - l) % 2 == 0 ? prm.out : prm.scratch;
    const float* src =
        first ? prm.x
              : ((prm.num_layers - l + 1) % 2 == 0 ? prm.out : prm.scratch);
    run_layer(src, dst, wd, wp, bias, prm.b, first ? prm.h : oh,
              first ? prm.w_in : ow, cin, oh, ow, prm.cout,
              first ? prm.stride : 1, dw_s);
    if (l < prm.num_layers) grid.sync();
  }
}

}  // namespace

// x [b, h, w, cin], out and scratch [b, oh, ow, cout], w the packed layers
// (layer 0: wd [3, 3, cin], wp [cin, cout], bias [cout]; layers 1..n the
// same with cin = cout); all f32, contiguous, on the device. cin and cout
// are multiples of 4 (16-byte weight loads); at stride 2, h and w are even.
// Launches on ``stream`` and returns the launch's CUDA error code.
extern "C" int rpn_sep_block(const void* x, void* out, void* scratch,
                             const void* w, int b, int h, int w_in, int cin,
                             int cout, int num_layers, int stride,
                             void* stream) {
  if (b <= 0 || h <= 0 || w_in <= 0 || cin <= 0 || cout <= 0 ||
      num_layers < 0 || cin % 4 != 0 || cout % 4 != 0 ||
      (stride != 1 && stride != 2) ||
      (stride == 2 && (h % 2 != 0 || w_in % 2 != 0)))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const size_t smem =
      sizeof(float) * kTileP * ((cin > cout ? cin : cout) + 1);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rpn_sep_block_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rpn_sep_block_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  const int oh = stride == 2 ? h / 2 : h;
  const int ow = stride == 2 ? w_in / 2 : w_in;
  const long long tiles = (long long)b * ((oh * ow + kTileP - 1) / kTileP) *
                          ((cout + kTileC - 1) / kTileC);
  const int grid = (int)(tiles < (long long)sms * per_sm ? tiles
                                                         : sms * per_sm);
  Params prm{static_cast<const float*>(x), static_cast<float*>(out),
             static_cast<float*>(scratch), static_cast<const float*>(w),
             b, h, w_in, cin, cout, num_layers, stride};
  void* args[] = {&prm};
  err = cudaLaunchCooperativeKernel((const void*)rpn_sep_block_kernel,
                                    dim3(grid), dim3(kThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
