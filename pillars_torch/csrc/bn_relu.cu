// Eval-mode BatchNorm + ReLU over float32 in one pass, for Hopper (sm_90a),
// on NCHW or channels-last (NHWC in memory) activations:
//
//   y = max((x - running_mean[c]) * (rsqrt(running_var[c] + eps) * weight[c])
//           + bias[c], 0)
//
// (flax's eval normalisation, which the JAX package and the port's bf16
// branch compute in this order).
//
// Replaces no TPU kernel: the JAX package leaves this to XLA, which fuses
// the normalisation and the ReLU into the conv's epilogue or one
// elementwise pass. In the port each of the RPN's convs and deconvs was
// followed by two library kernels, the eval BatchNorm and then the ReLU,
// each reading and writing the whole activation.
//
// What bounds it on this card. Two floating-point operations per element
// against 8 bytes (one f32 read, one f32 write): far below the ridge, so
// the only lever is to move each byte once, with enough loads in flight to
// keep device memory busy. At the KITTI grid the RPN's 19 activations hold
// 795 MB a cloud, 1.59 GB read and written: 0.47 ms at 3.35 TB/s.
//
// Design.
// - A 2-D grid: blockIdx.y walks the planes (n * C + c), blockIdx.x the
//   pixels of a plane, a contiguous chunk of kUnroll float4s a thread per
//   block, so the blocks in flight at any moment cover one contiguous
//   stretch of memory. A block's plane is one channel, so the block takes
//   its channel's scale and shift once, from the four BN vectors on the
//   device: a captured graph reads whatever was last copied into them,
//   never a value fixed at capture.
// - A thread issues its input loads first (streaming: the input is dead
//   after this pass), then the channel's four values and the scale are
//   read and computed while they are in flight; plain stores, since the
//   next conv reads the output, from L2 where it fits.
// - A plane whose start is not 16-byte aligned (H * W % 4 != 0) runs its
//   first and last elements scalar beside the float4 body; pointers that
//   are not 16-byte aligned at all take the scalar kernel.
// - Block width follows the plane: at d435i's small planes (320 pixels) a
//   block of 64 threads, so that B * C blocks still spread over the SMs.
// - Channels-last (bn_relu_nhwc): the channel is the fastest index, so a
//   float4 holds four channels of one pixel (channels % 4 == 0). A 1-D grid
//   walks the tensor in contiguous chunks as above; each thread reads the
//   four channels' values of its float4 (L1-resident: a few KB for the
//   whole tensor) after issuing its input loads. Other channel counts, and
//   pointers that are not 16-byte aligned, take the scalar kernel with
//   c = i % channels.
//
// Each host function returns cudaGetLastError() after the launch, and the
// wrapper (pillars_torch/ops/bn_relu_cuda.py) raises when it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;              // float4s a thread
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float bn_relu1(float v, float mean, float scale,
                                          float bias) {
  const float y = fmaf(v - mean, scale, bias);
  return y < 0.0f ? 0.0f : y;  // NaN passes, as torch.relu's
}

__device__ __forceinline__ float4 bn_relu4(float4 v, float mean,
                                           float scale, float bias) {
  return make_float4(bn_relu1(v.x, mean, scale, bias),
                     bn_relu1(v.y, mean, scale, bias),
                     bn_relu1(v.z, mean, scale, bias),
                     bn_relu1(v.w, mean, scale, bias));
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads)
bn_relu_kernel(const float* __restrict__ x, const float* __restrict__ mean,
               const float* __restrict__ var,
               const float* __restrict__ weight,
               const float* __restrict__ bias, float* __restrict__ y,
               int planes, int channels, long long hw, float eps) {
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    const long long base = (long long)p * hw;
    const int c = p % channels;
    if (kVector) {
      // x and y are 16-byte aligned: element base + head is too
      const long long head = min((4 - base % 4) % 4, hw);
      const long long nvec = (hw - head) / 4;
      const float4* xv = reinterpret_cast<const float4*>(x + base + head);
      float4* yv = reinterpret_cast<float4*>(y + base + head);
      const long long i0 =
          (long long)blockIdx.x * blockDim.x * kUnroll + threadIdx.x;
      float4 v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long i = i0 + (long long)k * blockDim.x;
        if (i < nvec) v[k] = __ldcs(xv + i);
      }
      const float m = mean[c];
      const float scale = rsqrtf(var[c] + eps) * weight[c];
      const float b = bias[c];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long i = i0 + (long long)k * blockDim.x;
        if (i < nvec) yv[i] = bn_relu4(v[k], m, scale, b);
      }
      if (i0 < 4) {
        const long long tail0 = head + 4 * nvec;
        const int t = (int)i0;
        if (t < head) y[base + t] = bn_relu1(x[base + t], m, scale, b);
        if (t < hw - tail0)
          y[base + tail0 + t] = bn_relu1(x[base + tail0 + t], m, scale, b);
      }
    } else {
      const long long i0 =
          (long long)blockIdx.x * blockDim.x * 4 * kUnroll + threadIdx.x;
      const float m = mean[c];
      const float scale = rsqrtf(var[c] + eps) * weight[c];
      const float b = bias[c];
#pragma unroll
      for (int k = 0; k < 4 * kUnroll; ++k) {
        const long long i = i0 + (long long)k * blockDim.x;
        if (i < hw) y[base + i] = bn_relu1(x[base + i], m, scale, b);
      }
    }
  }
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads)
bn_relu_nhwc_kernel(const float* __restrict__ x,
                    const float* __restrict__ mean,
                    const float* __restrict__ var,
                    const float* __restrict__ weight,
                    const float* __restrict__ bias, float* __restrict__ y,
                    long long n, int channels, float eps) {
  if (kVector) {
    // channels % 4 == 0 and every pointer 16-byte aligned
    const long long nvec = n / 4;
    const int quads = channels / 4;
    const float4* xv = reinterpret_cast<const float4*>(x);
    float4* yv = reinterpret_cast<float4*>(y);
    const long long i0 =
        (long long)blockIdx.x * blockDim.x * kUnroll + threadIdx.x;
    float4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = i0 + (long long)k * blockDim.x;
      if (i < nvec) v[k] = __ldcs(xv + i);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = i0 + (long long)k * blockDim.x;
      if (i < nvec) {
        const int q = (int)(i % quads);
        const float4 m = __ldg(reinterpret_cast<const float4*>(mean) + q);
        const float4 s = __ldg(reinterpret_cast<const float4*>(var) + q);
        const float4 w = __ldg(reinterpret_cast<const float4*>(weight) + q);
        const float4 b = __ldg(reinterpret_cast<const float4*>(bias) + q);
        yv[i] = make_float4(
            bn_relu1(v[k].x, m.x, rsqrtf(s.x + eps) * w.x, b.x),
            bn_relu1(v[k].y, m.y, rsqrtf(s.y + eps) * w.y, b.y),
            bn_relu1(v[k].z, m.z, rsqrtf(s.z + eps) * w.z, b.z),
            bn_relu1(v[k].w, m.w, rsqrtf(s.w + eps) * w.w, b.w));
      }
    }
  } else {
    const long long i0 =
        (long long)blockIdx.x * blockDim.x * 4 * kUnroll + threadIdx.x;
#pragma unroll
    for (int k = 0; k < 4 * kUnroll; ++k) {
      const long long i = i0 + (long long)k * blockDim.x;
      if (i < n) {
        const int c = (int)(i % channels);
        y[i] = bn_relu1(x[i], mean[c], rsqrtf(var[c] + eps) * weight[c],
                        bias[c]);
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// x, y: [planes, hw] float32 (NCHW with planes = N * C), y written; mean,
// var, weight, bias: [channels] float32, all on the device of `stream`.
// Returns cudaGetLastError() after the launch (0: launched).
int bn_relu_nchw(const float* x, const float* mean, const float* var,
                 const float* weight, const float* bias, float* y,
                 int planes, int channels, long long hw, float eps,
                 cudaStream_t stream) {
  // a thread per kUnroll float4s of a plane, up to a full block
  const long long per_thread = (hw + 4 * kUnroll - 1) / (4 * kUnroll);
  const int threads = (int)(per_thread >= kThreads
                                ? kThreads
                                : ((per_thread + 31) / 32) * 32);
  const long long chunk = 4LL * kUnroll * (threads > 0 ? threads : 1);
  const dim3 grid((unsigned)((hw + chunk - 1) / chunk),
                  (unsigned)(planes < kMaxGridY ? planes : kMaxGridY));
  if (aligned16(x) && aligned16(y))
    bn_relu_kernel<true><<<grid, threads, 0, stream>>>(
        x, mean, var, weight, bias, y, planes, channels, hw, eps);
  else
    bn_relu_kernel<false><<<grid, threads, 0, stream>>>(
        x, mean, var, weight, bias, y, planes, channels, hw, eps);
  return (int)cudaGetLastError();
}

// x, y: [n] float32, channels-last (element i holds channel i % channels),
// y written; mean, var, weight, bias: [channels] float32, all on the
// device of `stream`. Returns cudaGetLastError() after the launch.
int bn_relu_nhwc(const float* x, const float* mean, const float* var,
                 const float* weight, const float* bias, float* y,
                 long long n, int channels, float eps, cudaStream_t stream) {
  const long long per_thread = (n + 4 * kUnroll - 1) / (4 * kUnroll);
  const int threads = (int)(per_thread >= kThreads
                                ? kThreads
                                : ((per_thread + 31) / 32) * 32);
  const long long chunk = 4LL * kUnroll * (threads > 0 ? threads : 1);
  const dim3 grid((unsigned)((n + chunk - 1) / chunk));
  const bool vector = channels % 4 == 0 && aligned16(x) && aligned16(y) &&
                      aligned16(mean) && aligned16(var) &&
                      aligned16(weight) && aligned16(bias);
  if (vector)
    bn_relu_nhwc_kernel<true><<<grid, threads, 0, stream>>>(
        x, mean, var, weight, bias, y, n, channels, eps);
  else
    bn_relu_nhwc_kernel<false><<<grid, threads, 0, stream>>>(
        x, mean, var, weight, bias, y, n, channels, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
