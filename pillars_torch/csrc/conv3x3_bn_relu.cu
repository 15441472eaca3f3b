// Eval-mode 3x3 convolution + BatchNorm + ReLU over float32 in one pass, for
// Hopper (sm_90a):
//
//   y[n, o, i, j] = max((sum_{c, dy, dx} w[o, c, dy, dx]
//                        * x[n, c, i - pad_y + dy, j - 1 + dx]
//                        - mean[o]) * (rsqrt(var[o] + eps) * gamma[o])
//                       + beta[o], 0)
//
// with zeros outside the image (stride 1, pad_y 1, or 0 for a band of rows
// whose neighbours' rows were added, parallel/spatial.py). These are the
// RPN's plain stride-1 block convs (models/rpn.py::_Block), which the port
// ran as a cuDNN convolution followed by the BN + ReLU kernel of
// csrc/bn_relu.cu.
//
// Replaces no TPU kernel: the JAX package leaves its convolutions and their
// BatchNorm to XLA, which fuses the normalisation into the conv's epilogue.
//
// What bounds it on this card. Operations: a conv of the KITTI grid's block
// 1 (64 -> 64 channels over 496 x 432 pixels) is 15.80 GFLOP (2 per
// multiply-add) against 110 MB of compulsory traffic: 0.236 ms at the 67
// TFLOP/s of the CUDA cores' FFMA against 0.033 ms at 3.35 TB/s, and so are
// the others. TF32 and the tensor cores are ruled out by the
// configuration's precision, so the only lever is to keep the FFMA pipes
// issuing. What keeps them from it, measured on an H100 (one block an SM
// or two): FFMA in the order of a plain outer product reads its operands
// with bank conflicts (an 8 x 8 register product alone reaches 74-81% of
// the peak, in serpentine order 91-97%), and the chunk's staging (taking
// the copies, the weights' layout and the barriers out of the loop, which
// computes a wrong result, lifts the kernel from about 50% to 65%).
//
// Design.
// - Implicit GEMM over a 2-D output tile. A block computes TN output
//   channels for BR x BC output pixels. For each chunk of KC input channels
//   it brings the input patch with its halo (BR + 2 rows x BC + 2 columns)
//   into shared memory once, channel-major, and all 9 taps read it from
//   there: each input byte comes from L2 or device memory once a chunk, not
//   9 times. The patch is copied by cp.async, 4 bytes an element,
//   zero-filled where it falls outside the image (src-size 0): no branch on
//   padding in the product. The input is read through its own strides, so
//   any layout is taken; lanes copy along the columns. (Not TMA: a TMA box
//   lands in the tensor's own layout, and the product wants 4 neighbouring
//   pixels of one channel in a 16-byte word; the copies are about 3% of a
//   chunk's instructions.)
// - The weights are read as they are, [C_out][C_in][3][3], at every launch,
//   so a captured graph reads what was last copied into them (a buffer laid
//   out once, at a first call, would be stale after a checkpoint is loaded
//   into the captured state). A chunk's rows ([TN][9 KC] contiguous floats)
//   arrive by 16-byte cp.async into a staging area whose row stride (an odd
//   count of 16-byte words) keeps the transposing reads free of bank
//   conflicts; the block then lays them out as [tap][c][TN] for the
//   product. (Laying them out in a kernel of their own before each launch,
//   so that a chunk is copied as it is and one barrier a chunk suffices,
//   measured 5-10% slower at kitti3's shapes.)
// - Register tiles. A thread holds 4 output rows x 4 neighbouring columns
//   x 8 output channels (two quads 32 apart): 128 f32 accumulators. For
//   each input channel and each kernel row dy it reads its rows' 6 input
//   values each (LDS.128 + LDS.64), then for each of the 3 taps 8 weights
//   (two LDS.128) and issues 128 FFMA in serpentine order over (pixel,
//   channel), so that each shares an operand with the one before. Lanes
//   that share a weight word are neighbours (a quarter-warp reads 2
//   distinct words, which costs half the cycles of 8), and the input loads
//   of a warp read consecutive 16-byte words.
// - Pipeline: the patch double-buffered, the weights' staging single: the
//   copies of the next chunk are issued once this chunk's weights are laid
//   out and run under its product; two barriers a chunk. (mbarriers in
//   their place, so that warps drift apart by up to a chunk, measured no
//   faster.)
// - Balance: one block of 8 warps an SM (128 accumulators a thread leave
//   room for one), each with an equal share of the launch's (tile, chunk)
//   iterations and one pipeline across its tiles; a grid of whole tiles
//   left a partial last wave (kitti3's block2 read 47% against 59% on a
//   grid of whole waves). A tile that two or three blocks share is summed
//   by the last of them to count in on the tile's counter: each writes its
//   partial sums to a workspace, and the last adds all of them in the order
//   of the chunks. No block waits for another (no hang whatever the
//   residency), and the order of every sum is fixed by the shape, so two
//   launches give the same bits. The counters are back at 0 after every
//   launch.
// - Epilogue: per output channel scale = rsqrt(var + eps) * gamma in
//   registers (the four BN vectors read at every launch, as bn_relu.cu
//   does), then max(fma(acc - mean, scale, beta), 0) (NaN passes, as
//   torch.relu's), stored NCHW as float4s of 4 pixels.
// - Precision: f32 FFMA only, no TF32, no tensor cores. Each output sums its
//   C_in * 9 products in one fixed order (input channel, then dy, then dx,
//   a shared tile's partials in the order of their chunks).
// - Stride 2 (each block's first conv) stays with cuDNN: at kitti3's two
//   stride-2 shapes a stride-2 form of this design read 0.28-0.33 ms
//   against cuDNN + bn_relu's 0.24-0.26 (its patch is four times as large
//   for the same outputs, and its loads conflict two ways).
//
// The host function returns cudaGetLastError() after the launch (or the
// error of setting the shared memory size), and the wrapper
// (pillars_torch/ops/conv_cuda.py) raises when it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

// The launch's arguments (ops/conv_cuda.py::_Args, field for field).
struct ConvArgs {
  const float* x;
  long long sxn, sxc, sxh, sxw;  // the input's strides, in elements
  const float* w;                // [cout][cin][3][3], contiguous
  const float* mean;
  const float* var;
  const float* gamma;
  const float* beta;
  float* y;                      // [n][cout][ho][wo], contiguous
  float* ws;                     // partial sums of shared tiles (plan[1])
  int* counters;                 // one a tile (plan[2]), zero between launches
  int n, cin, h, w_, cout, ho, wo;
  int pad_y;
  int tiles_x, tiles_y;
  float eps;
};

namespace {

constexpr int kTaps = 9;
// a thread's tile: TR output rows x 4 neighbouring columns x TC output
// channels, two quads 4 * CG apart (CG: channel quads across a warp's lanes)
constexpr int TR = 4, TC = 8, CG = 8;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float bn_relu1(float v, float mean, float scale,
                                          float beta) {
  const float y = fmaf(v - mean, scale, beta);
  return y < 0.0f ? 0.0f : y;  // NaN passes, as torch.relu's
}

// WN x WR x WC: the block's warps along channels, rows and columns; KC:
// input channels a chunk.
template <int WN, int WR, int WC, int KC>
struct Tile {
  // one output channel's weights of a chunk, and their row in the staging
  // (an odd count of 16-byte words: 19 or 37)
  static constexpr int kRow = kTaps * KC;
  static constexpr int kRawStride = kRow + 4;
  static constexpr int PG = 32 / CG;           // column quads of a warp
  static constexpr int kThreads = 32 * WN * WR * WC;
  static constexpr int TN = WN * TC * CG;      // output channels
  static constexpr int BR = TR * WR;           // output rows
  static constexpr int BC = 4 * PG * WC;       // output columns
  static constexpr int PR = BR + 2;            // patch rows
  static constexpr int PC = BC + 2;            // patch columns
  static constexpr int PCS = (PC + 3) / 4 * 4; // a patch row in floats
  static constexpr int kPlane = PR * PCS;
  static constexpr int kPatch = KC * kPlane;
  static constexpr int kWeights = kTaps * KC * TN;  // a chunk's
  static constexpr int kRaw = TN * kRawStride;
  static constexpr int kSmemFloats = 2 * kPatch + kWeights + kRaw;
};

// the offset of a thread's channel j (< TC) from its first
__device__ __forceinline__ int quad_offset(int j) {
  return j < 4 ? j : 4 * CG + j - 4;
}

template <int WN, int WR, int WC, int KC>
__global__ void __launch_bounds__(32 * WN * WR * WC, 1)
conv3x3_bn_relu_kernel(const ConvArgs a) {
  using T = Tile<WN, WR, WC, KC>;
  constexpr int kAcc4 = TR * 4 * TC / 4;  // a thread's sums, in float4s
  extern __shared__ __align__(16) float smem[];
  float* const patch = smem;                         // [2][KC][PR][PCS]
  float* const wt = smem + 2 * T::kPatch;            // [9][KC][TN]
  float* const raw = wt + T::kWeights;               // [TN][9 KC + 4]
  __shared__ int last;

  const int tid = threadIdx.x;
  const int chunks = a.cin / KC;
  const int ntiles = a.cout / T::TN;
  // iterations (tile-major, then chunk) of the launch, fewer than 2**31
  const int iters = a.tiles_x * a.tiles_y * a.n * ntiles * chunks;
  // the first iteration of block b: each block runs an equal share
  auto first_of = [&](int b) {
    return (int)((long long)iters * b / gridDim.x);
  };
  auto block_of = [&](int i) {  // the block that runs iteration i
    return (int)(((long long)(i + 1) * gridDim.x + iters - 1) / iters - 1);
  };
  // tile t: output channels fastest, so that neighbouring tiles share
  // their input patch in L2
  struct At { int n, oy0, ox0, nt; };
  auto tile_at = [&](int t) {
    At r;
    r.nt = t % ntiles;
    t /= ntiles;
    r.ox0 = t % a.tiles_x * T::BC;
    t /= a.tiles_x;
    r.oy0 = t % a.tiles_y * T::BR;
    r.n = t / a.tiles_y;
    return r;
  };
  // the copies of iteration i (tile i / chunks, input channels i % chunks
  // * KC ..) into buffer `buf`
  auto issue = [&](int i, int buf) {
    const At at = tile_at(i / chunks);
    const int ch = i % chunks;
    const int iy0 = at.oy0 - a.pad_y, ix0 = at.ox0 - 1;
    float* const dst = patch + buf * T::kPatch;
    const float* const src =
        a.x + at.n * a.sxn + (long long)ch * KC * a.sxc;
    for (int e = tid; e < KC * T::PR * T::PC; e += T::kThreads) {
      const int c = e % T::PC, rk = e / T::PC;
      const int r = rk % T::PR, k = rk / T::PR;
      const int iy = iy0 + r, ix = ix0 + c;
      const bool in = (unsigned)iy < (unsigned)a.h &&
                      (unsigned)ix < (unsigned)a.w_;
      const float* const s =
          in ? src + k * a.sxc + iy * a.sxh + ix * a.sxw : a.x;
      cp_async4(dst + k * T::kPlane + r * T::PCS + c, s, in ? 4 : 0);
    }
    const float* const wsrc =
        a.w + ((long long)at.nt * T::TN * a.cin + ch * KC) * kTaps;
    for (int e = tid; e < T::TN * (T::kRow / 4); e += T::kThreads) {
      const int o = e / (T::kRow / 4), q = e % (T::kRow / 4);
      cp_async16(raw + o * T::kRawStride + 4 * q,
                 wsrc + (long long)o * a.cin * kTaps + 4 * q);
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int wn_i = warp % WN, ws_i = warp / WN;
  const int wr_i = ws_i % WR, wc_i = ws_i / WR;
  const int cg = lane / T::PG, pg = lane % T::PG;
  const int ty = TR * wr_i;                     // rows ty .. ty + TR - 1
  const int tx = 4 * (pg + T::PG * wc_i);       // columns tx .. tx + 3
  const int cb = wn_i * TC * CG + 4 * cg;       // channels cb.. (cb + 4CG..)

  float acc[TR][4][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][p][j] = 0.0f;

  // One pipeline over the block's iterations, across its tiles: the copies
  // of the next iteration run under this one's product, also where the
  // next belongs to the next tile.
  const int begin = first_of(blockIdx.x), end = first_of(blockIdx.x + 1);
  int c0 = begin % chunks;  // the first chunk of this tile's segment
  issue(begin, 0);
  cp_async_commit();
  for (int it = begin; it < end; ++it) {
    const int buf = (it - begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // iteration it landed; every product before it done
    // the staged rows [TN][9 KC] -> [tap][c][TN]: lanes on consecutive
    // output channels, so the reads (an odd count of 16-byte words apart)
    // and the writes (consecutive) miss no bank
    for (int e = tid; e < T::TN * (T::kRow / 4); e += T::kThreads) {
      const int o = e % T::TN, q = e / T::TN;
      const float4 v =
          *reinterpret_cast<const float4*>(raw + o * T::kRawStride + 4 * q);
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kt = 4 * q + u;  // c * 9 + tap
        wt[((kt % kTaps) * KC + kt / kTaps) * T::TN + o] = vs[u];
      }
    }
    __syncthreads();  // weights laid out; the staging and the buffer free
    if (it + 1 < end) issue(it + 1, buf ^ 1);
    cp_async_commit();

    const float* const pa = patch + buf * T::kPatch + ty * T::PCS + tx;
    const float* const pb = wt + cb;
#pragma unroll 1
    for (int k = 0; k < KC; ++k) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        // the input rows of this kernel row, then tap by tap its weights
        float v[TR][6];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float* row = pa + k * T::kPlane + (i + dy) * T::PCS;
          const float4 v0 = *reinterpret_cast<const float4*>(row);
          const float2 v1 = *reinterpret_cast<const float2*>(row + 4);
          v[i][0] = v0.x; v[i][1] = v0.y; v[i][2] = v0.z; v[i][3] = v0.w;
          v[i][4] = v1.x; v[i][5] = v1.y;
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wp = pb + ((dy * 3 + dx) * KC + k) * T::TN;
          float b[TC];
#pragma unroll
          for (int h = 0; h < TC / 4; ++h) {
            const float4 q = *reinterpret_cast<const float4*>(wp + 4 * CG * h);
            b[4 * h] = q.x; b[4 * h + 1] = q.y;
            b[4 * h + 2] = q.z; b[4 * h + 3] = q.w;
          }
          // serpentine over the (pixel, channel) grid: each product shares
          // an operand with the one before, also at the turns, which keeps
          // the register file's operand reads free of bank conflicts
#pragma unroll
          for (int r = 0; r < TR * 4; ++r)
#pragma unroll
            for (int jj = 0; jj < TC; ++jj) {
              const int i = r / 4, p = r % 4;
              const int j = r % 2 ? TC - 1 - jj : jj;
              acc[i][p][j] = fmaf(v[i][p + dx], b[j], acc[i][p][j]);
            }
        }
      }
    }

    const int ch = it % chunks;
    if (ch != chunks - 1 && it + 1 != end) continue;  // the tile goes on
    // the segment [c0, ch] of tile t ends here
    const int t = it / chunks;
    const bool whole = c0 == 0 && ch == chunks - 1;
    c0 = 0;  // the next segment starts a tile
    if (!whole) {
      // a tile shared among blocks: each writes its partial sums, and the
      // last to count in adds all of them in the order of the chunks and
      // finishes the tile (no block waits for another)
      const int t_first = t * chunks;
      const int b_first = block_of(t_first);
      const int segments = block_of(t_first + chunks - 1) - b_first + 1;
      // a block's partial of a tile that its range started before sits in
      // its slot 1, otherwise in slot 0
      auto partial = [&](int b) {
        const int slot = first_of(b) < t_first ? 1 : 0;
        return reinterpret_cast<float4*>(a.ws) +
               ((long long)b * 2 + slot) * kAcc4 * T::kThreads + tid;
      };
      float4* const mine = partial(blockIdx.x);
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int h = 0; h < TC / 4; ++h)
            mine[((i * 4 + p) * (TC / 4) + h) * T::kThreads] = make_float4(
                acc[i][p][4 * h], acc[i][p][4 * h + 1], acc[i][p][4 * h + 2],
                acc[i][p][4 * h + 3]);
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        last = atomicAdd(a.counters + t, 1) == segments - 1;
        if (last) a.counters[t] = 0;  // ready for the next launch
      }
      __syncthreads();
      if (!last) {
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int j = 0; j < TC; ++j) acc[i][p][j] = 0.0f;
        continue;
      }
      __threadfence();
      for (int sgm = 0; sgm < segments; ++sgm) {
        const float4* const src = partial(b_first + sgm);
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int h = 0; h < TC / 4; ++h) {
              const float4 q =
                  __ldcg(src + ((i * 4 + p) * (TC / 4) + h) * T::kThreads);
              const float qs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
              for (int u = 0; u < 4; ++u)
                acc[i][p][4 * h + u] =
                    sgm == 0 ? qs[u] : acc[i][p][4 * h + u] + qs[u];
            }
      }
    }

    // epilogue: BN + ReLU in registers, then the stores
    const At at = tile_at(t);
    const int co0 = at.nt * T::TN;
    float mean[TC], scale[TC], beta[TC];
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int o = co0 + cb + quad_offset(j);
      mean[j] = a.mean[o];
      scale[j] = rsqrtf(a.var[o] + a.eps) * a.gamma[o];
      beta[j] = a.beta[o];
    }
    const long long plane = (long long)a.ho * a.wo;
    float* const yn = a.y + (long long)at.n * a.cout * plane;
    const int ox = at.ox0 + tx;
    const bool vec = a.wo % 4 == 0 && ox + 3 < a.wo;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int oy = at.oy0 + ty + i;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        float y[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          y[p] = bn_relu1(acc[i][p][j], mean[j], scale[j], beta[j]);
          acc[i][p][j] = 0.0f;  // the next tile's sums start here
        }
        if (oy >= a.ho) continue;
        float* const row = yn + (co0 + cb + quad_offset(j)) * plane +
                           (long long)oy * a.wo + ox;
        if (vec) {
          *reinterpret_cast<float4*>(row) = make_float4(y[0], y[1], y[2],
                                                        y[3]);
        } else {
#pragma unroll
          for (int p = 0; p < 4; ++p)
            if (ox + p < a.wo) row[p] = y[p];
        }
      }
    }
  }
}

// The launch of one instance, or with `plan` its plan: plan[0] the grid
// (the blocks the card holds at once, at most one an iteration), plan[1]
// the workspace in floats, plan[2] the tiles (counters).
template <int WN, int WR, int WC, int KC>
int launch(const ConvArgs& args, cudaStream_t stream, long long* plan) {
  using T = Tile<WN, WR, WC, KC>;
  auto kernel = conv3x3_bn_relu_kernel<WN, WR, WC, KC>;
  const int smem = T::kSmemFloats * (int)sizeof(float);
  static int resident = 0;  // blocks the card holds at once
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, T::kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  ConvArgs a = args;
  a.tiles_x = (a.wo + T::BC - 1) / T::BC;
  a.tiles_y = (a.ho + T::BR - 1) / T::BR;
  const long long tiles = (long long)a.tiles_x * a.tiles_y * a.n *
                          (a.cout / T::TN);
  const long long iters = tiles * (a.cin / KC);
  if (iters >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long grid = iters < resident ? iters : resident;
  if (plan) {
    plan[0] = grid;
    plan[1] = grid * 2 * T::kThreads * TR * 4 * TC;
    plan[2] = tiles;
    return 0;
  }
  kernel<<<(unsigned)grid, T::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `plan` null: the launch of one conv + BN + ReLU, which returns
// cudaGetLastError() after it (cudaErrorInvalidValue for a shape the
// kernel does not take). `plan` not null: no launch; plan[0..2] as
// launch() says. The block tile follows C_out: 16 x 32 pixels x 64
// channels, 8 x 32 x 128, and 16 x 16 x 128 at 256 (measured fastest of
// five at kitti3's and SECOND's 256-channel shapes).
int conv3x3_bn_relu(const ConvArgs* args, cudaStream_t stream,
                    long long* plan) {
  const ConvArgs& a = *args;
  if (a.cin <= 0 || a.cin % 8 != 0 || a.n <= 0 || a.ho <= 0 || a.wo <= 0 ||
      (a.pad_y != 0 && a.pad_y != 1))
    return (int)cudaErrorInvalidValue;
  // <WN, WR, WC, KC>; 16 input channels a chunk
  // where C_in allows
  const bool wide = a.cin % 16 == 0;
  switch (a.cout) {
    case 64:
      return wide ? launch<1, 4, 2, 16>(a, stream, plan)
                  : launch<1, 4, 2, 8>(a, stream, plan);
    case 128:
      return wide ? launch<2, 2, 2, 16>(a, stream, plan)
                  : launch<2, 2, 2, 8>(a, stream, plan);
    case 256:
      return wide ? launch<2, 4, 1, 16>(a, stream, plan)
                  : launch<2, 4, 1, 8>(a, stream, plan);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
