// A chain of fused RPN downsample blocks for inference, for Hopper (sm_90a).
//
// Replaces the TPU kernel pillars_tpu/ops/rpn_pallas.py::_make_block_kernel
// (pallas_call in fused_sep_block) and computes the same function per block:
// 1 + num_layers separable layers, each a SAME 3x3 depthwise conv (stride 2
// on the first layer only: the even centres), a 1x1 pointwise product with
// eval-mode BN folded into its weights and bias, then ReLU. NHWC, with full
// f32 FMAs on the CUDA cores. Two entry points: rpn_sep_chain reads and
// writes float32; rpn_sep_chain_bf16 reads each block's input and writes its
// output as bfloat16, as the Pallas kernel does under
// runtime.compute_dtype=bfloat16, while every layer inside a block still
// computes in f32 from the f32 weights and keeps its activations in f32
// (two f32 scratch buffers): a block rounds once, at its output, and the
// next block reads that bfloat16 tensor. Not TF32: one TF32 pass
// misses the 1e-5 tolerance against the plain twin. A three-pass split
// product through mma.sync was weighed and not built: on tiles this small
// (20 pixels padded to 32 rows, three passes) it would by estimate save a
// third of the product's time, a twentieth of the kernel's, and the tensor
// cores' accumulator rounding would have to be kept off the tolerance.
//
// What bounds it on this card. At the d435i shapes and B = 1 the three
// blocks are 16 dependent layers of about 21 M multiply-adds each over
// [5120, 64], [1280, 128] and [320, 256] (pixels, channels): 730 M f32
// operations against 8.9 MB of compulsory traffic, so by the roofline
// operations bound it (10.9 us at 67 TFLOP/s). A layer is far too small for
// that rate. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (pillars_torch/utils/kernel_phases.py), the three blocks take about 90 us
// in one launch, a layer 5 to 6 us, in five parts of similar size:
// - the grid barrier to the layer before, about 2300 SM cycles;
// - the tile's input halo from L2, 1800-2200 cycles: every CTA re-reads
//   its neighbours' pixels and, where a layer has several channel tiles,
//   the same pixels as the other channel tiles' CTAs, and all SMs pulling
//   at once get about 20 bytes per cycle each;
// - the depthwise from shared memory, 1300-3100 cycles, with the issue of
//   the next layer's weight copies;
// - the product, 2700 cycles: a tile has only 640-2560 outputs, so the
//   reduction is split over the warps and each thread's 5 x 4 register tile
//   loads 9 16-byte vectors per 80 FMAs; a 16-byte shared load occupies the
//   load unit for 4 cycles a warp, which makes the loads, not the FMAs, the
//   limit (36 against 20 cycles per step and warp);
// - the reduction over the warps' slices, bias, ReLU and stores, 800-1300.
//
// Design.
// - One cooperative launch runs a whole chain of blocks (the RPN's three):
//   a cooperative-groups grid barrier separates consecutive layers, also
//   across blocks, and the activations ping-pong between each block's
//   output and one scratch buffer (they stay in the 50 MB L2). Every layer
//   needs the whole card for its FMAs and every pixel its 3x3 neighbours
//   from the layer before, hence grid-wide barriers: a cluster's shared
//   memory would hold block 3's activations, but 8 SMs would take 16 times
//   as long over the product as 128.
// - A layer is cut into tiles of TP output pixels (TH rows x TW columns) x
//   TC output channels, one 256-thread CTA per tile and SM. The tile is
//   picked per block so that B = 1 gives the card one wave: 40 x 64 for
//   block 1 (8 x 5 pixels, 128 tiles), 20 x 64 for block 2 (4 x 5, 128), 20
//   x 32 for block 3 (4 x 5, 128); among tilings with equally many tiles
//   the one with the fewest halo pixels wins (near-square tiles).
// - Per tile: cp.async (L2 only, so coherent with what other SMs wrote
//   before the barrier) brings the input halo into shared memory once,
//   zero-filled outside the image. The depthwise runs from shared memory,
//   one thread per row segment of 5 outputs x 4 channels with its 9 weight
//   vectors in registers, and writes the tile's [TP, C_in] product operand
//   to shared memory. Block 1 (one channel tile) computes it once per pixel
//   tile; blocks 2 and 3 recompute it in each of their 2 and 8 channel
//   tiles. Sharing it between two CTAs of a cluster through distributed
//   shared memory was built and measured: the halo copy got shorter, the
//   remote stores and the cluster barrier cost more than that (93 against
//   91 us), so it is not here.
// - The pointwise product reads the layer's weight slice [C_in, TC] (with
//   its depthwise weights and bias) from shared memory, staged by cp.async;
//   the slice of the CTA's next layer is prefetched into a second buffer
//   while this layer's product, stores and barrier run. The 8 warps split
//   the tile's pixels and then the reduction (2, 4 or 8 ways, 32 channels
//   each at the d435i shapes), so all four schedulers work on a tile of
//   only 640 outputs; the partial sums meet in shared memory, in a fixed
//   order, where bias and ReLU are applied and float4 stores leave.
// - The tile configuration is a run-time value and the three blocks share
//   one copy of the code: between two clouds hundreds of other kernels run,
//   the instruction cache forgets this one, and a copy per configuration
//   was fetched anew at every block's first layer (104 us after an L2 flush
//   against 86 us back to back; one copy takes about 91 either way).
// - Integer divisions by run-time sizes are made once per block, not per
//   layer or tile: after a barrier they were a tenth of the time.
// - Ragged shapes: channels are any multiples of 4 (weight columns past
//   C_out and pixels past the tile or image are computed on whatever the
//   buffers hold and never stored); C_in needs no padding.
// - bfloat16 input and output (the template flag kBf16): cp.async cannot
//   convert, so a block's first layer loads its bfloat16 halo with 8-byte
//   loads (4 channels, L2 only, as the copies) and stores it to shared
//   memory as f32; the halo, the depthwise and the product are the f32
//   path's, and the shared-memory budget is the same. The last layer of a
//   block rounds its f32 sums to bfloat16 (round to nearest even) in the
//   store; the layers before it ping-pong between two f32 scratch buffers.
//   Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 15),
//   the bfloat16 chain takes about 94 us of device time per launch at B = 1
//   against the f32 kernel's 89 in the same run: the same FMAs, minus the
//   cp.async overlap of the first layers' halos.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 8, "the reduction's slices are 8 >> pw_shift");
constexpr int kRP = 5;         // pixels per thread in the product
constexpr int kSeg = 5;        // outputs per depthwise item (a row segment)
constexpr int kMaxBlocks = 4;  // blocks per launch
constexpr int kNumCfg = 3;
constexpr size_t kMaxSmem = 227 * 1024;

// Tile configurations, largest tile first: TC output channels; the 8 warps
// are PW pixel sub-tiles x (8 / PW) slices of the reduction. Both are
// powers of two, kept as shifts: CL = TC / 4 lanes across a tile's channels.
__host__ __device__ constexpr int cfg_cl_shift(int cfg) {
  return cfg == 2 ? 3 : 4;
}
__host__ __device__ constexpr int cfg_pw_shift(int cfg) { return 2 - cfg; }
__host__ __device__ constexpr int cfg_tc(int cfg) {
  return 4 << cfg_cl_shift(cfg);
}
__host__ __device__ constexpr int cfg_pw(int cfg) {
  return 1 << cfg_pw_shift(cfg);
}
// pixels per tile: PW sub-tiles x (32 / (TC / 4)) pixel lanes x kRP
__host__ __device__ constexpr int cfg_tp(int cfg) {
  return cfg_pw(cfg) * (32 / (cfg_tc(cfg) / 4)) * kRP;
}

struct BlockDesc {
  const void* x;   // [b, h, w, cin], float or bfloat16
  void* out;       // [b, oh, ow, cout], as x
  const float* w;  // packed per layer: wd [3, 3, ci], wp [ci, cout], bias
  int h, w_in, cin, cout, num_layers, stride, oh, ow;
  int cfg, th, tw, tiles_y, tiles_x, ctiles;
  int w_floats, halo_floats;  // shared-memory regions, in floats
};

struct Params {
  BlockDesc blk[kMaxBlocks];
  float* scratch;   // as large as the largest output, in floats
  float* scratch2;  // the same, bfloat16 chains only
  int nblocks, b;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// With -DRPN_PHASE_CLOCKS one thread of CTA 0 stamps clock64() at the phase
// boundaries of every layer (pillars_torch/utils/kernel_phases.py reads the
// stamps); without it PHASE() is nothing.
#ifdef RPN_PHASE_CLOCKS
constexpr int kPhases = 7, kMaxStampedLayers = 64;
__device__ long long g_clocks[kMaxStampedLayers * kPhases];
__device__ int g_layer;
#define PHASE(i)                                                    \
  do {                                                              \
    if (blockIdx.x == 0 && threadIdx.x == 0 &&                      \
        g_layer < kMaxStampedLayers)                                \
      g_clocks[g_layer * kPhases + (i)] = clock64();                \
  } while (0)
#define PHASE_NEXT_LAYER()                                  \
  do {                                                      \
    if (blockIdx.x == 0 && threadIdx.x == 0) ++g_layer;     \
  } while (0)
#define PHASE_RESET()                                       \
  do {                                                      \
    if (blockIdx.x == 0 && threadIdx.x == 0) g_layer = 0;   \
  } while (0)
#else
#define PHASE(i)
#define PHASE_NEXT_LAYER()
#define PHASE_RESET()
#endif

// halo pixels of a th x tw tile at stride s: rows, and columns padded to
// whole depthwise segments
__host__ __device__ inline int halo_rows(int th, int s) {
  return (th - 1) * s + 3;
}
__host__ __device__ inline int halo_cols(int tw, int s) {
  return (cdiv(tw, kSeg) * kSeg - 1) * s + 3;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 fma4(const float4 a, const float4 b,
                                       float4 c) {
  c.x = fmaf(a.x, b.x, c.x);
  c.y = fmaf(a.y, b.y, c.y);
  c.z = fmaf(a.z, b.z, c.z);
  c.w = fmaf(a.w, b.w, c.w);
  return c;
}

// One layer's weights for output channels [c0, c0 + tc) -> shared memory:
// wd [9, k] | bias [tc] | wp [k, tc]. Columns past cout are left as they are.
__device__ void stage_weights(float* buf, const float* __restrict__ wl, int k,
                              int cout, int c0, int cl_shift) {
  const int cl4 = 1 << cl_shift, tc = 4 << cl_shift;
  const int tid = threadIdx.x;
  const float* wp = wl + 9 * k;
  const float* bias = wp + (size_t)k * cout;
  for (int i = tid; i < 9 * k / 4; i += kThreads)
    cp_async16(buf + 4 * i, wl + 4 * i);
  float* sbias = buf + 9 * k;
  if (tid < cl4 && c0 + 4 * tid < cout)
    cp_async16(sbias + 4 * tid, bias + c0 + 4 * tid);
  float* swp = sbias + tc;
  const int cl = tid & (cl4 - 1);
  if (c0 + 4 * cl < cout)
    for (int r = tid >> cl_shift; r < k; r += kThreads >> cl_shift)
      cp_async16(swp + r * tc + 4 * cl, wp + (size_t)r * cout + c0 + 4 * cl);
}

// How the threads share a halo copy, fixed per layer shape: the lanes of a
// warp cover the k channels of one pixel, or of 32 / (k / 4) pixels when k / 4
// divides 32, so no lane idles. A thread walks the halo's pixels from (r0,
// cx0) in steps of (dr, dc) rows and columns, without a division.
struct HaloLanes {
  int step;  // channels (floats) covered by one pass of a pixel's lanes
  int c0;    // this thread's first channel
  int r0, cx0, dr, dc;
};
__device__ inline HaloLanes halo_lanes(int k, int hc) {
  const int k4 = k / 4;
  const int lpp = (k4 < 32 && 32 % k4 == 0) ? k4 : 32;  // lanes per pixel
  const int lane = threadIdx.x % 32;
  const int cols = kWarps * (32 / lpp);  // pixels per step of the CTA
  const int col0 = (threadIdx.x / 32) * (32 / lpp) + lane / lpp;
  HaloLanes hl;
  hl.step = 4 * lpp;
  hl.c0 = 4 * (lane % lpp);
  hl.r0 = col0 / hc;
  hl.cx0 = col0 % hc;
  hl.dr = cols / hc;
  hl.dc = cols % hc;
  return hl;
}

// The input pixels [iy0, iy0 + hr) x [ix0, ix0 + hc) of one sample, all k
// channels -> shared memory [hr * hc, k], zeros outside the image. Four
// pixels per thread are addressed before their copies are issued, so the
// copies leave back to back.
__device__ void stage_halo(float* halo, const float* src, int ih, int iw,
                           int k, int iy0, int ix0, int hr, int hc,
                           const HaloLanes hl) {
  int r = hl.r0, cx = hl.cx0;
  while (r < hr) {
    float* dst[4];
    const float* from[4];
    bool ok[4], in[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int iy = iy0 + r, ix = ix0 + cx;
      ok[j] = r < hr;
      in[j] = iy >= 0 && iy < ih && ix >= 0 && ix < iw;
      dst[j] = halo + ((size_t)r * hc + cx) * k + hl.c0;
      from[j] = src + ((long long)iy * iw + ix) * k + hl.c0;
      r += hl.dr;
      cx += hl.dc;
      if (cx >= hc) {
        cx -= hc;
        ++r;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!ok[j]) continue;
      if (in[j]) {
        for (int c = 0; hl.c0 + c < k; c += hl.step)
          cp_async16(dst[j] + c, from[j] + c);
      } else {
        for (int c = 0; hl.c0 + c < k; c += hl.step)
          *reinterpret_cast<float4*>(dst[j] + c) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

// The bfloat16 counterpart of stage_halo: the same pixels and lanes, each
// lane 4 channels loaded as 8 bytes from L2 and stored as f32.
__device__ __forceinline__ float4 bf16x4_to_float4(const uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ void stage_halo_bf16(float* halo, const __nv_bfloat16* src, int ih,
                                int iw, int k, int iy0, int ix0, int hr,
                                int hc, const HaloLanes hl) {
  int r = hl.r0, cx = hl.cx0;
  while (r < hr) {
    const int iy = iy0 + r, ix = ix0 + cx;
    const bool in = iy >= 0 && iy < ih && ix >= 0 && ix < iw;
    float* dst = halo + ((size_t)r * hc + cx) * k + hl.c0;
    const __nv_bfloat16* from = src + ((long long)iy * iw + ix) * k + hl.c0;
    for (int c = 0; hl.c0 + c < k; c += hl.step)
      *reinterpret_cast<float4*>(dst + c) =
          in ? bf16x4_to_float4(
                   __ldcg(reinterpret_cast<const uint2*>(from + c)))
             : make_float4(0.f, 0.f, 0.f, 0.f);
    r += hl.dr;
    cx += hl.dc;
    if (cx >= hc) {
      cx -= hc;
      ++r;
    }
  }
}

// 4 f32 -> 4 bfloat16 (round to nearest even), one 8-byte store.
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst,
                                             const float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// 3x3 depthwise of the tile from the halo: an item is kSeg outputs of one
// row x 4 channels, taps in (dy, dx) order. dw [TP, kpad]. ``first`` is
// this thread's first item (channel, segment, row), split once per layer.
template <int S>
__device__ void depthwise_tile(const float* halo, const float* wd, float* dw,
                               int k, int kpad, int th, int tw, int hc,
                               const int3 first) {
  const int k4 = k / 4;
  const int nseg = cdiv(tw, kSeg);
  for (int item = threadIdx.x; item < th * nseg * k4; item += kThreads) {
    int c = first.x, seg = first.y, r = first.z;
    if (item != (int)threadIdx.x) {
      c = 4 * (item % k4);
      seg = (item / k4) % nseg;
      r = item / (k4 * nseg);
    }
    float4 acc[kSeg];
#pragma unroll
    for (int o = 0; o < kSeg; ++o) acc[o] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* hb = halo + ((size_t)(r * S) * hc + seg * kSeg * S) * k + c;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float4 w[3];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        w[dx] = *reinterpret_cast<const float4*>(wd + (dy * 3 + dx) * k + c);
#pragma unroll
      for (int j = 0; j < (kSeg - 1) * S + 3; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(hb + (size_t)(dy * hc + j) * k);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          if (j >= dx && (j - dx) % S == 0 && (j - dx) / S < kSeg)
            acc[(j - dx) / S] = fma4(v, w[dx], acc[(j - dx) / S]);
      }
    }
#pragma unroll
    for (int o = 0; o < kSeg; ++o)
      if (seg * kSeg + o < tw)
        *reinterpret_cast<float4*>(
            dw + (size_t)(r * tw + seg * kSeg + o) * kpad + c) = acc[o];
  }
}

// What a thread needs to know of a layer's shape, (k, stride): integer
// divisions, made once per block (the first layer, and the others) instead
// of after every barrier.
struct LayerLanes {
  HaloLanes hl;
  int3 item0;  // the thread's first depthwise item: channel, segment, row
};
__device__ inline LayerLanes layer_lanes(int k, int tw, int s) {
  const int k4 = k / 4, nseg = cdiv(tw, kSeg);
  LayerLanes ll;
  ll.hl = halo_lanes(k, halo_cols(tw, s));
  ll.item0 = make_int3(4 * (threadIdx.x % k4), (threadIdx.x / k4) % nseg,
                       threadIdx.x / (k4 * nseg));
  return ll;
}

struct TileIdx {
  int ct, tx, ty, bi;
};
__device__ inline TileIdx split_tile(const BlockDesc& d, int t) {
  TileIdx ti;
  ti.ct = t % d.ctiles;
  int u = t / d.ctiles;
  ti.tx = u % d.tiles_x;
  u /= d.tiles_x;
  ti.ty = u % d.tiles_y;
  ti.bi = u / d.tiles_y;
  return ti;
}

// All layers of one block. Shared memory: two weight buffers | halo (later
// the partial sums) | depthwise output.
template <bool kBf16>
__device__ void run_block(const BlockDesc& d, int b, float* scratch,
                          float* scratch2, bool last_block, float* smem,
                          cg::grid_group& grid) {
  const int cl_shift = cfg_cl_shift(d.cfg), pw_shift = cfg_pw_shift(d.cfg);
  const int TC = 4 << cl_shift, CL = 1 << cl_shift, PL = 32 >> cl_shift;
  const int PW = 1 << pw_shift, KS = kWarps >> pw_shift;
  const int WP = PL * kRP, TP = PW * WP;
  float* halo = smem + 2 * d.w_floats;
  float* red = halo;  // [KS, TP, TC], after the depthwise has read the halo
  float* dw = halo + d.halo_floats;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pw = warp & (PW - 1), ks = warp >> pw_shift;
  const int cl = lane & (CL - 1), pl = lane >> cl_shift;
  const int ntiles = b * d.tiles_y * d.tiles_x * d.ctiles;
  const int npix = d.oh * d.ow;
  // the epilogue's items (a pixel of the tile x 4 channels) of this thread
  constexpr int NI = (cfg_tp(0) * (cfg_tc(0) / 4) + kThreads - 1) / kThreads;
  int epix[NI], erow[NI], ecol[NI];
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    epix[j] = (threadIdx.x + j * kThreads) >> cl_shift;
    erow[j] = epix[j] / d.tw;
    ecol[j] = epix[j] % d.tw;
  }
  const int echan = 4 * (threadIdx.x & (CL - 1));  // kThreads % CL == 0
  const size_t size0 =
      9 * (size_t)d.cin + (size_t)d.cin * d.cout + d.cout;
  const size_t size_n =
      9 * (size_t)d.cout + (size_t)d.cout * d.cout + d.cout;
  const LayerLanes lanes_first = layer_lanes(d.cin, d.tw, d.stride);
  const LayerLanes lanes_rest = layer_lanes(d.cout, d.tw, 1);
  // this CTA's first tile is the same in every layer
  const TileIdx tile0 = split_tile(d, blockIdx.x);

  for (int l = 0; l <= d.num_layers; ++l) {
    const bool first = l == 0;
    const int k = first ? d.cin : d.cout;
    const int kpad = k + 4;
    const int s = first ? d.stride : 1;
    const int ih = first ? d.h : d.oh, iw = first ? d.w_in : d.ow;
    const float* wl = d.w + (first ? 0 : size0 + (l - 1) * size_n);
    const bool last = l == d.num_layers;
    // f32: the last layer writes ``out``, the ones before alternate with
    // scratch. bfloat16: the last writes ``out`` rounded; the ones before
    // alternate between the two f32 scratch buffers (dst unused when last)
    float* dst;
    const float* src;
    if (kBf16) {
      dst = l % 2 ? scratch2 : scratch;
      src = first ? nullptr : ((l - 1) % 2 ? scratch2 : scratch);
    } else {
      float* out = static_cast<float*>(d.out);
      dst = (d.num_layers - l) % 2 == 0 ? out : scratch;
      src = first ? static_cast<const float*>(d.x)
                  : ((d.num_layers - l + 1) % 2 == 0 ? out : scratch);
    }
    const int hr = halo_rows(d.th, s), hc = halo_cols(d.tw, s);
    float* wb = smem + (l & 1) * d.w_floats;
    const float* swd = wb;
    const float* sbias = wb + 9 * k;
    const float* swp = sbias + TC;
    // slice of the reduction for this warp, in steps of 4
    const int kc = ((k / 4 + KS - 1) >> (3 - pw_shift)) * 4;
    const int k0 = min(k, ks * kc), k1 = min(k, k0 + kc);
    // the slice staged in ``wb``: the prefetch made during the layer before
    int staged_ct = first ? -1 : tile0.ct;
    const HaloLanes hl = first ? lanes_first.hl : lanes_rest.hl;
    const int3 item0 = first ? lanes_first.item0 : lanes_rest.item0;

    PHASE(0);  // copies issued | arrived | depthwise | product | stored
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const TileIdx ti = t == (int)blockIdx.x ? tile0 : split_tile(d, t);
      const int ct = ti.ct, bi = ti.bi;
      const int oy0 = ti.ty * d.th, ox0 = ti.tx * d.tw, c0 = ct * TC;

      if (ct != staged_ct) {
        stage_weights(wb, wl, k, d.cout, c0, cl_shift);
        staged_ct = ct;
      }
      if (kBf16 && first)
        stage_halo_bf16(halo,
                        static_cast<const __nv_bfloat16*>(d.x) +
                            (size_t)bi * ih * iw * k,
                        ih, iw, k, oy0 * s - 1, ox0 * s - 1, hr, hc, hl);
      else
        stage_halo(halo, src + (size_t)bi * ih * iw * k, ih, iw, k,
                   oy0 * s - 1, ox0 * s - 1, hr, hc, hl);
      PHASE(1);
      cp_async_commit_wait();
      __syncthreads();
      PHASE(2);

      if (s == 1)
        depthwise_tile<1>(halo, swd, dw, k, kpad, d.th, d.tw, hc, item0);
      else
        depthwise_tile<2>(halo, swd, dw, k, kpad, d.th, d.tw, hc, item0);
      // the next layer's slice for this CTA's first tile, in flight during
      // the product, the stores and the barrier
      if (l < d.num_layers && t + gridDim.x >= ntiles) {
        stage_weights(smem + ((l + 1) & 1) * d.w_floats,
                      d.w + size0 + l * size_n, d.cout, d.cout, tile0.ct * TC,
                      cl_shift);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
      __syncthreads();

      PHASE(3);
      // product: 5 pixels x 4 channels per thread over this warp's slice
      float4 acc[kRP];
#pragma unroll
      for (int r = 0; r < kRP; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* a = dw + (size_t)(pw * WP + pl * kRP) * kpad + k0;
      const float* bp = swp + k0 * TC + 4 * cl;
#pragma unroll 4
      for (int kk = k0; kk < k1; kk += 4, a += 4, bp += 4 * TC) {
        float4 av[kRP];
#pragma unroll
        for (int r = 0; r < kRP; ++r)
          av[r] = *reinterpret_cast<const float4*>(a + r * kpad);
        const float4 b0 = *reinterpret_cast<const float4*>(bp);
        const float4 b1 = *reinterpret_cast<const float4*>(bp + TC);
        const float4 b2 = *reinterpret_cast<const float4*>(bp + 2 * TC);
        const float4 b3 = *reinterpret_cast<const float4*>(bp + 3 * TC);
#pragma unroll
        for (int r = 0; r < kRP; ++r) {
          acc[r] = fma4(make_float4(av[r].x, av[r].x, av[r].x, av[r].x), b0,
                        acc[r]);
          acc[r] = fma4(make_float4(av[r].y, av[r].y, av[r].y, av[r].y), b1,
                        acc[r]);
          acc[r] = fma4(make_float4(av[r].z, av[r].z, av[r].z, av[r].z), b2,
                        acc[r]);
          acc[r] = fma4(make_float4(av[r].w, av[r].w, av[r].w, av[r].w), b3,
                        acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRP; ++r)
        *reinterpret_cast<float4*>(
            red + ((size_t)(ks * TP + pw * WP + pl * kRP + r)) * TC + 4 * cl) =
            acc[r];
      __syncthreads();

      PHASE(4);
      // slices summed in order, bias, ReLU, store
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int p = epix[j], c = echan;
        const int oy = oy0 + erow[j], ox = ox0 + ecol[j];
        if (p < TP && erow[j] < d.th && oy < d.oh && ox < d.ow &&
            c0 + c < d.cout) {
          const float* part = red + p * TC + c;
          float4 sum = *reinterpret_cast<const float4*>(part);
#pragma unroll 4
          for (int q = 1; q < KS; ++q) {
            part += TP * TC;
            const float4 v = *reinterpret_cast<const float4*>(part);
            sum.x += v.x;
            sum.y += v.y;
            sum.z += v.z;
            sum.w += v.w;
          }
          const float4 bv = *reinterpret_cast<const float4*>(sbias + c);
          sum.x = fmaxf(sum.x + bv.x, 0.f);
          sum.y = fmaxf(sum.y + bv.y, 0.f);
          sum.z = fmaxf(sum.z + bv.z, 0.f);
          sum.w = fmaxf(sum.w + bv.w, 0.f);
          const size_t at =
              ((size_t)bi * npix + (size_t)oy * d.ow + ox) * d.cout + c0 + c;
          if (kBf16 && last)
            store_bf16x4(static_cast<__nv_bfloat16*>(d.out) + at, sum);
          else
            *reinterpret_cast<float4*>(dst + at) = sum;
        }
      }
      __syncthreads();  // the buffers are refilled by the next tile
    }
    PHASE(5);
    if (!(last_block && last)) grid.sync();
    PHASE(6);  // through the barrier
    PHASE_NEXT_LAYER();
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
rpn_sep_chain_kernel(const __grid_constant__ Params prm) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  PHASE_RESET();
  for (int i = 0; i < prm.nblocks; ++i) {
    const BlockDesc& d = prm.blk[i];
    const bool last = i == prm.nblocks - 1;
    run_block<kBf16>(d, prm.b, prm.scratch, prm.scratch2, last, smem, grid);
  }
}

// Tile geometry and shared-memory need of ``d`` under configuration cfg.
size_t plan_block(BlockDesc& d, int cfg) {
  const int tc = cfg_tc(cfg), tp = cfg_tp(cfg);
  d.cfg = cfg;
  // th x tw <= tp pixels: the fewest tiles, then the fewest halo pixels
  // over all tiles (a squarer tile re-reads less of its neighbours)
  long long best_tiles = 0, best_halo = 0;
  for (int nx = cdiv(d.ow, tp); nx <= d.ow; ++nx) {
    const int tw = cdiv(d.ow, nx);
    const int ny = cdiv(d.oh, tp / tw < d.oh ? tp / tw : d.oh);
    const int th = cdiv(d.oh, ny);
    const long long tiles = (long long)nx * ny;
    long long halo = tiles * halo_rows(th, 1) * halo_cols(tw, 1);
    if (d.num_layers == 0)
      halo = tiles * halo_rows(th, d.stride) * halo_cols(tw, d.stride);
    if (best_tiles == 0 || tiles < best_tiles ||
        (tiles == best_tiles && halo < best_halo)) {
      best_tiles = tiles;
      best_halo = halo;
      d.tiles_x = nx;
      d.tiles_y = ny;
      d.tw = tw;
      d.th = th;
    }
  }
  d.ctiles = cdiv(d.cout, tc);
  const int kmax = d.cin > d.cout ? d.cin : d.cout;
  d.w_floats = 9 * kmax + tc + kmax * tc;
  int halo = halo_rows(d.th, d.stride) * halo_cols(d.tw, d.stride) * d.cin;
  if (d.num_layers > 0) {
    const int later = halo_rows(d.th, 1) * halo_cols(d.tw, 1) * d.cout;
    halo = halo > later ? halo : later;
  }
  const int red = kWarps / cfg_pw(cfg) * tp * tc;
  d.halo_floats = halo > red ? halo : red;
  return sizeof(float) *
         (2 * (size_t)d.w_floats + d.halo_floats + (size_t)tp * (kmax + 4));
}

long long block_tiles(const BlockDesc& d, int b) {
  return (long long)b * d.tiles_y * d.tiles_x * d.ctiles;
}

template <bool kBf16>
int launch_chain(const void* x, int b, int h, int w, int cin, int nblocks,
                 const int* couts, const int* num_layers, const int* strides,
                 void* const* outs, const void* const* weights, void* scratch,
                 void* scratch2, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || cin % 4 != 0 ||
      nblocks <= 0 || nblocks > kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;

  Params prm{};
  prm.scratch = static_cast<float*>(scratch);
  prm.scratch2 = static_cast<float*>(scratch2);
  prm.nblocks = nblocks;
  prm.b = b;
  size_t smem = 0;
  long long max_tiles = 0;
  const void* in = x;
  for (int i = 0; i < nblocks; ++i) {
    BlockDesc& d = prm.blk[i];
    if (couts[i] <= 0 || couts[i] % 4 != 0 || num_layers[i] < 0 ||
        (strides[i] != 1 && strides[i] != 2) ||
        (strides[i] == 2 && (h % 2 != 0 || w % 2 != 0)))
      return (int)cudaErrorInvalidValue;
    d.x = in;
    d.out = outs[i];
    d.w = static_cast<const float*>(weights[i]);
    d.h = h;
    d.w_in = w;
    d.cin = cin;
    d.cout = couts[i];
    d.num_layers = num_layers[i];
    d.stride = strides[i];
    d.oh = h / strides[i];
    d.ow = w / strides[i];
    // the largest tile that still gives the card a wave of tiles; failing
    // that, the smallest tile whose buffers fit
    size_t need = 0;
    int chosen = -1;
    for (int cfg = 0; cfg < kNumCfg; ++cfg) {
      BlockDesc trial = d;
      const size_t bytes = plan_block(trial, cfg);
      if (bytes > kMaxSmem) continue;
      chosen = cfg;
      need = bytes;
      if (4 * block_tiles(trial, b) >= 3LL * sms) break;
    }
    if (chosen < 0) return (int)cudaErrorInvalidValue;
    plan_block(d, chosen);
    smem = need > smem ? need : smem;
    const long long tiles = block_tiles(d, b);
    max_tiles = tiles > max_tiles ? tiles : max_tiles;
    in = outs[i];
    h = d.oh;
    w = d.ow;
    cin = d.cout;
  }

  const auto kernel = rpn_sep_chain_kernel<kBf16>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  const long long capacity = (long long)sms * per_sm;
  const int grid = (int)(max_tiles < capacity ? max_tiles : capacity);
  // a cooperative launch (the grid syncs between layers) through the
  // extensible launch API: stream capture takes it into a CUDA graph as a
  // cooperative kernel node
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  config.attrs = attr;
  config.numAttrs = 1;
  void* args[] = {&prm};
  err = cudaLaunchKernelExC(&config, (const void*)kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// A chain of ``nblocks`` (1..4) blocks in one launch: x [b, h, w, cin]; block
// i maps [.., c_{i-1}] to outs[i] [b, oh_i, ow_i, couts[i]] with 1 +
// num_layers[i] layers from weights[i] (per layer wd [3, 3, ci], wp [ci,
// cout], bias [cout]; layer 0 has ci = the block's input channels, the
// others ci = cout) at strides[i] (1 or 2; 2 needs even input sizes).
// scratch holds as many floats as the largest output. All f32, contiguous,
// 16-byte aligned, on the device; channels are multiples of 4. Launches on
// ``stream`` and returns the launch's CUDA error code.
extern "C" int rpn_sep_chain(const void* x, int b, int h, int w, int cin,
                             int nblocks, const int* couts,
                             const int* num_layers, const int* strides,
                             void* const* outs, const void* const* weights,
                             void* scratch, void* stream) {
  return launch_chain<false>(x, b, h, w, cin, nblocks, couts, num_layers,
                             strides, outs, weights, scratch, nullptr, stream);
}

// rpn_sep_chain with x and every outs[i] bfloat16 (the weights f32): each
// block computes in f32 and rounds its output once. scratch and scratch2 each
// hold as many floats as the largest output.
extern "C" int rpn_sep_chain_bf16(const void* x, int b, int h, int w, int cin,
                                  int nblocks, const int* couts,
                                  const int* num_layers, const int* strides,
                                  void* const* outs,
                                  const void* const* weights, void* scratch,
                                  void* scratch2, void* stream) {
  return launch_chain<true>(x, b, h, w, cin, nblocks, couts, num_layers,
                            strides, outs, weights, scratch, scratch2, stream);
}

#ifdef RPN_PHASE_CLOCKS
// The stamps of the last launch: [layer][7] clock64() values of CTA 0.
extern "C" int rpn_phase_clocks(long long* host, int layers) {
  if (layers > kMaxStampedLayers) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(host, g_clocks,
                                   sizeof(long long) * layers * kPhases);
}
#endif
