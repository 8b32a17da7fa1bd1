// 3x3 convolution, stride 1, same (zero) padding, NHWC, no bias, for Hopper
// (sm_90a): bf16 in, fp32 accumulation, one bf16 rounding at the output.
//     out[b, y, x, o] = sum_{dy, dx, c} x[b, y+dy-1, x+dx-1, c] w[dy, dx, c, o]
// x is NHWC, w HWIO, so w is a row-major (9C, Cout) matrix, K ordered
// (tap, channel).
//
// Replaces the TPU kernels of scripts/ablate_pallas_conv.py:
// make_pallas_conv (one dot per tap over a VMEM-resident padded image) and
// make_pallas_conv_concat (the nine tap slices written into a VMEM im2col
// scratch, then one dot over K = 9C); both read an image padded in device
// memory first.
//
// Bound on the H100 at the UNet's levels (batch 2, Cout = C; 989 TFLOP/s
// bf16, 3.35 TB/s): levels 0-2 (96^2 x 320, 48^2 x 640, 24^2 x 1280) do
// 34.0 GFLOP each on 2.6-13.0 MB, so the tensor cores bound them at
// 0.0344 ms; level 3 (12^2 x 1280) does 8.5 GFLOP on 31.0 MB, 29.5 MB of
// them weights, so the weight bytes bound it at 0.0092 ms.
//
// Design: an implicit GEMM, M = B*H*W output pixels, N = Cout, K = 9C, in a
// persistent, warp-specialised kernel on the pattern of linear_bias_act.cu:
// one block of three warpgroups per SM walks units of work.
// * A (the image) comes through a 4-D tensor map over x as (C, W, H, B),
//   innermost first, with no im2col and no padded copy.  A consumer's 64
//   rows are a patch of bh x bw <= 64 output pixels of one image; a 128-row
//   M tile is two patches.  A K slab is one tap (dy, dx) x 64 channels: per
//   patch one box of (64, bw, bh, 1) at (c0, x0+dx-1, y0+dy-1, b).  TMA's
//   tiled mode writes zeros for every element outside the tensor, so the
//   halo (negative or past-the-edge coordinates) and the channels past C
//   (C % 64 != 0) cost nothing; the box lands as bh*bw rows of 128 bytes
//   in the 128-byte swizzle, the K-major layout of desc_b128.  Rows past
//   bh*bw hold stale data and are never stored.
// * B (the weights) is read as it lies: boxes of 64 columns x 64 K rows of
//   the (9C, Cout) matrix, BN / 64 per slab, at row tap*C + c0.  That is
//   MN-major for wgmma (the transpose flag, desc_b128_mn: lbo one box,
//   sbo 8 rows); no transpose per call.  Where C % 64 != 0 a slab's last
//   rows are the next tap's weights, met by zero channels of A; past 9C
//   and past Cout TMA fills zeros.  expect_tx counts whole boxes.
// * Warpgroup 0 is the producer: one thread keeps a ring of full / empty
//   mbarriers fed (4-8 stages, ~200 KB); warpgroups 1 and 2 run wgmma
//   m64nBNk16 (SS) on their patches, fp32 accumulators in registers,
//   setmaxnreg 40/232, one wgmma group in flight.
// * The walk: 128 x BN tiles, M tile fastest, so the tiles in flight share
//   the weight slabs in L2.  The whole waves of tiles (full = tiles / SMs
//   * SMs) run whole; where the tiles left over (the tail) would leave SMs
//   idle, each tail tile's K slabs are cut into `splits` contiguous ranges,
//   one unit each, so that the tail fills the card.  A split unit writes
//   its fp32 partial tile (splits, tail, 128, BN), masks and all; a second
//   kernel adds them in split order and rounds to bf16, so two calls give
//   the same bits.  A split costs (8 * splits + 2) * tail * 128 * BN bytes
//   beside the bound: the partials written and read, the output written.
// * Epilogue: pixels past H or W, rows past bh*bw, a tile's missing second
//   patch and columns past Cout are masked; bf16 rows go out as 16-byte
//   stores after a transpose inside each quad of lanes (quad_transpose).
//
// The configuration per level (ops/conv.py conv_config: the least time of
// its cost model by wave arithmetic on 132 SMs; patch 8 x 8 wastes no rows
// at levels 0-2):
//   level 0: patch 8 x 8, 144 M tiles, BN 192 (2 N tiles; 320 = 192 + 128,
//            a third of the second empty): 288 tiles, 264 whole (2 waves),
//            the last 24 in 5 splits of 9 slabs: 384 units; partials
//            11.8 MB;
//   level 1: patch 8 x 8, 36 M tiles, BN 256 (3 N tiles, the third half
//            empty): 108 tiles, one wave, no split;
//   level 2: patch 8 x 8, 9 M tiles, BN 192 (7 N tiles): 63 tiles, each in
//            2 splits of 90 slabs: 126 units; partials 12.4 MB;
//   level 3: patch 12 x 4 (48 of 64 rows: 25% of the M rows wasted, 3
//            patches per image, the fewest), 3 M tiles, BN 192: 21 tiles,
//            each in 6 splits of 30 slabs: 126 units; partials 12.4 MB
//            beside the 31.0 MB of the bound.
#include <algorithm>
#include <atomic>

#include "hopper.cuh"

namespace {

using namespace ik;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;      // output pixels per consumer (one patch)
constexpr int BK = 64;         // channels per K slab: one 128-byte row
constexpr int kThreads = 384;  // producer + 2 consumer warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kReduceThreads = 256;

template <int BN>
struct ConvSmem {
  static constexpr uint32_t kPatch = kRows * BK * 2;  // 8 KB per patch
  static constexpr uint32_t kA = 2 * kPatch;          // 16 KB
  static constexpr uint32_t kBox = 64 * BK * 2;       // 8 KB: 64 x 64 of w
  static constexpr uint32_t kB = BN / 64 * kBox;
  static constexpr uint32_t kStage = kA + kB;  // a multiple of 1024
  static constexpr int kStages = 200 * 1024 / kStage;  // 4, 5, 6, 8
  // mbarriers: full[kStages], then empty[kStages]
  static constexpr uint32_t bar = kStages * kStage;
  static constexpr uint32_t bytes = bar + 8 * 2 * kStages;
  static constexpr uint32_t alloc = bytes + 1024;  // room to align the base
};

// the shape and the walk, computed once on the host
struct ConvGeom {
  int B, H, W, C, Cout;
  int bh, bw, py, px;  // patch; patches down and across an image
  int patches, m_tiles, n_tiles, n_cc, n_slabs;
  int full, tail, splits, units;  // tiles whole, tiles split, splits
};

struct Unit {
  int mt, nt;    // M tile, N tile
  int slot;      // the tile's place among the split tiles; -1: whole
  int split, k0, k1;  // split, slabs [k0, k1)
};

// unit u: tiles full first (tile u), then each split of the tail tiles,
// tile fastest; a tile is numbered M tile fastest (ops/conv.py unit_work)
__device__ __forceinline__ Unit unit_of(const ConvGeom& g, int u) {
  Unit w;
  int tile = u;
  w.slot = -1;
  w.split = 0;
  w.k0 = 0;
  w.k1 = g.n_slabs;
  if (u >= g.full) {
    const int v = u - g.full;
    w.slot = v % g.tail;
    w.split = v / g.tail;
    tile = g.full + w.slot;
    w.k0 = w.split * g.n_slabs / g.splits;  // ops/conv.py split_range
    w.k1 = (w.split + 1) * g.n_slabs / g.splits;
  }
  w.mt = tile % g.m_tiles;
  w.nt = tile / g.m_tiles;
  return w;
}

// (image, first row, first column) of patch p
__device__ __forceinline__ void patch_origin(const ConvGeom& g, int p, int& b,
                                             int& y0, int& x0) {
  const int per_image = g.py * g.px;
  b = p / per_image;
  const int r = p - b * per_image;
  y0 = (r / g.px) * g.bh;
  x0 = (r % g.px) * g.bw;
}

// Accumulator fragment of wgmma m64nBN (f32), per thread of a warpgroup:
// warp w, lane l hold rows 16w + l/4 ("row 0") and 16w + l/4 + 8 ("row 1");
// for each 8-column group g, d[4g + e] is (row 0, 8g + 2(l%4) + e) and
// d[4g + 2 + e] is (row 1, the same column), e = 0, 1.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_w,
               bf16* __restrict__ out, float* __restrict__ partial,
               const ConvGeom g) {
  using L = ConvSmem<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_full = base + L::bar;            // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * L::kStages;  // + 8 * stage
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2);  // one arrival per consumer
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const uint32_t a_bytes = static_cast<uint32_t>(g.bh * g.bw) * BK * 2;
      int it = 0;  // slabs issued, over all of this block's units
      for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
        const Unit w = unit_of(g, u);
        const int n0 = w.nt * BN;
        // boxes of w that hold a column below Cout; the rest are not loaded
        const int nb = min(BN / 64, (g.Cout - n0 + 63) / 64);
        const uint32_t tx = 2 * a_bytes + nb * L::kBox;
        int b[2], y0[2], x0[2];
        for (int i = 0; i < 2; ++i) {
          const int p = 2 * w.mt + i;
          // a missing second patch loads the first again (never stored)
          patch_origin(g, p < g.patches ? p : 2 * w.mt, b[i], y0[i], x0[i]);
        }
        for (int k = w.k0; k < w.k1; ++k, ++it) {
          const int s = it % L::kStages;
          mbar_wait_or_trap(bar_empty + 8 * s,
                            ((it / L::kStages) & 1) ^ 1);
          const uint32_t ready = bar_full + 8 * s;
          mbar_expect_tx(ready, tx);
          const int tap = k / g.n_cc, c0 = (k - tap * g.n_cc) * BK;
          const int dy = tap / 3 - 1, dx = tap % 3 - 1;
          const uint32_t dst = base + s * L::kStage;
          for (int i = 0; i < 2; ++i)
            tma_load_4d(dst + i * L::kPatch, &tm_x, c0, x0[i] + dx,
                        y0[i] + dy, b[i], ready);
          for (int j = 0; j < nb; ++j)
            tma_load_2d(dst + L::kA + j * L::kBox, &tm_w, n0 + 64 * j,
                        tap * g.C + c0, ready);
        }
      }
    }
  } else {
    // ---- consumers: one patch (64 rows) of each M tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32, q = lane % 4;
    const int r0 = (t / 32) * 16 + lane / 4;  // row 0 in the patch
    float acc[BN / 2];
    int it = 0;  // slabs consumed
    for (int u = blockIdx.x; u < g.units; u += gridDim.x) {
      const Unit w = unit_of(g, u);
      for (int k = w.k0; k < w.k1; ++k, ++it) {
        const int s = it % L::kStages;
        mbar_wait_or_trap(bar_full + 8 * s, (it / L::kStages) & 1);
        const uint32_t a_base = base + s * L::kStage + cw * L::kPatch;
        const uint32_t b_base = base + s * L::kStage + L::kA;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss_mn<BN>(acc, desc_b128(a_base + kk * 32),
                          desc_b128_mn(b_base + kk * 16 * 128, L::kBox),
                          (k != w.k0) || (kk != 0));
        wgmma_commit();
        wgmma_wait<1>();  // the previous slab's group has completed
        if (k > w.k0 && t == 0)
          mbar_arrive(bar_empty + 8 * ((it - 1) % L::kStages));
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (t == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % L::kStages));

      // ---- epilogue: the two rows of this thread, masked ----
      const int p = 2 * w.mt + cw;
      int b, y0, x0;
      patch_origin(g, p, b, y0, x0);
      bool ok[2];
      size_t m[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const int y = y0 + r / g.bw, x = x0 + r % g.bw;
        ok[h] = p < g.patches && r < g.bh * g.bw && y < g.H && x < g.W;
        m[h] = (static_cast<size_t>(b) * g.H + y) * g.W + x;
      }
      const int n0 = w.nt * BN;
      if (w.slot < 0) {
        uint32_t p0[BN / 8], p1[BN / 8];
#pragma unroll
        for (int gi = 0; gi < BN / 8; ++gi) {
          p0[gi] = pack_bf16(acc[4 * gi], acc[4 * gi + 1]);
          p1[gi] = pack_bf16(acc[4 * gi + 2], acc[4 * gi + 3]);
        }
#pragma unroll
        for (int j = 0; j < BN / 32; ++j) {
          uint32_t a[4] = {p0[4 * j], p0[4 * j + 1], p0[4 * j + 2],
                           p0[4 * j + 3]};
          uint32_t c[4] = {p1[4 * j], p1[4 * j + 1], p1[4 * j + 2],
                           p1[4 * j + 3]};
          quad_transpose(a, q);
          quad_transpose(c, q);
          const int n = n0 + 32 * j + 8 * q;  // Cout % 8 == 0: all 8 or none
          if (n >= g.Cout) continue;
          if (ok[0])
            *reinterpret_cast<uint4*>(out + m[0] * g.Cout + n) =
                make_uint4(a[0], a[1], a[2], a[3]);
          if (ok[1])
            *reinterpret_cast<uint4*>(out + m[1] * g.Cout + n) =
                make_uint4(c[0], c[1], c[2], c[3]);
        }
      } else {
        // the whole 128 x BN tile, masks and all: the reduction masks
        float* part =
            partial + ((static_cast<size_t>(w.split) * g.tail + w.slot) * 128 +
                       cw * kRows + r0) * BN + 2 * q;
#pragma unroll
        for (int gi = 0; gi < BN / 8; ++gi) {
          *reinterpret_cast<float2*>(part + 8 * gi) =
              make_float2(acc[4 * gi], acc[4 * gi + 1]);
          *reinterpret_cast<float2*>(part + 8 * BN + 8 * gi) =
              make_float2(acc[4 * gi + 2], acc[4 * gi + 3]);
        }
      }
    }
  }
}

// The tail tiles' outputs: bf16(sum over s of partial[s]), s in order,
// partial (splits, tail, 128, bn) fp32; 8 columns per thread, masked as
// the main kernel's epilogue masks
__global__ void __launch_bounds__(kReduceThreads)
conv3x3_reduce_kernel(const float* __restrict__ partial,
                      bf16* __restrict__ out, const ConvGeom g, int bn) {
  const int groups = bn / 8;
  const size_t plane = static_cast<size_t>(g.tail) * 128 * bn;
  const size_t items = plane / 8;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < items; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int gi = static_cast<int>(i % groups);
    const int row = static_cast<int>(i / groups % 128);
    const int slot = static_cast<int>(i / groups / 128);
    const int tile = g.full + slot;
    const int n = (tile / g.m_tiles) * bn + 8 * gi;
    const int p = 2 * (tile % g.m_tiles) + row / kRows, r = row % kRows;
    int b, y, x;
    patch_origin(g, p, b, y, x);
    y += r / g.bw;
    x += r % g.bw;
    if (n >= g.Cout || p >= g.patches || r >= g.bh * g.bw || y >= g.H ||
        x >= g.W)
      continue;
    const float4* src = reinterpret_cast<const float4*>(partial) + 2 * i;
    float4 a = src[0], c = src[1];
    for (int s = 1; s < g.splits; ++s) {
      const float4* ps = src + s * (plane / 4);
      const float4 d = ps[0], e = ps[1];
      a.x += d.x; a.y += d.y; a.z += d.z; a.w += d.w;
      c.x += e.x; c.y += e.y; c.z += e.z; c.w += e.w;
    }
    *reinterpret_cast<uint4*>(
        out + ((static_cast<size_t>(b) * g.H + y) * g.W + x) * g.Cout + n) =
        make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                   pack_bf16(c.x, c.y), pack_bf16(c.z, c.w));
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// 4-D map over x (C, W, H, B), innermost first, with (64, bw, bh, 1) boxes
// and the 128-byte swizzle; reads outside the tensor fill with zeros
cudaError_t make_x_map(CUtensorMap* map, const void* x, const ConvGeom& g) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(g.C), static_cast<cuuint64_t>(g.W),
      static_cast<cuuint64_t>(g.H), static_cast<cuuint64_t>(g.B)};
  const cuuint64_t row = static_cast<cuuint64_t>(g.C) * 2;
  const cuuint64_t strides[3] = {row, row * g.W, row * g.W * g.H};
  const cuuint32_t box[4] = {BK, static_cast<cuuint32_t>(g.bw),
                             static_cast<cuuint32_t>(g.bh), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// 2-D map over w as a (9C, Cout) row-major matrix with 64 x 64 boxes and
// the 128-byte swizzle; reads past 9C or Cout fill with zeros
cudaError_t make_w_map(CUtensorMap* map, const void* w, const ConvGeom& g) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(g.Cout),
                              static_cast<cuuint64_t>(9) * g.C};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(g.Cout) * 2};
  const cuuint32_t box[2] = {64, BK};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Lift the instance's dynamic shared memory limit, once per device
template <int BN>
cudaError_t allow_smem() {
  static std::atomic<int> set_for{-1};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || set_for.load() == device) return err;
  err = cudaFuncSetAttribute(conv3x3_kernel<BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(ConvSmem<BN>::alloc));
  if (err == cudaSuccess) set_for.store(device);
  return err;
}

template <int BN>
cudaError_t launch(const void* x, const void* w, void* out, void* partial,
                   const ConvGeom& g, int grid, cudaStream_t stream) {
  CUtensorMap maps[2];
  cudaError_t err = make_x_map(&maps[0], x, g);
  if (err == cudaSuccess) err = make_w_map(&maps[1], w, g);
  if (err == cudaSuccess) err = allow_smem<BN>();
  if (err != cudaSuccess) return err;
  conv3x3_kernel<BN><<<grid, kThreads, ConvSmem<BN>::alloc, stream>>>(
      maps[0], maps[1], static_cast<bf16*>(out), static_cast<float*>(partial),
      g);
  err = cudaGetLastError();
  if (err != cudaSuccess || g.tail == 0) return err;
  const size_t items = static_cast<size_t>(g.tail) * 128 * BN / 8;
  const int blocks = static_cast<int>(
      std::min<size_t>((items + kReduceThreads - 1) / kReduceThreads,
                       static_cast<size_t>(grid) * 8));
  conv3x3_reduce_kernel<<<blocks, kReduceThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<bf16*>(out), g, BN);
  return cudaGetLastError();
}

}  // namespace

// the arguments, packed by _kernels.py (struct format "PPPPiiiiiiiiiiiP")
struct Conv3x3Args {
  const void *x, *w;
  void *out, *partial;
  int B, H, W, C, Cout, bh, bw, bn, splits, full, grid;
  void* stream;
};

// Requires C % 8 == 0 and Cout % 8 == 0 (16-byte strides for TMA and
// 16-byte output stores), 16-byte aligned pointers, B * H * W *
// max(C, Cout) below 2^31, a patch bh x bw <= 64 inside the image, bn in
// {64, 128, 192, 256}; either splits == 1 and every tile whole (full ==
// tiles), or 2 <= splits <= 9 * ceil(C / 64), full < tiles and fp32
// partials of (splits, tiles - full, 128, bn) (the wrapper checks and
// chooses the configuration, ops/conv.py conv_config).
IK_EXPORT int ik_conv3x3(const Conv3x3Args* args) {
  const auto [x, w, out, partial, B, H, W, C, Cout, bh, bw, bn, splits, full,
              grid, stream] = *args;
  if (B < 1 || H < 1 || W < 1 || C < 8 || C % 8 || Cout < 8 || Cout % 8 ||
      bh < 1 || bw < 1 || bh > H || bw > W || bh * bw > kRows || grid < 1)
    return (int)cudaErrorInvalidValue;
  ConvGeom g;
  g.B = B; g.H = H; g.W = W; g.C = C; g.Cout = Cout;
  g.bh = bh; g.bw = bw;
  g.py = (H + bh - 1) / bh;
  g.px = (W + bw - 1) / bw;
  g.patches = B * g.py * g.px;
  g.m_tiles = (g.patches + 1) / 2;
  g.n_cc = (C + BK - 1) / BK;
  g.n_slabs = 9 * g.n_cc;
  g.splits = splits;
  g.full = full;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
#define IK_CONV_CASE(BN)                                                  \
  case BN:                                                                \
    g.n_tiles = (Cout + BN - 1) / BN;                                     \
    g.tail = g.m_tiles * g.n_tiles - full;                                \
    g.units = full + g.tail * splits;                                     \
    if (splits == 1 ? g.tail != 0                                         \
                    : (splits > g.n_slabs || full < 0 || g.tail < 1 ||    \
                       partial == nullptr))                               \
      return (int)cudaErrorInvalidValue;                                  \
    return (int)launch<BN>(x, w, out, partial, g, grid, s);
    IK_CONV_CASE(256) IK_CONV_CASE(192) IK_CONV_CASE(128) IK_CONV_CASE(64)
#undef IK_CONV_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of the convolution instance with N tile bn, in
// bytes; 0 for no instance.
IK_EXPORT int ik_conv_smem_bytes(int bn) {
  switch (bn) {
    case 256: return ConvSmem<256>::alloc;
    case 192: return ConvSmem<192>::alloc;
    case 128: return ConvSmem<128>::alloc;
    case 64: return ConvSmem<64>::alloc;
    default: return 0;
  }
}
