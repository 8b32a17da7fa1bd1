// bf16 GEMM with a bias (+ exact GELU) epilogue for Hopper (sm_90a):
//   out = act(A @ W^T + bias),  A (M, K), W (N, K) (nn.Linear), out (M, N)
// bf16 in and out, fp32 accumulation; act is erf GELU (fc1) or the identity
// (fc2).
//
// Launched twice by the port's mlp_gelu, which replaces the TPU kernel
// inklayer_tpu/ops/mlp.py:_kernel (mlp_gelu: fc1 -> exact-erf GELU -> fc2,
// hidden chunks streamed with an fp32 (block_t, C) accumulator in VMEM).
// That fusion does not carry over: a 128-token tile's fp32 accumulator at
// C 1280 is 640 KB, beyond one SM's 227 KB of shared memory and its
// registers.  So the (T, 5120) bf16 hidden activation (42 MB at T 4096,
// inside the 50 MB L2) makes one round trip between the two launches.
//
// Bound on the H100: tensor-core throughput.  At SAM ViT-H (T 4096, C 1280,
// H 5120) each product is 53.7 GFLOP against 23-55 MB, far above the
// card's ~295 FLOP/byte ridge.
//
// Design: a persistent, warp-specialised kernel; one block of three
// warpgroups per SM walks the 128 x BN output tiles, N fastest, so that the
// tiles in flight share A's rows and W in L2.
// * Warpgroup 0 is the producer.  One thread issues TMA loads of 64-deep K
//   slabs of A (128 x 64) and W (BN x 64) into a 4-stage ring guarded by
//   full / empty mbarriers.  2-D tensor maps over the real (K, M) and
//   (K, N) extents, 128-byte swizzle, 64-column (128-byte) boxes, each tile
//   1024-byte aligned.  TMA zero-fills a last slab past K (K % 64 == 32),
//   and the full box still counts in expect_tx.  The ring runs on across
//   tiles, so the next tile's slabs load during this tile's epilogue.
// * Warpgroups 1 and 2 are consumers of 64 rows each: wgmma m64nBNk16, A and
//   W K-major in shared memory (SS, B128 descriptors, SBO 1024 B, +32 B per
//   k-step), the fp32 accumulator in registers (BN / 2 per thread: 128 at
//   BN 256).  One wgmma group stays in flight; a stage is released when the
//   group after it was committed and the one reading it has completed.
//   setmaxnreg gives the consumers 232 registers and the producer 40.
// * Epilogue in registers: bias per column in fp32, erff GELU in fp32 (the
//   TPU kernel's polynomial erf is the decided <= 1e-5 divergence), bf16
//   pairs, then a transpose inside each quad of lanes (4 shuffles per 4
//   pairs) so that every lane holds 8 consecutive columns and stores 16
//   bytes; a quad writes 64 contiguous bytes of a row.  The epilogue does not
//   overlap the other consumer's mainloop (both work on one tile); it
//   overlaps the producer's loads of the next tile.
//
// Block tile 128 x BN, BN in {256, 160, 128}: the wrapper (ops/mlp.py
// gemm_config) picks the BN with the least tile work per SM, ceil(tiles /
// SMs) * BN, the larger BN on a tie.  fc1 (N 5120): 640 tiles of 128 x 256
// are 4.85 waves on 132 SMs (tile work 5 * 256; BN 160 and 128 tie).  fc2
// (N 1280): 128 x 256 gives 160 tiles, 1.21 waves, 40% of the second wave
// idle (2 * 256); 128 x 128 gives 320 tiles, 2.42 waves (3 * 128);
// 128 x 160 gives 256 tiles, 1.94 waves (2 * 160): BN 160.
#include <atomic>

#include "hopper.cuh"

namespace {

using namespace ik;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;       // rows per tile: 2 consumer warpgroups x 64
constexpr int BK = 64;        // K per slab: one 128-byte swizzle row
constexpr int kStages = 4;    // ring depth
constexpr int kThreads = 384;  // producer + 2 consumer warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int BN>
struct GemmSmem {
  static constexpr uint32_t kA = BM * BK * 2;  // 16 KB
  static constexpr uint32_t kW = BN * BK * 2;  // 16, 20 or 32 KB
  static constexpr uint32_t kStage = kA + kW;  // a multiple of 1024
  // mbarriers: full[kStages], then empty[kStages]
  static constexpr uint32_t bar = kStages * kStage;
  static constexpr uint32_t bytes = bar + 8 * 2 * kStages;
  static constexpr uint32_t alloc = bytes + 1024;  // room to align the base
};

// Accumulator fragment of wgmma m64nBN (f32), per thread of a warpgroup:
// warp w, lane l hold rows 16w + l/4 ("row 0") and 16w + l/4 + 8 ("row 1");
// for each 8-column group g, d[4g + e] is (row 0, 8g + 2(l%4) + e) and
// d[4g + 2 + e] is (row 1, the same column), e = 0, 1.
template <int BN, bool kGelu>
__global__ void __launch_bounds__(kThreads, 1)
gemm_bias_act_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_w,
                     const bf16* __restrict__ bias, bf16* __restrict__ out,
                     int M, int N, int K) {
  using L = GemmSmem<BN>;
  static_assert(BN % 32 == 0, "the epilogue stores groups of 4 x 8 columns");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms aligned
  const uint32_t bar_full = base + L::bar;                 // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;       // + 8 * stage

  const int tiles_n = N / BN;
  const int n_tiles = (M / BM) * tiles_n;
  const int n_k = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
      int it = 0;  // slabs issued, over all of this block's tiles
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
        for (int kb = 0; kb < n_k; ++kb, ++it) {
          const int s = it % kStages;
          mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * s, L::kStage);
          const uint32_t dst = base + s * L::kStage;
          tma_load_2d(dst, &tm_a, kb * BK, m0, bar_full + 8 * s);
          tma_load_2d(dst + L::kA, &tm_w, kb * BK, n0, bar_full + 8 * s);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32, q = lane % 4;
    const int r0 = cw * 64 + (t / 32) * 16 + lane / 4;  // row 0 in the tile
    float acc[BN / 2];
    int it = 0;  // slabs consumed
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
      for (int kb = 0; kb < n_k; ++kb, ++it) {
        const int s = it % kStages;
        mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
        const uint32_t a_base = base + s * L::kStage + cw * 64 * 128;
        const uint32_t w_base = base + s * L::kStage + L::kA;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss<BN>(acc, desc_b128(a_base + kk * 32),
                       desc_b128(w_base + kk * 32), (kb | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous slab's group has completed
        if (kb > 0 && t == 0)
          mbar_arrive(bar_empty + 8 * ((it - 1) % kStages));
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (t == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % kStages));

      // epilogue: bias (+ GELU) in fp32, bf16 pairs, 16-byte stores
      uint32_t p0[BN / 8], p1[BN / 8];
      const bf16* bcol = bias + n0 + 2 * q;
#pragma unroll
      for (int g = 0; g < BN / 8; ++g) {
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(bcol + 8 * g));
        float v00 = acc[4 * g] + b.x, v01 = acc[4 * g + 1] + b.y;
        float v10 = acc[4 * g + 2] + b.x, v11 = acc[4 * g + 3] + b.y;
        if constexpr (kGelu) {
          v00 = gelu_erf(v00);
          v01 = gelu_erf(v01);
          v10 = gelu_erf(v10);
          v11 = gelu_erf(v11);
        }
        p0[g] = pack_bf16(v00, v01);
        p1[g] = pack_bf16(v10, v11);
      }
      bf16* o0 = out + static_cast<size_t>(m0 + r0) * N + n0 + 8 * q;
      bf16* o1 = o0 + static_cast<size_t>(8) * N;
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        uint32_t a[4] = {p0[4 * j], p0[4 * j + 1], p0[4 * j + 2],
                         p0[4 * j + 3]};
        uint32_t b[4] = {p1[4 * j], p1[4 * j + 1], p1[4 * j + 2],
                         p1[4 * j + 3]};
        quad_transpose(a, q);
        quad_transpose(b, q);
        *reinterpret_cast<uint4*>(o0 + 32 * j) = make_uint4(a[0], a[1], a[2],
                                                            a[3]);
        *reinterpret_cast<uint4*>(o1 + 32 * j) = make_uint4(b[0], b[1], b[2],
                                                            b[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// 2-D map over a (rows, K) bf16 row-major matrix with 64-column x box_rows
// boxes and the 128-byte swizzle; reads past K or rows fill with zeros
cudaError_t make_map(CUtensorMap* map, const void* ptr, int rows, int K,
                     int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Lift the instance's dynamic shared memory limit, once per device
template <int BN, bool kGelu>
cudaError_t allow_smem() {
  static std::atomic<int> set_for{-1};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || set_for.load() == device) return err;
  err = cudaFuncSetAttribute(gemm_bias_act_kernel<BN, kGelu>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(GemmSmem<BN>::alloc));
  if (err == cudaSuccess) set_for.store(device);
  return err;
}

template <int BN, bool kGelu>
cudaError_t launch(const void* a, const void* w, const void* bias, void* out,
                   int M, int N, int K, int grid, cudaStream_t stream) {
  CUtensorMap maps[2];
  cudaError_t err = make_map(&maps[0], a, M, K, BM);
  if (err == cudaSuccess) err = make_map(&maps[1], w, N, K, BN);
  if (err == cudaSuccess) err = allow_smem<BN, kGelu>();
  if (err != cudaSuccess) return err;
  gemm_bias_act_kernel<BN, kGelu>
      <<<grid, kThreads, GemmSmem<BN>::alloc, stream>>>(
          maps[0], maps[1], static_cast<const bf16*>(bias),
          static_cast<bf16*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// the arguments, packed by _kernels.py (struct format "PPPPiiiiiiP")
struct LinearArgs {
  const void *a, *w, *bias;
  void* out;
  int M, N, K, gelu, bn, grid;
  void* stream;
};

// Requires M % 128 == 0, N % bn == 0 with bn in {128, 160, 256}, K % 32 == 0
// and grid >= 1 (the wrapper checks and chooses bn and grid).
IK_EXPORT int ik_linear_bias_act(const LinearArgs* args) {
  const auto [a, w, bias, out, M, N, K, gelu, bn, grid, stream] = *args;
  if (M < BM || M % BM || K < 32 || K % 32 || grid < 1 || bn < 1 ||
      N < bn || N % bn)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IK_GEMM_CASE(BN, G)                                     \
  case BN * 2 + (G ? 1 : 0):                                    \
    return (int)launch<BN, G>(a, w, bias, out, M, N, K, grid, s);
  switch (bn * 2 + (gelu != 0)) {
    IK_GEMM_CASE(256, true) IK_GEMM_CASE(256, false)
    IK_GEMM_CASE(160, true) IK_GEMM_CASE(160, false)
    IK_GEMM_CASE(128, true) IK_GEMM_CASE(128, false)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef IK_GEMM_CASE
}

// Dynamic shared memory of the GEMM instance with block tile N = bn, in
// bytes; 0 for no instance.
IK_EXPORT int ik_gemm_smem_bytes(int bn) {
  switch (bn) {
    case 256: return GemmSmem<256>::alloc;
    case 160: return GemmSmem<160>::alloc;
    case 128: return GemmSmem<128>::alloc;
    default: return 0;
  }
}
