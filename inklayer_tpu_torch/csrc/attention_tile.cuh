// Flash-style softmax attention over (BH, N, D) bf16 tensors for Hopper
// (sm_90a), shared by relpos_attention.cu (SAM, with the decomposed rel-pos
// bias) and flash_attention.cu (plain attention: DINOv2, the SD1.5 UNet and
// ControlNet):
//   logits[t, u] = scale * q_t . k_u  (+ rel_h[t, u / kw] + rel_w[t, u % kw]
//                                      when kRel)
//   out[t]       = softmax_u(logits[t]) @ v
//
// One block of three warpgroups per (bh, 128-query tile).
// * Warpgroup 0 is the producer.  One thread issues TMA loads: the Q tile
//   once, then each 128-key K and V tile into a 3-stage ring guarded by
//   full / empty mbarriers.  The tensor maps are built on the host per call
//   and passed as __grid_constant__ parameters.
// * Warpgroups 1 and 2 are consumers of 64 query rows each.  Per key tile:
//   S = Q K^T is wgmma m64n128k16 with Q and K K-major in shared memory and
//   S in fp32 registers; the online softmax runs on that accumulator
//   fragment in registers (exp2 with scale * log2(e) folded in; a row's max
//   and sum over the four lanes that share it); P is rounded to bf16, as in
//   the plain versions, and is the A operand of O += P V (wgmma m64nDPk16,
//   A from registers, V MN-major in shared memory), with O in fp32
//   registers.  Then the warpgroup releases the stage.
// * setmaxnreg moves registers from the producer to the consumers.
//
// Shared memory: each tile is cut into 16-column (32-byte) boxes, one TMA
// box each, written with the 32-byte swizzle, which the wgmma descriptors
// read back with the matching B32 layout.  The tensor maps carry the real
// extents (D, N, BH), so TMA's zero fill pads head dim 40 to DP = 48 (QK^T
// runs 3 k-steps; PV runs N = 48 and the last 8 columns are dropped) and
// clears keys and queries past N.  Keys past N in the last tile are masked
// to -inf in the softmax: zero keys are not -inf logits.  The rel terms of
// the block's queries are staged once in shared memory in fp32, times
// log2(e); each column's (u / kw, u % kw) comes from one division per tile,
// stepped from column to column, not a division per logit.
#pragma once

#include <math_constants.h>

#include <atomic>

#include "hopper.cuh"

// anonymous: each including source gets its own copy of the kernels
namespace {

using namespace ik;

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;        // query rows per block: 2 consumer warpgroups
constexpr int BKV = 128;       // keys per tile
constexpr int kStages = 3;     // K/V ring depth
constexpr int kMaxRel = 64;    // kh, kw <= 64
constexpr int kRelLd = kMaxRel + 4;  // fp32 rel row stride (spreads banks)
constexpr int kThreads = 384;  // producer + 2 consumer warpgroups
constexpr int kBox = 16;       // columns per TMA box: 32 bytes
constexpr int kBoxRow = 32;    // bytes per box row
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 * 40 +
                                                        // 256 * 232 = 384 * 168
constexpr float kLog2e = 1.4426950408889634f;

// head dim padded to the wgmma depth of 16
template <int D>
constexpr int kPadded = (D + 15) / 16 * 16;

template <int D, bool kRel>
struct Smem {
  static constexpr int DP = kPadded<D>;
  static constexpr uint32_t kQBytes = BQ * DP * 2;
  static constexpr uint32_t kTileBytes = BKV * DP * 2;  // one K or V tile
  static constexpr uint32_t kRelBytes = kRel ? 4 * BQ * kRelLd : 0;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = q + kQBytes;
  static constexpr uint32_t v = k + kStages * kTileBytes;
  static constexpr uint32_t rh = v + kStages * kTileBytes;
  static constexpr uint32_t rw = rh + kRelBytes;
  // mbarriers: Q full, then full[kStages], then empty[kStages]
  static constexpr uint32_t bar = rw + kRelBytes;
  static constexpr uint32_t bytes = bar + 8 * (1 + 2 * kStages);
  static constexpr uint32_t alloc = bytes + 1024;  // room to align the base
};

// ---------------------------------------------------------------------------
// wgmma with A from registers (bf16 in, fp32 accumulators)
// ---------------------------------------------------------------------------

// d += A[64 x 16] B[16 x 48]: A in registers (bf16 pairs), B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A[64 x 16] B[16 x 64]: A in registers (bf16 pairs), B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A[64 x 16] B[16 x 80]: A in registers (bf16 pairs), B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&d)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  static_assert(DP == 48 || DP == 64 || DP == 80, "no PV instance");
  if constexpr (DP == 48)
    wgmma_rs_n48(d, a, db);
  else if constexpr (DP == 64)
    wgmma_rs_n64(d, a, db);
  else
    wgmma_rs_n80(d, a, db);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// Accumulator fragment of wgmma m64nN (f32), per thread of a warpgroup:
// warp w, lane l hold rows 16w + l/4 ("row 0") and 16w + l/4 + 8 ("row 1");
// for each 8-column group g, d[4g + e] is (row 0, 8g + 2(l%4) + e) and
// d[4g + 2 + e] is (row 1, the same column), e = 0, 1.  The A fragment of
// m64nNk16 has the same layout for 16 columns, so the bf16 pairs of S's
// groups 2t and 2t + 1 are the A operand of PV's k-step t as they stand.
template <int D, bool kRel>
__global__ void __launch_bounds__(kThreads, 1)
attention_tile_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const bf16* __restrict__ rel_h,
                      const bf16* __restrict__ rel_w, bf16* __restrict__ out,
                      int N, int kh, int kw, float scale_log2) {
  using L = Smem<D, kRel>;
  constexpr int DP = L::DP;
  constexpr int kBoxes = DP / kBox;
  static_assert(BKV == 128, "S is one m64n128 accumulator");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms aligned
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::bar;
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_q + 8 * (1 + kStages);  // + 8 * stage

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int n_tiles = (N + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
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
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int b = 0; b < kBoxes; ++b)
        tma_load_3d(base + L::q + b * BQ * kBoxRow, &tm_q, b * kBox, q0, bh,
                    bar_q);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(bar_empty + 8 * s, ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * L::kTileBytes);
        const uint32_t k_dst = base + L::k + s * L::kTileBytes;
        const uint32_t v_dst = base + L::v + s * L::kTileBytes;
        for (int b = 0; b < kBoxes; ++b) {
          tma_load_3d(k_dst + b * BKV * kBoxRow, &tm_k, b * kBox, j * BKV,
                      bh, bar_full + 8 * s);
          tma_load_3d(v_dst + b * BKV * kBoxRow, &tm_v, b * kBox, j * BKV,
                      bh, bar_full + 8 * s);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32, cq = lane % 4;
    const int r0 = cw * 64 + (t / 32) * 16 + lane / 4;  // row 0 in the block
    float* sRh = reinterpret_cast<float*>(smem + L::rh);
    float* sRw = reinterpret_cast<float*>(smem + L::rw);

    if constexpr (kRel) {
      // this warpgroup's 64 rows of rel_h / rel_w in fp32, times log2(e);
      // zero past N and past kh / kw
      for (int i = t; i < 64 * kMaxRel; i += 128) {
        const int r = cw * 64 + i / kMaxRel, c = i % kMaxRel;
        const int tq = q0 + r;
        const size_t row = static_cast<size_t>(bh) * N + tq;
        const bool ok = tq < N;
        sRh[r * kRelLd + c] =
            (ok && c < kh) ? __bfloat162float(rel_h[row * kh + c]) * kLog2e
                           : 0.f;
        sRw[r * kRelLd + c] =
            (ok && c < kw) ? __bfloat162float(rel_w[row * kw + c]) * kLog2e
                           : 0.f;
      }
      asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
    }

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
    const uint32_t q_base = base + L::q + cw * 64 * kBoxRow;

    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(bar_full + 8 * s, (j / kStages) & 1);
      const uint32_t k_base = base + L::k + s * L::kTileBytes;
      const uint32_t v_base = base + L::v + s * L::kTileBytes;

      // S = Q K^T over kBoxes k-steps of 16
      float sc[64];
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < kBoxes; ++b)
        wgmma_ss<128>(sc, desc_b32(q_base + b * BQ * kBoxRow, 16, 256),
                      desc_b32(k_base + b * BKV * kBoxRow, 16, 256), b > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // logits in log2 units, in place
      const int kv0 = j * BKV;
      if constexpr (kRel) {
        int h = (kv0 + 2 * cq) / kw;
        int w = kv0 + 2 * cq - h * kw;
#pragma unroll
        for (int g = 0; g < 16; ++g) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int hc = min(h, kh - 1);  // columns past N: masked below
            sc[4 * g + e] = fmaf(sc[4 * g + e], scale_log2,
                                 sRh[r0 * kRelLd + hc] + sRw[r0 * kRelLd + w]);
            sc[4 * g + 2 + e] =
                fmaf(sc[4 * g + 2 + e], scale_log2,
                     sRh[(r0 + 8) * kRelLd + hc] + sRw[(r0 + 8) * kRelLd + w]);
            if (++w == kw) {
              w = 0;
              ++h;
            }
          }
          w += 6;  // from column 8g + 2cq + 2 to 8(g + 1) + 2cq
          while (w >= kw) {
            w -= kw;
            ++h;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
      }
      if (kv0 + BKV > N) {
#pragma unroll
        for (int g = 0; g < 16; ++g)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (kv0 + 8 * g + 2 * cq + e >= N)
              sc[4 * g + e] = sc[4 * g + 2 + e] = -CUDART_INF_F;
      }

      // online softmax: row max over the four lanes of a row
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int g = 0; g < 16; ++g) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * g], sc[4 * g + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * g + 2], sc[4 * g + 3]));
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);  // 0 on tile 0
      m0 = mn0;
      m1 = mn1;
      uint32_t p[32];  // bf16 pairs: PV's A fragments
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int g = 0; g < 16; ++g) {
        const float p00 = ex2(sc[4 * g] - mn0), p01 = ex2(sc[4 * g + 1] - mn0);
        const float p10 = ex2(sc[4 * g + 2] - mn1);
        const float p11 = ex2(sc[4 * g + 3] - mn1);
        s0 += p00 + p01;
        s1 += p10 + p11;
        p[2 * g] = pack_bf16(p00, p01);
        p[2 * g + 1] = pack_bf16(p10, p11);
      }
      l0 = l0 * a0 + s0;  // this thread's share; summed over lanes at the end
      l1 = l1 * a1 + s1;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        o[4 * i] *= a0;
        o[4 * i + 1] *= a0;
        o[4 * i + 2] *= a1;
        o[4 * i + 3] *= a1;
      }

      // O += P V over 8 k-steps of 16 keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        wgmma_pv<DP>(o, a,
                     desc_b32(v_base + kk * 16 * kBoxRow, BKV * kBoxRow, 256));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (t == 0) mbar_arrive(bar_empty + 8 * s);  // stage read: release it
    }

#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int t0 = q0 + r0, t1 = t0 + 8;
    bf16* ob = out + static_cast<size_t>(bh) * N * D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = 8 * i + 2 * cq;
      if (c < D) {
        if (t0 < N)
          *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(t0) * D +
                                             c) =
              __floats2bfloat162_rn(o[4 * i] * inv0, o[4 * i + 1] * inv0);
        if (t1 < N)
          *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(t1) * D +
                                             c) =
              __floats2bfloat162_rn(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// 3-D map over a (BH, N, D) bf16 tensor with kBox x rows boxes and the
// 32-byte swizzle; reads outside (D, N, BH) fill with zeros
cudaError_t make_map(CUtensorMap* map, const void* ptr, int BH, int N, int D,
                     int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(N) * D * 2};
  const cuuint32_t box[3] = {kBox, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Lift the instance's dynamic shared memory limit, once per device (not on
// every launch: host time counts against the short calls)
template <int D, bool kRel>
cudaError_t allow_smem() {
  static std::atomic<int> set_for{-1};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || set_for.load() == device) return err;
  err = cudaFuncSetAttribute(attention_tile_kernel<D, kRel>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Smem<D, kRel>::alloc));
  if (err == cudaSuccess) set_for.store(device);
  return err;
}

template <int D, bool kRel>
cudaError_t launch_attention(const void* q, const void* k, const void* v,
                             const void* rel_h, const void* rel_w, void* out,
                             int BH, int N, int kh, int kw, float scale,
                             cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err =
        make_map(&maps[i], src[i], BH, N, D, i == 0 ? BQ : BKV);
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err = allow_smem<D, kRel>();
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, BH);
  attention_tile_kernel<D, kRel>
      <<<grid, kThreads, Smem<D, kRel>::alloc, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const bf16*>(rel_h),
      static_cast<const bf16*>(rel_w), static_cast<bf16*>(out), N, kh, kw,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace
