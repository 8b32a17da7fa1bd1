// bf16 GEMM with a bias (+ exact GELU) epilogue: out = act(A @ W^T + bias).
//
// Launched twice by the port's mlp_gelu (fc1 with GELU, then fc2), which
// replaces the TPU kernel inklayer_tpu/ops/mlp.py:_kernel (mlp_gelu:
// fc1 -> exact-erf GELU -> fc2 with the hidden activation kept in VMEM).
//
// Bound on the H100: tensor-core throughput.  At SAM ViT-H shapes
// (T=4096, C=1280, H=5120) each of the two products is 53.7 GFLOP over
// ~30 MB, far above the card's ~295 FLOP/byte ridge.  Design: 128x128x32
// block tiles, 8 warps each owning a 64x32 sub-tile of 4x2 WMMA bf16
// 16x16x16 fragments with fp32 accumulation, and a two-stage cp.async
// ring so the next K-slab loads while the current one multiplies.  The
// epilogue adds the bias, applies erf GELU in fp32 (the TPU kernel needed
// a polynomial erf; CUDA has erff) and rounds to bf16.  The (T, 5120)
// hidden activation makes one round trip through device memory between
// the two launches; keeping it on chip, as the TPU kernel did, and
// wgmma/TMA are later work.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDS = BK + 8;  // smem row stride (elements): breaks bank conflicts
constexpr int kThreads = 256;
constexpr int kStageElems = (BM + BN) * LDS;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A: (M, K) row-major; W: (N, K) row-major (nn.Linear layout); out (M, N).
__global__ void __launch_bounds__(kThreads)
linear_bias_act_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                       const bf16* __restrict__ bias, bf16* __restrict__ out,
                       int M, int N, int K, int gelu) {
  __shared__ __align__(128) bf16 smem[2 * kStageElems];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp >> 2;  // 0..1 -> 64-row half
  const int warp_n = warp & 3;   // 0..3 -> 32-col quarter
  const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;

  auto load_stage = [&](int stage, int k0) {
    bf16* sa = smem + stage * kStageElems;
    bf16* sw = sa + BM * LDS;
    // 128 rows x 32 cols = 128 x 4 chunks of 16 B for each operand
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int chunk = tid + i * kThreads;  // 0..511
      const int r = chunk >> 2, c = (chunk & 3) * 8;
      cp_async16(sa + r * LDS + c, A + (size_t)(bm + r) * K + k0 + c);
      cp_async16(sw + r * LDS + c, W + (size_t)(bn + r) * K + k0 + c);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int kt_total = K / BK;
  load_stage(0, 0);
  for (int kt = 0; kt < kt_total; ++kt) {
    if (kt + 1 < kt_total) {
      load_stage((kt + 1) & 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sa = smem + (kt & 1) * kStageElems;
    const bf16* sw = sa + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], sa + (warp_m * 64 + i * 16) * LDS + kk,
                               LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sw + (warp_n * 32 + j * 16) * LDS + kk,
                               LDS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the stage is overwritten by the next iteration's load
  }

  // epilogue: each warp stages one 16x16 fragment at a time in its own
  // 1 KB slice of the (now idle) operand buffers
  float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int grow = bm + warp_m * 64 + i * 16 + r;
      const int gcol = bn + warp_n * 32 + j * 16 + c0;
      alignas(16) bf16 o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float v = scratch[r * 16 + c0 + e] + __bfloat162float(bias[gcol + e]);
        if (gelu) v = ik::gelu_erf(v);
        o[e] = __float2bfloat16(v);
      }
      *reinterpret_cast<uint4*>(out + (size_t)grow * N + gcol) =
          *reinterpret_cast<const uint4*>(o);
      __syncwarp();
    }
  }
}

}  // namespace

// Requires M % 128 == 0, N % 128 == 0, K % 32 == 0 (checked by the wrapper).
IK_EXPORT int ik_linear_bias_act(const void* a, const void* w,
                                 const void* bias, void* out, int M, int N,
                                 int K, int gelu, void* stream) {
  if (M % BM || N % BN || K % BK) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, M / BM);
  linear_bias_act_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), M, N, K, gelu);
  return (int)cudaGetLastError();
}
