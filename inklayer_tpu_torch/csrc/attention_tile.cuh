// Flash-style softmax attention over (BH, N, D) bf16 tensors, shared by
// relpos_attention.cu (SAM, with the decomposed rel-pos bias) and
// flash_attention.cu (plain attention, DINOv2):
//   logits[t, u] = scale * q_t . k_u  (+ rel_h[t, u / kw] + rel_w[t, u % kw]
//                                      when kRel)
//   out[t]       = softmax_u(logits[t]) @ v
//
// One block per (bh, 64-query tile) walks 64-key tiles with an online
// softmax in fp32.  QK^T and PV are WMMA bf16 16x16x16 products with fp32
// accumulators; each of the 4 warps owns 16 query rows.  WMMA needs a
// head dim that is a multiple of 16, so the Q/K/V tiles and the output
// accumulator are DP = round_up(D, 16) wide in shared memory, with columns
// D..DP-1 of Q, K and V zero (head_dim 40 -> 48: the zero columns add
// nothing to q.k, and the scale stays the caller's D ** -0.5); only D
// columns are rescaled and written out.  Keys past N in
// the last tile are masked to -inf; the rel terms of the block's queries
// are staged once in shared memory and added in the softmax pass, so the
// (N, N) bias never exists.  The probabilities are rounded to bf16 for the
// PV product, as in the plain versions.
#pragma once

#include <math_constants.h>
#include <mma.h>

#include "common.cuh"

// anonymous: each including source gets its own copy of the kernels
namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;      // query rows per block (4 warps x 16)
constexpr int BKV = 64;     // keys per tile
constexpr int kMaxRel = 64; // kh, kw <= 64
constexpr int kThreads = 128;
constexpr int LDS_P = BKV + 8;   // bf16 P tile stride
constexpr int LDS_S = BKV + 4;   // fp32 logits stride

// head dim padded to the WMMA depth of 16
template <int D>
constexpr int kPadded = (D + 15) / 16 * 16;

template <int D, bool kRel>
struct Smem {
  static constexpr int DP = kPadded<D>;
  static constexpr int LDQ = DP + 8;  // bf16 Q/K/V stride
  static constexpr int LDO = DP + 4;  // fp32 O stride
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(bf16) * BQ * LDQ;
  static constexpr size_t v = k + sizeof(bf16) * BKV * LDQ;
  static constexpr size_t s = v + sizeof(bf16) * BKV * LDQ;
  static constexpr size_t p = s + sizeof(float) * BQ * LDS_S;
  static constexpr size_t o = p + sizeof(bf16) * BQ * LDS_P;
  static constexpr size_t rh = o + sizeof(float) * BQ * LDO;
  static constexpr size_t rw = rh + (kRel ? sizeof(bf16) * BQ * kMaxRel : 0);
  static constexpr size_t bytes =
      rw + (kRel ? sizeof(bf16) * BQ * kMaxRel : 0);
};

// rows [row0, row0 + 64) of a (N, D) bf16 matrix into a DP-wide smem tile:
// zero past N and in the pad columns D..DP-1 (D % 8 == 0: a row is whole
// 16-byte vectors)
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int N, int tid) {
  static_assert(D % 8 == 0, "rows must be whole 16-byte vectors");
  constexpr int DP = kPadded<D>;
  constexpr int kVec = DP / 8;  // 16-byte vectors per smem row
  constexpr int LD = DP + 8;
  for (int i = tid; i < 64 * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < N && c < D)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D, bool kRel>
__global__ void __launch_bounds__(kThreads)
attention_tile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ rel_h,
                      const bf16* __restrict__ rel_w, bf16* __restrict__ out,
                      int N, int kh, int kw, float scale) {
  using L = Smem<D, kRel>;
  constexpr int DP = L::DP, LDQ = L::LDQ, LDO = L::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  bf16* sRh = reinterpret_cast<bf16*>(smem + L::rh);
  bf16* sRw = reinterpret_cast<bf16*>(smem + L::rw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + bh * N * D;
  const bf16* kb = k + bh * N * D;
  const bf16* vb = v + bh * N * D;

  load_tile<D>(sQ, qb, q0, N, tid);
  if constexpr (kRel) {
    for (int i = tid; i < BQ * kMaxRel; i += kThreads) {
      const int r = i / kMaxRel, c = i % kMaxRel;
      const int t = q0 + r;
      const bool ok = t < N;
      sRh[i] = (ok && c < kh) ? rel_h[(bh * N + t) * kh + c]
                              : __float2bfloat16(0.f);
      sRw[i] = (ok && c < kw) ? rel_w[(bh * N + t) * kw + c]
                              : __float2bfloat16(0.f);
    }
  }
  for (int i = tid; i < BQ * LDO; i += kThreads) sO[i] = 0.f;

  // softmax ownership: lane pair (2r, 2r+1) owns row r of the warp's 16,
  // each lane half of the 64 tile columns and half of the D output columns
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r;
  float m = -CUDART_INF_F, l = 0.f;

  for (int kv0 = 0; kv0 < N; kv0 += BKV) {
    __syncthreads();  // previous tile's K/V no longer read
    load_tile<D>(sK, kb, kv0, N, tid);
    load_tile<D>(sV, vb, kv0, N, tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + warp * 16 * LDQ + kk, LDQ);
        wmma::load_matrix_sync(fb, sK + j * 16 * LDQ + kk, LDQ);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sS + warp * 16 * LDS_S + j * 16, acc, LDS_S,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile's 64 keys
    float s[32];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = half * 32 + i;
      const int u = kv0 + c;
      float val = -CUDART_INF_F;
      if (u < N) {
        if constexpr (kRel)
          val = sS[row * LDS_S + c] * scale +
                __bfloat162float(sRh[row * kMaxRel + u / kw]) +
                __bfloat162float(sRw[row * kMaxRel + u % kw]);
        else
          val = sS[row * LDS_S + c] * scale;
      }
      s[i] = val;
      mx = fmaxf(mx, val);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = __expf(m - m_new);  // 0 on the first tile
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = __expf(s[i] - m_new);
      sum += p;
      sP[row * LDS_P + half * 32 + i] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
#pragma unroll 4
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d)
      sO[row * LDO + d] *= alpha;
    __syncwarp();

    // O += P V
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + warp * 16 * LDO + j * 16, LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + warp * 16 * LDS_P + kk, LDS_P);
        wmma::load_matrix_sync(fb, sV + kk * LDQ + j * 16, LDQ);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sO + warp * 16 * LDO + j * 16, acc, LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int t = q0 + row;
  if (t < N) {
    const float inv = 1.f / l;
    bf16* ob = out + (bh * N + t) * D;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d)
      ob[d] = __float2bfloat16(sO[row * LDO + d] * inv);
  }
}

template <int D, bool kRel>
cudaError_t launch_attention(const void* q, const void* k, const void* v,
                             const void* rel_h, const void* rel_w, void* out,
                             int BH, int N, int kh, int kw, float scale,
                             cudaStream_t stream) {
  const size_t bytes = Smem<D, kRel>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      attention_tile_kernel<D, kRel>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, BH);
  attention_tile_kernel<D, kRel><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(rel_h),
      static_cast<const bf16*>(rel_w), static_cast<bf16*>(out), N, kh, kw,
      scale);
  return cudaGetLastError();
}

}  // namespace
