// Multi-scale deformable attention, direct bilinear gather.
//
// Replaces the TPU kernels inklayer_tpu/ops/deformable.py:
// _ms_deform_attn_pallas_tiled (_pallas_tiled_kernel, the encoder's raster
// queries) and _ms_deform_attn_pallas_fused v3
// (_pallas_fused_levels_kernel_v3, the decoder and the tiled path's tail
// levels).  Same semantics as F.grid_sample(align_corners=False,
// padding_mode="zeros"): pixel coordinate = loc * size - 0.5, corners
// outside the level contribute zero, a NaN location contributes zero, sums
// in fp32.  The TPU kernels rebuilt the gather as separable matmuls
// (Sy @ V @ Sx^T) with query tiles, x-windows and an escape correction
// only because gathers are slow there; none of that carries over.
//
// Bound on the H100: the gather's load instructions and L2 sectors, not
// HBM (the value tensor, 13294 x 8 x 32 bf16 = 6.8 MB, stays in L2).  Each
// (query, head) reads n_levels * n_points * 4 corners of 32 channels, 64
// bytes each, at data-dependent addresses.  One thread per channel would
// have each lane issue 64 two-byte loads and all 32 lanes repeat the same
// location and weight loads and corner arithmetic
// (scripts/torch_msda_anatomy.py times that design piece by piece).
// Design: one warp per (query, head), its lanes split over (point slot,
// channel group): bf16 takes 8 slots x 4 groups of 8 channels, fp32 4
// slots x 8 groups of 4, so every lane loads 16 bytes per corner.  A lane
// loads its own point's location and weight once (coalesced over the
// slots), computes its own corners and weights, keeps two points' eight
// corner loads in flight, and accumulates in fp32; the slots are then
// summed with shuffles and one lane per group stores 16 bytes.  Blocks go
// head-major, so the blocks in flight share one head's 1/8 of the value
// tensor, and a block's warps take neighbouring queries of that head,
// which sample neighbouring pixels on the real path.  The level table
// travels by value in the argument struct and is staged in shared memory
// (lanes of one warp index different levels).
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kHeadDim = 32;
constexpr int kWarps = 4;  // queries per block, one head

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// 16 bytes of values as fp32: 8 bf16 (a bf16 is the top half of an fp32)
// or 4 fp32
__device__ __forceinline__ void widen(const uint4 v, float* f,
                                      const __nv_bfloat16*) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(u[j] << 16);
    f[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(const uint4 v, float* f, const float*) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ uint4 narrow(const float* f, const __nv_bfloat16*) {
  unsigned u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    u[j] = *reinterpret_cast<const unsigned*>(&p);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ uint4 narrow(const float* f, const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// grid (heads * ceil(B * Lq / kWarps)), kWarps warps, head-major: the
// blocks in flight at a time share one head's slice of the value tensor,
// and a block's warps take neighbouring queries
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ms_deform_attn_kernel(const T* __restrict__ value,
                      const __grid_constant__ Levels lv, int n_levels,
                      const float* __restrict__ loc,
                      const float* __restrict__ attn, T* __restrict__ out,
                      int S, int Lq, int heads, int n_points, long bq_total,
                      int q_blocks) {
  constexpr int kVec = 16 / sizeof(T);       // channels per lane
  constexpr int kGroups = kHeadDim / kVec;   // lanes per point
  constexpr int kSlots = 32 / kGroups;       // points in flight per warp
  __shared__ int s_h[kMaxLevels], s_w[kMaxLevels], s_start[kMaxLevels];
  if (threadIdx.x < kMaxLevels) {
    s_h[threadIdx.x] = lv.h[threadIdx.x];
    s_w[threadIdx.x] = lv.w[threadIdx.x];
    s_start[threadIdx.x] = lv.start[threadIdx.x];
  }
  __syncthreads();
  const int h = blockIdx.x / q_blocks;
  const long bq = (long)(blockIdx.x - h * q_blocks) * kWarps +
                  (threadIdx.x >> 5);
  if (bq >= bq_total) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const int slot = lane / kGroups, grp = lane % kGroups;
  const long bqh = bq * heads + h;
  const long b = bq / Lq;
  const int lp = n_levels * n_points;
  const float2* l = reinterpret_cast<const float2*>(loc) + bqh * lp;
  const float* a = attn + bqh * lp;
  const size_t pix = (size_t)heads * kHeadDim;  // elements per pixel
  const T* vb = value + (size_t)b * S * pix + (size_t)h * kHeadDim +
                grp * kVec;
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
  // two points per lane per step: their 8 corner loads in flight together
  for (int k0 = slot; k0 < lp; k0 += 2 * kSlots) {
    uint4 v[2][4];
    float cw[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[u][c] = make_uint4(0, 0, 0, 0);
        cw[u][c] = 0.f;
      }
      const int k = k0 + u * kSlots;
      if (k >= lp) continue;
      const int lvl = k / n_points;
      const int H = s_h[lvl], W = s_w[lvl];
      const float2 xy = l[k];
      const float wk = a[k];
      const float x = xy.x * W - 0.5f;
      const float y = xy.y * H - 0.5f;
      // every corner outside the level (or a NaN location): no contribution
      if (!(x > -1.f && x < (float)W && y > -1.f && y < (float)H)) continue;
      const float x0f = floorf(x), y0f = floorf(y);
      const int x0 = (int)x0f, y0 = (int)y0f;
      const float fx = x - x0f, fy = y - y0f;
      const T* base = vb + (size_t)s_start[lvl] * pix;
      // corner c = (y0 + c / 2, x0 + c % 2)
      const bool in_x[2] = {x0 >= 0, x0 + 1 < W};
      const bool in_y[2] = {y0 >= 0, y0 + 1 < H};
      const float wx[2] = {1.f - fx, fx};
      const float wy[2] = {1.f - fy, fy};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int dy = c >> 1, dx = c & 1;
        if (!(in_y[dy] && in_x[dx])) continue;
        cw[u][c] = wk * (wy[dy] * wx[dx]);
        v[u][c] = __ldg(reinterpret_cast<const uint4*>(
            base + ((size_t)(y0 + dy) * W + x0 + dx) * pix));
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float f[kVec];
        widen(v[u][c], f, value);
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] += cw[u][c] * f[j];
      }
  }
  // the slots of one channel group: lanes grp, grp + kGroups, ...
#pragma unroll
  for (int o = kGroups; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  if (slot == 0)
    *reinterpret_cast<uint4*>(out + bqh * kHeadDim + grp * kVec) =
        narrow(acc, value);
}

template <typename T>
cudaError_t launch(const void* value, const Levels& lv, int n_levels,
                   const void* loc, const void* attn, void* out, int B, int S,
                   int Lq, int heads, int n_points, cudaStream_t stream) {
  const long bq = (long)B * Lq;
  const long q_blocks = (bq + kWarps - 1) / kWarps;
  if (q_blocks * heads > INT_MAX) return cudaErrorInvalidValue;
  ms_deform_attn_kernel<T><<<(unsigned)(q_blocks * heads), kWarps * 32, 0,
                             stream>>>(
      static_cast<const T*>(value), lv, n_levels,
      static_cast<const float*>(loc), static_cast<const float*>(attn),
      static_cast<T*>(out), S, Lq, heads, n_points, bq, (int)q_blocks);
  return cudaGetLastError();
}

}  // namespace

// the arguments, packed by _kernels.py (struct format "PPPP7i24iP"); the
// level table by value: heights, widths and token offsets of each level in
// the flattened value, unused entries 0
struct MsdaArgs {
  const void *value, *loc, *attn;
  void* out;
  int B, S, Lq, heads, n_levels, n_points, is_bf16;
  Levels lv;
  void* stream;
};

IK_EXPORT int ik_ms_deform_attn(const MsdaArgs* args) {
  const auto [value, loc, attn, out, B, S, Lq, heads, n_levels, n_points,
              is_bf16, lv, stream] = *args;
  if (n_levels < 1 || n_levels > kMaxLevels || n_points < 1 || heads < 1 ||
      B < 1 || Lq < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(value, lv, n_levels, loc, attn, out, B, S,
                                 Lq, heads, n_points, s);
  return launch<float>(value, lv, n_levels, loc, attn, out, B, S, Lq, heads,
                       n_points, s);
}
