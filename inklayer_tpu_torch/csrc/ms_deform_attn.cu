// Multi-scale deformable attention, direct bilinear gather.
//
// Replaces the TPU kernels inklayer_tpu/ops/deformable.py:
// _ms_deform_attn_pallas_tiled (_pallas_tiled_kernel, the encoder's raster
// queries) and _ms_deform_attn_pallas_fused v3
// (_pallas_fused_levels_kernel_v3, the decoder and the tiled path's tail
// levels).  Same semantics as F.grid_sample(align_corners=False,
// padding_mode="zeros"): pixel coordinate = loc * size - 0.5, corners
// outside the level contribute zero, sums in fp32.
//
// Bound on the H100: latency of scattered reads.  Each output element
// needs n_levels * n_points * 4 = 64 reads of the value tensor at
// data-dependent addresses and ~200 FLOPs.  The TPU kernels rebuilt the
// gather as separable matmuls (Sy @ V @ Sx^T) with query tiles, x-windows
// and an escape correction only because gathers are slow there; none of
// that carries over.  Design: one thread per (query, head, channel), a
// warp per (query, head), so the 32 channels of a head (head_dim 32) read
// 32 neighbouring values of one pixel in one transaction per corner, and
// the sampling location and weight are warp-uniform broadcast reads.  The
// value tensor (13294 x 8 x 32 bf16 = 6.8 MB) stays in L2.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kHeadDim = 32;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

template <typename T>
__global__ void __launch_bounds__(256)
ms_deform_attn_kernel(const T* __restrict__ value, Levels lv, int n_levels,
                      const float* __restrict__ loc,
                      const float* __restrict__ attn, T* __restrict__ out,
                      int S, int Lq, int heads, int n_points, long total) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long bqh = idx / kHeadDim;  // (b * Lq + q) * heads + h
  const int c = (int)(idx % kHeadDim);
  if (bqh >= total) return;
  const int h = (int)(bqh % heads);
  const long b = bqh / heads / Lq;
  const int lp = n_levels * n_points;
  const float* l = loc + bqh * lp * 2;
  const float* a = attn + bqh * lp;
  const size_t pix_stride = (size_t)heads * kHeadDim;
  float acc = 0.f;
  for (int lvl = 0; lvl < n_levels; ++lvl) {
    const int H = lv.h[lvl], W = lv.w[lvl];
    const T* base = value + ((size_t)b * S + lv.start[lvl]) * pix_stride +
                    (size_t)h * kHeadDim + c;
    for (int p = 0; p < n_points; ++p) {
      const int k = lvl * n_points + p;
      const float x = l[2 * k] * W - 0.5f;
      const float y = l[2 * k + 1] * H - 0.5f;
      // every corner outside the level (or a NaN location): no contribution
      if (!(x > -1.f && x < (float)W && y > -1.f && y < (float)H)) continue;
      const float x0f = floorf(x), y0f = floorf(y);
      const int x0 = (int)x0f, y0 = (int)y0f;
      const float fx = x - x0f, fy = y - y0f;
      float s = 0.f;
      if (y0 >= 0) {
        const T* row = base + (size_t)y0 * W * pix_stride;
        if (x0 >= 0) s += (1.f - fy) * (1.f - fx) * ik::to_f(row[(size_t)x0 * pix_stride]);
        if (x0 + 1 < W) s += (1.f - fy) * fx * ik::to_f(row[(size_t)(x0 + 1) * pix_stride]);
      }
      if (y0 + 1 < H) {
        const T* row = base + (size_t)(y0 + 1) * W * pix_stride;
        if (x0 >= 0) s += fy * (1.f - fx) * ik::to_f(row[(size_t)x0 * pix_stride]);
        if (x0 + 1 < W) s += fy * fx * ik::to_f(row[(size_t)(x0 + 1) * pix_stride]);
      }
      acc += a[k] * s;
    }
  }
  out[bqh * kHeadDim + c] = ik::from_f<T>(acc);
}

template <typename T>
cudaError_t launch(const void* value, const Levels& lv, int n_levels,
                   const float* loc, const float* attn, void* out, int B,
                   int S, int Lq, int heads, int n_points,
                   cudaStream_t stream) {
  const long total = (long)B * Lq * heads;
  const long threads = total * kHeadDim;
  const int block = 256;
  const long grid = (threads + block - 1) / block;
  ms_deform_attn_kernel<T><<<(unsigned)grid, block, 0, stream>>>(
      static_cast<const T*>(value), lv, n_levels, loc, attn,
      static_cast<T*>(out), S, Lq, heads, n_points, total);
  return cudaGetLastError();
}

}  // namespace

// level_shapes: host int[2 * n_levels] (h, w pairs); level_starts: host
// int[n_levels] token offsets of each level in the flattened value.
// the arguments, packed by _kernels.py (struct format "PPPiPPPiiiiiiP");
// level_shapes and level_starts are host arrays
struct MsdaArgs {
  const void* value;
  const int *level_shapes, *level_starts;
  int n_levels;
  const void *loc, *attn;
  void* out;
  int B, S, Lq, heads, n_points, is_bf16;
  void* stream;
};

IK_EXPORT int ik_ms_deform_attn(const MsdaArgs* args) {
  const auto [value, level_shapes, level_starts, n_levels, loc, attn, out, B,
              S, Lq, heads, n_points, is_bf16, stream] = *args;
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels lv{};
  for (int i = 0; i < n_levels; ++i) {
    lv.h[i] = level_shapes[2 * i];
    lv.w[i] = level_shapes[2 * i + 1];
    lv.start[i] = level_starts[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(attn);
  if (is_bf16)
    return launch<__nv_bfloat16>(value, lv, n_levels, l, a, out, B, S, Lq,
                                 heads, n_points, s);
  return launch<float>(value, lv, n_levels, l, a, out, B, S, Lq, heads,
                       n_points, s);
}
