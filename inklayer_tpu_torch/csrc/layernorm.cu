// Row LayerNorm with fp32 statistics, optionally fused with a residual add.
//
// Replaces the TPU kernels inklayer_tpu/ops/norm.py:_ln_kernel
// (layernorm_2d) and :_ln_res_kernel (layernorm_residual_2d).
//
// Bound on the H100: device memory.  A (4096, 1280) bf16 row block is read
// once (twice with the residual) and written once (twice), at ~0.2 FLOP per
// byte.  Design: one warp per row, the whole row held in registers as
// 16-byte vectors (up to 16 per lane), so x and y are read from device
// memory exactly once and the mean and the centred variance are two
// register passes with warp-shuffle reductions.  Any C that is a multiple
// of 8 works (96 ... 1280 on the model's path).
#include "common.cuh"

namespace {

template <typename T>
struct alignas(16) Pack {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T, int VPT>
__global__ void __launch_bounds__(256)
layernorm_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 const T* __restrict__ scale, const T* __restrict__ bias,
                 T* __restrict__ sum_out, T* __restrict__ out, int rows, int C,
                 float eps) {
  constexpr int E = Pack<T>::N;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int nvec = C / E;
  const Pack<T>* xr = reinterpret_cast<const Pack<T>*>(x + (size_t)row * C);
  const Pack<T>* yr =
      y ? reinterpret_cast<const Pack<T>*>(y + (size_t)row * C) : nullptr;
  float v[VPT][E];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = lane + i * 32;
    if (vi < nvec) {
      Pack<T> a = xr[vi];
#pragma unroll
      for (int e = 0; e < E; ++e) v[i][e] = ik::to_f(a.v[e]);
      if (yr) {
        Pack<T> b = yr[vi];
#pragma unroll
        for (int e = 0; e < E; ++e) v[i][e] += ik::to_f(b.v[e]);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) s += v[i][e];
    }
  }
  const float mean = ik::warp_sum(s) / C;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (lane + i * 32 < nvec) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = v[i][e] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(ik::warp_sum(sq) / C + eps);
  const Pack<T>* sc = reinterpret_cast<const Pack<T>*>(scale);
  const Pack<T>* bi = reinterpret_cast<const Pack<T>*>(bias);
  Pack<T>* orow = reinterpret_cast<Pack<T>*>(out + (size_t)row * C);
  Pack<T>* srow =
      sum_out ? reinterpret_cast<Pack<T>*>(sum_out + (size_t)row * C) : nullptr;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = lane + i * 32;
    if (vi < nvec) {
      Pack<T> g = sc[vi], b = bi[vi], o;
#pragma unroll
      for (int e = 0; e < E; ++e)
        o.v[e] = ik::from_f<T>((v[i][e] - mean) * rstd * ik::to_f(g.v[e]) +
                               ik::to_f(b.v[e]));
      orow[vi] = o;
      if (srow) {
        Pack<T> t;
#pragma unroll
        for (int e = 0; e < E; ++e) t.v[e] = ik::from_f<T>(v[i][e]);
        srow[vi] = t;
      }
    }
  }
}

template <typename T, int VPT>
void launch_vpt(const void* x, const void* y, const void* scale,
                const void* bias, void* sum_out, void* out, int rows, int C,
                float eps, cudaStream_t stream) {
  layernorm_kernel<T, VPT><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<T*>(sum_out), static_cast<T*>(out), rows, C, eps);
}

template <typename T>
cudaError_t launch(const void* x, const void* y, const void* scale,
                   const void* bias, void* sum_out, void* out, int rows, int C,
                   float eps, cudaStream_t stream) {
  const int per_lane = (C / Pack<T>::N + 31) / 32;
  if (per_lane <= 1)
    launch_vpt<T, 1>(x, y, scale, bias, sum_out, out, rows, C, eps, stream);
  else if (per_lane <= 2)
    launch_vpt<T, 2>(x, y, scale, bias, sum_out, out, rows, C, eps, stream);
  else if (per_lane <= 4)
    launch_vpt<T, 4>(x, y, scale, bias, sum_out, out, rows, C, eps, stream);
  else if (per_lane <= 8)
    launch_vpt<T, 8>(x, y, scale, bias, sum_out, out, rows, C, eps, stream);
  else if (per_lane <= 16)
    launch_vpt<T, 16>(x, y, scale, bias, sum_out, out, rows, C, eps, stream);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

IK_EXPORT int ik_layernorm(const void* x, const void* y, const void* scale,
                           const void* bias, void* sum_out, void* out,
                           int rows, int C, float eps, int is_bf16,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, y, scale, bias, sum_out, out, rows, C, eps,
                                 s);
  return launch<float>(x, y, scale, bias, sum_out, out, rows, C, eps, s);
}

IK_EXPORT const char* ik_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
