// Row LayerNorm with fp32 statistics, optionally fused with a residual add.
//
// Replaces the TPU kernels inklayer_tpu/ops/norm.py:_ln_kernel
// (layernorm_2d) and :_ln_res_kernel (layernorm_residual_2d).
//
// Bound on the H100: device memory.  A (4096, 1280) bf16 row block is read
// once (twice with the residual) and written once (twice), at ~0.2 FLOP per
// byte; the smaller shapes of the model's path (2-21 MB) are bound by one
// round trip to device memory and by the launch itself.
//
// Design: each row belongs to a group of `lanes` lanes of one warp (a power
// of two up to 32), sized to C by the wrapper (ops/norm.py
// layernorm_config) so that every lane of the group holds the same number
// V of 16-byte vectors: C 96 (bf16: 12 vectors) is 8 rows of 4 lanes x 3
// per warp, C 320 is 4 rows of 8 x 5, C 1280 one row of 32 x 5.  Where no
// power of two divides C's vector count into at most 16 per lane, the row
// takes the whole warp; where a lane's share has no instance, the next
// larger one runs; either way the last vectors are guarded.  The row stays in
// registers, so x and y are read from device memory exactly once; the mean
// and the centred variance are two register passes with __shfl_xor_sync
// reductions over the group.  Every lane of the warp takes part in the
// shuffles, those of a missing last row too, and only returns before the
// stores.  The wrapper sizes the blocks (32 to 256 threads) so that the
// grid holds at least two blocks per SM where the rows allow it.
#include "common.cuh"

namespace {

template <typename T>
struct alignas(16) Pack {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// sum over the `lanes` lanes of a group (lanes a power of two)
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int V>
__global__ void __launch_bounds__(256)
layernorm_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 const T* __restrict__ scale, const T* __restrict__ bias,
                 T* __restrict__ sum_out, T* __restrict__ out, int rows, int C,
                 int lanes, float eps) {
  constexpr int E = Pack<T>::N;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = gid / lanes;
  const int sub = gid & (lanes - 1);
  const bool live = row < rows;
  const int nvec = C / E;
  const size_t off = static_cast<size_t>(live ? row : 0) * C;
  const Pack<T>* xr = reinterpret_cast<const Pack<T>*>(x + off);
  const Pack<T>* yr = y ? reinterpret_cast<const Pack<T>*>(y + off) : nullptr;
  float v[V][E];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int vi = sub + i * lanes;
    if (live && vi < nvec) {
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
  const float mean = group_sum(s, lanes) / C;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (live && sub + i * lanes < nvec) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = v[i][e] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(group_sum(sq, lanes) / C + eps);
  if (!live) return;
  const Pack<T>* sc = reinterpret_cast<const Pack<T>*>(scale);
  const Pack<T>* bi = reinterpret_cast<const Pack<T>*>(bias);
  Pack<T>* orow = reinterpret_cast<Pack<T>*>(out + off);
  Pack<T>* srow = sum_out ? reinterpret_cast<Pack<T>*>(sum_out + off) : nullptr;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int vi = sub + i * lanes;
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

template <typename T, int V>
void launch_v(const void* x, const void* y, const void* scale,
              const void* bias, void* sum_out, void* out, int rows, int C,
              int lanes, int threads, float eps, cudaStream_t stream) {
  const long long total = static_cast<long long>(rows) * lanes;
  const int blocks = static_cast<int>((total + threads - 1) / threads);
  layernorm_kernel<T, V><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(scale), static_cast<const T*>(bias),
      static_cast<T*>(sum_out), static_cast<T*>(out), rows, C, lanes, eps);
}

// the instances: vectors per lane in {1, 2, 3, 4, 5, 8, 16} (the powers of
// two take any C, guarded; 3 and 5 split C = 96 * 2^k and 320 * 2^k evenly)
template <typename T>
cudaError_t launch(const void* x, const void* y, const void* scale,
                   const void* bias, void* sum_out, void* out, int rows, int C,
                   int lanes, int vpl, int threads, float eps,
                   cudaStream_t s) {
#define IK_LN_CASE(V)                                                        \
  case V:                                                                    \
    launch_v<T, V>(x, y, scale, bias, sum_out, out, rows, C, lanes, threads, \
                   eps, s);                                                  \
    break;
  switch (vpl) {
    IK_LN_CASE(1) IK_LN_CASE(2) IK_LN_CASE(3) IK_LN_CASE(4) IK_LN_CASE(5)
    IK_LN_CASE(8) IK_LN_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef IK_LN_CASE
  return cudaGetLastError();
}

}  // namespace

// the arguments, packed by _kernels.py (struct format "PPPPPPiiiiifiP");
// y and sum_out are null without the residual
struct LayerNormArgs {
  const void *x, *y, *scale, *bias;
  void *sum_out, *out;
  int rows, C, lanes, vpl, threads;
  float eps;
  int is_bf16;
  void* stream;
};

// lanes: a power of two <= 32 with lanes * vpl * (16 / sizeof(T)) >= C;
// threads: a multiple of 32 up to 256 (the wrapper chooses all three).
IK_EXPORT int ik_layernorm(const LayerNormArgs* args) {
  const auto [x, y, scale, bias, sum_out, out, rows, C, lanes, vpl, threads,
              eps, is_bf16, stream] = *args;
  const int per_vec = is_bf16 ? 8 : 4;
  if (rows < 1 || C < per_vec || C % per_vec || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) || lanes * vpl * per_vec < C || threads < 32 ||
      threads > 256 || threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, y, scale, bias, sum_out, out, rows, C,
                                 lanes, vpl, threads, eps, s);
  return launch<float>(x, y, scale, bias, sum_out, out, rows, C, lanes, vpl,
                       threads, eps, s);
}

IK_EXPORT const char* ik_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
