// 3x3 convolution, stride 1, same (zero) padding, NHWC, no bias: bf16 in,
// fp32 accumulation, one bf16 rounding at the output.
//
// Replaces the TPU kernels of scripts/ablate_pallas_conv.py:
// make_pallas_conv (one dot per tap over a VMEM-resident padded image) and
// make_pallas_conv_concat (the nine tap slices written into a VMEM im2col
// scratch, then one dot over K = 9C).  Both computed
//     out[b, y, x, o] = sum_{dy, dx, c} x[b, y+dy-1, x+dx-1, c] w[dy, dx, c, o]
// with the halo as zeros (the wrapper there padded the image in device
// memory first).
//
// Bound on the H100: the tensor cores.  At the UNet's levels (batch 2:
// 96^2 x 320 ... 12^2 x 1280) a launch does 2 * B*H*W * 9C * Cout
// operations (34.0 GFLOP at 96^2 x 320) on 2-19 MB of operands, 1,500-
// 12,000 operations per byte, far above the card's ~295.
//
// Design: an implicit GEMM, M = B*H*W output pixels, N = Cout, K = 9C taps
// x channels, K ordered (tap, channel) like the HWIO weights, so the
// weights are a plain row-major (9C, Cout) matrix.  A block computes a
// 128 x 128 output tile with 8 warps (2 x 4, 64 x 32 each) of bf16
// mma.sync m16n8k16, over K in slabs of 32.  A slab of A is gathered
// straight from the image: each 16-byte chunk (8 channels) of a row lies
// in one tap because C % 8 == 0, so a thread finds the chunk's tap and
// channel with one division per slab and reads the shifted pixel, or
// zeros where the tap falls outside the image (cp.async with a source
// size of 0): the halo costs no padded copy.  Slabs of A and B go through
// a 3-stage cp.async ring in shared memory (rows padded by 16 bytes, so
// ldmatrix reads them without bank conflicts), and fragments come from
// ldmatrix (.trans for B).  A simple kernel first: no TMA, no wgmma, no
// split-K for the small levels (at 12^2 the grid has 30 blocks).
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32, kStages = 3, kThreads = 256;
constexpr int kApitch = BK + 8;  // bf16 per A row in shared memory
constexpr int kBpitch = BN + 8;  // bf16 per B row
constexpr int kAstage = BM * kApitch, kBstage = BK * kBpitch;
constexpr int kSmemBytes = kStages * (kAstage + kBstage) * 2;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ out, int B, int H, int W, int C,
               int Cout) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* As = smem;                      // [stage][BM][kApitch]
  __nv_bfloat16* Bs = smem + kStages * kAstage;  // [stage][BK][kBpitch]

  const int M = B * H * W, K = 9 * C;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps

  // A loads: rows tid/4 and tid/4 + 64 of the tile, 16-byte chunk tid%4 of
  // the slab; each row's pixel is fixed over the whole K loop
  const int a_chunk = tid & 3;
  int a_y[2], a_x[2];
  const __nv_bfloat16* a_img[2];  // the pixel's image, or null past M
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (tid >> 2) + 64 * i;
    const int b = m / (H * W), r = m - b * H * W;
    a_y[i] = r / W;
    a_x[i] = r - a_y[i] * W;
    a_img[i] = m < M ? x + static_cast<size_t>(b) * H * W * C : nullptr;
  }
  // B loads: slab rows tid/16 and tid/16 + 16, chunk tid%16 of the 128
  // output channels
  const int b_row = tid >> 4, b_col = n0 + (tid & 15) * 8;

  auto load_slab = [&](int stage, int kt) {
    const int k = kt * BK + a_chunk * 8;
    const int tap = k / C, c = k - tap * C;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int yy = a_y[i] + dy, xx = a_x[i] + dx;
      const bool ok = a_img[i] != nullptr && k < K && yy >= 0 && yy < H &&
                      xx >= 0 && xx < W;
      const __nv_bfloat16* src =
          ok ? a_img[i] + (static_cast<size_t>(yy) * W + xx) * C + c : x;
      cp_async16(As + stage * kAstage + ((tid >> 2) + 64 * i) * kApitch +
                     a_chunk * 8,
                 src, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = kt * BK + b_row + 16 * i;
      const bool ok = kr < K && b_col < Cout;
      const __nv_bfloat16* src =
          ok ? w + static_cast<size_t>(kr) * Cout + b_col : w;
      cp_async16(Bs + stage * kBstage + (b_row + 16 * i) * kBpitch +
                     (tid & 15) * 8,
                 src, ok ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_slab(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slab kt landed; every warp is done with kt - 1
    if (kt + kStages - 1 < KT)
      load_slab((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* a_s = As + (kt % kStages) * kAstage;
    const __nv_bfloat16* b_s = Bs + (kt % kStages) * kBstage;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], a_s + (wm * 64 + i * 16 + (lane & 15)) * kApitch +
                               ks + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        unsigned r[4];
        ldmatrix_x4_trans(
            r, b_s + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * kBpitch +
                   wn * 32 + j * 16 + (lane >> 4) * 8);
        bfr[2 * j][0] = r[0];
        bfr[2 * j][1] = r[1];
        bfr[2 * j + 1][0] = r[2];
        bfr[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
  }
  cp_async_wait<0>();

  // each accumulator: rows lane/4 and lane/4 + 8, columns 2 (lane%4), +1
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn * 32 + j * 8 + (lane & 3) * 2;
      if (n >= Cout) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + i * 16 + (lane >> 2) + h * 8;
        if (m < M)
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<size_t>(m) * Cout + n) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

// Lift the kernel's dynamic shared memory limit, once per device
cudaError_t allow_smem() {
  static int set_for = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || set_for == device) return err;
  err = cudaFuncSetAttribute(conv3x3_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess) set_for = device;
  return err;
}

}  // namespace

// the arguments, packed by _kernels.py (struct format "PPPiiiiiP")
struct Conv3x3Args {
  const void *x, *w;
  void* out;
  int B, H, W, C, Cout;
  void* stream;
};

// Requires C % 8 == 0 and Cout % 8 == 0 (16-byte chunks), 16-byte aligned
// pointers, B * H * W * max(C, Cout) below 2^31 and at most 65535 row
// tiles (the wrapper checks).
IK_EXPORT int ik_conv3x3(const Conv3x3Args* args) {
  const auto [x, w, out, B, H, W, C, Cout, stream] = *args;
  if (B < 1 || H < 1 || W < 1 || C < 8 || C % 8 || Cout < 8 || Cout % 8)
    return (int)cudaErrorInvalidValue;
  const long long M = static_cast<long long>(B) * H * W;
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Cout + BN - 1) / BN, static_cast<unsigned>((M + BM - 1) / BM));
  conv3x3_kernel<<<grid, kThreads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), B, H, W, C, Cout);
  return (int)cudaGetLastError();
}
