// 8-connected components of a stack of binary masks, and the mask-cleaning
// component keep built on them.
//
//   ik_connected_components: (N, H, W) uint8 -> (N, H, W) int32 labels,
//     -1 at background, each component labelled by the smallest linear
//     index y * W + x of its pixels;
//   ik_clean_components: the same labels, then per-component area and
//     bounding box, and out[p] = p in a component with area > min_area or
//     max(w, h) / (min(w, h) + 1e-5) > min_aspect (fp32, as the JAX package
//     computes it).
//
// Replaces the TPU kernels inklayer_tpu/ops/components.py:
// _cc_pallas_kernel (_connected_components_pallas) and _clean_keep_kernel
// (_clean_components_pallas).  Those hold one whole mask in VMEM and
// iterate min-label propagation with run-gated doubling scans, capped at
// 16 iterations, and examine at most 256 components.  A 750^2 int32 label
// map is 2.25 MB, which no SM's shared memory holds, so this version works
// in device memory with union-find instead (Playne & Hawick style):
//   1. init:     parent[p] = p on the foreground, -1 elsewhere;
//   2. merge:    each foreground pixel unions itself with its foreground
//                backward neighbours (W, NW, N, NE); a union links the
//                larger root under the smaller with atomicMin and retries
//                when another thread moved the root first, so a root is
//                always the smallest index of its set;
//   3. compress: label[p] = root(p);
//   4. (keep)    stats at the roots with atomics, then the keep rule.
// The result is the exact fixpoint: no iteration cap, no component cap.
//
// Bound on the H100: device-memory latency of the pointer chasing in the
// merge, and atomics on one address when a large component's pixels meet
// at its root; the bytes are small (64 x 750^2 masks: 36 MB in, 144 MB of
// labels).  Finds halve the path as they go, and a warp whose 32 pixels
// share a root adds its stats with one atomic each.  The label map doubles
// as the parent array, so K6b allocates nothing beyond its output.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Root of x.  Parents only ever decrease and stay inside x's component, so
// a stale read during concurrent unions still lands on an ancestor.
__device__ __forceinline__ int find_root(const volatile int* parent, int x) {
  int p = parent[x];
  while (p != x) {
    x = p;
    p = parent[x];
  }
  return x;
}

// The same, halving the path on the way (each visited pointer lowered to
// its grandparent).  The lowering is an atomicMin, which never raises a
// pointer, so it cannot undo a concurrent union's link.  Without it the
// unions of a solid row build chains as long as the row.
__device__ __forceinline__ int find_root_halving(int* parent, int x) {
  const volatile int* vp = parent;
  while (true) {
    const int p = vp[x];
    if (p == x) return x;
    const int gp = vp[p];
    if (gp == p) return p;
    atomicMin(parent + x, gp);
    x = gp;
  }
}

__device__ void unite(int* parent, int a, int b) {
  bool done;
  do {
    a = find_root_halving(parent, a);
    b = find_root_halving(parent, b);
    if (a < b) {
      const int old = atomicMin(parent + b, a);
      done = (old == b);
      b = old;
    } else if (b < a) {
      const int old = atomicMin(parent + a, b);
      done = (old == a);
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

// grid (ceil(H*W / kThreads), N): one thread per pixel of one mask

__global__ void cc_init(const uint8_t* __restrict__ mask,
                        int* __restrict__ label, int hw) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const size_t off = (size_t)blockIdx.y * hw;
  label[off + p] = mask[off + p] ? p : -1;
}

__global__ void cc_merge(const uint8_t* __restrict__ mask, int* label, int H,
                         int W) {
  const int hw = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const size_t off = (size_t)blockIdx.y * hw;
  const uint8_t* m = mask + off;
  if (!m[p]) return;
  int* parent = label + off;
  const int y = p / W, x = p - y * W;
  if (x > 0 && m[p - 1]) unite(parent, p, p - 1);
  if (y > 0) {
    const int up = p - W;
    if (x > 0 && m[up - 1]) unite(parent, p, up - 1);
    if (m[up]) unite(parent, p, up);
    if (x + 1 < W && m[up + 1]) unite(parent, p, up + 1);
  }
}

__global__ void cc_compress(int* label, int hw) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  int* parent = label + (size_t)blockIdx.y * hw;
  if (parent[p] >= 0) parent[p] = find_root(parent, p);
}

// stats: 5 planes of N*H*W int32 (area, ymin, ymax, xmin, xmax), valid at
// the roots only
__global__ void stats_init(const int* __restrict__ label, int* stats,
                           size_t plane, int hw) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const size_t i = (size_t)blockIdx.y * hw + p;
  if (label[i] != p) return;
  stats[i] = 0;
  stats[plane + i] = INT_MAX;
  stats[2 * plane + i] = -1;
  stats[3 * plane + i] = INT_MAX;
  stats[4 * plane + i] = -1;
}

__global__ void stats_accumulate(const int* __restrict__ label, int* stats,
                                 size_t plane, int W, int hw) {
  // no early return: the warp votes below need every lane
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const size_t off = (size_t)blockIdx.y * hw;
  const int root = p < hw ? label[off + p] : -1;
  const int y = p / W, x = p - y * W;
  const unsigned full = 0xffffffffu;
  const int root0 = __shfl_sync(full, root, 0);
  if (__all_sync(full, root == root0) && root0 >= 0) {
    // the whole warp lies in one component (the common case inside a
    // blob): one atomic per statistic instead of 32 on the same address
    const int ymin = __reduce_min_sync(full, y);
    const int ymax = __reduce_max_sync(full, y);
    const int xmin = __reduce_min_sync(full, x);
    const int xmax = __reduce_max_sync(full, x);
    if ((threadIdx.x & 31) == 0) {
      const size_t r = off + root0;
      atomicAdd(stats + r, 32);
      atomicMin(stats + plane + r, ymin);
      atomicMax(stats + 2 * plane + r, ymax);
      atomicMin(stats + 3 * plane + r, xmin);
      atomicMax(stats + 4 * plane + r, xmax);
    }
    return;
  }
  if (root < 0) return;
  const size_t r = off + root;
  atomicAdd(stats + r, 1);
  atomicMin(stats + plane + r, y);
  atomicMax(stats + 2 * plane + r, y);
  atomicMin(stats + 3 * plane + r, x);
  atomicMax(stats + 4 * plane + r, x);
}

__global__ void keep_components(const int* __restrict__ label,
                                const int* __restrict__ stats, size_t plane,
                                uint8_t* __restrict__ out, int hw,
                                int min_area, float min_aspect) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const size_t off = (size_t)blockIdx.y * hw;
  const int root = label[off + p];
  uint8_t keep = 0;
  if (root >= 0) {
    const size_t r = off + root;
    const float ww = (float)(stats[4 * plane + r] - stats[3 * plane + r] + 1);
    const float hh = (float)(stats[2 * plane + r] - stats[plane + r] + 1);
    const float aspect = fmaxf(ww, hh) / (fminf(ww, hh) + 1e-5f);
    keep = (stats[r] > min_area) || (aspect > min_aspect);
  }
  out[off + p] = keep;
}

cudaError_t label_components(const uint8_t* mask, int* label, int N, int H,
                             int W, cudaStream_t stream) {
  const int hw = H * W;
  const dim3 grid((hw + kThreads - 1) / kThreads, N);
  cc_init<<<grid, kThreads, 0, stream>>>(mask, label, hw);
  cc_merge<<<grid, kThreads, 0, stream>>>(mask, label, H, W);
  cc_compress<<<grid, kThreads, 0, stream>>>(label, hw);
  return cudaGetLastError();
}

}  // namespace

// the arguments, packed by _kernels.py (struct format "PPiiiP")
struct LabelArgs {
  const void* mask;
  void* labels;
  int N, H, W;
  void* stream;
};

IK_EXPORT int ik_connected_components(const LabelArgs* args) {
  const auto [mask, labels, N, H, W, stream] = *args;
  if (N < 1 || H < 1 || W < 1 || (long long)H * W > INT_MAX / 2 ||
      N > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)label_components(static_cast<const uint8_t*>(mask),
                               static_cast<int*>(labels), N, H, W,
                               static_cast<cudaStream_t>(stream));
}

// the arguments, packed by _kernels.py (struct format "PPPPiiiifP")
struct CleanArgs {
  const void* mask;
  void *out, *labels, *stats;
  int N, H, W, min_area;
  float min_aspect;
  void* stream;
};

IK_EXPORT int ik_clean_components(const CleanArgs* args) {
  const auto [mask, out, labels, stats, N, H, W, min_area, min_aspect,
              stream] = *args;
  if (N < 1 || H < 1 || W < 1 || (long long)H * W > INT_MAX / 2 ||
      N > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int* lab = static_cast<int*>(labels);
  int* st = static_cast<int*>(stats);
  cudaError_t err = label_components(m, lab, N, H, W, s);
  if (err != cudaSuccess) return (int)err;
  const int hw = H * W;
  const size_t plane = (size_t)N * hw;
  const dim3 grid((hw + kThreads - 1) / kThreads, N);
  stats_init<<<grid, kThreads, 0, s>>>(lab, st, plane, hw);
  stats_accumulate<<<grid, kThreads, 0, s>>>(lab, st, plane, W, hw);
  keep_components<<<grid, kThreads, 0, s>>>(lab, st, plane,
                                            static_cast<uint8_t*>(out), hw,
                                            min_area, min_aspect);
  return (int)cudaGetLastError();
}
