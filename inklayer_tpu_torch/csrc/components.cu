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
// map is 2.25 MB, which no SM's shared memory holds.  This version is the
// exact fixpoint (no iteration cap, no component cap), by block-based
// union-find over 2 x 2 pixel blocks (all four pixels of a block are
// neighbours, so a block's set pixels are one node, named by its first set
// pixel; two blocks are linked when a pixel of one touches a pixel of the
// other):
//   1. local:   one thread block per (mask, 32 x 32 tile), one thread per
//               2 x 2 block, reads its mask bytes once and runs union-find
//               over a parent array in shared memory, with shared atomics;
//               a union always links the larger root under the smaller, so
//               each piece's root is its smallest pixel, local order being
//               global order.  The tile writes the global index of each
//               pixel's local root as its label (the parent array of step 2);
//   2. border:  only blocks on a tile's top row and left column have
//               backward neighbours in another tile (the south-west one of
//               a left-column block is the north-east link of the block
//               across the corner); they unite the two labels in device
//               memory with atomicMin, path halving and retries;
//   3. finish:  each tile labels its blocks again in shared memory, chases
//               each local root to its global root once, and writes that
//               root to every pixel of the piece;
//   4. keep:    (ik_clean_components) step 3 also sums area and bounding
//               box per piece in shared memory and adds them with one
//               global atomic per (tile, piece) and statistic into a table
//               of one cell per 2 x 2 block (a block holds at most one
//               root); ymin is the root's row.  One pass then applies the
//               keep rule.
// Launches per call: 3 (connected components), 4 (clean).
//
// Bound on the H100: not the bytes (64 x 750^2 masks: 36 MB in, 144 MB of
// labels) but the dependent loads of union-find and the atomics where a
// component's pixels meet at one root.  Step 1 keeps both in shared memory
// over a quarter of the nodes; in device memory only the ~1/8 of the
// blocks on tile borders unite, with chains one hop long after step 1, and
// the keep adds one atomic per piece and statistic.  The cell table is one
// int32 plane's size (4 x N * ceil(H/2) * ceil(W/2)).  What is left is
// latency: steps 1 and 3 move 4 mask bytes in and 16 label bytes out per
// thread around three barriers.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kTileH = 32, kTileW = 32;  // pixels; even
constexpr int kTile = kTileH * kTileW;
// a tile's 2 x 2 blocks: all four pixels of one are neighbours, so a
// block's set pixels always lie in one piece; one thread per block
constexpr int kBlocksH = kTileH / 2, kBlocksW = kTileW / 2;
constexpr int kThreads = kBlocksH * kBlocksW;
constexpr int kBorder = kBlocksW + kBlocksH - 1;  // top row + left column
static_assert(kTileH % 2 == 0 && kTileW % 2 == 0 && kThreads <= 1024 &&
                  kThreads % 32 == 0 && 32 % kBlocksW == 0,
              "tile shape: even, and whole rows of blocks in a warp");

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
// unions of a solid row build chains as long as the row.  Works on shared
// and device memory alike.
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

// Union of the sets of a and b: the larger root is linked under the
// smaller with atomicMin, retried when another thread moved the root first.
__device__ __forceinline__ void unite(int* parent, int a, int b) {
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

// a block's pixels as bits: 1 top left, 2 top right, 4 bottom left,
// 8 bottom right; (y, x) is the top left pixel, x even (a row's two bytes
// are one 2-byte load where they are aligned for it)
__device__ __forceinline__ int row_bits(const uint8_t* __restrict__ r, int W,
                                        int x) {
  if (x + 1 < W && (reinterpret_cast<uintptr_t>(r + x) & 1) == 0) {
    const unsigned v = *reinterpret_cast<const uint16_t*>(r + x);
    return ((v & 0xff) ? 1 : 0) | ((v >> 8) ? 2 : 0);
  }
  return (x < W && r[x] ? 1 : 0) | (x + 1 < W && r[x + 1] ? 2 : 0);
}

__device__ __forceinline__ int block_bits(const uint8_t* __restrict__ m, int H,
                                          int W, int y, int x) {
  int bits = 0;
  if (y < H) bits = row_bits(m + (size_t)y * W, W, x);
  if (y + 1 < H) bits |= row_bits(m + (size_t)(y + 1) * W, W, x) << 2;
  return bits;
}

// index (row stride `stride`) of the first set pixel of a block with bits
// != 0 whose top left pixel is (y, x): the block's node in union-find
__device__ __forceinline__ int first_pixel(int bits, int y, int x,
                                           int stride) {
  return (bits & 3) ? y * stride + x + ((bits & 1) ? 0 : 1)
                    : (y + 1) * stride + x + ((bits & 4) ? 0 : 1);
}

// Whether a block with bits `me` touches its west, north, north-west or
// north-east neighbour block with bits `nb` (8-connectivity), or its
// south-west one (whose north-east link that is).
__device__ __forceinline__ bool joins_w(int me, int nb) {
  return (me & 5) && (nb & 10);
}
__device__ __forceinline__ bool joins_n(int me, int nb) {
  return (me & 3) && (nb & 12);
}
__device__ __forceinline__ bool joins_nw(int me, int nb) {
  return (me & 1) && (nb & 8);
}
__device__ __forceinline__ bool joins_ne(int me, int nb) {
  return (me & 2) && (nb & 4);
}
__device__ __forceinline__ bool joins_sw(int me, int nb) {
  return (me & 4) && (nb & 2);
}

// per-root statistics, one cell per 2 x 2 pixels (ymin is the root's row)
struct Cell {
  int area, ymax, xmin, xmax;
};

__device__ __forceinline__ size_t cell_of(int root, int W, size_t mask_cells,
                                          int cells_w, int n) {
  const int y = root / W, x = root - y * W;
  return n * mask_cells + (size_t)(y >> 1) * cells_w + (x >> 1);
}

struct Shape {
  int H, W, tiles_x, tiles, cells_w;  // tiles per row and per mask
  size_t mask_cells;                  // ceil(H / 2) * cells_w
};

// A thread's 2 x 2 block after label_tile: its bits and, where any is
// set, its node (the local index ly * kTileW + lx of its first set pixel)
// and its piece's root, the smallest node of the piece (the block's
// component inside the tile), which is the piece's smallest pixel.
struct TileNode {
  int bits, node, root;
};

// The distinct runs above block t (at column bc, bits != 0, not on the
// tile's top row) that it touches (north, north-west, north-east), as the
// runs' smallest nodes; returns how many.
__device__ __forceinline__ int runs_above(int t, int bits, int bc,
                                          const uint8_t* bits_s,
                                          const int* run_s, int* up) {
  const int u = t - kBlocksW;
  int n = 0;
  if (joins_n(bits, bits_s[u])) up[n++] = run_s[u];
  if (bc > 0 && joins_nw(bits, bits_s[u - 1]) &&
      (n == 0 || up[0] != run_s[u - 1]))
    up[n++] = run_s[u - 1];
  if (bc + 1 < kBlocksW && joins_ne(bits, bits_s[u + 1])) {
    const int r = run_s[u + 1];
    if ((n < 1 || up[0] != r) && (n < 2 || up[1] != r)) up[n++] = r;
  }
  return n;
}

// Labels a tile in shared memory from its blocks' bits, one thread per
// 2 x 2 block (a warp holds whole rows of blocks).
//   - Runs: a row's blocks that touch their west neighbour form runs, found
//     with one ballot; every block of a run points straight at the run's
//     smallest node, without atomics.
//   - Runs above: a block unites its run with each run in the row above
//     that it touches (north, north-west, north-east), unless its west
//     neighbour in the run touches that run too (then a block further west
//     makes the link): one union per pair of touching runs, in shared
//     memory with atomicMin.
__device__ __forceinline__ TileNode label_tile(int bits, int* par,
                                               uint8_t* bits_s, int* run_s) {
  const int t = threadIdx.x, lane = t & 31;
  const int bc = t % kBlocksW, ly = 2 * (t / kBlocksW), lx = 2 * bc;
  const int node = bits ? first_pixel(bits, ly, lx, kTileW) : -1;
  bits_s[t] = (uint8_t)bits;
  __syncthreads();
  const unsigned full = 0xffffffffu;
  const bool joined_w = bits && bc > 0 && joins_w(bits, bits_s[t - 1]);
  // a run starts at every block that does not join its west neighbour (the
  // first block of a row among them); its start is the nearest one west
  const unsigned starts = ~__ballot_sync(full, joined_w);
  const int start = 31 - __clz(starts & (full >> (31 - lane)));
  const unsigned run_lanes = __match_any_sync(full, bits ? start : -1 - lane);
  const int run = __reduce_min_sync(run_lanes, bits ? node : INT_MAX);
  run_s[t] = run;
  if (bits) par[node] = run;
  __syncthreads();
  if (bits && ly > 0) {
    int up[3], west[3];
    const int n = runs_above(t, bits, bc, bits_s, run_s, up);
    const int nw = joined_w ? runs_above(t - 1, bits_s[t - 1], bc - 1, bits_s,
                                         run_s, west)
                            : 0;
    for (int i = 0; i < n; ++i) {
      bool made_west = false;
      for (int j = 0; j < nw; ++j) made_west |= west[j] == up[i];
      if (!made_west) unite(par, node, up[i]);
    }
  }
  __syncthreads();
  return TileNode{bits, node, bits ? find_root(par, node) : -1};
}

// the thread block's tile: its origin, and the (y, x) of the thread's
// 2 x 2 block in the mask
struct TilePos {
  int y0, x0, y, x;
};

__device__ __forceinline__ TilePos tile_pos(const Shape& s) {
  const int ty = blockIdx.x / s.tiles_x, tx = blockIdx.x - ty * s.tiles_x;
  const int t = threadIdx.x;
  return TilePos{ty * kTileH, tx * kTileW, ty * kTileH + 2 * (t / kBlocksW),
                 tx * kTileW + 2 * (t % kBlocksW)};
}

// the labels of a block's four pixels: g where set, -1 elsewhere (on an
// even width a row's two labels are one aligned 8-byte store)
__device__ __forceinline__ void store_row(int* r, int W, int x, int bits,
                                          int g) {
  const int a = (bits & 1) ? g : -1, b = (bits & 2) ? g : -1;
  if (x + 1 < W && (W & 1) == 0) {
    *reinterpret_cast<int2*>(r + x) = make_int2(a, b);
    return;
  }
  if (x < W) r[x] = a;
  if (x + 1 < W) r[x + 1] = b;
}

__device__ __forceinline__ void store_block(int* label, const Shape& s, int y,
                                            int x, int bits, int g) {
  if (y < s.H) store_row(label + (size_t)y * s.W, s.W, x, bits, g);
  if (y + 1 < s.H)
    store_row(label + (size_t)(y + 1) * s.W, s.W, x, bits >> 2, g);
}

// grid (tiles, N): step 1, and (cells != nullptr) the start values of the
// cells of the tile's local roots, the only pixels that can be roots (a
// block is its own cell)
__global__ void __launch_bounds__(kThreads)
cc_local(const uint8_t* __restrict__ mask, int* __restrict__ label,
         Cell* __restrict__ cells, Shape s) {
  __shared__ int par[kTile];
  __shared__ uint8_t bits_s[kThreads];
  __shared__ int run_s[kThreads];
  const TilePos tp = tile_pos(s);
  const size_t off = (size_t)blockIdx.y * s.H * s.W;
  const TileNode tn = label_tile(block_bits(mask + off, s.H, s.W, tp.y, tp.x),
                                 par, bits_s, run_s);
  if (tp.y >= s.H || tp.x >= s.W) return;
  const int g = tn.bits ? (tp.y0 + tn.root / kTileW) * s.W + tp.x0 +
                              tn.root % kTileW
                        : -1;
  store_block(label + off, s, tp.y, tp.x, tn.bits, g);
  if (cells != nullptr && tn.bits && tn.root == tn.node)
    cells[cell_of(g, s.W, s.mask_cells, s.cells_w, blockIdx.y)] =
        Cell{0, -1, INT_MAX, -1};
}

// one thread per (mask, tile, block on the tile's top row or left column):
// step 2.  Each link to a touching neighbour block in another tile unites
// the two blocks' labels (local roots, or ancestors of them).
__global__ void __launch_bounds__(kThreads)
cc_border(const uint8_t* __restrict__ mask, int* label, Shape s,
          long total) {
  const long t = (long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int slot = (int)(t % kBorder);
  const long tn = t / kBorder;
  const int tile = (int)(tn % s.tiles), n = (int)(tn / s.tiles);
  const int ty = tile / s.tiles_x, tx = tile - ty * s.tiles_x;
  const int y0 = ty * kTileH, x0 = tx * kTileW;
  // slots 0 .. kBlocksW-1: the top row; then the left column below it
  const int by = slot < kBlocksW ? 0 : slot - kBlocksW + 1;
  const int y = y0 + 2 * by, x = x0 + 2 * (slot < kBlocksW ? slot : 0);
  const bool top = by == 0 && y0 > 0, left = x == x0 && x0 > 0;
  const int H = s.H, W = s.W;
  if (y >= H || x >= W || !(top || left)) return;
  const size_t off = (size_t)n * H * W;
  const uint8_t* m = mask + off;
  const int bits = block_bits(m, H, W, y, x);
  if (!bits) return;
  int* parent = label + off;
  const int me = parent[first_pixel(bits, y, x, W)];
  int nb;
  if (left && joins_w(bits, nb = block_bits(m, H, W, y, x - 2)))
    unite(parent, me, parent[first_pixel(nb, y, x - 2, W)]);
  if (top && joins_n(bits, nb = block_bits(m, H, W, y - 2, x)))
    unite(parent, me, parent[first_pixel(nb, y - 2, x, W)]);
  if (y >= 2 && x >= 2 &&
      joins_nw(bits, nb = block_bits(m, H, W, y - 2, x - 2)))
    unite(parent, me, parent[first_pixel(nb, y - 2, x - 2, W)]);
  if (top && x + 2 < W &&
      joins_ne(bits, nb = block_bits(m, H, W, y - 2, x + 2)))
    unite(parent, me, parent[first_pixel(nb, y - 2, x + 2, W)]);
  // the south-west block's north-east link, unless that block sits on a
  // tile's top row itself (then it makes the link)
  if (left && by + 1 < kBlocksH && y + 2 < H &&
      joins_sw(bits, nb = block_bits(m, H, W, y + 2, x - 2)))
    unite(parent, me, parent[first_pixel(nb, y + 2, x - 2, W)]);
}

// grid (tiles, N): step 3, and (kStats) the tile's share of each root's
// statistics
template <bool kStats>
__global__ void __launch_bounds__(kThreads)
cc_finish(const uint8_t* __restrict__ mask, int* label,
          Cell* __restrict__ cells, Shape s) {
  __shared__ int par[kTile];
  __shared__ uint8_t bits_s[kThreads];
  __shared__ int run_s[kThreads];
  __shared__ int root_s[kThreads];  // global root, at local roots' blocks
  __shared__ int st[kStats ? 4 : 1][kThreads];  // area, ymax, xmin, xmax
  const TilePos tp = tile_pos(s);
  const size_t off = (size_t)blockIdx.y * s.H * s.W;
  const int t = threadIdx.x;
  const TileNode tn = label_tile(block_bits(mask + off, s.H, s.W, tp.y, tp.x),
                                 par, bits_s, run_s);
  const bool local_root = tn.bits && tn.root == tn.node;
  if (local_root) {
    // other blocks write roots into this map meanwhile: still ancestors
    root_s[t] = find_root(label + off, (tp.y0 + tn.node / kTileW) * s.W +
                                           tp.x0 + tn.node % kTileW);
    if constexpr (kStats) {
      st[0][t] = 0;
      st[1][t] = -1;
      st[2][t] = INT_MAX;
      st[3][t] = -1;
    }
  }
  __syncthreads();
  // the block holding the piece's root
  const int rb = tn.bits ? (tn.root / kTileW / 2) * kBlocksW +
                               tn.root % kTileW / 2
                         : -1;
  const int y = tp.y, x = tp.x;
  if (y < s.H && x < s.W)
    store_block(label + off, s, y, x, tn.bits, rb < 0 ? -1 : root_s[rb]);
  if constexpr (kStats) {
    // the block's share: its set pixels, their last row, first and last
    // column; a warp whose blocks all lie in one piece (the common case
    // inside a blob) adds one value per statistic
    const int area = __popc(tn.bits);
    const int ymax = y + ((tn.bits & 12) ? 1 : 0);
    const int xmin = x + ((tn.bits & 5) ? 0 : 1);
    const int xmax = x + ((tn.bits & 10) ? 1 : 0);
    const unsigned full = 0xffffffffu;
    const int r0 = __shfl_sync(full, rb, 0);
    if (__all_sync(full, rb == r0)) {
      const int a = __reduce_add_sync(full, area);
      const int y1 = __reduce_max_sync(full, ymax);
      const int xa = __reduce_min_sync(full, xmin);
      const int xb = __reduce_max_sync(full, xmax);
      if (r0 >= 0 && (t & 31) == 0) {
        atomicAdd(&st[0][r0], a);
        atomicMax(&st[1][r0], y1);
        atomicMin(&st[2][r0], xa);
        atomicMax(&st[3][r0], xb);
      }
    } else if (rb >= 0) {
      atomicAdd(&st[0][rb], area);
      atomicMax(&st[1][rb], ymax);
      atomicMin(&st[2][rb], xmin);
      atomicMax(&st[3][rb], xmax);
    }
    __syncthreads();
    if (local_root) {
      Cell* c = cells + cell_of(root_s[t], s.W, s.mask_cells, s.cells_w,
                                blockIdx.y);
      atomicAdd(&c->area, st[0][t]);
      atomicMax(&c->ymax, st[1][t]);
      atomicMin(&c->xmin, st[2][t]);
      atomicMax(&c->xmax, st[3][t]);
    }
  }
}

// four pixels per thread: the keep rule at each pixel's root.  The four
// may straddle masks (H * W % 4 != 0), and roots are indices within one
// mask, so the cached decision is dropped at a mask's start.
__global__ void __launch_bounds__(kThreads)
cc_keep(const int* __restrict__ label, const Cell* __restrict__ cells,
        uint8_t* __restrict__ out, Shape s, long total, int min_area,
        float min_aspect) {
  const long base = ((long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (base >= total) return;
  const int hw = s.H * s.W;
  int r[4];
  if (base + 4 <= total) {
    const int4 v = *reinterpret_cast<const int4*>(label + base);
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  } else {
    for (int j = 0; j < 4; ++j) r[j] = base + j < total ? label[base + j] : -1;
  }
  uint8_t o[4];
  int n = (int)(base / hw), at = (int)(base - (long)n * hw);  // mask, pixel
  int last = -1;  // the root, in mask n, whose decision is cached
  uint8_t last_keep = 0;
  for (int j = 0; j < 4; ++j, ++at) {
    if (at == hw) {
      at = 0;
      ++n;
      last = -1;
    }
    const int root = r[j];
    if (root < 0) {
      o[j] = 0;
      continue;
    }
    if (root != last) {
      const Cell c = cells[cell_of(root, s.W, s.mask_cells, s.cells_w, n)];
      const float ww = (float)(c.xmax - c.xmin + 1);
      const float hh = (float)(c.ymax - root / s.W + 1);
      const float aspect = fmaxf(ww, hh) / (fminf(ww, hh) + 1e-5f);
      last = root;
      last_keep = (c.area > min_area) || (aspect > min_aspect);
    }
    o[j] = last_keep;
  }
  if (base + 4 <= total) {
    *reinterpret_cast<uchar4*>(out + base) = make_uchar4(o[0], o[1], o[2],
                                                         o[3]);
  } else {
    for (int j = 0; j < 4 && base + j < total; ++j) out[base + j] = o[j];
  }
}

Shape shape_of(int H, int W) {
  const int tiles_x = (W + kTileW - 1) / kTileW, cells_w = (W + 1) / 2;
  return Shape{H, W, tiles_x, tiles_x * ((H + kTileH - 1) / kTileH), cells_w,
               (size_t)((H + 1) / 2) * cells_w};
}

// steps 1-3 (with cells: also the statistics)
cudaError_t label_components(const uint8_t* mask, int* label, Cell* cells,
                             int N, int H, int W, cudaStream_t stream) {
  const Shape s = shape_of(H, W);
  const dim3 grid(s.tiles, N);
  cc_local<<<grid, kThreads, 0, stream>>>(mask, label, cells, s);
  const long border = (long)N * s.tiles * kBorder;
  cc_border<<<(unsigned)((border + kThreads - 1) / kThreads), kThreads, 0,
              stream>>>(mask, label, s, border);
  if (cells == nullptr)
    cc_finish<false><<<grid, kThreads, 0, stream>>>(mask, label, cells, s);
  else
    cc_finish<true><<<grid, kThreads, 0, stream>>>(mask, label, cells, s);
  return cudaGetLastError();
}

bool shape_ok(int N, int H, int W) {
  return N >= 1 && H >= 1 && W >= 1 && (long long)H * W <= INT_MAX / 2 &&
         N <= 65535 && (long long)((H + kTileH - 1) / kTileH) *
                               ((W + kTileW - 1) / kTileW) <= INT_MAX;
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
  if (!shape_ok(N, H, W)) return (int)cudaErrorInvalidValue;
  return (int)label_components(static_cast<const uint8_t*>(mask),
                               static_cast<int*>(labels), nullptr, N, H, W,
                               static_cast<cudaStream_t>(stream));
}

// the arguments, packed by _kernels.py (struct format "PPPPiiiifP");
// cells: int32 (N, ceil(H/2), ceil(W/2), 4) scratch, labels: int32
// (N, H, W) scratch
struct CleanArgs {
  const void* mask;
  void *out, *labels, *cells;
  int N, H, W, min_area;
  float min_aspect;
  void* stream;
};

IK_EXPORT int ik_clean_components(const CleanArgs* args) {
  const auto [mask, out, labels, cells, N, H, W, min_area, min_aspect,
              stream] = *args;
  if (!shape_ok(N, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* lab = static_cast<int*>(labels);
  Cell* c = static_cast<Cell*>(cells);
  cudaError_t err = label_components(static_cast<const uint8_t*>(mask), lab,
                                     c, N, H, W, st);
  if (err != cudaSuccess) return (int)err;
  const long total = (long)N * H * W;
  const long threads = (total + 3) / 4;
  cc_keep<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
            st>>>(lab, c, static_cast<uint8_t*>(out), shape_of(H, W), total,
                  min_area, min_aspect);
  return (int)cudaGetLastError();
}
