// SAM attention with the decomposed relative-position bias:
//   logits[t, u] = scale * q_t . k_u + rel_h[t, u / kw] + rel_w[t, u % kw]
//   out[t]       = softmax_u(logits[t]) @ v
// for q, k, v of shape (BH, N, D) with N == kh * kw.
//
// Replaces the TPU kernels inklayer_tpu/ops/attention.py:
// _window_block_kernel / _window_band_body (sam_window_block_attention:
// 14x14 windows, 196 tokens) and _global_aug_kernel (sam_global_attention2:
// 4096 tokens), and covers _global_relpos_kernel (sam_global_attention, any
// kh/kw) and _window_relpos_kernel (sam_window_attention).  One kernel
// serves all of them: windows are a batch of BH = windows * heads.
//
// Bound on the H100: tensor-core throughput in principle — the global form
// is 2 * 2 * 16 * 4096^2 * 80 = 86 GFLOP per call against 42 MB of q, k,
// v, out — and in this first version the shared-memory round trips of the
// logits and of the output accumulator, which the softmax needs because
// WMMA fragments give no element access.  The TPU kernel kept one head's
// whole K/V (1.3 MB) in VMEM and took a full-row softmax; that does not
// fit in 227 KB of shared memory, so this kernel is flash-style: one block
// per (bh, 64-query tile) walks 64-key tiles with an online softmax in
// fp32.  QK^T and PV are WMMA bf16 16x16x16 products with fp32
// accumulators; each of the 4 warps owns 16 query rows.  The rel terms of
// the block's queries are staged once in shared memory and added to the
// logits in the softmax pass, so the (N, N) bias never exists.  The loop
// lives in attention_tile.cuh and is shared with flash_attention.cu
// (kRel = false there).
#include "attention_tile.cuh"

IK_EXPORT int ik_relpos_attention(const void* q, const void* k, const void* v,
                                  const void* rel_h, const void* rel_w,
                                  void* out, int BH, int N, int D, int kh,
                                  int kw, float scale, void* stream) {
  if (kh < 1 || kw < 1 || kh > kMaxRel || kw > kMaxRel || kh * kw != N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_attention<64, true>(q, k, v, rel_h, rel_w, out, BH, N,
                                        kh, kw, scale, s);
    case 80:
      return launch_attention<80, true>(q, k, v, rel_h, rel_w, out, BH, N,
                                        kh, kw, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
