// SAM attention with the decomposed relative-position bias:
//   logits[t, u] = scale * q_t . k_u + rel_h[t, u / kw] + rel_w[t, u % kw]
//   out[t]       = softmax_u(logits[t]) @ v
// for q, k, v of shape (BH, N, D) with N == kh * kw.
//
// Replaces the TPU kernels inklayer_tpu/ops/attention.py:
// _window_block_kernel / _window_band_body (sam_window_block_attention:
// 14x14 windows, 196 tokens) and _global_aug_kernel (sam_global_attention2:
// 4096 tokens), and covers _global_relpos_kernel (sam_global_attention, any
// kh/kw), _window_relpos_kernel (sam_window_attention) and
// _flash_relpos_kernel (flash_attention with rel_h/rel_w).  One kernel
// serves all of them: windows are a batch of BH = windows * heads.
//
// Bound on the H100: tensor-core throughput — the global form is
// 2 * 2 * 16 * 4096^2 * 80 = 86 GFLOP per call against 42 MB of q, k, v,
// out — with the exponentials and the two rel-term reads per logit beside
// it.  The TPU kernel kept one head's whole K/V (1.3 MB) in VMEM and took
// a full-row softmax; that does not fit in 227 KB of shared memory, so
// this kernel streams 128-key tiles with an online softmax in fp32 (the
// loop of attention_tile.cuh: wgmma products, softmax in registers, a TMA
// ring).  The rel terms of the block's 128 queries are staged once in
// shared memory and added to the logits in the softmax, so the (N, N) bias
// never exists.
#include "attention_tile.cuh"

// the arguments, packed by _kernels.py (struct format "PPPPPPiiiiifP")
struct RelposArgs {
  const void *q, *k, *v, *rel_h, *rel_w;
  void* out;
  int BH, N, D, kh, kw;
  float scale;
  void* stream;
};

IK_EXPORT int ik_relpos_attention(const RelposArgs* args) {
  const auto [q, k, v, rel_h, rel_w, out, BH, N, D, kh, kw, scale, stream] =
      *args;
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
