// Softmax attention with no bias, for (BH, N, D) bf16 q, k, v and head_dim
// 64 (DINOv2 ViT-B in the depth model: BH = 12, N = 1370):
//   out[t] = softmax_u(scale * q_t . k_u) @ v
//
// Replaces the TPU kernel inklayer_tpu/ops/attention.py _flash_kernel
// (flash_attention without rel_h/rel_w).  That kernel keeps one head's
// whole K and V in VMEM, masks the padded tail keys (nk_valid) and takes a
// full-row softmax.  One head's K and V at 1370 tokens are 175 KB each and
// do not both fit in 227 KB of shared memory, so this kernel walks 64-key
// tiles with an fp32 online softmax instead; the tail of the last tile
// (1370 = 21 * 64 + 26) is masked to -inf.  The loop is the one of the
// SAM rel-pos kernel (attention_tile.cuh) with the rel terms compiled out.
//
// Bound on the H100: tensor-core throughput in principle (2 * 2 * 12 *
// 1370^2 * 64 = 5.8 GFLOP against 9 MB of q, k, v, out); in this first
// version the shared-memory round trips of the logits and the output
// accumulator that WMMA's opaque fragments force, as in the rel-pos kernel.
#include "attention_tile.cuh"

IK_EXPORT int ik_flash_attention(const void* q, const void* k, const void* v,
                                 void* out, int BH, int N, int D, float scale,
                                 void* stream) {
  if (BH < 1 || N < 1 || D != 64) return (int)cudaErrorInvalidValue;
  return launch_attention<64, false>(q, k, v, nullptr, nullptr, out, BH, N,
                                     1, 1, scale,
                                     static_cast<cudaStream_t>(stream));
}
