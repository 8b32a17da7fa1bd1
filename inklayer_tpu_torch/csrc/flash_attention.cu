// Softmax attention with no bias, for (BH, N, D) bf16 q, k, v and head_dim
// 40, 64 or 80:
//   out[t] = softmax_u(scale * q_t . k_u) @ v
// Callers: DINOv2 ViT-B in the depth model (BH = 12, N = 1370, D = 64) and
// the self-attention of the SD1.5 UNet and ControlNet on the inpaint path
// (N = 9216 at D = 40, N = 2304 at D = 80 for a 768^2 image; BH = 2 * 8
// per sample with classifier-free guidance).
//
// Replaces the TPU kernel inklayer_tpu/ops/attention.py _flash_kernel
// (flash_attention without rel_h/rel_w).  That kernel keeps one head's
// whole K and V in VMEM, masks the padded tail keys (nk_valid) and takes a
// full-row softmax.  One head's K and V at 1370 tokens are 175 KB each and
// do not both fit in 227 KB of shared memory (at 9216 tokens they are
// 737 KB each), so this kernel walks 64-key tiles with an fp32 online
// softmax instead; the tail of the last tile (1370 = 21 * 64 + 26) is
// masked to -inf.  The loop is the one of the SAM rel-pos kernel
// (attention_tile.cuh) with the rel terms compiled out.  Head dim 40 runs
// with the tiles padded to 48 columns of which the last 8 are zero.
//
// Bound on the H100: tensor-core throughput in principle (the UNet's
// level-0 call, 4 * 16 * 9216^2 * 40 = 217 GFLOP, against 47 MB of q, k,
// v, out); in this first version the shared-memory round trips of the
// logits and the output accumulator that WMMA's opaque fragments force, as
// in the rel-pos kernel.
#include "attention_tile.cuh"

IK_EXPORT int ik_flash_attention(const void* q, const void* k, const void* v,
                                 void* out, int BH, int N, int D, float scale,
                                 void* stream) {
  if (BH < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return launch_attention<40, false>(q, k, v, nullptr, nullptr, out, BH,
                                         N, 1, 1, scale, s);
    case 64:
      return launch_attention<64, false>(q, k, v, nullptr, nullptr, out, BH,
                                         N, 1, 1, scale, s);
    case 80:
      return launch_attention<80, false>(q, k, v, nullptr, nullptr, out, BH,
                                         N, 1, 1, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
