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
// full-row softmax.  One head's K and V at 9216 tokens are 737 KB each and
// do not fit in 227 KB of shared memory, so this kernel streams 128-key
// tiles through a TMA ring with an fp32 online softmax instead; the tail
// of the last tile (1370 = 10 * 128 + 90) is masked to -inf.  The loop is
// the one of the SAM rel-pos kernel (attention_tile.cuh) with the rel terms
// compiled out.  Head dim 40 runs on boxes padded to 48 columns by TMA's
// zero fill.
//
// Bound on the H100: tensor-core throughput (the UNet's level-0 call,
// 4 * 16 * 9216^2 * 40 = 217 GFLOP, against 47 MB of q, k, v, out), and at
// head dim 40 the exponentials next to it: 16 * 9216^2 = 1.4e9 exp2 at 16
// per clock per SM take about as long as the products.  Both products run
// on wgmma with the softmax in registers between them; the two consumer
// warpgroups of a block overlap one's softmax with the other's products.
#include "attention_tile.cuh"

// the arguments, packed by _kernels.py (struct format "PPPPiiifP")
struct FlashArgs {
  const void *q, *k, *v;
  void* out;
  int BH, N, D;
  float scale;
  void* stream;
};

IK_EXPORT int ik_flash_attention(const FlashArgs* args) {
  const auto [q, k, v, out, BH, N, D, scale, stream] = *args;
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

// Dynamic shared memory of the attention kernel instance at head dim D,
// with (rel != 0) or without the rel terms, in bytes; 0 for no instance.
IK_EXPORT int ik_attention_smem_bytes(int D, int rel) {
  switch (D * 2 + (rel != 0)) {
    case 80: return Smem<40, false>::alloc;
    case 128: return Smem<64, false>::alloc;
    case 129: return Smem<64, true>::alloc;
    case 160: return Smem<80, false>::alloc;
    case 161: return Smem<80, true>::alloc;
    default: return 0;
  }
}
