// K6  splash_attention: non-causal split-head attention on contiguous
// [B, H, N, D] q, k, v with segment ids taken from a [B, N] key mask.
//
// Replaces: lemas_tts_tpu/ops/attention.py:splash_attention (:60-83), which
//   runs JAX's own Pallas TPU kernel, make_splash_mha with a FullMask (its
//   forward pallas_call at jax/experimental/pallas/ops/tpu/splash_attention/
//   splash_attention_kernel.py:1137, body flash_attention_kernel): q is
//   scaled by 1/sqrt(D) and rounded to its dtype before the kernel; segment
//   ids seg = mask (pad 0, valid 1), so query i sees key j iff seg(i) ==
//   seg(j); logits q . k^T in f32, masked with -0.7 f32 max; online softmax
//   in f32 over 128-key blocks; v cast to f32 and P V in f32 (p never
//   rounded); o * (1 / l) cast to q's dtype. N % 128 != 0 goes to XLA sdpa
//   in JAX and to K5 here (ops/attention.py:splash_attention), not to this
//   kernel. It is reached by TTS(attn_backend="splash") on the DiT's and
//   UNetT's split-head chain and the MMDiT's joint attention.
// Bound on the H100: as K5's, at rows 2, 16 x 64 heads, N 1024 8.6 GFLOP
//   against ~13 MB, so the tensor cores bound it in principle; the softmax
//   between the two products (MUFU exp2) is where a warpgroup waits.
// Design: K5's kernels (attention_bhnd.cuh) with SEG set. bf16 (the main
//   path, sm_90a): each consumer warpgroup scales its q boxes in place once
//   they land (a 16-byte chunk a thread a step, then fence.proxy.async and a
//   warpgroup barrier before wgmma reads them); a key's byte is its segment
//   and each thread compares it with the segments of its two query rows, so
//   a pad query attends the pad keys and no key tile is skipped. The running
//   max starts at -inf like K5's; every row sees at least itself, so the
//   result is splash's exact softmax. One rounding point differs: P V runs
//   on the bf16 wgmma, so the unnormalised p (<= 1) is rounded to bf16 where
//   splash keeps it in f32 (a relative 2^-9 on each p, well inside the bf16
//   bar of rel-L2 2e-2; ops/attention.py:splash_attention_plain keeps
//   splash's f32 P V). f32 (the checking path): K5's mma.sync-layout kernel
//   with exact f32 FMAs, q scaled in shared memory, the same segment rule;
//   its rounding points are splash's.
#include "attention_bhnd.cuh"

// device: the CUDA device of the tensors (this library links its own CUDA
// runtime). mask may be null (one segment: full attention). q_scale is
// 1/sqrt(dim_head) rounded to q's dtype by the caller (as JAX's weakly typed
// scale is). dim_head 64 or 128; n a multiple of 128 (splash's block).
extern "C" int lemas_attention_splash(int device, int dtype, int dim_head, const void* q,
                                      const void* k, const void* v, const void* mask, void* out,
                                      int batch, int n, int heads, float q_scale, void* stream) {
  if (n % 128 != 0) return (int)cudaErrorInvalidValue;
  return launch_bhnd<true>(device, dtype, dim_head, q, k, v, mask, out, batch, n, heads, 1.f,
                           q_scale, stream);
}
