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
// Bound on the H100: at rows 2, 16 x 64 heads, N 1024 8.6 GFLOP of visible
//   (query, key) pairs against ~17 MB, so the tensor cores bound it in
//   principle; at d64 the MUFU exp2 of a score tile takes as long as its two
//   products, so the softmax has to overlap the products.
// Design: bf16 (the main path, sm_90a) is attention_splash_sm90.cuh, a kernel
//   of its own (its header says how it is built): 128-key tiles in a TMA
//   ring, a producer warpgroup that gives its registers to two consumer
//   warpgroups (setmaxnreg), ping-pong between the consumers on named
//   barriers, S of the next tile issued before the softmax of this one, and
//   key tiles that no row of the block can see skipped. q is scaled in
//   shared memory and rounded to bf16; a key's byte is its segment, compared
//   with the row's only in a tile where the two can differ; the running max
//   starts at -inf and every row sees at least itself, so the result is
//   splash's exact softmax. One rounding point differs: P V runs on the
//   bf16 wgmma, so the unnormalised p (<= 1) is rounded to bf16 where splash
//   keeps it in f32 (a relative 2^-9 on each p, well inside the bf16 bar of
//   rel-L2 2e-2; ops/attention.py:splash_attention_plain keeps splash's f32
//   P V). f32 (the checking path): attention_bhnd.cuh's mma.sync-layout
//   kernel with SEG set, exact f32 FMAs, q scaled in shared memory, the same
//   segment rule; its rounding points are splash's.
#include "attention_bhnd.cuh"
#include "attention_splash_sm90.cuh"

// device: the CUDA device of the tensors (this library links its own CUDA
// runtime). mask may be null (one segment: full attention). q_scale is
// 1/sqrt(dim_head) rounded to q's dtype by the caller (as JAX's weakly typed
// scale is). dim_head 64 or 128; n a multiple of 128 (splash's block).
extern "C" int lemas_attention_splash(int device, int dtype, int dim_head, const void* q,
                                      const void* k, const void* v, const void* mask, void* out,
                                      int batch, int n, int heads, float q_scale, void* stream) {
  if (n % splash::kKeys != 0 || (dim_head != 64 && dim_head != 128))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return dim_head == 64 ? splash::launch_splash_sm90<64>(device, q, k, v, mask, out, batch, n,
                                                           heads, q_scale, s)
                          : splash::launch_splash_sm90<128>(device, q, k, v, mask, out, batch,
                                                            n, heads, q_scale, s);
  return dim_head == 64
             ? launch_bhnd_f32<64, true>(q, k, v, mask, out, batch, n, heads, 1.f, q_scale, s)
             : launch_bhnd_f32<128, true>(q, k, v, mask, out, batch, n, heads, 1.f, q_scale, s);
}
