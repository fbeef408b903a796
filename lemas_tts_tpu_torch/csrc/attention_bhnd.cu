// K5  vmem_attention: non-causal split-head attention on contiguous
// [B, H, N, D] q, k, v with a [B, N] key-padding mask; no rope.
//
// Replaces: lemas_tts_tpu/ops/attention.py:vmem_attention (Pallas
//   _vmem_attn_kernel, attention.py:96-119, pallas_call at :162), which held
//   one (batch, head)'s whole K/V in TPU VMEM and ran a one-shot softmax per
//   q block: scores (q . k^T) * (1/sqrt(D)) in f32 after the product, padded
//   keys -1e30, p = exp(s - max) with no floor, P V in the compute dtype of
//   the unnormalised p, / l last. It serves the DiT blocks with qk_norm or
//   pe_attn_head, the MMDiT's joint attention and the UNetT (at N + 1).
// Bound on the H100: at rows 2, N = 1280, 16 x 64 heads (the MMDiT's joint
//   sequence) the call does 13.4 GFLOP against about 21 MB, ~640 FLOP/byte:
//   the tensor cores bound it in principle; but at d64 a 64 x 128 score
//   tile's exp2 (MUFU, 16 a clock an SM) takes as long as its two products,
//   so the softmax of one tile has to run while products run. At a ragged N
//   (the UNetT's N + 1: 1025, 1537) two more costs stand in the way: a tail
//   of a few query rows a (batch row, head), which one block a tile would
//   spill into a second wave, and a key tail, mostly padding there, as are
//   the 12-17 % of keys past each request's frames.
// bf16 (the main path), attention_bhnd.cuh on attention_splash_sm90.cuh:
//   K6's Hopper design with K5's function. A persistent grid of
//   min(items, SMs) blocks walks items of 128 query rows of one (batch row,
//   head), whole tiles first and the ragged tails last; a producer
//   warpgroup (setmaxnreg 40) issues TMA copies of q and of 128-key K and V
//   tiles into a ring; two consumer warpgroups of 64 rows (setmaxnreg 232)
//   issue S of tile j before P V of tile j - 1 and take turns on named
//   barriers, so one's softmax runs under the other's products. Where no row
//   of the second warpgroup is below n it issues nothing (a tail item runs
//   on one warpgroup at its own pace). The scale follows the product
//   (folded into the exp2 factor, 1/sqrt(D) log2 e); a padded key scores
//   -1e30, a key beyond n -inf (p = 0 exactly), the running max starts at
//   -inf, so a row whose keys are all padded gets the mean of v; rows past
//   n are not stored. Key tiles whose keys below n are all padded are
//   skipped in a batch row with a kept key (their p is 0 exactly there), from
//   tile classes the block works out of the mask itself (no host sync: the
//   call sits in a CUDA graph); a tile of kept keys only takes no compare.
// f32 (the checking path; wgmma has no full-precision f32 mode),
//   attention.cuh: the first flash-style forward, on this layout. One block
//   per (64-query tile, head, batch row), four warps of 16 query rows; 64-key
//   tiles of k and v staged in shared memory, products in exact f32 FMAs in
//   the mma.sync register layout; the same rounding points, the same rules
//   for padded keys, keys beyond N and the starting max as the bf16 kernel.
//   The head dim is a template parameter: 64 and 128.
#include "attention_bhnd.cuh"

// device: the CUDA device of the tensors (this library links its own CUDA
// runtime). mask may be null (every key kept). sm_scale is 1/sqrt(dim_head)
// rounded to f32 by the caller. dim_head 64 or 128; any n >= 1. bf16 runs the
// sm_90a kernel with the scores taken into the log2 domain by sm_scale
// log2 e; f32 the checking path. counts may be null; where it is not, the
// bf16 kernel adds to its two u64 the key tiles its items walked and the key
// tiles of those items (the f32 path takes none).
extern "C" int lemas_attention_bhnd(int device, int dtype, int dim_head, const void* q,
                                    const void* k, const void* v, const void* mask, void* out,
                                    int batch, int n, int heads, float sm_scale, void* counts,
                                    void* stream) {
  if (dim_head != 64 && dim_head != 128) return (int)cudaErrorInvalidValue;
  if (dtype != kBF16 && counts != nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    const float factor = sm_scale * sm90::kLog2e;
    unsigned long long* c = static_cast<unsigned long long*>(counts);
    return dim_head == 64
               ? launch_bhnd_sm90<64>(device, q, k, v, mask, out, batch, n, heads, factor, c, s)
               : launch_bhnd_sm90<128>(device, q, k, v, mask, out, batch, n, heads, factor, c,
                                       s);
  }
  return dim_head == 64
             ? launch_bhnd_f32<64, false>(q, k, v, mask, out, batch, n, heads, sm_scale, 1.f, s)
             : launch_bhnd_f32<128, false>(q, k, v, mask, out, batch, n, heads, sm_scale, 1.f,
                                           s);
}
