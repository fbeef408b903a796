// K5  vmem_attention: non-causal split-head attention on contiguous
// [B, H, N, D] q, k, v with a [B, N] key-padding mask; no rope.
//
// Replaces: lemas_tts_tpu/ops/attention.py:vmem_attention (Pallas
//   _vmem_attn_kernel, attention.py:96-119, pallas_call at :162), which held
//   one (batch, head)'s whole K/V in TPU VMEM and ran a one-shot softmax per
//   q block: scores (q . k^T) * (1/sqrt(D)) in f32 after the product, padded
//   keys -1e30, p = exp(s - max) with no floor, P V in the compute dtype of
//   the unnormalised p, / l last. It serves the DiT blocks with qk_norm or
//   pe_attn_head and the MMDiT's joint attention.
// Bound on the H100: at rows 2, N = 1280, 16 x 64 heads (the MMDiT's joint
//   sequence) the call does 13.4 GFLOP against about 21 MB, ~640 FLOP/byte:
//   the tensor cores bound it in principle; as in K3, each warpgroup waits
//   on its f32 softmax (MUFU exp2) between the two products, and the other
//   warpgroups' products fill the tensor cores meanwhile.
// bf16 (the main path), attention_bhnd.cuh on attention_sm90.cuh: K3's
//   Hopper design without the rope. A block is WGS consumer warpgroups of 64 query rows and one
//   producer warp. The producer issues TMA loads of the block's q boxes once
//   and of each 64-key tile's K and V boxes into a ring of ST stages,
//   completing on mbarriers; q, k and v are read in place as [B*H, N, D]
//   (3-D maps, a d128 head is two 64-column boxes) and rows past N in each
//   (batch, head) read as zeros. Its 32 lanes also write the tile's 64 key
//   bytes (kept, padded, or beyond N) with plain loads of the mask: a TMA map
//   of the [B, N] mask needs N % 16 == 0, and this way every N and a null
//   mask take one path. Each consumer warpgroup runs S = Q K^T with wgmma (A
//   and B from shared memory), the softmax in registers with the scale
//   applied to the f32 scores after the product (folded into the exp2
//   factor, 1/sqrt(D) log2 e), padded keys -1e30, keys beyond N -inf (p = 0
//   exactly, so a row whose keys are all padded gets the mean of v), the
//   running max from -inf, then O += P V with wgmma (P from registers, V as
//   stored, transpose bit set), releases the stage, and stores only rows
//   below N. One block per (64 WGS query rows, head, batch row): at d64 four
//   warpgroups and one block an SM, or two and two blocks an SM where the
//   grid of fours would spill into a second wave (bhnd_four_warpgroups).
// f32 (the checking path; wgmma has no full-precision f32 mode),
//   attention.cuh: the first flash-style forward, on this layout. One block
//   per (64-query tile, head, batch row), four warps of 16 query rows; 64-key
//   tiles of k and v staged in shared memory, products in exact f32 FMAs in
//   the mma.sync register layout; the same rounding points, the same rules
//   for padded keys, keys beyond N and the starting max as the bf16 kernel.
//   The head dim is a template parameter: 64 and 128.
#include "attention_bhnd.cuh"

// Split of the d64 bf16 kernel: one block of four warpgroups (256 query rows)
// an SM where the grid fits in one wave, as at rows 2 x 16 heads, N 1024 (128
// blocks on 132 SMs); else two blocks of two (128 rows) an SM, whose second
// wave is half as long, as at N 1280 (320 blocks on 264 slots, where blocks
// of four would need two full waves). On the card the first is the faster
// per query tile, which is why it is not used everywhere.
static bool bhnd_four_warpgroups(int device, int batch, int heads, int n) {
  return (long long)batch * heads * ((n + 255) / 256) <= sm90::sm_count(device);
}

// device: the CUDA device of the tensors (this library links its own CUDA
// runtime). mask may be null (every key kept). sm_scale is 1/sqrt(dim_head)
// rounded to f32 by the caller. dim_head 64 or 128; any n >= 1. bf16 runs the
// sm_90a kernel with the scores taken into the log2 domain by sm_scale
// log2 e; f32 the checking path.
extern "C" int lemas_attention_bhnd(int device, int dtype, int dim_head, const void* q,
                                    const void* k, const void* v, const void* mask, void* out,
                                    int batch, int n, int heads, float sm_scale, void* stream) {
  if (dim_head != 64 && dim_head != 128) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    const float factor = sm_scale * sm90::kLog2e;
    if (dim_head == 128)
      return launch_bhnd_sm90<128, 2, 1>(q, k, v, mask, out, batch, n, heads, factor, s);
    return bhnd_four_warpgroups(device, batch, heads, n)
               ? launch_bhnd_sm90<64, 4, 1>(q, k, v, mask, out, batch, n, heads, factor, s)
               : launch_bhnd_sm90<64, 2, 2>(q, k, v, mask, out, batch, n, heads, factor, s);
  }
  return dim_head == 64
             ? launch_bhnd_f32<64, false>(q, k, v, mask, out, batch, n, heads, sm_scale, 1.f, s)
             : launch_bhnd_f32<128, false>(q, k, v, mask, out, batch, n, heads, sm_scale, 1.f,
                                           s);
}
