// K1  qkv_block: LN -> AdaLN modulation -> q/k/v projections, one launch.
//
// Replaces: lemas_tts_tpu/ops/ffn.py:qkv_block (Pallas _qkv_block_kernel,
//   ffn.py:64-87), which kept all three [D, I] weights resident in 9 MB of
//   TPU VMEM and projected one 256-row block at a time.
// Bound on the H100: at the flagship shape (rows 2B*N = 2048, D = I = 1024)
//   the call does 12.9 GFLOP against about 23 MB of traffic, 560 FLOP/byte,
//   above the card's ~295 FLOP/byte ridge: the tensor cores bound it.
// Design: an H100 block has at most 227 KB of shared memory, so the weights
//   are tiled, not resident. One GEMM runs over the 3*I output columns of
//   the logically concatenated [wq; wk; wv] weight (each 128-column tile
//   lies inside one of the three, so no concatenated copy is made). The LN
//   statistics and the modulation are fused into the A-tile staging, so the
//   normalised activations never reach device memory; the epilogue rounds,
//   adds the bias and writes q, k, v in the flat [B, N, H*D] layout the
//   attention kernel reads. mma.sync bf16 with f32 accumulation; wgmma, TMA
//   and warp specialisation are left for a later pass.
#include "ln_mod_gemm.cuh"

// device: the CUDA device of the tensors (this library links its own CUDA
// runtime, whose current device is not PyTorch's).
extern "C" int lemas_qkv_block(int device, int dtype, const void* x, const void* scale,
                               const void* shift, const void* wq, const void* bq,
                               const void* wk, const void* bk, const void* wv, const void* bv,
                               void* q, void* k, void* v,
                               int rows, int seq, int d, int inner, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  GemmArgs p = {};
  p.a = x;
  p.scale = scale;
  p.shift = shift;
  p.w[0] = wq; p.w[1] = wk; p.w[2] = wv;
  p.bias[0] = bq; p.bias[1] = bk; p.bias[2] = bv;
  p.out[0] = q; p.out[1] = k; p.out[2] = v;
  p.rows = rows;
  p.seq = seq;
  p.K = d;
  p.Nw = inner;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return (int)launch_ln_mod_gemm<bf16, true, kEpiBias>(p, 3 * inner, s);
  return (int)launch_ln_mod_gemm<float, true, kEpiBias>(p, 3 * inner, s);
}
