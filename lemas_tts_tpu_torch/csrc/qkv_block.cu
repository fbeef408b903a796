// K1  qkv_block: LN -> AdaLN modulation -> q/k/v projections.
//
// Replaces: lemas_tts_tpu/ops/ffn.py:qkv_block (Pallas _qkv_block_kernel,
//   ffn.py:64-87), which kept all three [D, I] weights resident in 9 MB of
//   TPU VMEM and projected one 256-row block at a time.
// Bound on the H100: at the flagship shape (rows 2B*N = 2048, D = I = 1024)
//   the call does 12.9 GFLOP against about 23 MB of traffic (x, the three
//   weights, q, k, v), ~560 FLOP/byte, above the card's ~295 FLOP/byte
//   ridge: the tensor cores bound it, at 0.013 ms.
// Design: an H100 block has at most 227 KB of shared memory, so the weights
//   are tiled, not resident. One GEMM launch runs over the 3I output columns
//   of q | k | v, each 64-column B box loaded by TMA through the tensor map
//   of the weight it lies in (I % 64 == 0), so no concatenated copy is made;
//   the epilogue rounds, adds the bias and writes q, k, v in the flat
//   [B, N, H*D] layout the attention kernel reads.
// bf16 (the main path), gemm_sm90.cuh: wgmma and TMA, one producer warp and
//   two consumer warpgroups a block, 128-row tiles of kTileN = 192 columns
//   (columns past 3I are masked, so it takes every I % 128). The LN-modulate
//   takes one of two forms, with the same values and rounding points
//   (bit-identical q, k, v):
//   ln_pass = 1  ln_mod_kernel writes m in bf16 once ([rows, D] scratch from
//                the caller), then the GEMM reads m without a prologue;
//   ln_pass = 0  ln_stats_kernel writes each row's mean and rstd ([rows, 2]
//                f32 scratch), then every column tile modulates its landed x
//                boxes in shared memory (K2's up-projection).
//   chip_smoke.py times both. On an H100 80GB HBM3 at 700 W at the flagship
//   shape the pass took the least card time (about 0.040 ms against 0.049
//   for the prologue, whose 3I / kTileN column tiles each re-transform the
//   same rows), and ops/ffn.py defaults to it. Of the tile widths 128, 192
//   and 256, measured the same way with either form, 192 was the fastest
//   (PERF.md). Its GEMM loads 40 KB by TMA per 64-deep stage of a tile,
//   168 MB in all, which in its ~0.033 ms is ~5 TB/s from L2: the operand
//   bytes per FLOP of a 128 x 192 tile, not the tensor cores, look to bound
//   it (PERF.md).
// f32 (the checking path; wgmma has no full-precision f32 mode),
//   ln_mod_gemm.cuh: the mma.sync GEMM with exact f32 FMAs over the same
//   3I columns, its LN statistics computed by every column-tile block.
#include "gemm_sm90.cuh"
#include "ln_mod_gemm.cuh"

namespace {
constexpr int kStages = 4;
constexpr int kTileN = 192;

int qkv_block_sm90(const void* x, const void* scale, const void* shift, const void* const w[3],
                   const void* const b[3], void* const out[3], void* scratch, int rows, int seq,
                   int d, int inner, bool ln_pass, cudaStream_t s) {
  sm90::GemmMaps maps;
  sm90::GemmArgs p = {};
  cudaError_t err = cudaSuccess;
  for (int j = 0; j < 3; ++j) {
    if (err == cudaSuccess) err = sm90::box_map(&maps.b[j], w[j], inner, d);
    p.bias[j] = static_cast<const bf16*>(b[j]);
    p.out[j] = static_cast<bf16*>(out[j]);
  }
  p.rows = rows;
  p.seq = seq;
  p.K = d;
  p.wcols = inner;
  const bf16* xb = static_cast<const bf16*>(x);
  if (ln_pass) {
    if (err == cudaSuccess) err = sm90::box_map(&maps.a, scratch, rows, d);
    if (err != cudaSuccess) return (int)err;
    sm90::ln_mod_kernel<<<(rows + 7) / 8, 256, 0, s>>>(
        xb, static_cast<const bf16*>(scale), static_cast<const bf16*>(shift),
        static_cast<bf16*>(scratch), rows, seq, d);
  } else {
    const int batch = rows / seq;
    if (err == cudaSuccess) err = sm90::box_map(&maps.a, x, rows, d);
    // 64 columns of two batch rows, unswizzled (a tile straddles at most two)
    if (err == cudaSuccess)
      err = sm90::map_2d(&maps.scale, scale, batch, d, 2, sm90::kBox,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess)
      err = sm90::map_2d(&maps.shift, shift, batch, d, 2, sm90::kBox,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return (int)err;
    p.stats = static_cast<const float2*>(scratch);
    sm90::ln_stats_kernel<<<(rows + 7) / 8, 256, 0, s>>>(xb, static_cast<float2*>(scratch),
                                                         rows, d);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (ln_pass)
    return (int)sm90::launch_gemm_sm90<kTileN, kStages, false, sm90::kEpiBias>(maps, p, s);
  return (int)sm90::launch_gemm_sm90<kTileN, kStages, true, sm90::kEpiBias>(maps, p, s);
}
}  // namespace

// device: the CUDA device of the tensors (this library links its own CUDA
// runtime, whose current device is not PyTorch's). scratch is the bf16
// kernel's LN-modulate scratch: m [rows, d] bf16 with ln_pass, else the
// [rows, 2] f32 mean and rstd. f32 reads neither (scratch may be null).
extern "C" int lemas_qkv_block(int device, int dtype, const void* x, const void* scale,
                               const void* shift, const void* wq, const void* bq,
                               const void* wk, const void* bk, const void* wv, const void* bv,
                               void* q, void* k, void* v, void* scratch, int rows, int seq,
                               int d, int inner, int ln_pass, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* const w[3] = {wq, wk, wv};
  const void* const b[3] = {bq, bk, bv};
  void* const out[3] = {q, k, v};
  if (dtype == kBF16)
    return qkv_block_sm90(x, scale, shift, w, b, out, scratch, rows, seq, d, inner, ln_pass != 0,
                          s);
  GemmArgs p = {};
  p.a = x;
  p.scale = scale;
  p.shift = shift;
  for (int j = 0; j < 3; ++j) {
    p.w[j] = w[j];
    p.bias[j] = b[j];
    p.out[j] = out[j];
  }
  p.rows = rows;
  p.seq = seq;
  p.K = d;
  p.Nw = inner;
  return (int)launch_ln_mod_gemm<float, true, kEpiBias>(p, 3 * inner, s);
}
