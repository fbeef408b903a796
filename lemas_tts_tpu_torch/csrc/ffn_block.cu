// K2  ffn_block: x + gate * (GELU_tanh(m W1 + b1) W2 + b2), m = LN-mod(x).
//
// Replaces: lemas_tts_tpu/ops/ffn.py:ffn_block (Pallas _ffn_block_kernel,
//   ffn.py:34-61), which kept W1 and W2 resident in TPU VMEM and carried the
//   [256, F] hidden tile between the two products inside one program.
// Bound on the H100: at rows 2048, D = 1024, F = 2048 the call does
//   17.2 GFLOP against about 17 MB (+17 MB for the hidden round trip below),
//   above the ~295 FLOP/byte ridge: the tensor cores bound it.
// Design: the hidden tile of 128 rows x F is 512 KB at F = 2048, more than a
//   block's 227 KB of shared memory, so the call is two GEMM launches with h
//   in the compute type between them (8 MB at rows 2048, which stays in the
//   50 MB L2). The split costs no accuracy: the Pallas kernel rounds h to the
//   compute type at exactly that point (ffn.py:52-56).
// bf16 (the main path), gemm_sm90.cuh: wgmma and TMA, one producer warp and
//   two consumer warpgroups a block. First a pass of one warp a row writes
//   each row's LayerNorm mean and rstd ([rows] float2 scratch from the
//   caller); then (1) the up-projection, 128 x 256 tiles (128 blocks at rows
//   2048, F 2048: one wave), each landed x box turned into m in shared memory
//   by the LN-modulate prologue, + b1 and tanh-GELU in the epilogue; (2) the
//   down-projection h W2, 128 x 128 tiles (128 blocks at D 1024), + b2 and
//   x + gate * o in the epilogue.
// f32 (the checking path; wgmma has no full-precision f32 mode),
//   ln_mod_gemm.cuh: the mma.sync GEMM with exact f32 FMAs, its LN
//   statistics computed by every column-tile block.
#include "gemm_sm90.cuh"
#include "ln_mod_gemm.cuh"

namespace {
constexpr int kUpBN = 256, kDownBN = 128, kStages = 4;

int ffn_block_sm90(const void* x, const void* scale, const void* shift, const void* gate,
                   const void* w1, const void* b1, const void* w2, const void* b2, void* h,
                   void* stats, void* out, int rows, int seq, int d, int f, cudaStream_t s) {
  const int batch = rows / seq;
  sm90::GemmMaps up_maps, down_maps;
  cudaError_t err = sm90::box_map(&up_maps.a, x, rows, d);
  if (err == cudaSuccess) err = sm90::box_map(&up_maps.b[0], w1, f, d);
  if (err == cudaSuccess) err = sm90::box_map(&down_maps.a, h, rows, f);
  if (err == cudaSuccess) err = sm90::box_map(&down_maps.b[0], w2, d, f);
  // 64 columns of two batch rows, unswizzled (a tile straddles at most two)
  if (err == cudaSuccess)
    err = sm90::map_2d(&up_maps.scale, scale, batch, d, 2, sm90::kBox,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = sm90::map_2d(&up_maps.shift, shift, batch, d, 2, sm90::kBox,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return (int)err;

  sm90::ln_stats_kernel<<<(rows + 7) / 8, 256, 0, s>>>(static_cast<const bf16*>(x),
                                                       static_cast<float2*>(stats), rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  sm90::GemmArgs up = {};
  up.stats = static_cast<const float2*>(stats);
  up.bias[0] = static_cast<const bf16*>(b1);
  up.out[0] = static_cast<bf16*>(h);
  up.rows = rows;
  up.seq = seq;
  up.K = d;
  up.wcols = f;
  err = sm90::launch_gemm_sm90<kUpBN, kStages, true, sm90::kEpiGelu>(up_maps, up, s);
  if (err != cudaSuccess) return (int)err;

  sm90::GemmArgs down = {};
  down.bias[0] = static_cast<const bf16*>(b2);
  down.out[0] = static_cast<bf16*>(out);
  down.resid = static_cast<const bf16*>(x);
  down.gate = static_cast<const bf16*>(gate);
  down.rows = rows;
  down.seq = seq;
  down.K = f;
  down.wcols = d;
  return (int)sm90::launch_gemm_sm90<kDownBN, kStages, false, sm90::kEpiGateRes>(down_maps,
                                                                                 down, s);
}
}  // namespace

// device: the CUDA device of the tensors (this library links its own CUDA
// runtime, whose current device is not PyTorch's). h [rows, f] is the
// hidden scratch of both types; stats [rows, 2] f32 is the LayerNorm scratch
// of the bf16 kernel (unused, may be null, in f32).
extern "C" int lemas_ffn_block(int device, int dtype, const void* x, const void* scale,
                               const void* shift, const void* gate, const void* w1,
                               const void* b1, const void* w2, const void* b2, void* h,
                               void* stats, void* out, int rows, int seq, int d, int f,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return ffn_block_sm90(x, scale, shift, gate, w1, b1, w2, b2, h, stats, out, rows, seq, d, f,
                          s);
  GemmArgs up = {};
  up.a = x;
  up.scale = scale;
  up.shift = shift;
  up.w[0] = w1;
  up.bias[0] = b1;
  up.out[0] = h;
  up.rows = rows;
  up.seq = seq;
  up.K = d;
  up.Nw = f;
  GemmArgs down = {};
  down.a = h;
  down.w[0] = w2;
  down.bias[0] = b2;
  down.out[0] = out;
  down.resid = x;
  down.gate = gate;
  down.rows = rows;
  down.seq = seq;
  down.K = f;
  down.Nw = d;
  err = launch_ln_mod_gemm<float, true, kEpiGelu>(up, f, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_ln_mod_gemm<float, false, kEpiGateRes>(down, d, s);
}
