// K2  ffn_block: x + gate * (GELU_tanh(m W1 + b1) W2 + b2), m = LN-mod(x).
//
// Replaces: lemas_tts_tpu/ops/ffn.py:ffn_block (Pallas _ffn_block_kernel,
//   ffn.py:34-61), which kept W1 and W2 resident in TPU VMEM and carried the
//   [256, F] hidden tile between the two products inside one program.
// Bound on the H100: at rows 2048, D = 1024, F = 2048 the call does
//   17.2 GFLOP against about 17 MB (+17 MB for the hidden round trip below),
//   above the ~295 FLOP/byte ridge: the tensor cores bound it.
// Design: the hidden [rows, F] tile does not fit one block's 227 KB of
//   shared memory at useful row counts, so the call is two launches of the
//   shared tiled GEMM: (1) LN + modulation fused into the A staging, W1,
//   + b1 and tanh-GELU in the epilogue, h written in T (8 MB at rows 2048,
//   which stays in the 50 MB L2); (2) h W2, + b2, then x + gate * o in the
//   epilogue. The split costs no accuracy: the Pallas kernel rounds h to the
//   compute type at exactly that point (ffn.py:52-56).
#include "ln_mod_gemm.cuh"

// device: the CUDA device of the tensors (this library links its own CUDA
// runtime, whose current device is not PyTorch's).
extern "C" int lemas_ffn_block(int device, int dtype, const void* x, const void* scale,
                               const void* shift, const void* gate, const void* w1,
                               const void* b1, const void* w2, const void* b2, void* h,
                               void* out, int rows, int seq, int d, int f, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  if (dtype == kBF16) {
    err = launch_ln_mod_gemm<bf16, true, kEpiGelu>(up, f, s);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_ln_mod_gemm<bf16, false, kEpiGateRes>(down, d, s);
  }
  err = launch_ln_mod_gemm<float, true, kEpiGelu>(up, f, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_ln_mod_gemm<float, false, kEpiGateRes>(down, d, s);
}
