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
//   the tensor cores bound it in principle; like K3 this first kernel waits
//   on the f32 softmax work between the two products.
// Design (attention.cuh): K3's flash-style forward on another layout. One
//   block per (64-query tile, head, batch row), four warps of 16 query rows;
//   64-key tiles of k and v are staged in shared memory, the f32 online
//   softmax stays in registers, products on mma.sync. Unlike K3 there is no
//   rope and no q pre-scaling: the scale multiplies the f32 scores after the
//   product, as the Pallas kernel does. The running max starts at -inf, not
//   at K3's floor, so a row whose keys are all masked gives the mean of v, as
//   the Pallas kernel and sdpa do. Every N is taken: rows of the last q or kv
//   tile beyond N are staged as zeros, keys beyond N get p = 0 exactly (not
//   the -1e30 of a padded key, which would join that mean), and rows beyond
//   N are not stored. The head dim is a template parameter: 64 and 128.
#include "attention.cuh"

template <typename T, int D>
__global__ void __launch_bounds__(128)
    attn_bhnd_kernel(const T* q, const T* k, const T* v, const uint8_t* mask, T* out, int N,
                     int heads, float sm_scale) {
  using namespace attn;
  constexpr int LD = D + PAD, NT = 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BQ * LD;
  T* sV = sK + BKV * LD;
  float* sKey = reinterpret_cast<float*>(sV + BKV * LD);

  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t base = ((size_t)b * heads + h) * N * D;  // (b, h, pos 0)
  const uint8_t* mrow = mask == nullptr ? nullptr : mask + (size_t)b * N;

  stage_tile<T, D, D, NT>(sQ, LD, q + base, D, nullptr, 1.f, q0, BQ, N);
  SoftmaxRows<D> st;
  init_rows(st, neg_inf());
  for (int kv0 = 0; kv0 < N; kv0 += BKV) {
    __syncthreads();  // the previous tile's readers are done (and sQ is staged)
    stage_tile<T, D, D, NT>(sK, LD, k + base, D, nullptr, 1.f, kv0, BKV, N);
    stage_tile<T, D, D, NT>(sV, LD, v + base, D, nullptr, 1.f, kv0, BKV, N);
    stage_keys<NT>(sKey, mrow, kv0, N);
    __syncthreads();
    attend_tile<T, D>(st, sQ, sK, sV, LD, sKey, warp * 16, sm_scale);
  }
  store_rows<T, D>(st, out + base, D, q0 + warp * 16, N);
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                  int batch, int n, int heads, float sm_scale, cudaStream_t s) {
  using namespace attn;
  const size_t smem = (size_t)(BQ + 2 * BKV) * (D + PAD) * sizeof(T) + BKV * sizeof(float);
  cudaError_t err = allow_smem(attn_bhnd_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + BQ - 1) / BQ, heads, batch);
  attn_bhnd_kernel<T, D><<<grid, 128, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), n, heads, sm_scale);
  return (int)cudaGetLastError();
}

// device: the CUDA device of the tensors (this library links its own CUDA
// runtime). mask may be null (every key kept). sm_scale is 1/sqrt(dim_head)
// rounded to f32 by the caller. dim_head 64 or 128; any n >= 1.
extern "C" int lemas_attention_bhnd(int device, int dtype, int dim_head, const void* q,
                                    const void* k, const void* v, const void* mask, void* out,
                                    int batch, int n, int heads, float sm_scale, void* stream) {
  if (dim_head != 64 && dim_head != 128) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return dim_head == 64 ? launch<bf16, 64>(q, k, v, mask, out, batch, n, heads, sm_scale, s)
                          : launch<bf16, 128>(q, k, v, mask, out, batch, n, heads, sm_scale, s);
  return dim_head == 64 ? launch<float, 64>(q, k, v, mask, out, batch, n, heads, sm_scale, s)
                        : launch<float, 128>(q, k, v, mask, out, batch, n, heads, sm_scale, s);
}
