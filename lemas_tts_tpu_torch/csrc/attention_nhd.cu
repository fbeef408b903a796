// K3  vmem_attention_nhd and K4  vmem_attention_nhd(pack_pair=True):
// non-causal multi-head attention on the flat [B, N, H*D] layout,
// interleaved-pair rope on q and k inside the kernel, 1/sqrt(D) folded into
// q, key-padding mask.
//
// Replaces: lemas_tts_tpu/ops/attention.py:vmem_attention_nhd (Pallas
//   _vmem_attn_nhd_kernel, attention.py:223-339, and the head-pair-packed
//   _vmem_attn_nhd_pack_kernel, attention.py:342-410). The TPU kernels held a
//   whole head pair's K/V for one batch row in VMEM; the packed one built
//   block-diagonal K/V concatenations so that a d64 pair ran one score and
//   one PV matmul on the 128-wide MXU.
// Bound on the H100: at rows 2, N = 1024, 16 x 64 heads the call does
//   8.6 GFLOP against about 17 MB, ~500 FLOP/byte: the tensor cores bound it
//   in principle; in these first kernels the f32 softmax work between the two
//   products (exp, max, rescale) is what they wait on.
// Design (attention.cuh): flash-style forward, scores in registers, q, k, v
//   and the output read and written in place in the flat layout with no
//   transposes. The running max starts at the floor -1e29, so a row whose
//   keys are all masked yields 0.
//   K3: one block per (64-query tile, head, batch row), four warps of 16
//   query rows; the block ropes and scales its q tile once, then walks the
//   keys in 64-key tiles, roping each k tile as it is staged. The head dim is
//   a template parameter: 64 (the flagship's pairs) and 128 (the wide-head
//   student).
//   K4 (d64 only): one block per (64-query tile, head pair, batch row), eight
//   warps: warps 0-3 take head 2p, warps 4-7 head 2p+1. The block stages the
//   pair's 128-wide q, k and v windows once, ropes each k window once, and
//   both heads' score and PV chains run from that one load: the Hopper
//   counterpart of the TPU's block-diagonal packing (one read of the pair
//   window instead of two). Each warp does K3's arithmetic on the same
//   staged values, so K4 equals K3 bit for bit.
#include "attention.cuh"

template <typename T, int D>
__global__ void __launch_bounds__(128)
    attn_nhd_kernel(const T* q, const T* k, const T* v, const uint8_t* mask, const float* angles,
                    T* out, int N, int heads, float sm_scale) {
  using namespace attn;
  constexpr int LD = D + PAD, NT = 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BQ * LD;
  T* sV = sK + BKV * LD;
  float* sKey = reinterpret_cast<float*>(sV + BKV * LD);

  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int inner = heads * D;
  const size_t base = (size_t)b * N * inner + (size_t)h * D;  // (b, pos 0, head h)
  const uint8_t* mrow = mask == nullptr ? nullptr : mask + (size_t)b * N;

  stage_tile<T, D, D, NT>(sQ, LD, q + base, inner, angles, sm_scale, q0, BQ, N);
  SoftmaxRows<D> st;
  init_rows(st, kMFloor);
  for (int kv0 = 0; kv0 < N; kv0 += BKV) {
    __syncthreads();  // the previous tile's readers are done (and sQ is staged)
    stage_tile<T, D, D, NT>(sK, LD, k + base, inner, angles, 1.f, kv0, BKV, N);
    stage_tile<T, D, D, NT>(sV, LD, v + base, inner, nullptr, 1.f, kv0, BKV, N);
    stage_keys<NT>(sKey, mrow, kv0, N);
    __syncthreads();
    attend_tile<T, D>(st, sQ, sK, sV, LD, sKey, warp * 16, 1.f);
  }
  store_rows<T, D>(st, out + base, inner, q0 + warp * 16, N);
}

template <typename T>
__global__ void __launch_bounds__(256)
    attn_nhd_pair_kernel(const T* q, const T* k, const T* v, const uint8_t* mask,
                         const float* angles, T* out, int N, int heads, float sm_scale) {
  using namespace attn;
  constexpr int D = 64, W = 2 * D, LD = W + PAD, NT = 256;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BQ * LD;
  T* sV = sK + BKV * LD;
  float* sKey = reinterpret_cast<float*>(sV + BKV * LD);

  const int warp = threadIdx.x >> 5;
  const int hw = warp >> 2, row0 = (warp & 3) * 16;  // head within the pair, first query row
  const int q0 = blockIdx.x * BQ, pair = blockIdx.y, b = blockIdx.z;
  const int inner = heads * D;
  const size_t base = (size_t)b * N * inner + (size_t)pair * W;  // (b, pos 0, head 2 * pair)
  const uint8_t* mrow = mask == nullptr ? nullptr : mask + (size_t)b * N;

  stage_tile<T, W, D, NT>(sQ, LD, q + base, inner, angles, sm_scale, q0, BQ, N);
  SoftmaxRows<D> st;
  init_rows(st, kMFloor);
  for (int kv0 = 0; kv0 < N; kv0 += BKV) {
    __syncthreads();
    stage_tile<T, W, D, NT>(sK, LD, k + base, inner, angles, 1.f, kv0, BKV, N);
    stage_tile<T, W, D, NT>(sV, LD, v + base, inner, nullptr, 1.f, kv0, BKV, N);
    stage_keys<NT>(sKey, mrow, kv0, N);
    __syncthreads();
    attend_tile<T, D>(st, sQ + hw * D, sK + hw * D, sV + hw * D, LD, sKey, row0, 1.f);
  }
  store_rows<T, D>(st, out + base + hw * D, inner, q0 + row0, N);
}

// Shared memory of one block: q, k and v tiles of width `width`, key flags.
template <typename T>
static size_t tile_smem(int width) {
  using namespace attn;
  return (size_t)(BQ + 2 * BKV) * (width + PAD) * sizeof(T) + BKV * sizeof(float);
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, const void* mask,
                  const void* angles, void* out, int batch, int n, int heads, float sm_scale,
                  cudaStream_t s) {
  const size_t smem = tile_smem<T>(D);
  cudaError_t err = allow_smem(attn_nhd_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n / attn::BQ, heads, batch);
  attn_nhd_kernel<T, D><<<grid, 128, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(angles), static_cast<T*>(out),
      n, heads, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_pair(const void* q, const void* k, const void* v, const void* mask,
                       const void* angles, void* out, int batch, int n, int heads,
                       float sm_scale, cudaStream_t s) {
  const size_t smem = tile_smem<T>(128);
  cudaError_t err = allow_smem(attn_nhd_pair_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n / attn::BQ, heads / 2, batch);
  attn_nhd_pair_kernel<T><<<grid, 256, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(angles), static_cast<T*>(out),
      n, heads, sm_scale);
  return (int)cudaGetLastError();
}

// device: the CUDA device of the tensors (this library links its own CUDA
// runtime, whose current device is not PyTorch's). sm_scale is
// 1/sqrt(dim_head) rounded to f32 by the caller, as the Pallas kernel
// receives it. N % 64 == 0; dim_head 64 with heads even, or 128.
extern "C" int lemas_attention_nhd(int device, int dtype, int dim_head, const void* q,
                                   const void* k, const void* v, const void* mask,
                                   const void* angles, void* out, int batch, int n, int heads,
                                   float sm_scale, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return dim_head == 64
               ? launch<bf16, 64>(q, k, v, mask, angles, out, batch, n, heads, sm_scale, s)
               : launch<bf16, 128>(q, k, v, mask, angles, out, batch, n, heads, sm_scale, s);
  return dim_head == 64
             ? launch<float, 64>(q, k, v, mask, angles, out, batch, n, heads, sm_scale, s)
             : launch<float, 128>(q, k, v, mask, angles, out, batch, n, heads, sm_scale, s);
}

// K4: the same arguments; dim_head must be 64 and heads even.
extern "C" int lemas_attention_nhd_pack(int device, int dtype, int dim_head, const void* q,
                                        const void* k, const void* v, const void* mask,
                                        const void* angles, void* out, int batch, int n,
                                        int heads, float sm_scale, void* stream) {
  if (dim_head != 64 || heads % 2 != 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == kBF16
             ? launch_pair<bf16>(q, k, v, mask, angles, out, batch, n, heads, sm_scale, s)
             : launch_pair<float>(q, k, v, mask, angles, out, batch, n, heads, sm_scale, s);
}
