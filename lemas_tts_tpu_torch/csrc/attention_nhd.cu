// K3  vmem_attention_nhd: non-causal multi-head attention on the flat
// [B, N, H*D] layout, interleaved-pair rope on q and k inside the kernel,
// 1/sqrt(D) folded into q, key-padding mask.
//
// Replaces: lemas_tts_tpu/ops/attention.py:vmem_attention_nhd (Pallas
//   _vmem_attn_nhd_kernel, attention.py:223-339), which held a whole head
//   pair's K/V for one batch row in TPU VMEM, roped k once per (batch, head)
//   into a scratch and ran one-shot or kv-chunked softmax per q block.
// Bound on the H100: at rows 2, N = 1024, 16 x 64 heads the call does
//   8.6 GFLOP against about 17 MB, ~500 FLOP/byte: the tensor cores bound it
//   in principle; in this first kernel the f32 softmax work between the two
//   products (exp, max, rescale) is what it waits on.
// Design: flash-style forward. One block per (64-query tile, head, batch
//   row), four warps of 16 query rows each. The block ropes and scales its q
//   tile once into shared memory, then walks the keys in 64-key tiles: each
//   tile is loaded, k roped and rounded to T as the Pallas kernel does, and
//   S = Q K^T, the online softmax (f32 running max starting at the floor
//   -1e29, f32 running sum of p) and O += T(p) V run with the scores kept in
//   registers, never in memory. q, k, v and the output are read and written
//   in place in the flat layout, with no transposes. The head dim is a
//   template parameter: 64 (the flagship's pairs) and 128 (the wide-head
//   student). A row whose keys are all masked yields 0.
#include "common.cuh"

namespace attn {
constexpr int BQ = 64, BKV = 64, THREADS = 128, PAD = 8;
constexpr float kMasked = -1e30f;  // score of a padded key
constexpr float kMFloor = -1e29f;  // running-max floor (attention.py:220)
}  // namespace attn

template <typename T>
__device__ __forceinline__ void rope_pair(float x0, float x1, float ang, float scale, T* dst) {
  float sn, cs;
  sincosf(ang, &sn, &cs);
  dst[0] = from_f<T>((x0 * cs + (-x1) * sn) * scale);
  dst[1] = from_f<T>((x1 * cs + x0 * sn) * scale);
}

// Stage rows [pos0, pos0+rows) of one head of x ([B, N, inner], T) into
// shared memory [rows][ld], roped (x . cos + rot(x) . sin) and scaled when
// angles is given, rounded to T.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* x, const float* angles,
                                           float scale, int pos0, int rows, int inner) {
  constexpr int VEC = Vec<T>::N;
  for (int idx = threadIdx.x; idx < rows * D / VEC; idx += attn::THREADS) {
    const int r = idx / (D / VEC), c = (idx % (D / VEC)) * VEC;
    Vec<T> v = ld16(x + (size_t)(pos0 + r) * inner + c);
    if (angles != nullptr) {
      const float* ar = angles + (size_t)(pos0 + r) * (D / 2);
#pragma unroll
      for (int e = 0; e < VEC; e += 2)
        rope_pair<T>(to_f(v.v[e]), to_f(v.v[e + 1]), ar[(c + e) / 2], scale, &v.v[e]);
    }
    st16(dst + r * ld + c, v);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(attn::THREADS)
    attn_nhd_kernel(const T* q, const T* k, const T* v, const uint8_t* mask, const float* angles,
                    T* out, int N, int heads, float sm_scale) {
  using namespace attn;
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BQ * LD;
  T* sV = sK + BKV * LD;
  float* sMask = reinterpret_cast<float*>(sV + BKV * LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int inner = heads * D;
  const size_t base = (size_t)b * N * inner + (size_t)h * D;  // (b, pos 0, head h)

  stage_tile<T, D>(sQ, LD, q + base, angles, sm_scale, q0, BQ, inner);

  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m_run[2] = {kMFloor, kMFloor}, l_part[2] = {0.f, 0.f};

  for (int kv0 = 0; kv0 < N; kv0 += BKV) {
    __syncthreads();  // the previous tile's readers are done (and sQ is staged)
    stage_tile<T, D>(sK, LD, k + base, angles, 1.f, kv0, BKV, inner);
    stage_tile<T, D>(sV, LD, v + base, nullptr, 1.f, kv0, BKV, inner);
    for (int i = threadIdx.x; i < BKV; i += THREADS)
      sMask[i] = (mask == nullptr || mask[(size_t)b * N + kv0 + i]) ? 1.f : 0.f;
    __syncthreads();

    float s[BKV / 8][4];
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      FragA<T> fa;
      load_a(fa, sQ, LD, warp * 16, kk);
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni) {
        FragB<T> fb;
        load_b_nk(fb, sK, LD, ni * 8, kk);
        mma16816(s[ni], fa, fb);
      }
    }

    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (sMask[ni * 8 + 2 * t + (e & 1)] == 0.f) s[ni][e] = kMasked;
        m_new[e >> 1] = fmaxf(m_new[e >> 1], s[ni][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
      m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
      alpha[r] = expf(m_run[r] - m_new[r]);
      l_part[r] *= alpha[r];
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[ni][e] = expf(s[ni][e] - m_new[e >> 1]);
        l_part[e >> 1] += s[ni][e];
      }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] *= alpha[e >> 1];

#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      FragA<T> pa;  // C layout of two adjacent n8 score tiles = A layout of k16
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa.x[e] = from_f<T>(s[2 * kk][e]);
        pa.x[4 + e] = from_f<T>(s[2 * kk + 1][e]);
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        FragB<T> fb;
        load_b_kn(fb, sV, LD, kk * 16, dn * 8);
        mma16816(o[dn], pa, fb);
      }
    }
  }

  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_part[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  T* ob = out + base;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + warp * 16 + g + 8 * (e >> 1);
      ob[(size_t)row * inner + dn * 8 + 2 * t + (e & 1)] = from_f<T>(o[dn][e] / l[e >> 1]);
    }
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, const void* mask,
                  const void* angles, void* out, int batch, int n, int heads, float sm_scale,
                  cudaStream_t s) {
  using namespace attn;
  const size_t smem = (size_t)(BQ + 2 * BKV) * (D + PAD) * sizeof(T) + BKV * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attn_nhd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n / BQ, heads, batch);
  attn_nhd_kernel<T, D><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(angles), static_cast<T*>(out),
      n, heads, sm_scale);
  return (int)cudaGetLastError();
}

// device: the CUDA device of the tensors (this library links its own CUDA
// runtime, whose current device is not PyTorch's). sm_scale is
// 1/sqrt(dim_head) rounded to f32 by the caller, as the Pallas kernel
// receives it.
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
