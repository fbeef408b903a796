// Tiled GEMM  out = epilogue(prologue(A) . W^T)  on mma.sync: the f32
// checking path of qkv_block (K1) and of the two launches of ffn_block (K2);
// the bf16 K1 and K2 run on gemm_sm90.cuh.
//
// prologue (kLnMod): A is the raw residual stream x [rows, K]; the block
//   computes the LayerNorm statistics of its rows in f32 (fast variance
//   E[x^2] - mu^2, eps 1e-6, no affine), then every A tile it stages in shared
//   memory is m = T(normed) * T(1 + scale) + shift, rounded to T after each op
//   as the T-typed Pallas kernel computes it.
// W is up to three torch-layout weights [Nw, K] (k contiguous) laid side by
//   side: output columns [j*Nw, (j+1)*Nw) use w[j], bias[j] and out[j]. For
//   qkv_block this is the concatenated [3I, D] q/k/v weight without a copy.
// epilogue: acc (f32) is rounded to T, then
//   kEpiBias:     + bias                        -> out   (q, k, v)
//   kEpiGelu:     gelu_tanh(T(acc) + b1)        -> out   (the hidden h)
//   kEpiGateRes:  x + gate * (T(acc) + b2)      -> out   (the block output)
//
// Tiles: BM=64 rows x BN=128 columns per block, BK=32 deep, 8 warps in a
// 2x4 grid of 32x32 warp tiles (2 m16 x 4 n8 mma tiles each).
#pragma once

#include "common.cuh"

enum { kEpiBias = 0, kEpiGelu = 1, kEpiGateRes = 2 };

struct GemmArgs {
  const void* a;       // [rows, K]
  const void* scale;   // [batch, K]   (kLnMod)
  const void* shift;   // [batch, K]   (kLnMod)
  const void* w[3];    // [Nw, K] each
  const void* bias[3]; // [Nw] each
  void* out[3];        // [rows, Nw] each
  const void* resid;   // [rows, Nw]   (kEpiGateRes)
  const void* gate;    // [batch, Nw]  (kEpiGateRes)
  int rows, seq, K, Nw;
};

namespace gemm {
constexpr int BM = 64, BN = 128, BK = 32, THREADS = 256;
constexpr int PAD = 8;             // elements; keeps rows 16-byte aligned
constexpr int LDS = BK + PAD;
constexpr float kLnEps = 1e-6f;
}  // namespace gemm

template <typename T, bool kLnMod, int kEpi>
__global__ void __launch_bounds__(gemm::THREADS) ln_mod_gemm_kernel(GemmArgs p) {
  using namespace gemm;
  constexpr int VEC = Vec<T>::N;
  __shared__ __align__(16) T sA[BM * LDS];
  __shared__ __align__(16) T sB[BN * LDS];
  __shared__ float sMean[BM], sRstd[BM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int j = col0 / p.Nw, c0 = col0 - j * p.Nw;
  const int K = p.K;
  const T* A = static_cast<const T*>(p.a);
  const T* W = static_cast<const T*>(p.w[j]);

  if (kLnMod) {
    for (int r = warp; r < BM; r += THREADS / 32) {
      const T* xr = A + (size_t)(row0 + r) * K;
      float s = 0.f, ss = 0.f;
      for (int c = lane * VEC; c < K; c += 32 * VEC) {
        Vec<T> v = ld16(xr + c);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = to_f(v.v[e]);
          s += f;
          ss += f * f;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
      }
      if (lane == 0) {
        const float mu = s / K;
        const float var = ss / K - mu * mu;
        sMean[r] = mu;
        sRstd[r] = 1.f / sqrtf(var + kLnEps);
      }
    }
    __syncthreads();
  }

  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile [BM, BK], through the LN + modulation prologue when kLnMod
    for (int idx = tid; idx < BM * BK / VEC; idx += THREADS) {
      const int r = idx / (BK / VEC), c = (idx % (BK / VEC)) * VEC;
      Vec<T> v = ld16(A + (size_t)(row0 + r) * K + k0 + c);
      if (kLnMod) {
        const int b = (row0 + r) / p.seq;
        Vec<T> sc = ld16(static_cast<const T*>(p.scale) + (size_t)b * K + k0 + c);
        Vec<T> sh = ld16(static_cast<const T*>(p.shift) + (size_t)b * K + k0 + c);
        const float mu = sMean[r], rs = sRstd[r];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float normed = rnd<T>((to_f(v.v[e]) - mu) * rs);
          const float m = rnd<T>(normed * rnd<T>(1.f + to_f(sc.v[e])));
          v.v[e] = from_f<T>(m + to_f(sh.v[e]));
        }
      }
      st16(sA + r * LDS + c, v);
    }
    // W tile [BN, BK]
    for (int idx = tid; idx < BN * BK / VEC; idx += THREADS) {
      const int n = idx / (BK / VEC), c = (idx % (BK / VEC)) * VEC;
      st16(sB + n * LDS + c, ld16(W + (size_t)(c0 + n) * K + k0 + c));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA<T> fa[2];
      FragB<T> fb[4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) load_a(fa[mi], sA, LDS, wm + mi * 16, kk);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) load_b_nk(fb[ni], sB, LDS, wn + ni * 8, kk);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma16816(acc[mi][ni], fa[mi], fb[ni]);
    }
    __syncthreads();
  }

  const T* bias = static_cast<const T*>(p.bias[j]);
  T* out = static_cast<T*>(p.out[j]);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm + mi * 16 + g + 8 * h;
        const int col = c0 + wn + ni * 8 + 2 * t;
        T y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float o = rnd<T>(rnd<T>(acc[mi][ni][2 * h + e]) + to_f(bias[col + e]));
          if (kEpi == kEpiBias) {
            y[e] = from_f<T>(o);
          } else if (kEpi == kEpiGelu) {
            y[e] = from_f<T>(gelu_tanh(o));
          } else {
            const int b = row / p.seq;
            const float gt = to_f(static_cast<const T*>(p.gate)[(size_t)b * p.Nw + col + e]);
            const float x = to_f(static_cast<const T*>(p.resid)[(size_t)row * p.Nw + col + e]);
            y[e] = from_f<T>(x + rnd<T>(gt * o));
          }
        }
        out[(size_t)row * p.Nw + col] = y[0];
        out[(size_t)row * p.Nw + col + 1] = y[1];
      }
}

// Host launcher: one block per (BN columns, BM rows) tile over ncols columns.
template <typename T, bool kLnMod, int kEpi>
inline cudaError_t launch_ln_mod_gemm(const GemmArgs& p, int ncols, cudaStream_t stream) {
  dim3 grid(ncols / gemm::BN, p.rows / gemm::BM);
  ln_mod_gemm_kernel<T, kLnMod, kEpi><<<grid, gemm::THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}
