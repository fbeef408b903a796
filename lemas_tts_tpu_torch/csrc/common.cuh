// Shared device helpers for the hand-written Hopper kernels of this package.
//
// Every matrix product in the kernels goes through one warp-level primitive,
// `mma16816`: a 16x8 f32 accumulator tile += a 16x16 A tile times a 16x8 B
// tile. For bf16 operands it is the tensor-core instruction
// `mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32`. For f32 operands (the
// checking path: the TPU kernels run f32 at HIGHEST precision) it is the same
// tile product done with exact f32 FMAs, the operands gathered across the
// warp with shuffles, so that both element types share one register layout
// (the PTX fragment layout below) and one kernel body.
//
// Fragment layout (lane = 4*g + t, g in 0..7, t in 0..3):
//   A elem i (16x16): row g + 8*((i>>1)&1), col 2t + (i&1) + 8*(i>>2)
//   B elem i (16x8):  k   2t + (i&1) + 8*(i>>1),  col g
//   C elem i (16x8):  row g + 8*(i>>1),           col 2t + (i&1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

enum { kF32 = 0, kBF16 = 1 };  // dtype codes passed from Python

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// Round an f32 value to T and back: models one op of a T-typed computation
// (round to nearest even, as XLA and PyTorch do for bf16).
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

template <typename T> struct FragA { T x[8]; };
template <typename T> struct FragB { T x[4]; };

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma16816(float c[4], const FragA<bf16>& a, const FragB<bf16>& b) {
  uint32_t a0 = pack2(a.x[0], a.x[1]), a1 = pack2(a.x[2], a.x[3]);
  uint32_t a2 = pack2(a.x[4], a.x[5]), a3 = pack2(a.x[6], a.x[7]);
  uint32_t b0 = pack2(b.x[0], b.x[1]), b1 = pack2(b.x[2], b.x[3]);
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// f32 tile product in the same layout: gather rows g, g+8 of A from the
// four lanes of this quad and columns 2t, 2t+1 of B from their owners.
__device__ __forceinline__ void mma16816(float c[4], const FragA<float>& a, const FragB<float>& b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float ar0[16], ar1[16], bc0[16], bc1[16];
#pragma unroll
  for (int tt = 0; tt < 4; ++tt) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = __shfl_sync(0xffffffffu, a.x[i], (g << 2) | tt);
      const int col = 2 * tt + (i & 1) + 8 * (i >> 2);
      if ((i >> 1) & 1) ar1[col] = v; else ar0[col] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 2 * tt + (i & 1) + 8 * (i >> 1);
      bc0[k] = __shfl_sync(0xffffffffu, b.x[i], ((2 * t) << 2) | tt);
      bc1[k] = __shfl_sync(0xffffffffu, b.x[i], ((2 * t + 1) << 2) | tt);
    }
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    c[0] = fmaf(ar0[k], bc0[k], c[0]);
    c[1] = fmaf(ar0[k], bc1[k], c[1]);
    c[2] = fmaf(ar1[k], bc0[k], c[2]);
    c[3] = fmaf(ar1[k], bc1[k], c[3]);
  }
}

// A tile from shared memory stored [row][k] (k contiguous), rows row0..+15,
// k k0..+15.
template <typename T>
__device__ __forceinline__ void load_a(FragA<T>& f, const T* s, int ld, int row0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    f.x[i] = s[(row0 + g + 8 * ((i >> 1) & 1)) * ld + k0 + 2 * t + (i & 1) + 8 * (i >> 2)];
}

// B tile from shared memory stored [n][k] (k contiguous): the layout of a
// torch Linear weight [out, in] and of K [key, d] in S = Q K^T.
template <typename T>
__device__ __forceinline__ void load_b_nk(FragB<T>& f, const T* s, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f.x[i] = s[(n0 + g) * ld + k0 + 2 * t + (i & 1) + 8 * (i >> 1)];
}

// B tile from shared memory stored [k][n] (n contiguous): V [key, d] in O = P V.
template <typename T>
__device__ __forceinline__ void load_b_kn(FragB<T>& f, const T* s, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f.x[i] = s[(k0 + 2 * t + (i & 1) + 8 * (i >> 1)) * ld + n0 + g];
}

// GELU with the tanh approximation, in f32 (the K2 kernels' hidden layer).
__device__ __forceinline__ float gelu_tanh(float h) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * h * (1.f + tanhf(k0 * (h + 0.044715f * h * h * h)));
}

// 16-byte vector of T: the unit of every global load and store below.
template <typename T> struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T>
__device__ __forceinline__ Vec<T> ld16(const T* p) {
  Vec<T> r;
  *reinterpret_cast<uint4*>(r.v) = *reinterpret_cast<const uint4*>(p);
  return r;
}

template <typename T>
__device__ __forceinline__ void st16(T* p, const Vec<T>& r) {
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(r.v);
}
