// Hopper pieces of the bf16 attention kernels (K3 and K4 in attention_nhd.cu,
// K5 in attention_bhnd.cuh, K6 in attention_splash_sm90.cuh), on the
// primitives of sm90.cuh: their TMA maps, in-place rope of a TMA-loaded tile,
// the exp2, the running row state, and one warpgroup's online-softmax step
// over a 64-key tile whose scores stay in registers (K3 and K4; K5 and K6
// have their own over 128 keys).
//
// Elements 8kk .. 8kk + 7 of a m64n64 score accumulator (layout in
// sm90.cuh), packed in pairs to bf16, are the A fragment of keys
// 16kk .. 16kk + 15 of the P V product, so p never leaves registers (as in
// FlashAttention-3).
#pragma once

#include "attention.cuh"
#include "sm90.cuh"

namespace sm90 {

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------ host side
// Map of a bf16 tensor [batch, n, width] (width contiguous) in boxes of
// box_rows x 64 with the 128-byte swizzle; coordinates are (column, row,
// batch row). Rows past n inside a batch row read as zeros.
static cudaError_t flat_map(CUtensorMap* map, const void* base, int batch, int n, int width,
                            int box_rows = kBox) {
  EncodeTiledFn enc;
  cudaError_t err = encode_fn(&enc);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2, (cuuint64_t)n * width * 2};
  const cuuint32_t box[3] = {kBox, (cuuint32_t)box_rows, 1}, elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Map of the f32 rope angles [n, half_d] in boxes of 64 rows, no swizzle.
static cudaError_t angles_map(CUtensorMap* map, const void* base, int n, int half_d) {
  EncodeTiledFn enc;
  cudaError_t err = encode_fn(&enc);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)half_d, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)half_d * 4};
  const cuuint32_t box[2] = {(cuuint32_t)half_d, kBox}, elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Map of the key mask [batch, n] (bytes) in boxes of 64 keys of one row.
static cudaError_t mask_map(CUtensorMap* map, const void* base, int batch, int n) {
  EncodeTiledFn enc;
  cudaError_t err = encode_fn(&enc);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t strides[1] = {(cuuint64_t)n};
  const cuuint32_t box[2] = {kBox, 1}, elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ------------------------------------------------------------ rope in place
// rope_pair (attention.cuh) for bf16 with the hardware sine and cosine: the
// angle is first reduced to [-pi, pi] (2 pi split in two floats, so the
// reduction is exact to ~1e-11 for the angles of N <= 2^16), then MUFU gives
// cos and sin within 4e-7, against 1 ulp (6e-8) from sincosf. Products and
// sums, and the one rounding to bf16, are rope_pair's.
__device__ __forceinline__ void rope_pair_mufu(float x0, float x1, float ang, float scale,
                                               bf16* dst) {
  const float k = rintf(ang * 0.159154943091895336f);  // turns
  const float r = fmaf(k, 1.74845553e-7f, fmaf(-k, 6.28318548202514648f, ang));
  float sn, cs;
  __sincosf(r, &sn, &cs);
  dst[0] = __float2bfloat16((x0 * cs + (-x1) * sn) * scale);
  dst[1] = __float2bfloat16((x1 * cs + x0 * sn) * scale);
}

// Rope NBOX boxes at `tile` in place, with NT threads (this one is `tid`),
// one 16-byte chunk (four pairs) a thread at a time. Box i holds columns
// 64 (i % ND) .. + 63 of a head of ND boxes at rows pos0 .. pos0 + 63; the
// angles of position pos are at ang + (pos - ang_pos0) * D / 2. Rows at or
// beyond n are left alone (TMA filled them with zeros). A pair never
// straddles a chunk, so the swizzle only moves whole chunks: the logical
// chunk of physical chunk pc in row r is pc ^ (r % 8).
template <int ND, int NBOX, int NT>
__device__ __forceinline__ void rope_boxes(bf16* tile, int pos0, int n, const float* ang,
                                           int ang_pos0, float scale, int tid) {
  constexpr int HALF_D = ND * kBox / 2;
#pragma unroll 4
  for (int it = 0; it < NBOX * kBox * 8 / NT; ++it) {
    const int idx = it * NT + tid;
    const int box = idx >> 9, r = (idx >> 3) & 63, pc = idx & 7;
    const int pos = pos0 + r;
    if (pos >= n) continue;
    const int pair0 = (box % ND) * (kBox / 2) + (pc ^ (r & 7)) * 4;
    Vec<bf16>* p = reinterpret_cast<Vec<bf16>*>(tile + box * kBoxElems + r * kBox + pc * 8);
    Vec<bf16> v = *p;
    const float4 a = *reinterpret_cast<const float4*>(ang + (size_t)(pos - ang_pos0) * HALF_D +
                                                      pair0);
    rope_pair_mufu(to_f(v.v[0]), to_f(v.v[1]), a.x, scale, &v.v[0]);
    rope_pair_mufu(to_f(v.v[2]), to_f(v.v[3]), a.y, scale, &v.v[2]);
    rope_pair_mufu(to_f(v.v[4]), to_f(v.v[5]), a.z, scale, &v.v[4]);
    rope_pair_mufu(to_f(v.v[6]), to_f(v.v[7]), a.w, scale, &v.v[6]);
    *p = v;
  }
}

// ------------------------------------------------------ online softmax step
// 2^x from MUFU, subnormal results flushed to 0 (a p below 2^-126 of the
// row's max adds nothing a bf16 product can carry).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Running state of this thread's two query rows (g and g + 8 of its warp's
// 16), in the log2 domain: m is the running max of log2(e) * score.
struct RowState {
  float m[2], l[2];
};

// One 64-key tile of K3 or K4: s holds this thread's scores of q already
// scaled by 1/sqrt(D); keep the tile's 64 key bytes (1 kept, 0 padded;
// nullptr: every key kept). A padded key scores -1e30: fmaf(s, log2 e,
// -1e30) is exactly -1e30, as |s| is far below the ulp of 1e30, so no
// element needs a branch. Updates the running max and sum, rescales the ND
// output accumulators and leaves the unnormalised p, rounded to bf16, in the
// A fragments p[kk] of the P V product.
template <int ND>
__device__ __forceinline__ void softmax_step(RowState& st, float (&s)[32], float (&o)[ND][32],
                                             uint32_t (&p)[4][4], const uint8_t* keep) {
  const int t = threadIdx.x & 3;
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float2 bb = {0.f, 0.f};
    if (keep != nullptr) {
      const uchar2 kk = *reinterpret_cast<const uchar2*>(keep + 8 * j + 2 * t);
      bb = {kk.x ? 0.f : attn::kMasked, kk.y ? 0.f : attn::kMasked};
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float& x0 = s[4 * j + 2 * r];
      float& x1 = s[4 * j + 2 * r + 1];
      x0 = fmaf(x0, kLog2e, bb.x);
      x1 = fmaf(x1, kLog2e, bb.y);
      mx[r] = fmaxf(mx[r], fmaxf(x0, x1));
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = fast_exp2(st.m[r] - mx[r]);  // 0 on the first tile when m starts at -inf
    st.l[r] *= alpha[r];
    st.m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = fast_exp2(s[i] - mx[r]);
    st.l[r] += s[i];
  }
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      __nv_bfloat162 v = __floats2bfloat162_rn(s[8 * kk + 2 * h], s[8 * kk + 2 * h + 1]);
      p[kk][h] = *reinterpret_cast<uint32_t*>(&v);
    }
}

// O / max(l, 1e-30) of this thread's rows, rounded to bf16 and stored for
// rows below n: out points at row 0, column 0 of this warpgroup's head,
// rows `stride` elements apart; row0 is the warpgroup's first query row.
template <int ND>
__device__ __forceinline__ void store_rows(const RowState& st, const float (&o)[ND][32], bf16* out,
                                           size_t stride, int row0, int n) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = st.l[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + g + 8 * r;
    if (row >= n) continue;
    bf16* dst = out + (size_t)row * stride + 2 * t;
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(dst + c * kBox + 8 * j) =
            __floats2bfloat162_rn(o[c][i] / l[r], o[c][i + 1] / l[r]);
      }
  }
}

}  // namespace sm90
