// Shared pieces of the f32 flash-style attention kernels (K3 and K4 in
// attention_nhd.cu, K5 and K6 in attention_bhnd.cuh; bf16 runs
// attention_sm90.cuh):
// staging of q/k/v tiles and key flags into shared memory, and one warp's
// online-softmax step over one staged 64-key tile.
//
// Work split: a block owns a 64-query tile of one head (K3, K5) or of one
// head pair (K4). Each warp owns 16 query rows of one head; its scores live
// in registers in the C layout of `mma16816`, which is also the A layout of
// the P V product, so p never touches shared memory.
#pragma once

#include "common.cuh"

namespace attn {
constexpr int BQ = 64, BKV = 64, PAD = 8;
constexpr float kMasked = -1e30f;  // score of a padded key
constexpr float kMFloor = -1e29f;  // K3's running-max floor when chunked (attention.py:220)
// flag of each key of a staged tile
constexpr float kKeep = 1.f, kPadKey = 0.f, kBeyond = -1.f;
}  // namespace attn

__device__ __forceinline__ float neg_inf() { return __int_as_float((int)0xff800000u); }

template <typename T>
__device__ __forceinline__ void rope_pair(float x0, float x1, float ang, float scale, T* dst) {
  float sn, cs;
  sincosf(ang, &sn, &cs);
  dst[0] = from_f<T>((x0 * cs + (-x1) * sn) * scale);
  dst[1] = from_f<T>((x1 * cs + x0 * sn) * scale);
}

// Stage rows [pos0, pos0 + rows) of a W-wide window of x (rows `stride`
// elements apart) into shared memory dst[rows][ld], with NT threads. Rows at
// or beyond n are zero. With angles ([n, D/2] f32), every D-wide head of the
// window is roped (x . cos + rot(x) . sin) and scaled, rounded to T.
template <typename T, int W, int D, int NT>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* x, size_t stride,
                                           const float* angles, float scale, int pos0, int rows,
                                           int n) {
  constexpr int VEC = Vec<T>::N;
  for (int idx = threadIdx.x; idx < rows * W / VEC; idx += NT) {
    const int r = idx / (W / VEC), c = (idx % (W / VEC)) * VEC;
    Vec<T> v;
    if (pos0 + r < n) {
      v = ld16(x + (size_t)(pos0 + r) * stride + c);
      if (angles != nullptr) {
        const float* ar = angles + (size_t)(pos0 + r) * (D / 2);
#pragma unroll
        for (int e = 0; e < VEC; e += 2)
          rope_pair<T>(to_f(v.v[e]), to_f(v.v[e + 1]), ar[((c + e) % D) / 2], scale, &v.v[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v.v[e] = from_f<T>(0.f);
    }
    st16(dst + r * ld + c, v);
  }
}

// Flags of keys [kv0, kv0 + BKV): kept, padded (mask false) or beyond n.
template <int NT>
__device__ __forceinline__ void stage_keys(float* dst, const uint8_t* mask_row, int kv0, int n) {
  for (int i = threadIdx.x; i < attn::BKV; i += NT) {
    const int j = kv0 + i;
    dst[i] = j >= n ? attn::kBeyond
                    : (mask_row == nullptr || mask_row[j]) ? attn::kKeep : attn::kPadKey;
  }
}

// Online-softmax state of 16 query rows of one head, held by one warp: this
// thread's accumulator fragments, and the running max and its part of the
// running sum for its rows g and g + 8.
template <int D>
struct SoftmaxRows {
  float o[D / 8][4];
  float m[2], l[2];
};

template <int D>
__device__ __forceinline__ void init_rows(SoftmaxRows<D>& st, float m0) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[dn][e] = 0.f;
  st.m[0] = st.m[1] = m0;
  st.l[0] = st.l[1] = 0.f;
}

// One step over a staged tile: S = Q[row0, row0 + 16) K^T in f32, times
// scale after the product; padded keys score -1e30, keys beyond n -inf (so
// p = 0 exactly); the running max and sum are updated and O += T(p) V.
// sQ, sK, sV point at this head's columns, rows ld elements apart. With SEG
// (K6's segment ids) a key scores -1e30 where its flag (kKeep 1, kPadKey 0)
// differs from qseg of the thread's row g or g + 8.
template <typename T, int D, bool SEG = false>
__device__ __forceinline__ void attend_tile(SoftmaxRows<D>& st, const T* sQ, const T* sK,
                                            const T* sV, int ld, const float* sKey, int row0,
                                            float scale, const float* qseg = nullptr) {
  using namespace attn;
  const int t = threadIdx.x & 3;
  float s[BKV / 8][4];
#pragma unroll
  for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[ni][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA<T> fa;
    load_a(fa, sQ, ld, row0, kk);
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
      FragB<T> fb;
      load_b_nk(fb, sK, ld, ni * 8, kk);
      mma16816(s[ni], fa, fb);
    }
  }

  float m_new[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[ni][e] *= scale;
      const float flag = sKey[ni * 8 + 2 * t + (e & 1)];
      if constexpr (SEG) {
        if (flag != qseg[e >> 1]) s[ni][e] = kMasked;
      } else {
        if (flag != kKeep) s[ni][e] = flag == kPadKey ? kMasked : neg_inf();
      }
      m_new[e >> 1] = fmaxf(m_new[e >> 1], s[ni][e]);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
    m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
    alpha[r] = expf(st.m[r] - m_new[r]);  // 0 on the first tile when m starts at -inf
    st.l[r] *= alpha[r];
    st.m[r] = m_new[r];
  }
#pragma unroll
  for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[ni][e] = expf(s[ni][e] - m_new[e >> 1]);
      st.l[e >> 1] += s[ni][e];
    }
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[dn][e] *= alpha[e >> 1];

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
      load_b_kn(fb, sV, ld, kk * 16, dn * 8);
      mma16816(st.o[dn], pa, fb);
    }
  }
}

// O / max(l, 1e-30) for this warp's rows q_row0 .. q_row0 + 15 below n;
// out points at row 0 of this head, rows `stride` elements apart.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const SoftmaxRows<D>& st, T* out, size_t stride,
                                           int q_row0, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = st.l[r];
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q_row0 + g + 8 * (e >> 1);
      if (row < n)
        out[(size_t)row * stride + dn * 8 + 2 * t + (e & 1)] = from_f<T>(st.o[dn][e] / l[e >> 1]);
    }
}

// Raise the dynamic shared-memory limit of `kernel` to `smem` bytes.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
