// Split-head [B, H, N, D] attention kernels: K5's (attention_bhnd.cu:
// key-padding mask) in f32 and bf16, and K6's f32 checking path
// (attention_splash.cu: segment ids; its bf16 kernel is
// attention_splash_sm90.cuh). The f32 kernel's template flag SEG picks K6's
// function; with SEG false it is K5's, as is every line of the bf16 kernel.
//
// K5: scores (q . k^T) * sm_scale in f32 after the product; a padded key
//   scores -1e30, a key beyond n -inf (p = 0), the running max starts at
//   -inf, so a query row whose keys are all padded gets the mean of v.
// K6 (SEG): q is first scaled by q_scale in place and rounded to its dtype
//   (the JAX wrapper's `(q * (1/sqrt(D))).astype(q.dtype)`), the scores are
//   not scaled again; key j is visible to query i iff seg(i) == seg(j), with
//   seg = mask (1 kept, 0 padded; every position 1 without a mask). A pad
//   query so attends the pad keys, and a batch row with every position
//   padded attends every key. Every query sees at least itself, so a masked
//   score of -1e30 (splash: -0.7 f32 max) gives p = 0 exactly in both.
//   N % 128 == 0 (the wrapper hands other N to K5, as JAX hands them to
//   its XLA sdpa), so no key lies beyond n.
#pragma once

#include "attention_sm90.cuh"

// ------------------------------------------------------------------- f32
// One block per (64-query tile, head, batch row), four warps of 16 query
// rows; 64-key tiles of k and v staged in shared memory, products in exact
// f32 FMAs in the mma.sync register layout.
template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(128)
    attn_bhnd_kernel(const T* q, const T* k, const T* v, const uint8_t* mask, T* out, int N,
                     int heads, float sm_scale, float q_scale) {
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
  float qseg[2] = {1.f, 1.f};  // K6: the segments of this thread's rows g, g + 8
  if constexpr (SEG) {
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * D; i += NT) {
      T& x = sQ[(i / D) * LD + i % D];
      x = from_f<T>(to_f(x) * q_scale);
    }
    const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      qseg[r] = (mrow == nullptr || row >= N || mrow[row]) ? kKeep : kPadKey;
    }
  }
  SoftmaxRows<D> st;
  init_rows(st, neg_inf());
  for (int kv0 = 0; kv0 < N; kv0 += BKV) {
    __syncthreads();  // the previous tile's readers are done (and sQ is staged)
    stage_tile<T, D, D, NT>(sK, LD, k + base, D, nullptr, 1.f, kv0, BKV, N);
    stage_tile<T, D, D, NT>(sV, LD, v + base, D, nullptr, 1.f, kv0, BKV, N);
    stage_keys<NT>(sKey, mrow, kv0, N);
    __syncthreads();
    attend_tile<T, D, SEG>(st, sQ, sK, sV, LD, sKey, warp * 16, sm_scale, qseg);
  }
  store_rows<T, D>(st, out + base, D, q0 + warp * 16, N);
}

template <int D, bool SEG>
static int launch_bhnd_f32(const void* q, const void* k, const void* v, const void* mask,
                           void* out, int batch, int n, int heads, float sm_scale,
                           float q_scale, cudaStream_t s) {
  using namespace attn;
  const size_t smem = (size_t)(BQ + 2 * BKV) * (D + PAD) * sizeof(float) + BKV * sizeof(float);
  cudaError_t err = allow_smem(attn_bhnd_kernel<float, D, SEG>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + BQ - 1) / BQ, heads, batch);
  attn_bhnd_kernel<float, D, SEG><<<grid, 128, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), n, heads, sm_scale, q_scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16, sm_90a
namespace {
// Work split of the bf16 kernel: WGS consumer warpgroups of 64 query rows and
// one producer warp, BPS blocks resident an SM (the kernel's template
// parameters). d64 runs one block of four warpgroups or two blocks of two
// (bhnd_four_warpgroups picks): either way an SM sub-partition holds at most
// five warps, so ptxas gives each thread up to 96 registers (a sixth warp
// would cut that to 80 and spill); d128, as K3, one block of two, as its O
// accumulator takes 32 more registers a thread. ST stages of K, V and key
// bytes; shared memory holds the q boxes, the ring and the barriers.
template <int D, int WGS_>
struct BhndTiles {
  static constexpr int WGS = WGS_;                             // consumer warpgroups
  static constexpr int CONSUMERS = 128 * WGS;                  // their threads
  static constexpr int THREADS = CONSUMERS + 32;               // + the producer warp
  static constexpr int ND = D / sm90::kBox;                    // boxes per head
  static constexpr int NQ = WGS * ND;                          // q boxes of the block
  static constexpr int ST = D == 64 ? 4 : 3;                   // stages
  static constexpr int ROWS = sm90::kBox * WGS;                // query rows of a block
  static constexpr int KEYS = 128;  // bytes for a stage's 64 key bytes (keeps stages aligned)
  static constexpr size_t kBytes =
      1024 + (size_t)(NQ + 2 * ST * ND) * sm90::kBoxBytes + ST * KEYS + (2 * ST + 1) * 8;
};
}  // namespace

template <int D, int WGS_, int BPS_>
__global__ void __launch_bounds__(BhndTiles<D, WGS_>::THREADS, BPS_)
    attn_bhnd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const uint8_t* mask,
                          bf16* out, int n, int heads, float factor) {
  using namespace sm90;
  using Tiles = BhndTiles<D, WGS_>;
  constexpr int WGS = Tiles::WGS, ND = Tiles::ND, NQ = Tiles::NQ, ST = Tiles::ST,
                CONSUMERS = Tiles::CONSUMERS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  bf16* sQ = reinterpret_cast<bf16*>(base);  // box w * ND + c: warpgroup w's c-th box
  bf16* sK = sQ + NQ * kBoxElems;            // stage s, box c at (s * ND + c) * kBoxElems
  bf16* sV = sK + ST * ND * kBoxElems;
  uint8_t* sKeys = reinterpret_cast<uint8_t*>(sV + ST * ND * kBoxElems);  // [ST][KEYS]
  uint64_t* full = reinterpret_cast<uint64_t*>(sKeys + ST * Tiles::KEYS);  // stage landed
  uint64_t* empty = full + ST;                                            // stage released
  uint64_t* qfull = empty + ST;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int b = blockIdx.z, bh = b * heads + blockIdx.y;
  const int ntiles = (n + kBox - 1) / kBox;
  const int q0 = blockIdx.x * Tiles::ROWS;
  const uint8_t* mrow = mask == nullptr ? nullptr : mask + (size_t)b * n;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);               // every producer lane (one with the TMA bytes)
      mbar_init(&empty[s], CONSUMERS / 32);  // lane 0 of every consumer warp
    }
    mbar_init(qfull, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == WGS) {
    // The producer warp: lane 0 loads the q boxes once, then each tile's K
    // and V boxes into the ring as soon as the consumers release the stage;
    // every lane writes two of the tile's key bytes and arrives.
    const int lane = tid & 31;
    if (lane == 0) {
      mbar_expect_tx(qfull, NQ * kBoxBytes);
      for (int w = 0; w < WGS; ++w)
        for (int c = 0; c < ND; ++c)
          tma_load(sQ + (w * ND + c) * kBoxElems, &qmap, qfull, kBox * c, q0 + kBox * w, bh);
    }
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % ST;
      if (j >= ST) mbar_wait(&empty[s], (j / ST - 1) & 1);
      uint8_t kb[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * kBox + 2 * lane + e;
        kb[e] = key >= n ? kKeyBeyond : (mrow == nullptr || mrow[key]) ? kKeyKept : kKeyPadded;
      }
      *reinterpret_cast<uchar2*>(sKeys + s * Tiles::KEYS + 2 * lane) = make_uchar2(kb[0], kb[1]);
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * ND * kBoxBytes);
        for (int c = 0; c < ND; ++c) {
          tma_load(sK + (s * ND + c) * kBoxElems, &kmap, &full[s], kBox * c, j * kBox, bh);
          tma_load(sV + (s * ND + c) * kBoxElems, &vmap, &full[s], kBox * c, j * kBox, bh);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows 64 wg.. of the block.
  const int row0 = q0 + kBox * wg;
  const uint64_t qdesc = desc_b128(sQ + wg * ND * kBoxElems, 1024, 16);
  float o[ND][32], sc[32];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  RowState st = {{neg_inf(), neg_inf()}, {0.f, 0.f}};
  mbar_wait(qfull, 0);
  // One product in flight at a time (S, softmax, P V), as in K3: the other
  // warpgroups' products fill the tensor cores meanwhile.
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % ST;
    mbar_wait(&full[s], (j / ST) & 1);
    wgmma_fence();
    const uint64_t kdesc = desc_b128(sK + s * ND * kBoxElems, 1024, 16);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // S = Q K^T: 16 head columns a step, next box after 64
      const uint64_t off = ((kk >> 2) * kBoxBytes + (kk & 3) * 32) >> 4;
      wgmma_ss_n64(sc, qdesc + off, kdesc + off, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(sc[i]);
    uint32_t p[4][4];
    softmax_step<ND, true>(st, sc, o, p, sKeys + s * Tiles::KEYS, factor);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < ND; ++c) {  // O += P V: 16 keys (rows of V, 2 KB) a step
      const uint64_t vdesc = desc_b128(sV + (s * ND + c) * kBoxElems, 1024, kBoxBytes);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n64_tb(o[c], p[kk], vdesc + ((kk * 16 * kBox * 2) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_reg(o[c][i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h) fence_reg(p[kk][h]);
    if ((tid & 31) == 0) mbar_arrive(&empty[s]);
  }
  sm90::store_rows<ND>(st, o, out + (size_t)bh * n * D, D, row0, n);
}

template <int D, int WGS, int BPS>
static int launch_bhnd_sm90(const void* q, const void* k, const void* v, const void* mask,
                            void* out, int batch, int n, int heads, float factor,
                            cudaStream_t s) {
  using Tiles = BhndTiles<D, WGS>;
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = sm90::flat_map(&qmap, q, batch * heads, n, D);
  if (err == cudaSuccess) err = sm90::flat_map(&kmap, k, batch * heads, n, D);
  if (err == cudaSuccess) err = sm90::flat_map(&vmap, v, batch * heads, n, D);
  if (err == cudaSuccess) err = allow_smem(attn_bhnd_sm90_kernel<D, WGS, BPS>, Tiles::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + Tiles::ROWS - 1) / Tiles::ROWS, heads, batch);
  attn_bhnd_sm90_kernel<D, WGS, BPS><<<grid, Tiles::THREADS, Tiles::kBytes, s>>>(
      qmap, kmap, vmap, static_cast<const uint8_t*>(mask), static_cast<bf16*>(out), n, heads,
      factor);
  return (int)cudaGetLastError();
}
