// Split-head [B, H, N, D] attention kernels: K5's (attention_bhnd.cu:
// key-padding mask) in f32 and bf16, and K6's f32 checking path
// (attention_splash.cu: segment ids; its bf16 kernel is
// attention_splash_sm90.cuh, whose design K5's bf16 kernel shares). The f32
// kernel's template flag SEG picks K6's function; with SEG false it is K5's,
// as is every line of the bf16 kernel.
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

#include "attention_splash_sm90.cuh"

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
// K5's bf16 kernel: K6's Hopper design (attention_splash_sm90.cuh: its ring
// geometry splash::Tiles, its turns) with K5's function at any n >= 1.
// - A persistent grid of min(items, SMs) blocks; block i walks items i,
//   i + grid, ... An item is 128 query rows of one (batch row, head): first
//   every whole 128-row tile (tile, then head, then batch row), then the
//   ragged tail of each (batch row, head), so the light items come last.
// - A producer warpgroup (setmaxnreg 40) whose one thread issues TMA copies
//   of each item's q boxes and of its 128-key K and V tiles into a ring;
//   two consumer warpgroups of 64 rows (setmaxnreg 232), each issuing S_j =
//   Q K_j^T before O += P_{j-1} V_{j-1} and running the softmax of tile j
//   while P V runs, and taking turns to issue on named barriers (ping-pong).
// - Rows and keys past n read as zeros (TMA). A key beyond n scores -inf
//   (p = 0 exactly), a padded key -1e30, the running max starts at -inf, so
//   a row whose keys are all padded gets the mean of v; rows past n are not
//   stored. Where no row of the second warpgroup is below n (an item of a
//   tail of at most 64 rows) it issues no product: it takes its turns and
//   releases each stage at once, so the first runs as fast as alone.
// - Before the roles split the block classes every 128-key tile of every
//   batch row (shared memory): all its keys kept and below n (no compare),
//   every key below n padded, or mixed (each key's byte read while the stage
//   lands, the scores offset 0, -1e30 or -inf). In a batch row with a kept
//   key, an all-padding tile is skipped: exp2(-1e30 - m) is 0 against any
//   real running max m, and a tile walked before the first kept key is
//   rescaled by exp2(-1e30 - m) = 0 when it comes, so skipping changes no
//   value. A row with no kept key walks every tile. The producer and both
//   consumers walk the same tiles in order, so the ring's parities agree.
namespace bhnd {

// Class of a 128-key tile of a batch row.
constexpr uint8_t kPadTile = 0, kKeptTile = 1, kMixedTile = 2;
// Byte of a key of a mixed tile: kept, padded (mask false) or at or beyond n.
constexpr uint8_t kKeyPadded = 0, kKeyKept = 1, kKeyBeyond = 2;

// The bytes of this thread's 32 keys of the tile whose first key is key0
// (columns 8j + 2t and 8j + 2t + 1 of the m64n128 layout, sm90.cuh); mrow
// is the batch row's mask (nullptr: every key kept).
__device__ __forceinline__ void key_bytes(uchar2 (&kb)[16], const uint8_t* mrow, int key0, int n) {
  auto byte = [&](int key) -> uint8_t {
    return key >= n ? kKeyBeyond : (mrow == nullptr || mrow[key]) ? kKeyKept : kKeyPadded;
  };
  const int c0 = key0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) kb[j] = make_uchar2(byte(c0 + 8 * j), byte(c0 + 8 * j + 1));
}

// The online-softmax step of a 128-key tile: s holds this thread's 64
// scores (m64n128 layout), factor = 1/sqrt(D) log2 e takes a score to the
// log2 domain after the product; on return the unnormalised p in f32 and
// alpha the factor by which O is to be rescaled. MASKED offsets each score
// by its key byte (fmaf(s, factor, -1e30) is exactly -1e30); otherwise
// every key is kept and below n, and the max is taken before the factor
// (rounding is monotone and factor > 0).
template <bool MASKED>
__device__ __forceinline__ void tile_softmax(sm90::RowState& st, float (&s)[64],
                                             float (&alpha)[2], const uchar2 (&kb)[16],
                                             float factor) {
  using namespace sm90;
  auto bias = [](uint8_t k) {
    return k == kKeyKept ? 0.f : k == kKeyPadded ? attn::kMasked : neg_inf();
  };
  float mx[2];
  if constexpr (MASKED) {
    mx[0] = st.m[0];
    mx[1] = st.m[1];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float b0 = bias(kb[j].x), b1 = bias(kb[j].y);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x0 = s[4 * j + 2 * r];
        float& x1 = s[4 * j + 2 * r + 1];
        x0 = fmaf(x0, factor, b0);
        x1 = fmaf(x1, factor, b1);
        mx[r] = fmaxf(mx[r], fmaxf(x0, x1));
      }
    }
  } else {  // a tree of maxima: 5 deep where a chain would be 31
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) m[j] = fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]);
#pragma unroll
      for (int j = 0; j < 8; ++j) m[j] = fmaxf(m[j], m[j + 8]);
#pragma unroll
      for (int j = 0; j < 4; ++j) m[j] = fmaxf(m[j], m[j + 4]);
      mx[r] = fmaxf(fmaxf(m[0], m[2]), fmaxf(m[1], m[3]));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    if constexpr (!MASKED) mx[r] = fmaxf(st.m[r], mx[r] * factor);
    alpha[r] = fast_exp2(st.m[r] - mx[r]);  // 0 on the first tile: m starts at -inf
    st.m[r] = mx[r];
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // two partial sums a row
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = fast_exp2(MASKED ? s[i] - mx[r] : fmaf(s[i], factor, -mx[r]));
    sum[r][i & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * alpha[r] + (sum[r][0] + sum[r][1]);
}

}  // namespace bhnd

// counts (nullptr on the main path): two u64 the producers add to, the key
// tiles the block's items walked and the key tiles of those items.
template <int D>
__global__ void __launch_bounds__(splash::Tiles<D>::THREADS, 1)
    attn_bhnd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const uint8_t* mask,
                          bf16* out, int batch, int n, int heads, float factor,
                          unsigned long long* counts) {
  using namespace sm90;
  using namespace bhnd;
  using T = splash::Tiles<D>;
  constexpr int ND = T::ND, ST = T::ST, QB = T::QB, KV_BOX = T::KV_BOX, KEYS = splash::kKeys,
                TURN = splash::kTurn;
  static_assert(T::ROWS == KEYS, "an item's query rows are one key tile's width");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  bf16* sQ = reinterpret_cast<bf16*>(base);  // buffer u, consumer w, box c: (2u + w) ND + c
  bf16* sK = sQ + QB * 2 * ND * kBoxElems;   // stage s, columns 64c.. at (s * ND + c) * KV_BOX
  bf16* sV = sK + ST * ND * KV_BOX;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + ST * ND * KV_BOX);  // stage landed
  uint64_t* empty = full + ST;                                          // stage released
  uint64_t* qfull = empty + ST;                                         // q buffer landed
  uint64_t* qempty = qfull + QB;                                        // q buffer released
  uint8_t* classes = reinterpret_cast<uint8_t*>(qempty + QB);  // [batch][ntiles] tile classes

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int ntiles = (n + KEYS - 1) / KEYS, nwhole = n / KEYS, bhs = batch * heads;
  const int items = bhs * ntiles;
  // item -> query tile qt of (batch row, head) bh: whole tiles first, then the tails
  auto item_of = [&](int item, int& qt, int& bh) {
    if (item < bhs * nwhole) {
      qt = item % nwhole;
      bh = item / nwhole;
    } else {
      qt = nwhole;
      bh = item - bhs * nwhole;
    }
  };
  // Whether a batch row whose tile classes are cl skips its all-padding tiles:
  // it has a tile with a kept key.
  auto skips = [&](const uint8_t* cl) {
    for (int j = 0; j < ntiles; ++j)
      if (cl[j] != kPadTile) return true;
    return false;
  };
  if (tid == 256) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);   // the producer, with the TMA bytes
      mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    for (int u = 0; u < QB; ++u) {
      mbar_init(&qfull[u], 1);
      mbar_init(&qempty[u], 8);
    }
    mbar_init_fence();
  }
  auto load_tile = [&](int bh, int j, int s) {
    mbar_expect_tx(&full[s], 2 * ND * KV_BOX * 2);
    for (int c = 0; c < ND; ++c) {
      tma_load(sK + (s * ND + c) * KV_BOX, &kmap, &full[s], kBox * c, j * KEYS, bh);
      tma_load(sV + (s * ND + c) * KV_BOX, &vmap, &full[s], kBox * c, j * KEYS, bh);
    }
  };
  auto load_q = [&](int bh, int qt, int u) {
    mbar_expect_tx(&qfull[u], 2 * ND * kBoxBytes);
    for (int w = 0; w < 2; ++w)
      for (int c = 0; c < ND; ++c)
        tma_load(sQ + ((2 * u + w) * ND + c) * kBoxElems, &qmap, &qfull[u], kBox * c,
                 qt * T::ROWS + kBox * w, bh);
  };
  // The first item's q is copied while the tiles are classed.
  __syncthreads();
  if (tid == 256) {
    int qt, bh;
    item_of(blockIdx.x, qt, bh);
    load_q(bh, qt, 0);
  }
  // Every warp classes tiles warp, warp + 12, ... (batch row r / ntiles, tile
  // r % ntiles), four keys a lane.
  for (int r = warp; r < batch * ntiles; r += T::THREADS / 32) {
    const int b = r / ntiles, key0 = (r % ntiles) * KEYS;
    bool kept = false, padded = false;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 32 * e + lane;
      if (key < n) {
        const bool m = mask == nullptr || mask[(size_t)b * n + key];
        kept |= m;
        padded |= !m;
      }
    }
    const bool any_kept = __any_sync(0xffffffffu, kept);
    const bool any_padded = __any_sync(0xffffffffu, padded);
    if (lane == 0)
      classes[r] = !any_kept                            ? kPadTile
                   : (any_padded || key0 + KEYS > n) ? kMixedTile
                                                       : kKeptTile;
  }
  __syncthreads();

  if (wg == 2) {
    // The producer: one thread walks the block's items and loads each walked
    // tile's K and V boxes into the ring once both consumers have released
    // the stage, and each item's q once its buffer is free.
    setmaxnreg_dec<T::PRODUCER_REGS>();
    if (tid != 256) return;
    int it = 0;
    unsigned long long walked = 0, tiles = 0;
    int ii = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++ii) {
      int qt, bh;
      item_of(item, qt, bh);
      const uint8_t* cl = classes + (bh / heads) * ntiles;
      const bool skip = skips(cl);
      if (ii > 0) {
        if (ii >= QB) mbar_wait(&qempty[ii % QB], (ii / QB - 1) & 1);
        load_q(bh, qt, ii % QB);
      }
      for (int j = 0; j < ntiles; ++j) {
        if (skip && cl[j] == kPadTile) continue;
        const int s = it % ST;
        if (it >= ST) mbar_wait(&empty[s], (it / ST - 1) & 1);
        load_tile(bh, j, s);
        ++it;
        ++walked;
      }
      tiles += ntiles;
    }
    if (counts != nullptr) {
      atomicAdd(counts, walked);
      atomicAdd(counts + 1, tiles);
    }
    return;
  }

  // Consumer warpgroup wg: query rows 64 wg.. of each item.
  setmaxnreg_inc<T::CONSUMER_REGS>();
  if (wg == 1) bar_arrive(TURN, 256);  // consumer 0 takes the first turn
  float o[ND][32], sc[64];
  uint32_t p[8][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  RowState st;
  int it = 0;                     // walked tiles taken so far, over every item
  uint64_t qdesc = 0;             // this item's q boxes
  const uint8_t* mrow = nullptr;  // this item's mask row

  // O += P V of the tile before, from stage sp: 16 keys (rows of V, 2 KB) a step.
  auto issue_pv = [&](int sp) {
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      const uint64_t vdesc = desc_b128(sV + (sp * ND + c) * KV_BOX, 1024, KV_BOX * 2);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs_n64_tb(o[c], p[kk], vdesc + ((kk * 16 * kBox * 2) >> 4));
    }
    wgmma_commit();
  };
  // Wait for P V, then release its stage.
  auto finish_pv = [&](int sp) {
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_reg(o[c][i]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h) fence_reg(p[kk][h]);
    if (lane == 0) mbar_arrive(&empty[sp]);
  };
  // Walked tile j: in this warpgroup's turn, S = Q K_j^T and (PV) the P V of
  // the tile before; the softmax while P V runs; then O rescaled and p_j
  // packed. No branch lies between a product's issue and its wait (ptxas
  // would serialize the products, C7520): the caller picks MASKED and PV
  // before the step.
  auto step = [&](int j, auto masked, auto pv) {
    constexpr bool MASKED = decltype(masked)::value, PV = decltype(pv)::value;
    const int s = it % ST, sp = (it + ST - 1) % ST;  // this tile's stage, the one before's
    uchar2 kb[16];  // MASKED: the keys' bytes, read while the stage lands
    if constexpr (MASKED) key_bytes(kb, mrow, j * KEYS, n);
    mbar_wait(&full[s], (it / ST) & 1);
    bar_sync(TURN + wg, 256);
    wgmma_fence();
    {  // 16 head columns a step, the next box after 64
      const uint64_t kdesc = desc_b128(sK + s * ND * KV_BOX, 1024, 16);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128(sc, qdesc + (((kk >> 2) * kBoxBytes + (kk & 3) * 32) >> 4),
                      kdesc + (((kk >> 2) * KV_BOX * 2 + (kk & 3) * 32) >> 4), kk > 0);
      wgmma_commit();
    }
    if constexpr (PV) issue_pv(sp);
    bar_arrive(TURN + (wg ^ 1), 256);  // the other warpgroup's turn
    if constexpr (PV)
      wgmma_wait_one();
    else
      wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_reg(sc[i]);
    float alpha[2];
    tile_softmax<MASKED>(st, sc, alpha, kb, factor);
    if constexpr (PV) {
      // The softmax's results pinned before the wait for P V: without this
      // the compiler sinks the softmax past the wait, and nothing overlaps.
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_reg(sc[i]);
      fence_reg(alpha[0]);
      fence_reg(alpha[1]);
      finish_pv(sp);
    }
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        __nv_bfloat162 v = __floats2bfloat162_rn(sc[8 * kk + 2 * h], sc[8 * kk + 2 * h + 1]);
        p[kk][h] = *reinterpret_cast<uint32_t*>(&v);
      }
    ++it;
  };
  using Yes = std::true_type;
  using No = std::false_type;
  int ii = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++ii) {
    int qt, bh;
    item_of(item, qt, bh);
    const int row0 = qt * T::ROWS + kBox * wg;
    const uint8_t* cl = classes + (bh / heads) * ntiles;
    const bool skip = skips(cl);
    mbar_wait(&qfull[ii % QB], (ii / QB) & 1);
    if (row0 >= n) {
      // No row of this warpgroup is below n: take each turn and release each
      // stage as it lands, issuing nothing.
      for (int j = 0; j < ntiles; ++j) {
        if (skip && cl[j] == kPadTile) continue;
        const int s = it % ST;
        mbar_wait(&full[s], (it / ST) & 1);
        bar_sync(TURN + wg, 256);
        bar_arrive(TURN + (wg ^ 1), 256);
        if (lane == 0) mbar_arrive(&empty[s]);
        ++it;
      }
      if (lane == 0) mbar_arrive(&qempty[ii % QB]);
      bar_sync(TURN + wg, 256);  // the other warpgroup's last P V
      bar_arrive(TURN + (wg ^ 1), 256);
      continue;
    }
    mrow = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * n;
    qdesc = desc_b128(sQ + (2 * (ii % QB) + wg) * ND * kBoxElems, 1024, 16);
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    st = {{neg_inf(), neg_inf()}, {0.f, 0.f}};
    int j = 0;
    if (skip)
      while (cl[j] == kPadTile) ++j;
    if (cl[j] == kKeptTile)
      step(j, No{}, No{});
    else
      step(j, Yes{}, No{});
    for (++j; j < ntiles; ++j) {
      if (skip && cl[j] == kPadTile) continue;
      if (cl[j] == kKeptTile)
        step(j, No{}, Yes{});
      else
        step(j, Yes{}, Yes{});
    }
    // The item's last S is done, so its q buffer is free for the next copy;
    // then the last tile's P V, in this warpgroup's turn.
    if (lane == 0) mbar_arrive(&qempty[ii % QB]);
    bar_sync(TURN + wg, 256);
    wgmma_fence();
    issue_pv((it + ST - 1) % ST);
    bar_arrive(TURN + (wg ^ 1), 256);
    finish_pv((it + ST - 1) % ST);
    sm90::store_rows<ND>(st, o, out + (size_t)bh * n * D, D, row0, n);
  }
  if (wg == 0) bar_sync(TURN, 256);  // the turn consumer 1 handed over last
}

// The bf16 launch: a persistent grid of min(items, SMs) blocks (item: 128
// query rows of a head of a batch row), in as many launches as the tile
// classes of the batch rows need to fit in shared memory (one at any
// practical batch). factor = sm_scale log2 e.
template <int D>
static int launch_bhnd_sm90(int device, const void* q, const void* k, const void* v,
                            const void* mask, void* out, int batch, int n, int heads,
                            float factor, unsigned long long* counts, cudaStream_t s) {
  using T = splash::Tiles<D>;
  constexpr size_t kMaxSmem = 232448;  // an sm_90 block's dynamic shared memory
  const int ntiles = (n + splash::kKeys - 1) / splash::kKeys;
  const int per = (int)std::min<size_t>(batch, (kMaxSmem - T::kBytes) / ntiles);
  if (per < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(attn_bhnd_sm90_kernel<D>, T::kBytes + (size_t)per * ntiles);
  for (int b0 = 0; b0 < batch && err == cudaSuccess; b0 += per) {
    const int nb = std::min(per, batch - b0);
    const size_t off = (size_t)b0 * heads * n * D;  // elements of q, k, v and out before b0
    CUtensorMap qmap, kmap, vmap;
    err = sm90::flat_map(&qmap, static_cast<const bf16*>(q) + off, nb * heads, n, D);
    if (err == cudaSuccess)
      err = sm90::flat_map(&kmap, static_cast<const bf16*>(k) + off, nb * heads, n, D,
                           splash::kKeys);
    if (err == cudaSuccess)
      err = sm90::flat_map(&vmap, static_cast<const bf16*>(v) + off, nb * heads, n, D,
                           splash::kKeys);
    if (err != cudaSuccess) break;
    const int items = ntiles * heads * nb;
    attn_bhnd_sm90_kernel<D><<<std::min(items, sm90::sm_count(device)), T::THREADS,
                               T::kBytes + (size_t)nb * ntiles, s>>>(
        qmap, kmap, vmap,
        mask == nullptr ? nullptr : static_cast<const uint8_t*>(mask) + (size_t)b0 * n,
        static_cast<bf16*>(out) + off, nb, n, heads, factor, counts);
    err = cudaGetLastError();
  }
  return (int)err;
}
