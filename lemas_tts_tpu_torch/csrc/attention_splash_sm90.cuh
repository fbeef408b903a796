// K6's bf16 kernel for sm_90a (attention_splash.cu is its entry point):
// non-causal split-head attention on q, k, v read in place as [B*H, N, D]
// (D 64 or 128, N % 128 == 0) with splash's segment ids from the [B, N] key
// mask. Its function and rounding points are attention_splash.cu's: q scaled
// by q_scale and rounded to bf16 in shared memory, f32 logits and online
// softmax in the log2 domain, the unnormalised p rounded to bf16 for the P V
// product, o / l last.
//
// What bounds it: at rows 2, 16 x 64 heads, N 1024 the two products are 8.6
// GFLOP against ~17 MB, so the tensor cores bound it; but at d64 a 64 x 128
// score tile's exp2 (MUFU, 16 a clock an SM) takes as long as its two
// products, so the softmax of one tile has to run while products run.
//
// Design (FlashAttention-3's, cut to K6):
// - A persistent grid, one block an SM: block i walks items i, i + grid, ...
//   (an item is 128 query rows of one (batch row, head)), so the start of a
//   block and the fill of its ring are paid once an SM, and the next item's
//   q and key tiles land while the consumers finish this one. A block is two
//   consumer warpgroups of 64 rows and one producer warpgroup. The producer
//   gives its registers back (setmaxnreg.dec to 40) and the consumers take
//   them (setmaxnreg.inc to 232), so a consumer holds its 64 x 128 f32
//   scores, the bf16 p of the tile before and O without spilling.
// - 128-key tiles: one ring stage holds a tile's K and V, ND boxes of 128
//   rows x 64 columns each (one TMA copy a box), issued by one producer
//   thread that reads nothing else, so no load's latency lies between two
//   copies. S = Q K^T is m64n128 `wgmma` from shared memory; O += P V is
//   m64n64 `wgmma` with P from registers, one per 64 columns of the head and
//   16 keys.
// - Inside a warpgroup the products of two tiles overlap its softmax: it
//   issues S_j = Q K_j^T and then O += P_{j-1} V_{j-1}, waits for S_j alone,
//   runs the softmax of tile j while P V runs, then waits for P V, releases
//   tile j-1's stage, rescales O and packs p_j.
// - Across the two warpgroups, ping-pong: each issues its two products only
//   in its turn (a named barrier of 256 threads that the other warpgroup
//   arrives on once it has issued its own), so one warpgroup's softmax runs
//   while the other's products run.
// - Key tiles that no row of an item can see are skipped: before the roles
//   split, the block classes every 64-position run of every batch row as
//   all valid, all padding or mixed (in shared memory). An item of valid
//   rows never loads an all-padding tile, an item of padding rows never an
//   all-valid one; the producer and both consumers walk the same list (from
//   the item's own tile, which it always sees, wrapping around), so the
//   ring's parities stay in step. A skipped tile's p is exactly 0 for every
//   row of the item and the running max starts at -inf (every row sees at
//   least itself), so skipping changes no value. A tile whose keys all share
//   the segment of every row of the warpgroup takes the scores to the log2
//   domain inside the exp2's FMA, with no compare or select; other tiles
//   compare each key's mask byte, read from device memory while the stage
//   lands, with the row's segment (-1e30 where they differ). Without a mask
//   there is one segment and nothing is skipped.
#pragma once

#include <algorithm>
#include <type_traits>

#include "attention_sm90.cuh"

namespace splash {

constexpr int kKeys = 128;  // keys of a tile: one ring stage
// Class of a run of positions of a batch row (64 or 128): its mask values.
constexpr uint8_t kPadRun = 0, kValidRun = 1, kMixedRun = 2;

// The class of two runs together.
__device__ __forceinline__ uint8_t join(uint8_t a, uint8_t b) { return a == b ? a : kMixedRun; }

// Whether an item whose rows are of class `rows` sees a key of a tile of class `keys`.
__device__ __forceinline__ bool seen(uint8_t rows, uint8_t keys) {
  return rows == kMixedRun || keys == kMixedRun || keys == rows;
}

template <int D>
struct Tiles {
  static constexpr int ND = D / sm90::kBox;          // 64-column boxes of a head
  static constexpr int THREADS = 384;                // consumers 0, 1; the producer 2
  static constexpr int ROWS = 2 * sm90::kBox;        // query rows of an item
  static constexpr int KV_BOX = kKeys * sm90::kBox;  // elements of a 128 x 64 box (16 KB)
  static constexpr int ST = D == 64 ? 4 : 3;         // ring stages
  static constexpr int QB = D == 64 ? 2 : 1;         // q buffers (d128: no room for two)
  // 128 x 40 + 256 x 232 = 384 x 168, the block's registers at launch
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  // the q buffers, the K and V ring and the barriers; batch x n / 64 run
  // classes follow
  static constexpr size_t kBytes = 1024 + (size_t)QB * 2 * ND * sm90::kBoxBytes +
                                   (size_t)2 * ST * ND * KV_BOX * 2 + (2 * ST + 2 * QB) * 8;
};

// Named barriers: 1 + w a consumer's own, kTurn + w its turn to issue products.
constexpr int kTurn = 3;

// The mask bytes of this thread's 32 keys of a 128-key tile (columns 8j +
// 2t and 8j + 2t + 1 of the m64n128 layout, sm90.cuh), from the tile's 128
// bytes of the mask row (byte loads: the mask may start at any address).
__device__ __forceinline__ void key_bytes(uchar2 (&kb)[16], const uint8_t* tile_mask) {
  const uint8_t* src = tile_mask + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) kb[j] = make_uchar2(src[8 * j], src[8 * j + 1]);
}

// The online-softmax step of a 128-key tile: s holds this thread's 64
// scores (m64n128 layout); on return the unnormalised p in f32 and alpha the
// factor by which O is to be rescaled. MASKED compares each key's mask byte
// kb with the segment of each of the thread's two rows; otherwise every key
// is seen and the max is taken before the log2 factor (rounding is
// monotone, so the max of the products is the product of the max).
template <bool MASKED>
__device__ __forceinline__ void tile_softmax(sm90::RowState& st, float (&s)[64],
                                             float (&alpha)[2], const uchar2 (&kb)[16],
                                             const uint8_t (&qseg)[2]) {
  using namespace sm90;
  float mx[2];
  if constexpr (MASKED) {
    mx[0] = st.m[0];
    mx[1] = st.m[1];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uchar2 kk = kb[j];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x0 = s[4 * j + 2 * r];
        float& x1 = s[4 * j + 2 * r + 1];
        x0 = fmaf(x0, kLog2e, (kk.x != 0) == qseg[r] ? 0.f : attn::kMasked);
        x1 = fmaf(x1, kLog2e, (kk.y != 0) == qseg[r] ? 0.f : attn::kMasked);
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
    if constexpr (!MASKED) mx[r] = fmaxf(st.m[r], mx[r] * kLog2e);
    alpha[r] = fast_exp2(st.m[r] - mx[r]);  // 0 on the first tile: m starts at -inf
    st.m[r] = mx[r];
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // two partial sums a row
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = fast_exp2(MASKED ? s[i] - mx[r] : fmaf(s[i], kLog2e, -mx[r]));
    sum[r][i & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * alpha[r] + (sum[r][0] + sum[r][1]);
}

// O * (1 / l) of this thread's two rows, splash's normalisation (the
// reciprocal correctly rounded, then one product), rounded to bf16 and
// stored: out points at row 0, column 0 of the head; row0 is the
// warpgroup's first query row (every row is below n).
template <int ND>
__device__ __forceinline__ void store_out(const sm90::RowState& st, const float (&o)[ND][32],
                                          bf16* out, int row0) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = st.l[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = __frcp_rn(l);  // l >= 1: the row's max contributes exp2(0)
    bf16* dst = out + (size_t)(row0 + 16 * warp + g + 8 * r) * (ND * sm90::kBox) + 2 * t;
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(dst + c * sm90::kBox + 8 * j) =
            __floats2bfloat162_rn(o[c][i] * inv, o[c][i + 1] * inv);
      }
  }
}

template <int D>
__global__ void __launch_bounds__(Tiles<D>::THREADS, 1)
    splash_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const uint8_t* mask,
                       bf16* out, int batch, int n, int heads, float q_scale) {
  using namespace sm90;
  using T = Tiles<D>;
  constexpr int ND = T::ND, ST = T::ST, QB = T::QB, KV_BOX = T::KV_BOX;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  bf16* sQ = reinterpret_cast<bf16*>(base);  // buffer u, consumer w, box c: (2u + w) ND + c
  bf16* sK = sQ + QB * 2 * ND * kBoxElems;   // stage s, columns 64c.. at (s * ND + c) * KV_BOX
  bf16* sV = sK + ST * ND * KV_BOX;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + ST * ND * KV_BOX);  // stage landed
  uint64_t* empty = full + ST;                                          // stage released
  uint64_t* qfull = empty + ST;                                         // q buffer landed
  uint64_t* qempty = qfull + QB;                                        // q buffer released
  uint8_t* runs = reinterpret_cast<uint8_t*>(qempty + QB);  // [batch][n / 64] run classes

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int nq = n / T::ROWS, ntiles = n / kKeys, nruns = n / kBox;
  const int items = nq * heads * batch;  // item: query tile item % nq of (batch, head) item / nq
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
      tma_load(sK + (s * ND + c) * KV_BOX, &kmap, &full[s], kBox * c, j * kKeys, bh);
      tma_load(sV + (s * ND + c) * KV_BOX, &vmap, &full[s], kBox * c, j * kKeys, bh);
    }
  };
  auto load_q = [&](int bh, int qt, int u) {
    mbar_expect_tx(&qfull[u], 2 * ND * kBoxBytes);
    for (int w = 0; w < 2; ++w)
      for (int c = 0; c < ND; ++c)
        tma_load(sQ + ((2 * u + w) * ND + c) * kBoxElems, &qmap, &qfull[u], kBox * c,
                 qt * T::ROWS + kBox * w, bh);
  };
  // An item's walk over key tiles starts at its own tile qt (its rows'
  // positions), which it always sees, and wraps around: the first item's q
  // and tile are copied while the runs are classed.
  __syncthreads();
  if (tid == 256) {
    load_q(blockIdx.x / nq, blockIdx.x % nq, 0);
    load_tile(blockIdx.x / nq, blockIdx.x % nq, 0);
  }
  // Every warp classes runs warp, warp + 12, ... of every batch row (mask
  // row b's run r is run b * nruns + r), two positions a lane.
  for (int r = warp; r < batch * nruns; r += T::THREADS / 32) {
    bool valid0 = true, valid1 = true;
    if (mask != nullptr) {
      valid0 = mask[(size_t)r * kBox + 2 * lane];
      valid1 = mask[(size_t)r * kBox + 2 * lane + 1];
    }
    const bool any_valid = __any_sync(0xffffffffu, valid0 || valid1);
    const bool any_pad = __any_sync(0xffffffffu, !valid0 || !valid1);
    if (lane == 0) runs[r] = !any_pad ? kValidRun : !any_valid ? kPadRun : kMixedRun;
  }
  __syncthreads();
  auto tile_class = [&](const uint8_t* rr, int j) { return join(rr[2 * j], rr[2 * j + 1]); };

  if (wg == 2) {
    // The producer: one thread walks the block's items (item blockIdx.x, then
    // every gridDim.x-th) and loads each seen tile's K and V boxes into the
    // ring once both consumers have released the stage, and each item's q
    // once its buffer is free. It reads nothing from device memory, so no
    // load's latency stands between two copies, and the next item's tiles
    // land while the consumers finish this one.
    setmaxnreg_dec<T::PRODUCER_REGS>();
    if (tid != 256) return;
    int it = 1;  // the first item's tile qt is in stage 0
    auto next_stage = [&]() {
      const int s = it % ST;
      if (it >= ST) mbar_wait(&empty[s], (it / ST - 1) & 1);
      ++it;
      return s;
    };
    int ii = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++ii) {
      const int qt = item % nq, bh = item / nq;
      const uint8_t* rr = runs + (bh / heads) * nruns;
      const uint8_t block_rows = tile_class(rr, qt);
      if (ii > 0) {
        load_tile(bh, qt, next_stage());
        if (ii >= QB) mbar_wait(&qempty[ii % QB], (ii / QB - 1) & 1);
        load_q(bh, qt, ii % QB);
      }
      for (int jj = 1; jj < ntiles; ++jj) {
        const int j = qt + jj < ntiles ? qt + jj : qt + jj - ntiles;
        if (seen(block_rows, tile_class(rr, j))) load_tile(bh, j, next_stage());
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows 64 wg.. of each item.
  setmaxnreg_inc<T::CONSUMER_REGS>();
  if (wg == 1) bar_arrive(kTurn, 256);  // consumer 0 takes the first turn
  float o[ND][32], sc[64];
  uint32_t p[8][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  RowState st;
  int it = 0;                // seen tiles taken so far, over every item
  uint64_t qdesc = 0;        // this item's q boxes
  const uint8_t* mrow = nullptr;  // this item's mask row
  uint8_t qseg[2];           // the segments of this thread's two rows

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
  // Seen tile j: in this warpgroup's turn, S = Q K_j^T and (PV) the P V of
  // the tile before; the softmax while P V runs; then O rescaled and p_j
  // packed. No branch lies between a product's issue and its wait (ptxas
  // would serialize the products, C7520): the caller picks MASKED and PV
  // before the step.
  auto step = [&](int j, auto masked, auto pv) {
    constexpr bool MASKED = decltype(masked)::value, PV = decltype(pv)::value;
    const int s = it % ST, sp = (it + ST - 1) % ST;  // this tile's stage, the one before's
    uchar2 kb[16];  // MASKED: the keys' mask bytes, read while the stage lands
    if constexpr (MASKED) key_bytes(kb, mrow + j * kKeys);
    mbar_wait(&full[s], (it / ST) & 1);
    bar_sync(kTurn + wg, 256);
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
    bar_arrive(kTurn + (wg ^ 1), 256);  // the other warpgroup's turn
    if constexpr (PV)
      wgmma_wait_one();
    else
      wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_reg(sc[i]);
    float alpha[2];
    tile_softmax<MASKED>(st, sc, alpha, kb, qseg);
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
    const int qt = item % nq, bh = item / nq, row0 = qt * T::ROWS + kBox * wg;
    const uint8_t* rr = runs + (bh / heads) * nruns;
    const uint8_t block_rows = tile_class(rr, qt), rows = rr[2 * qt + wg];
    mrow = mask == nullptr ? nullptr : mask + (size_t)(bh / heads) * n;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * (warp & 3) + (lane >> 2) + 8 * r;
      qseg[r] = (mrow == nullptr || mrow[row]) ? 1 : 0;
    }
    mbar_wait(&qfull[ii % QB], (ii / QB) & 1);
    // Scale the q boxes in place (one 16-byte chunk a thread a step; the
    // swizzle only moves whole chunks) before wgmma reads them.
    bf16* qw = sQ + (2 * (ii % QB) + wg) * ND * kBoxElems;
    for (int i = tid & 127; i < ND * kBoxElems / 8; i += 128) {
      Vec<bf16>* x = reinterpret_cast<Vec<bf16>*>(qw + 8 * i);
      Vec<bf16> v = *x;
#pragma unroll
      for (int e = 0; e < 8; ++e) v.v[e] = __float2bfloat16(to_f(v.v[e]) * q_scale);
      *x = v;
    }
    fence_proxy_async();
    warpgroup_sync(1 + wg);
    qdesc = desc_b128(qw, 1024, 16);
#pragma unroll
    for (int c = 0; c < ND; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    st = {{neg_inf(), neg_inf()}, {0.f, 0.f}};
    // Whether tile j takes no compare: its keys share the segment of every
    // row of this warpgroup.
    auto plain = [&](int j) { return rows != kMixedRun && tile_class(rr, j) == rows; };
    if (plain(qt))
      step(qt, No{}, No{});
    else
      step(qt, Yes{}, No{});
    for (int jj = 1; jj < ntiles; ++jj) {  // the producer's walk
      const int j = qt + jj < ntiles ? qt + jj : qt + jj - ntiles;
      if (!seen(block_rows, tile_class(rr, j))) continue;
      if (plain(j))
        step(j, No{}, Yes{});
      else
        step(j, Yes{}, Yes{});
    }
    // The item's last S is done, so its q buffer is free for the next copy;
    // then the last tile's P V, in this warpgroup's turn.
    if (lane == 0) mbar_arrive(&qempty[ii % QB]);
    bar_sync(kTurn + wg, 256);
    wgmma_fence();
    issue_pv((it + ST - 1) % ST);
    bar_arrive(kTurn + (wg ^ 1), 256);
    finish_pv((it + ST - 1) % ST);
    store_out<ND>(st, o, out + (size_t)bh * n * D, row0);
  }
  if (wg == 0) bar_sync(kTurn, 256);  // the turn consumer 1 handed over last
}

// The bf16 launch: a persistent grid of min(items, SMs) blocks, each
// walking items blockIdx.x, + gridDim.x, ... (item: 128 query rows of a
// head of a batch row, in the order query tile, head, batch row), in as many
// launches as the run classes of the batch rows need to fit in shared
// memory (one at any practical batch).
template <int D>
static int launch_splash_sm90(int device, const void* q, const void* k, const void* v,
                              const void* mask, void* out, int batch, int n, int heads,
                              float q_scale, cudaStream_t s) {
  using T = Tiles<D>;
  constexpr size_t kMaxSmem = 232448;  // an sm_90 block's dynamic shared memory
  const int per = (int)std::min<size_t>(batch, (kMaxSmem - T::kBytes) / (n / sm90::kBox));
  if (per < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(splash_sm90_kernel<D>, T::kBytes + (size_t)per * n / sm90::kBox);
  for (int b0 = 0; b0 < batch && err == cudaSuccess; b0 += per) {
    const int nb = std::min(per, batch - b0);
    const size_t off = (size_t)b0 * heads * n * D;  // elements of q, k, v and out before b0
    CUtensorMap qmap, kmap, vmap;
    err = sm90::flat_map(&qmap, static_cast<const bf16*>(q) + off, nb * heads, n, D);
    if (err == cudaSuccess)
      err = sm90::flat_map(&kmap, static_cast<const bf16*>(k) + off, nb * heads, n, D, kKeys);
    if (err == cudaSuccess)
      err = sm90::flat_map(&vmap, static_cast<const bf16*>(v) + off, nb * heads, n, D, kKeys);
    if (err != cudaSuccess) break;
    const int items = n / T::ROWS * heads * nb;
    splash_sm90_kernel<D><<<std::min(items, sm90::sm_count(device)), T::THREADS,
                            T::kBytes + (size_t)nb * n / sm90::kBox, s>>>(
        qmap, kmap, vmap,
        mask == nullptr ? nullptr : static_cast<const uint8_t*>(mask) + (size_t)b0 * n,
        static_cast<bf16*>(out) + off, nb, n, heads, q_scale);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace splash
