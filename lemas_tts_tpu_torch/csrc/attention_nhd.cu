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
//   in principle; between the two products sit the exponentials (MUFU) and
//   the in-kernel rope (sincosf), which the design below keeps off the
//   tensor cores' critical path as far as it can.
// Function: q is roped and scaled by the f32 1/sqrt(D), then rounded; k is
//   roped, then rounded; scores accumulate in f32; padded keys score -1e30,
//   keys beyond N -inf; the unnormalised p is rounded before the PV product;
//   / max(l, 1e-30) comes last. The running max starts where the JAX package's
//   softmax starts it: K3 runs one-shot (no floor) unless N > 2048 and
//   N % 512 == 0, where it is chunked from the floor -1e29; K4 is always
//   one-shot. So a query row whose keys are all masked gets the mean of v,
//   except from K3 in the chunked regime, where it gets 0.
//
// bf16 (the main path), attention_sm90.cuh: a block is WGS consumer
//   warpgroups (four at d64, two at d128) and one producer warp. The
//   producer issues TMA loads of the q boxes once and of each 64-key tile's K
//   and V boxes, rope angles and mask bytes into a ring of ST stages,
//   completing on mbarriers; the tensor maps are 3-D ([B, N, H*D], a box at
//   column h*D), so the flat layout is read in place, and rows past N read as
//   zeros. Each consumer warpgroup ropes and scales its own q box once. All
//   consumer threads rope the next K tile in shared memory, one 16-byte chunk
//   each at d64, while the current tile's score product runs, so each block
//   ropes each K tile once. Then S = Q K^T with wgmma (A and B from shared
//   memory), the softmax in registers (exp2 with log2(e) folded in, the mask
//   a select), O += P V with wgmma (P from registers, V as stored, transpose
//   bit set), and the stage is released.
//   K3: one block per (64 WGS query rows, head, batch row); warpgroup w takes
//   query rows 64w .. 64w + 63. d64 and d128.
//   K4 (d64 only): one block per (128 query rows, head pair, batch row);
//   warpgroup w takes head 2p + (w & 1) and query rows 64 (w >> 1) .., and
//   each stage loads the pair's K and V windows once, as two boxes: the
//   Hopper counterpart of the TPU's block-diagonal packing. Each warpgroup
//   runs K3's instruction sequence on the same tiles in the same order, so K4
//   equals K3 bit for bit.
// f32 (the checking path; wgmma has no full-precision f32 mode), attention.cuh:
//   exact-FMA tile products in the mma.sync register layout,
//   one block per 64-query tile (K3) or per 64-query tile and head pair (K4).
#include <cmath>

#include "attention_sm90.cuh"

// ------------------------------------------------------------------- f32
template <typename T, int D>
__global__ void __launch_bounds__(128)
    attn_nhd_kernel(const T* q, const T* k, const T* v, const uint8_t* mask, const float* angles,
                    T* out, int N, int heads, float sm_scale, float m0) {
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
  init_rows(st, m0);
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
                         const float* angles, T* out, int N, int heads, float sm_scale,
                         float m0) {
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
  init_rows(st, m0);
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

// ------------------------------------------------------------ bf16, sm_90a
namespace {
// Work split of the bf16 kernel: WGS consumer warpgroups of 64 query rows and
// one producer warp. d64 runs four: 17 warps, so one SM sub-partition holds
// five and ptxas gives each thread 96 registers (one block an SM); d128 runs
// two, as its O accumulator takes 32 more registers a thread. ST stages of K,
// V, rope angles and mask bytes; shared memory holds the q boxes, the ring
// and the barriers. K4 ropes two K boxes a tile, and roping two tiles ahead
// keeps that off its score products (K3 gains nothing from it).
template <int D, bool PAIR>
struct Sm90Tiles {
  static constexpr int WGS = D == 64 ? 4 : 2;                 // consumer warpgroups
  static constexpr int CONSUMERS = 128 * WGS;                  // their threads
  static constexpr int THREADS = CONSUMERS + 32;               // + the producer warp
  static constexpr int ND = D / sm90::kBox;                    // boxes per head
  static constexpr int NQ = WGS * ND;                          // q boxes of the block
  static constexpr int NKV = PAIR ? 2 : ND;                    // K (and V) boxes of a stage
  static constexpr int ST = D == 64 ? 4 : 3;                   // stages
  static constexpr int AHEAD = PAIR ? 2 : 1;                  // K tiles roped ahead
  static constexpr int ROWS = sm90::kBox * (PAIR ? WGS / 2 : WGS);  // query rows of a block
  static constexpr int ANG = sm90::kBox * D / 2;               // angles of a tile's 64 keys
  static constexpr int KEEP = 128;  // bytes of a stage's 64 mask bytes (TMA aligns to 128)
  static constexpr size_t kBytes = 1024 + (size_t)(NQ + 2 * ST * NKV) * sm90::kBoxBytes +
                                   ST * (ANG * sizeof(float) + KEEP) + (3 * ST + 1) * 8;
};
}  // namespace

template <int D, bool PAIR>
__global__ void __launch_bounds__(Sm90Tiles<D, PAIR>::THREADS, 1)
    attn_nhd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap amap,
                         const __grid_constant__ CUtensorMap mmap, bool has_mask,
                         const float* angles, bf16* out, int n, int heads, float sm_scale,
                         float m0) {
  using namespace sm90;
  using Tiles = Sm90Tiles<D, PAIR>;
  constexpr int WGS = Tiles::WGS, ND = Tiles::ND, NQ = Tiles::NQ, NKV = Tiles::NKV,
                ST = Tiles::ST, CONSUMERS = Tiles::CONSUMERS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  bf16* sQ = reinterpret_cast<bf16*>(base);  // box w * ND + c: warpgroup w's c-th box
  bf16* sK = sQ + NQ * kBoxElems;            // stage s, box c at (s * NKV + c) * kBoxElems
  bf16* sV = sK + ST * NKV * kBoxElems;
  float* sAng = reinterpret_cast<float*>(sV + ST * NKV * kBoxElems);   // [ST][64][D / 2]
  uint8_t* sKeep = reinterpret_cast<uint8_t*>(sAng + ST * Tiles::ANG);  // [ST][KEEP] mask bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(sKeep + ST * Tiles::KEEP);  // stage landed
  uint64_t* ready = full + ST;                                         // its K roped
  uint64_t* empty = ready + ST;                                        // stage released
  uint64_t* qfull = empty + ST;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int b = blockIdx.z, ntiles = n / kBox;
  const int q0 = blockIdx.x * Tiles::ROWS;
  const int col0 = blockIdx.y * (PAIR ? 2 * kBox : D);  // first column of the head (pair)
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], CONSUMERS);
      mbar_init(&empty[s], CONSUMERS / 32);  // lane 0 of every consumer warp
    }
    mbar_init(qfull, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == WGS) {
    // The producer warp: one thread loads the q boxes once, then each tile's
    // K and V boxes, rope angles and mask bytes into the ring as soon as the
    // consumers release the stage.
    if (tid == CONSUMERS) {
      mbar_expect_tx(qfull, NQ * kBoxBytes);
      for (int w = 0; w < WGS; ++w)
        for (int c = 0; c < ND; ++c)
          tma_load(sQ + (w * ND + c) * kBoxElems, &qmap, qfull,
                   col0 + kBox * (PAIR ? (w & 1) : c), q0 + kBox * (PAIR ? (w >> 1) : w), b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(&empty[s], (j / ST - 1) & 1);
        mbar_expect_tx(&full[s], 2 * NKV * kBoxBytes + Tiles::ANG * sizeof(float) +
                                     (has_mask ? kBox : 0));
        tma_load_2d(sAng + s * Tiles::ANG, &amap, &full[s], 0, j * kBox);
        if (has_mask) tma_load_2d(sKeep + s * Tiles::KEEP, &mmap, &full[s], j * kBox, b);
        for (int c = 0; c < NKV; ++c) {
          tma_load(sK + (s * NKV + c) * kBoxElems, &kmap, &full[s], col0 + kBox * c, j * kBox, b);
          tma_load(sV + (s * NKV + c) * kBoxElems, &vmap, &full[s], col0 + kBox * c, j * kBox, b);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg. K3: query rows 64 wg.. of the block's head; K4:
  // head 2p + (wg & 1), query rows 64 (wg >> 1)..
  const int kvbox = PAIR ? (wg & 1) : 0;  // its first K/V box within a stage
  const int row0 = q0 + kBox * (PAIR ? (wg >> 1) : wg);
  const size_t inner = (size_t)heads * D;
  const uint64_t qdesc = desc_b128(sQ + wg * ND * kBoxElems, 1024, 16);

  // Every consumer thread ropes its share of tile j's K boxes once the stage
  // has landed (one 16-byte chunk at d64), then arrives on ready.
  auto rope_k = [&](int j) {
    const int s = j % ST;
    mbar_wait(&full[s], (j / ST) & 1);
    rope_boxes<ND, NKV, CONSUMERS>(sK + s * NKV * kBoxElems, j * kBox, n,
                                   sAng + s * Tiles::ANG, j * kBox, 1.f, tid);
    fence_proxy_async();
    mbar_arrive(&ready[s]);
  };

  // this warpgroup's q boxes, roped and scaled once they land
  mbar_wait(qfull, 0);
  rope_boxes<ND, ND, 128>(sQ + wg * ND * kBoxElems, row0, n, angles, 0, sm_scale, tid & 127);
  fence_proxy_async();
  warpgroup_sync(1 + wg);
  for (int t = 0; t < Tiles::AHEAD && t < ntiles; ++t) rope_k(t);

  float o[ND][32], sc[32];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  RowState st = {{m0, m0}, {0.f, 0.f}};
  // One product in flight at a time (S, softmax, P V): the other warpgroups'
  // products fill the tensor cores meanwhile, and the registers of a second
  // S in flight would serialize the wgmmas (96 a thread with 17 warps).
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % ST;
    mbar_wait(&ready[s], (j / ST) & 1);
    wgmma_fence();
    const uint64_t kdesc = desc_b128(sK + (s * NKV + kvbox) * kBoxElems, 1024, 16);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // S = Q K^T: 16 head columns a step, next box after 64
      const uint64_t off = ((kk >> 2) * kBoxBytes + (kk & 3) * 32) >> 4;
      wgmma_ss_n64(sc, qdesc + off, kdesc + off, kk > 0);
    }
    wgmma_commit();
    if (j + Tiles::AHEAD < ntiles) rope_k(j + Tiles::AHEAD);  // beside the score product
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(sc[i]);
    uint32_t p[4][4];
    softmax_step<ND>(st, sc, o, p, has_mask ? sKeep + s * Tiles::KEEP : nullptr);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < ND; ++c) {  // O += P V: 16 keys (rows of V, 2 KB) a step
      const uint64_t vdesc = desc_b128(sV + (s * NKV + kvbox + c) * kBoxElems, 1024, kBoxBytes);
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
  sm90::store_rows<ND>(st, o, out + (size_t)b * n * inner + col0 + kvbox * kBox, inner, row0, n);
}

template <int D, bool PAIR>
static int launch_sm90(const void* q, const void* k, const void* v, const void* mask,
                       const void* angles, void* out, int batch, int n, int heads,
                       float sm_scale, float m0, cudaStream_t s) {
  using Tiles = Sm90Tiles<D, PAIR>;
  const int width = heads * D;
  CUtensorMap qmap, kmap, vmap, amap, mmap = {};
  cudaError_t err = sm90::flat_map(&qmap, q, batch, n, width);
  if (err == cudaSuccess) err = sm90::flat_map(&kmap, k, batch, n, width);
  if (err == cudaSuccess) err = sm90::flat_map(&vmap, v, batch, n, width);
  if (err == cudaSuccess) err = sm90::angles_map(&amap, angles, n, D / 2);
  if (err == cudaSuccess && mask != nullptr) err = sm90::mask_map(&mmap, mask, batch, n);
  if (err == cudaSuccess) err = allow_smem(attn_nhd_sm90_kernel<D, PAIR>, Tiles::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + Tiles::ROWS - 1) / Tiles::ROWS, PAIR ? heads / 2 : heads, batch);
  attn_nhd_sm90_kernel<D, PAIR><<<grid, Tiles::THREADS, Tiles::kBytes, s>>>(
      qmap, kmap, vmap, amap, mmap, mask != nullptr, static_cast<const float*>(angles),
      static_cast<bf16*>(out), n, heads, sm_scale, m0);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ f32 launches
// Shared memory of one f32 block: q, k and v tiles of width `width`, key flags.
static size_t tile_smem(int width) {
  using namespace attn;
  return (size_t)(BQ + 2 * BKV) * (width + PAD) * sizeof(float) + BKV * sizeof(float);
}

template <int D>
static int launch_f32(const void* q, const void* k, const void* v, const void* mask,
                      const void* angles, void* out, int batch, int n, int heads, float sm_scale,
                      float m0, cudaStream_t s) {
  const size_t smem = tile_smem(D);
  cudaError_t err = allow_smem(attn_nhd_kernel<float, D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n / attn::BQ, heads, batch);
  attn_nhd_kernel<float, D><<<grid, 128, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(angles),
      static_cast<float*>(out), n, heads, sm_scale, m0);
  return (int)cudaGetLastError();
}

static int launch_pair_f32(const void* q, const void* k, const void* v, const void* mask,
                           const void* angles, void* out, int batch, int n, int heads,
                           float sm_scale, float m0, cudaStream_t s) {
  const size_t smem = tile_smem(128);
  cudaError_t err = allow_smem(attn_nhd_pair_kernel<float>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n / attn::BQ, heads / 2, batch);
  attn_nhd_pair_kernel<float><<<grid, 256, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(angles),
      static_cast<float*>(out), n, heads, sm_scale, m0);
  return (int)cudaGetLastError();
}

// Starting running max of K3: the JAX kernel's softmax is one-shot (no
// floor, -inf here) unless N > 2048 and N % 512 == 0, where it runs chunked
// from the floor -1e29 (the same rule as ops/attention.py:nhd_start_max).
static float k3_start_max(int n) { return n > 2048 && n % 512 == 0 ? attn::kMFloor : -INFINITY; }

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
  const float m0 = k3_start_max(n);
  if (dtype == kBF16)
    return dim_head == 64
               ? launch_sm90<64, false>(q, k, v, mask, angles, out, batch, n, heads, sm_scale,
                                        m0, s)
               : launch_sm90<128, false>(q, k, v, mask, angles, out, batch, n, heads, sm_scale,
                                         m0, s);
  return dim_head == 64
             ? launch_f32<64>(q, k, v, mask, angles, out, batch, n, heads, sm_scale, m0, s)
             : launch_f32<128>(q, k, v, mask, angles, out, batch, n, heads, sm_scale, m0, s);
}

// K4: the same arguments; dim_head must be 64 and heads even. Its softmax is
// one-shot at every N, so the running max starts at -inf.
extern "C" int lemas_attention_nhd_pack(int device, int dtype, int dim_head, const void* q,
                                        const void* k, const void* v, const void* mask,
                                        const void* angles, void* out, int batch, int n,
                                        int heads, float sm_scale, void* stream) {
  if (dim_head != 64 || heads % 2 != 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == kBF16
             ? launch_sm90<64, true>(q, k, v, mask, angles, out, batch, n, heads, sm_scale,
                                     -INFINITY, s)
             : launch_pair_f32(q, k, v, mask, angles, out, batch, n, heads, sm_scale,
                               -INFINITY, s);
}
