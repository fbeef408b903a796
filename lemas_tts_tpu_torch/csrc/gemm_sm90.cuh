// Warp-specialised bf16 GEMM for Hopper, out = epilogue(prologue(A) . W^T),
// with A [rows, K] and W [ncols, K] (torch Linear weights, already K-major
// for B) both read by TMA in 64 x 64 boxes with the 128-byte swizzle. Used by
// qkv_block (K1) and both launches of ffn_block (K2).
//
// A block owns a 128-row x BN-column output tile: two consumer warpgroups of
// 64 rows, each running wgmma m64nBNk16 with A and B from shared memory into
// BN / 2 f32 accumulators a thread, and one producer warp whose lane 0 keeps
// TMA loads of the next 64-deep stages in flight in a ring of ST stages
// (full and empty mbarriers per stage).
//
// W is one weight, or under kEpiBias the three q, k, v weights side by side
//   (K1: 3 x wcols output columns), each with its own tensor map: wcols % 64
//   == 0, so every 64-column B box lies inside one weight and is loaded
//   through its map, and no concatenated copy of the weights is made.
// prologue (LNMOD): A is the raw residual stream x, and each landed x box is
//   turned into m = T(T((x - mu) rstd) T(1 + scale)) + shift in shared memory
//   by the warpgroup that reads it, in place, before its wgmma (then
//   fence.proxy.async and a warpgroup barrier), as the K3 kernel ropes its K
//   tiles. Each warpgroup transforms stage j + 1 while its stage-j products
//   run. mu and rstd come from ln_stats_kernel, one pass over x before the
//   GEMM ([rows] float2 scratch), so no column-tile block recomputes them.
//   The scale and shift slices of the stage (64 columns of the two batch rows
//   a 128-row tile can straddle, N % 64 == 0) come by TMA with the stage.
//   ln_mod_kernel instead writes the same m once, for a GEMM without it.
// epilogue, in the accumulator's register layout (sm90.cuh), 4-byte stores
//   of column pairs; acc is rounded to bf16, then
//   kEpiBias:     T(acc) + bias, column c of weight j into out[j]  (K1's q, k, v)
//   kEpiGelu:     gelu_tanh(T(acc) + bias)             (K2's hidden h; the tanh
//                 through one exp2 and one reciprocal)
//   kEpiGateRes:  resid + T(gate T(T(acc) + bias))     (K2's block output)
// Rows at or beyond `rows`, columns past the weights and depth past K read
// as zeros (TMA); rows and columns past the output are not stored.
#pragma once

#include "sm90.cuh"

namespace sm90 {

enum { kEpiBias = 0, kEpiGelu = 1, kEpiGateRes = 2 };

// Weights side by side in B: q, k and v under kEpiBias, else one.
template <int EPI>
constexpr int kWeights = EPI == kEpiBias ? 3 : 1;

#define SM90_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define SM90_OUT64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
      "+f"(d[62]), "+f"(d[63])
#define SM90_D96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, " \
  "%90, %91, %92, %93, %94, %95}"
#define SM90_OUT96(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), \
      "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
#define SM90_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, " \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, " \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, " \
  "%123, %124, %125, %126, %127}"
#define SM90_OUT128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), \
      "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), \
      "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), \
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), \
      "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
      "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), \
      "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_OUT64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 192] (+)= A[64 x 16] B[16 x 192], likewise.
__device__ __forceinline__ void wgmma_ss(float (&d)[96], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " SM90_D96
      ", %96, %97, p, 1, 1, 0, 0;\n}\n"
      : SM90_OUT96(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 256] (+)= A[64 x 16] B[16 x 256], likewise.
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SM90_D128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : SM90_OUT128(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef SM90_D64
#undef SM90_OUT64
#undef SM90_D96
#undef SM90_OUT96
#undef SM90_D128
#undef SM90_OUT128

struct GemmArgs {
  const float2* stats;  // [rows] (mean, rstd) of x                 (LNMOD)
  const bf16* bias[3];  // [wcols] of each weight
  bf16* out[3];         // [rows, wcols] of each weight
  const bf16* resid;    // [rows, wcols]                            (kEpiGateRes)
  const bf16* gate;     // [batch, wcols]                           (kEpiGateRes)
  int rows, seq, K, wcols;  // output columns: kWeights<EPI> x wcols
};

// The tensor maps of one launch: A, the weights (b[0] only unless
// kEpiBias), and the scale and shift rows of the prologue (LNMOD only).
struct GemmMaps {
  CUtensorMap a, b[3], scale, shift;
};

constexpr int kGemmBM = 128;                 // rows of a block: two warpgroups of 64
constexpr int kGemmThreads = 2 * 128 + 32;  // + the producer warp
constexpr float kLnEps = 1e-6f;

template <int BN, int ST, bool LNMOD>
struct GemmTiles {
  static constexpr int NB = BN / kBox;                            // B boxes of a stage
  static constexpr int MOD = LNMOD ? 4 * kBox : 0;                // scale, shift: 2 rows each
  static constexpr int STAGE_TX = (2 + NB) * kBoxBytes + MOD * 2;  // TMA bytes of a stage
  static constexpr size_t kBytes = 1024 + (size_t)ST * STAGE_TX + 2 * ST * 8;
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}
// Word e (0..3, a compile-time constant after unrolling) of a 16-byte chunk.
__device__ __forceinline__ uint32_t word(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// (mean, rstd) of the row xr of length K in f32 (fast variance
// E[x^2] - mu^2, eps 1e-6, as ln_mod_gemm.cuh), for every lane of the
// row's warp; lane `lane` sums chunks lane, lane + 32, ... of 8.
__device__ __forceinline__ float2 row_stats(const bf16* xr, int K, int lane) {
  float s = 0.f, ss = 0.f;
  for (int c = lane * 8; c < K; c += 32 * 8) {
    Vec<bf16> v = ld16(xr + c);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
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
  const float mu = s / K;
  return make_float2(mu, 1.f / sqrtf(ss / K - mu * mu + kLnEps));
}

// T(T((x - mu) rstd) s1) + sh of one pair of x, s1 = T(1 + scale): the
// rounding points of every LN-modulate here.
__device__ __forceinline__ uint32_t modulate2(uint32_t x2, float mu, float rs, uint32_t s1,
                                              uint32_t sh) {
  const float2 xf = __bfloat1622float2(bf2(x2));
  const __nv_bfloat162 normed = __floats2bfloat162_rn((xf.x - mu) * rs, (xf.y - mu) * rs);
  return bits(__hadd2(__hmul2(normed, bf2(s1)), bf2(sh)));
}

// mean and rstd of each row of x [rows, K]: one warp a row.
__global__ void __launch_bounds__(256) ln_stats_kernel(const bf16* x, float2* stats, int rows,
                                                       int K) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float2 st = row_stats(x + (size_t)row * K, K, lane);
  if (lane == 0) stats[row] = st;
}

// m [rows, K] = LN-modulate of x [rows, K] with the scale and shift rows
// [batch, K] of each row's batch row, one warp a row: the values the LNMOD
// prologue makes in shared memory, written once for all the column tiles of
// a GEMM without it.
__global__ void __launch_bounds__(256) ln_mod_kernel(const bf16* x, const bf16* scale,
                                                     const bf16* shift, bf16* m, int rows,
                                                     int seq, int K) {
  const int lane = threadIdx.x & 31, row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * K;
  const float2 st = row_stats(xr, K, lane);
  const size_t b = (size_t)(row / seq) * K;
  const __nv_bfloat162 one = __float2bfloat162_rn(1.f);
  for (int c = lane * 8; c < K; c += 32 * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const uint4 sc = *reinterpret_cast<const uint4*>(scale + b + c);
    const uint4 sh = *reinterpret_cast<const uint4*>(shift + b + c);
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = modulate2(word(v, e), st.x, st.y, bits(__hadd2(one, bf2(word(sc, e)))), word(sh, e));
    *reinterpret_cast<uint4*>(m + (size_t)row * K + c) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// GELU_tanh as h sigmoid(2u), u = sqrt(2 / pi) (h + 0.044715 h^3): one MUFU
// exp2 and one MUFU reciprocal, within a few f32 ulps of gelu_tanh.
__device__ __forceinline__ float gelu_tanh_fast(float h) {
  const float u = 0.7978845608028654f * (h + 0.044715f * h * h * h);
  return __fdividef(h, 1.f + __expf(-2.f * u));
}

// The weight of output column col (0 with one weight).
template <int NW>
__device__ __forceinline__ int weight_of(int col, int wcols) {
  return NW == 1 ? 0 : (col >= wcols) + (col >= 2 * wcols);
}

template <int BN, int ST, bool LNMOD, int EPI>
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_sm90_kernel(const __grid_constant__ GemmMaps maps, GemmArgs p) {
  using Tiles = GemmTiles<BN, ST, LNMOD>;
  constexpr int NB = Tiles::NB, NW = kWeights<EPI>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  bf16* sA = reinterpret_cast<bf16*>(base);  // stage s, warpgroup w: box 2 s + w
  bf16* sB = sA + ST * 2 * kBoxElems;        // stage s: boxes NB s ..
  bf16* sMod = sB + ST * NB * kBoxElems;     // stage s: scale, shift rows b0, b0 + 1
  uint64_t* full = reinterpret_cast<uint64_t*>(sMod + ST * Tiles::MOD);
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int c0 = blockIdx.x * BN, r0 = blockIdx.y * kGemmBM;
  const int b0 = r0 / p.seq;
  const int ktiles = (p.K + kBox - 1) / kBox;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // The producer warp: lane 0 keeps the ring full.
    if (tid == 256) {
      const CUtensorMap* bmap[NB];  // the map and column of each B box
      int bcol[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const int col = c0 + kBox * c, j = weight_of<NW>(col, p.wcols);
        bmap[c] = j == 0 ? &maps.b[0] : j == 1 ? &maps.b[1] : &maps.b[2];
        bcol[c] = col - j * p.wcols;
      }
      for (int j = 0; j < ktiles; ++j) {
        const int s = j % ST, k0 = j * kBox;
        if (j >= ST) mbar_wait(&empty[s], (j / ST - 1) & 1);
        mbar_expect_tx(&full[s], Tiles::STAGE_TX);
        tma_load_2d(sA + (2 * s) * kBoxElems, &maps.a, &full[s], k0, r0);
        tma_load_2d(sA + (2 * s + 1) * kBoxElems, &maps.a, &full[s], k0, r0 + kBox);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load_2d(sB + (s * NB + c) * kBoxElems, bmap[c], &full[s], k0, bcol[c]);
        if constexpr (LNMOD) {
          tma_load_2d(sMod + s * Tiles::MOD, &maps.scale, &full[s], k0, b0);
          tma_load_2d(sMod + s * Tiles::MOD + 2 * kBox, &maps.shift, &full[s], k0, b0);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows r0 + 64 wg .. + 63 of the tile.
  const int t128 = tid & 127;
  // The LN-modulate prologue: thread t128 transforms physical chunk pc of
  // rows 16 it + t128 / 8 (it = 0..3) of its warpgroup's box; the swizzle
  // puts logical chunk lc there, the same for all four rows.
  const int pc = t128 & 7, lc = pc ^ ((t128 >> 3) & 7);
  float mu[4], rs[4];
  bool upper[4];  // the row lies in batch row b0 + 1
  if constexpr (LNMOD) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int row = r0 + kBox * wg + 16 * it + (t128 >> 3);
      const float2 st = row < p.rows ? p.stats[row] : make_float2(0.f, 0.f);
      mu[it] = st.x;
      rs[it] = st.y;
      upper[it] = row / p.seq != b0;
    }
  }
  auto transform = [&](int j) {
    const int s = j % ST;
    mbar_wait(&full[s], (j / ST) & 1);
    bf16* box = sA + (2 * s + wg) * kBoxElems;
    const bf16* mod = sMod + s * Tiles::MOD + lc * 8;
    const uint4 sc0 = *reinterpret_cast<const uint4*>(mod);
    const uint4 sc1 = *reinterpret_cast<const uint4*>(mod + kBox);
    const uint4 sh0 = *reinterpret_cast<const uint4*>(mod + 2 * kBox);
    const uint4 sh1 = *reinterpret_cast<const uint4*>(mod + 3 * kBox);
    const __nv_bfloat162 one = __float2bfloat162_rn(1.f);
    uint32_t s1[2][4];  // T(1 + scale) of the two batch rows, in pairs
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s1[0][e] = bits(__hadd2(one, bf2(word(sc0, e))));
      s1[1][e] = bits(__hadd2(one, bf2(word(sc1, e))));
    }
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      uint4* chunk = reinterpret_cast<uint4*>(box + (16 * it + (t128 >> 3)) * kBox + pc * 8);
      const uint4 v = *chunk;
      uint32_t m[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m[e] = modulate2(word(v, e), mu[it], rs[it], upper[it] ? s1[1][e] : s1[0][e],
                         upper[it] ? word(sh1, e) : word(sh0, e));
      *chunk = make_uint4(m[0], m[1], m[2], m[3]);
    }
    fence_proxy_async();
    warpgroup_sync(1 + wg);
  };

  float acc[BN / 2];  // set by the first product (accumulate = 0): no other
                     // instruction may write it while products are in flight
  // Stage j's products are queued behind stage j - 1's; with LNMOD stage
  // j + 1 is transformed while both run. A stage is released once its
  // products are done.
  if constexpr (LNMOD) transform(0);
  for (int j = 0; j < ktiles; ++j) {
    const int s = j % ST;
    if constexpr (!LNMOD) mbar_wait(&full[s], (j / ST) & 1);
    wgmma_fence();
    const uint64_t adesc = desc_b128(sA + (2 * s + wg) * kBoxElems, 1024, 16);
    const uint64_t bdesc = desc_b128(sB + s * NB * kBoxElems, 1024, 16);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 deep a step: +32 bytes
      wgmma_ss(acc, adesc + 2 * kk, bdesc + 2 * kk, j > 0 || kk > 0);
    wgmma_commit();
    if constexpr (LNMOD) {
      if (j + 1 < ktiles) transform(j + 1);
    }
    wgmma_wait_one();  // stage j - 1's products are done
    if (j > 0 && (tid & 31) == 0) mbar_arrive(&empty[(j - 1) % ST]);
  }
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);

  // Epilogue: this thread holds rows g and g + 8 of its warp's 16, columns
  // 8 jj + 2 t and + 1 of the tile.
  const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jj = 0; jj < BN / 8; ++jj) {
    const int col = c0 + 8 * jj + 2 * t;
    if (col >= NW * p.wcols) continue;
    const int w = weight_of<NW>(col, p.wcols), wc = col - w * p.wcols;
    const bf16* bias = w == 0 ? p.bias[0] : w == 1 ? p.bias[1] : p.bias[2];
    bf16* out = w == 0 ? p.out[0] : w == 1 ? p.out[1] : p.out[2];
    const __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(bias + wc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + kBox * wg + 16 * warp + g + 8 * h;
      if (row >= p.rows) continue;
      const __nv_bfloat162 o =
          __hadd2(__floats2bfloat162_rn(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]), b2);
      __nv_bfloat162 y;
      if (EPI == kEpiBias) {
        y = o;
      } else if (EPI == kEpiGelu) {
        const float2 of = __bfloat1622float2(o);
        y = __floats2bfloat162_rn(gelu_tanh_fast(of.x), gelu_tanh_fast(of.y));
      } else {
        const __nv_bfloat162 gt = *reinterpret_cast<const __nv_bfloat162*>(
            p.gate + (size_t)(row / p.seq) * p.wcols + wc);
        const __nv_bfloat162 x =
            *reinterpret_cast<const __nv_bfloat162*>(p.resid + (size_t)row * p.wcols + wc);
        y = __hadd2(x, __hmul2(gt, o));
      }
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * p.wcols + wc) = y;
    }
  }
}

// One launch of the GEMM over a [rows, kWeights<EPI> x wcols] output.
template <int BN, int ST, bool LNMOD, int EPI>
static cudaError_t launch_gemm_sm90(const GemmMaps& maps, const GemmArgs& p, cudaStream_t s) {
  constexpr size_t smem = GemmTiles<BN, ST, LNMOD>::kBytes;
  auto kernel = gemm_sm90_kernel<BN, ST, LNMOD, EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((kWeights<EPI> * p.wcols + BN - 1) / BN, (p.rows + kGemmBM - 1) / kGemmBM);
  kernel<<<grid, kGemmThreads, smem, s>>>(maps, p);
  return cudaGetLastError();
}

}  // namespace sm90
