// conv_taps_mish: one grouped 1-D convolution of ConvPositionEmbedding with
// its bias and Mish, channel-last: out[b, n, o] = mish(T(bias[o] +
// sum_t sum_i xpad[b, n + t, g cin + i] w[g, t, o, i])), o in group g, xpad
// x with (pad_left, pad_right) zero rows around each batch row, T the
// rounding to the compute type.
//
// Replaces no TPU kernel. The JAX package lowers this conv in XLA as K shifted
// tap products accumulated in f32 (lemas_tts_tpu/models/modules.py:
// GroupedConvTaps, taken because XLA's grouped conv ran at ~6 % of the MXU).
// On the H100 the port first ran it through cuDNN: per conv one fprop launch
// a group (16), layout transposes, a pad copy of a transposed view and a
// strided Mish pass, ~29 ms of card time a flagship request. One launch here
// does all of that (two a DiT forward).
// Bound on the H100: at rows 2, N 1024, C 1024, k 31, 16 groups the call is
//   2 rows N C 64 k = 8.3 GFLOP against 12.4 MB (x, out, the taps), ~670
//   FLOP/byte: the tensor cores bound it (8.4 us at 989 TFLOP/s).
// bf16 (the main path): an implicit GEMM for each (tile of BM = 128 output
//   frames of one batch row, group): M 128, N 64 output channels, depth
//   k x 64 input channels. One producer warp and two consumer warpgroups of
//   64 frames each.
//   - The halo tile (BM + k - 1 input rows x the group's 64 channels, 20 KB at
//     k 31) lands once by one TMA copy of a 3-D map over x [B, N, C]: rows
//     before 0 or past N inside the batch row read as zeros, so the padding
//     costs nothing and a tile never reads another batch row.
//   - The group's taps ([64 out x 64 in] each, 8 KB; 248 KB a group at k 31,
//     more than a block's shared memory) stream through a ring of ST stages
//     by TMA, full and empty mbarriers a stage.
//   - A comes from registers: for tap t, a warp's 16 frames are halo rows
//     t + 16 w .. + 15, which no shared-memory descriptor can address (a
//     descriptor starts on an 8-row swizzle atom); each warp reads them by
//     ldmatrix, any row shift conflict-free under the 128-byte swizzle, and
//     runs wgmma m64n64k16 with A in registers and the tap K-major in shared
//     memory (a TMA re-load of A per tap would read each tile k times from
//     L2). Tap t + 1's fragments load while tap t's products run (two
//     register sets, one wgmma group a tap in flight).
//   - Epilogue in f32 in the accumulator's registers: + bias, rounded to
//     bf16, Mish as x n / (n + 2), n = e^x (e^x + 2) (= x tanh(softplus x);
//     x above 20 passes), rounded again, 4-byte stores of channel pairs;
//     frames past N_out are not stored.
// f32 (the checking path; wgmma has no full-precision f32 mode): exact f32
//   FMAs, one block of 256 threads a (64 frames, group, batch row), the halo
//   in shared memory and one tap at a time beside it.
// The taps come from the wrapper as [groups, k, 64 out, 64 in] (ops/conv.py
// keeps that copy of the torch [C, 64, k] weight); 64 channels a group.
#include "sm90.cuh"

namespace {
using namespace sm90;

constexpr int kCG = 64;                    // channels a group, in and out
constexpr int kBM = 128;                   // output frames a bf16 block
constexpr int kST = 4;                     // tap stages in the ring
constexpr int kThreads = 2 * 128 + 32;     // two consumer warpgroups + the producer warp
constexpr int kMaxHalo = 256;              // rows of one TMA box
constexpr int kF32Rows = 64;               // output frames an f32 block

__host__ __device__ constexpr int halo_bytes(int ksize) {
  return ((kBM + ksize - 1) * kCG * 2 + 1023) / 1024 * 1024;
}
static size_t smem_bytes(int ksize) {
  return 1024 + (size_t)halo_bytes(ksize) + kST * kBoxBytes + (2 * kST + 1) * 8;
}

// Mish of an f32 value: x tanh(log(1 + e^x)) = x n / (n + 2), n = e^x (e^x + 2);
// above 20 tanh(softplus(x)) is 1 in f32 (and n would overflow).
__device__ __forceinline__ float mish(float x) {
  if (x > 20.f) return x;
  const float e = __expf(x), n = e * (e + 2.f);
  return __fdividef(x * n, n + 2.f);
}

#define CONV_D32                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define CONV_OUT32(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers (four bf16 pairs a
// thread), B K-major in shared memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CONV_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : CONV_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
#undef CONV_D32
#undef CONV_OUT32

// The A fragments of one tap for this warp: frames r0 .. r0 + 15 of the halo
// tile (r0 = tap + the warp's first frame), all 64 channels as four k16
// steps. Lane l addresses row r0 + (l & 7) + 8 ((l >> 3) & 1), chunk
// 2 kk + (l >> 4); the tile sits in 128-byte rows with chunk c of row r at
// c ^ (r % 8) (TMA's 128-byte swizzle, the base 1024-byte aligned).
__device__ __forceinline__ void load_taps_a(uint32_t (&a)[4][4], uint32_t halo, int r0,
                                            int lane) {
  const int row = r0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const uint32_t line = halo + row * 128;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int chunk = (2 * kk + (lane >> 4)) ^ (row & 7);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
                 : "r"(line + chunk * 16));
  }
}

struct ConvArgs {
  const bf16* bias;  // [C]
  bf16* out;         // [B, n_out, C]
  int n_out, channels, ksize;
};

// grid (output tiles, batch rows, groups)
__global__ void __launch_bounds__(kThreads, 2)
    conv_taps_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap, ConvArgs p, int pad_left) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  unsigned char* sX = base;                             // the halo tile
  bf16* sW = reinterpret_cast<bf16*>(base + halo_bytes(p.ksize));  // stage s: box s
  uint64_t* full = reinterpret_cast<uint64_t*>(sW + kST * kBoxElems);
  uint64_t* empty = full + kST;
  uint64_t* xbar = empty + kST;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int n0 = blockIdx.x * kBM, b = blockIdx.y, g = blockIdx.z, K = p.ksize;
  if (tid == 0) {
    for (int s = 0; s < kST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    mbar_init(xbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // The producer warp: lane 0 loads the halo tile, then keeps the tap ring full.
    if (tid == 256) {
      mbar_expect_tx(xbar, (kBM + K - 1) * kCG * 2);
      tma_load(sX, &xmap, xbar, g * kCG, n0 - pad_left, b);
      for (int t = 0; t < K; ++t) {
        const int s = t % kST;
        if (t >= kST) mbar_wait(&empty[s], (t / kST - 1) & 1);
        mbar_expect_tx(&full[s], kBoxBytes);
        tma_load_2d(sW + s * kBoxElems, &wmap, &full[s], 0, (g * K + t) * kCG);
      }
    }
    return;
  }

  // Consumer warpgroup wg: output frames n0 + 64 wg .. + 63; warp w of it
  // frames + 16 w .. + 15.
  const int warp = (tid >> 5) & 3, r_warp = kBox * wg + 16 * warp;
  const uint32_t halo = smem_u32(sX);
  float acc[32];  // set by the first product (accumulate = 0)
  uint32_t a0[4][4], a1[4][4];
  // Tap t's products are queued behind tap t - 1's; once those are done, their
  // stage is released and their register set takes tap t + 1's fragments.
  auto tap = [&](int t, uint32_t (&cur)[4][4], uint32_t (&next)[4][4]) {
    const int s = t % kST;
    mbar_wait(&full[s], (t / kST) & 1);
    wgmma_fence();
    const uint64_t bdesc = desc_b128(sW + s * kBoxElems, 1024, 16);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 deep a step: +32 bytes
      wgmma_rs_n64(acc, cur[kk], bdesc + 2 * kk, t > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait_one();  // tap t - 1's products are done
    if (t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % kST]);
    if (t + 1 < K) load_taps_a(next, halo, r_warp + t + 1, lane);
  };
  mbar_wait(xbar, 0);
  load_taps_a(a0, halo, r_warp, lane);
  for (int t = 0; t < K; t += 2) {
    tap(t, a0, a1);
    if (t + 1 < K) tap(t + 1, a1, a0);
  }
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_reg(acc[i]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      fence_reg(a0[kk][h]);
      fence_reg(a1[kk][h]);
    }

  // Epilogue: this thread holds frames g8 and g8 + 8 of its warp's 16,
  // channels 8 jj + 2 q and + 1 of the group (accumulator layout, sm90.cuh).
  const int g8 = lane >> 2, q = lane & 3;
  const size_t row0 = (size_t)b * p.n_out;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = g * kCG + 8 * jj + 2 * q;
    const float2 bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.bias + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + r_warp + g8 + 8 * h;
      if (n >= p.n_out) continue;
      const float2 c = __bfloat1622float2(__floats2bfloat162_rn(acc[4 * jj + 2 * h] + bias.x,
                                                                acc[4 * jj + 2 * h + 1] + bias.y));
      *reinterpret_cast<__nv_bfloat162*>(p.out + (row0 + n) * p.channels + col) =
          __floats2bfloat162_rn(mish(c.x), mish(c.y));
    }
  }
}

// f32: block (64 output frames, batch row, group) of 256 threads; thread
// (4 frames-quarter, 64 channels) owns channel tid % 64 of 16 frames.
__global__ void __launch_bounds__(256)
    conv_taps_f32_kernel(const float* x, const float* taps, const float* bias, float* out,
                         int n_in, int n_out, int channels, int ksize, int pad_left) {
  extern __shared__ float smem_f[];
  const int halo_rows = kF32Rows + ksize - 1;
  float* sX = smem_f;                   // [halo_rows][64]
  float* sW = sX + halo_rows * kCG;     // one tap, [64 in][64 out]
  const int tid = threadIdx.x, o = tid & 63, m0 = (tid >> 6) * 16;
  const int n0 = blockIdx.x * kF32Rows, b = blockIdx.y, g = blockIdx.z;
  for (int e = tid; e < halo_rows * kCG; e += 256) {
    const int r = e / kCG, c = e % kCG, n = n0 - pad_left + r;
    sX[e] = (n >= 0 && n < n_in) ? x[((size_t)b * n_in + n) * channels + g * kCG + c] : 0.f;
  }
  float acc[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) acc[m] = 0.f;
  for (int t = 0; t < ksize; ++t) {
    __syncthreads();  // the halo is in; the last tap is read
    const float* wt = taps + ((size_t)g * ksize + t) * kCG * kCG;  // [64 out][64 in]
    for (int e = tid; e < kCG * kCG; e += 256) sW[(e % kCG) * kCG + e / kCG] = wt[e];
    __syncthreads();
    for (int i = 0; i < kCG; ++i) {
      const float w = sW[i * kCG + o];
#pragma unroll
      for (int m = 0; m < 16; ++m) acc[m] = fmaf(sX[(m0 + m + t) * kCG + i], w, acc[m]);
    }
  }
  const float bo = bias[g * kCG + o];
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int n = n0 + m0 + m;
    if (n < n_out) out[((size_t)b * n_out + n) * channels + g * kCG + o] = mish(acc[m] + bo);
  }
}

// Map of x [batch, n, channels] bf16 in boxes of `rows` x 64 channels with
// the 128-byte swizzle; coordinates (channel, row, batch row). Rows outside
// [0, n) read as zeros.
cudaError_t halo_map(CUtensorMap* map, const void* x, int batch, int n, int channels, int rows) {
  EncodeTiledFn enc;
  cudaError_t err = encode_fn(&enc);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)channels, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)channels * 2, (cuuint64_t)n * channels * 2};
  const cuuint32_t box[3] = {kCG, (cuuint32_t)rows, 1}, elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}
}  // namespace

// device: the CUDA device of the tensors (this library links its own CUDA
// runtime, whose current device is not PyTorch's). x [batch, n_in, channels],
// taps [channels / 64, ksize, 64, 64], bias [channels], out [batch, n_out,
// channels], all of dtype `dtype`; n_out = n_in + pad_left + pad_right -
// ksize + 1, and pad_right is implied by it.
extern "C" int lemas_conv_taps_mish(int device, int dtype, const void* x, const void* taps,
                                    const void* bias, void* out, int batch, int n_in, int n_out,
                                    int channels, int ksize, int pad_left, void* stream) {
  if (channels % kCG != 0 || ksize < 1 || kBM + ksize - 1 > kMaxHalo || n_out < 1 ||
      batch < 1 || batch > 65535 || channels / kCG > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = channels / kCG;
  if (dtype == kBF16) {
    CUtensorMap xmap, wmap;
    err = halo_map(&xmap, x, batch, n_in, channels, kBM + ksize - 1);
    if (err == cudaSuccess) err = box_map(&wmap, taps, groups * ksize * kCG, kCG);
    const size_t smem = smem_bytes(ksize);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(conv_taps_sm90_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ConvArgs p = {static_cast<const bf16*>(bias), static_cast<bf16*>(out), n_out, channels,
                  ksize};
    const dim3 grid((n_out + kBM - 1) / kBM, batch, groups);
    conv_taps_sm90_kernel<<<grid, kThreads, smem, s>>>(xmap, wmap, p, pad_left);
    return (int)cudaGetLastError();
  }
  const size_t smem = ((size_t)(kF32Rows + ksize - 1) * kCG + kCG * kCG) * sizeof(float);
  err = cudaFuncSetAttribute(conv_taps_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_out + kF32Rows - 1) / kF32Rows, batch, groups);
  conv_taps_f32_kernel<<<grid, 256, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(taps),
      static_cast<const float*>(bias), static_cast<float*>(out), n_in, n_out, channels, ksize,
      pad_left);
  return (int)cudaGetLastError();
}
