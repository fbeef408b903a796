// Hopper (sm_90a) primitives shared by the bf16 kernels: TMA tensor maps and
// loads, mbarriers, proxy fences, named barriers, register reallocation
// between warpgroups (`setmaxnreg`) and the `wgmma` forms the attention
// kernels (attention_sm90.cuh, attention_splash_sm90.cuh) and the GEMM
// (gemm_sm90.cuh) use.
//
// Every bf16 tile in shared memory is made of 64 x 64 boxes (8 KB, 128 bytes
// a row), each loaded by one TMA copy with the 128-byte swizzle and read by
// `wgmma` through a descriptor of the same swizzle: chunk c (16 bytes) of
// row r of a box sits at chunk c ^ (r % 8). Box bases are 1024-byte aligned.
// K6 loads two boxes stacked in rows (128 x 64, 16 KB) with one copy: the
// swizzle repeats every 8 rows, so they lie as two boxes would.
//
// Register layout of a m64nN f32 accumulator (lane = 4g + t of warp w of the
// warpgroup): element i is row 16w + g + 8((i >> 1) & 1), column
// 8(i >> 2) + 2t + (i & 1).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime

#include "common.cuh"

namespace sm90 {

constexpr int kBox = 64;                     // rows and bf16 columns of a box
constexpr int kBoxElems = kBox * kBox;       // 4096
constexpr int kBoxBytes = kBoxElems * 2;     // 8 KB

// ------------------------------------------------------------------ host side
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda by the runtime's entry-point
// query: the library then links no -lcuda.
static cudaError_t encode_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// Streaming multiprocessors of the device, looked up once a device.
static int sm_count(int device) {
  static int sms[64] = {0};
  int& count = sms[device & 63];
  if (count == 0 && cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) !=
                        cudaSuccess)
    count = 132;
  return count;
}

// Map of a row-major bf16 matrix [rows, cols] in boxes of box_rows x
// box_cols; coordinates are (column, row). Rows and columns past the matrix
// read as zeros.
static cudaError_t map_2d(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
                          int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn enc;
  cudaError_t err = encode_fn(&enc);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows}, elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The same in 64 x 64 boxes with the 128-byte swizzle, the operand layout
// of every wgmma here.
static cudaError_t box_map(CUtensorMap* map, const void* base, int rows, int cols) {
  return map_2d(map, base, rows, cols, kBox, kBox, CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---------------------------------------------------------- barriers and TMA
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and expect `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of `map` at (c0, c1, c2) into shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of the 2-D map at (c0, c1) into dst, completing on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Generic-proxy writes to shared memory (a tile transformed in place) made
// visible to the async proxy (wgmma reads, later TMA writes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1 and up; 0 is __syncthreads) over the 128 threads of one
// warpgroup.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Named barrier `id` over `count` threads: bar_sync waits until `count`
// threads have arrived (itself included), bar_arrive adds this thread's
// arrival without waiting. Two warpgroups hand a turn back and forth with
// count 256: one syncs on its barrier, the other arrives on it.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Register reallocation of a warp-specialised block: every warp of a
// warpgroup runs it together, with no path of the kernel rejoining the
// warpgroups' after it (else ptxas ignores it, C7508). dec gives registers
// back to the block's pool, inc waits until the pool holds what it asks.
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ------------------------------------------------------------------- wgmma
// Descriptor of a 128-byte-swizzled operand at `smem`: `sbo` bytes between
// 8-row groups, `lbo` bytes between 64-element blocks of an MN-major operand
// (unused by a K-major one).
__device__ __forceinline__ uint64_t desc_b128(const void* smem, uint32_t sbo, uint32_t lbo) {
  return (uint64_t)((smem_u32(smem) >> 4) & 0x3FFF) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most one committed group of this warpgroup is in flight.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Placed after wgmma_wait_all on every register an async wgmma reads or
// writes: the compiler then neither reads an accumulator early nor reuses an
// operand register while the product is in flight.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

#define SM90_D32                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SM90_OUT32(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers (four bf16 pairs a
// thread), B MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#define SM90_D64                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define SM90_OUT64(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),           \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),           \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),           \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),           \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),           \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),           \
      "+f"(d[62]), "+f"(d[63])

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory
// (B: 128 rows, 8-row groups `sbo` apart in the descriptor); accumulate = 0
// overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_OUT64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef SM90_D32
#undef SM90_OUT32
#undef SM90_D64
#undef SM90_OUT64

}  // namespace sm90
