// Hopper (sm_90a) pipeline building blocks: TMA tensor maps and loads, the
// mbarrier stage ring, wgmma with shared-memory descriptors, setmaxnreg,
// and thread block clusters (rank, distributed shared memory, the cluster
// barrier, the cluster launch).
//
// The layout every helper here agrees on is the 128-byte swizzle: a TMA box
// whose inner extent is 64 16-bit elements (128 B) lands in shared memory
// as rows of 128 B, XOR-swizzled in 1024 B atoms of 8 rows
// (CU_TENSOR_MAP_SWIZZLE_128B), and a wgmma descriptor of layout type
// B128 reads it back. Stage buffers start on 1024 B boundaries.
//
// Tensor maps are encoded on the host by cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, so a library that includes this header
// links against the CUDA runtime alone (no -lcuda). A kernel takes a map
// as a member of a `const __grid_constant__` parameter struct (CUtensorMap
// is 64-byte aligned).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ffpa {
namespace sm90 {

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A 3-D map of 16-bit elements with 128 B swizzle: dims and box innermost
// first, strides in bytes of dims 1 and 2. Elements past dims read as 0.
inline cudaError_t encode_3d(CUtensorMap* map, bool f16, const void* base, uint64_t d0,
                             uint64_t d1, uint64_t d2, uint64_t stride1, uint64_t stride2,
                             uint32_t box0, uint32_t box1) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || stride1 % 16 != 0 || stride2 % 16 != 0 ||
      box0 * 2 != 128)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {stride1, stride2};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        3, const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 3-D map of 1-byte elements (an e4m3 slab read as bytes), unswizzled: a
// box row of box0 bytes (a multiple of 16) lands in shared memory as a
// dense row, so a box is box1 rows of box0 bytes on a 128 B boundary. Dims
// and box innermost first, strides in bytes of dims 1 and 2. Elements past
// dims read as 0.
inline cudaError_t encode_3d_bytes(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
                                   uint64_t d2, uint64_t stride1, uint64_t stride2, uint32_t box0,
                                   uint32_t box1) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || stride1 % 16 != 0 || stride2 % 16 != 0 ||
      box0 % 16 != 0)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {stride1, stride2};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Device: mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cvta_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(cvta_smem(bar)), "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(cvta_smem(bar)) : "memory");
}
// One arrival where pred is set, without a branch (a predicated
// instruction), so the warpgroup's path around wgmma stays uniform.
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          cvta_smem(bar)),
      "r"((int)pred)
      : "memory");
}
// One arrival that also expects `bytes` of TMA traffic before the phase ends.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(cvta_smem(bar)),
               "r"(bytes)
               : "memory");
}
// Blocks until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = cvta_smem(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// mbar_arrive_expect_tx where pred is set, as a predicated instruction.
__device__ __forceinline__ void mbar_arrive_expect_tx_if(uint64_t* bar, uint32_t bytes, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(cvta_smem(bar)),
      "r"(bytes), "r"((int)pred)
      : "memory");
}
// mbar_wait with acquire at cluster scope: for data another block of the
// cluster stored here (st_async_v4) before completing the phase.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = cvta_smem(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// A barrier among `count` threads (whole warps) on hardware barrier `id`
// (1..15; 0 is __syncthreads).
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// Orders this thread's earlier generic-proxy writes to shared memory before
// later async-proxy reads of it (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The box of `map` at (c0, c1, c2) into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(cvta_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(cvta_smem(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// Thread block clusters: rank, distributed shared memory, cluster barrier
// ---------------------------------------------------------------------------

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The shared::cluster address, in block `rank` of the cluster, of the
// shared::cta address `addr` of this block (the same offset there).
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// Four floats stored into another block's shared memory at `remote` (a
// mapa address), completing 16 bytes of transaction on the mbarrier at
// `remote_bar` in that block: the receiver expects the bytes on its own
// barrier and waits there (mbar_wait_cluster). Fire and forget here.
__device__ __forceinline__ void st_async_v4(uint32_t remote, const float* x, uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(remote),
      "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3]), "r"(remote_bar)
      : "memory");
}
// One arrival on the mbarrier at `remote` (a mapa address of a barrier in
// another block of the cluster), releasing this thread's earlier accesses
// at cluster scope: the owner waits on it with mbar_wait_cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t remote) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}
// Four floats of this block's shared memory at shared::cta address addr.
__device__ __forceinline__ void lds_v4(uint32_t addr, float* x) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
               : "r"(addr)
               : "memory");
}
// One 32-bit word into this block's shared memory at shared::cta address
// addr.
__device__ __forceinline__ void sts_u32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}
// Every thread of every block of the cluster meets here: what a thread
// wrote before (barrier initialisation included) is visible to the whole
// cluster after, and no block runs past while another may still write
// into its shared memory.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Host: launches `kernel` over `grid` in clusters of `cluster_x` blocks
// along x (cudaLaunchKernelEx with the cluster-dimension attribute); a
// launch the card refuses returns its error.
template <typename... Params, typename... Args>
inline cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                                  cudaStream_t stream, unsigned cluster_x, Args&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<Args&&>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// A position in an mbarrier stage ring whose depth is a run-time value: the
// stage and the parity of the ring's round (how often it has wrapped, mod
// 2), stepped one stage at a time without a branch, so a walk pays no
// division by the depth at every stage.
struct RingPos {
  int st = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next(int stages) {
    const int n = st + 1;
    const bool wrap = n == stages;
    st = wrap ? 0 : n;
    ph ^= wrap ? 1u : 0u;
  }
};

// ---------------------------------------------------------------------------
// Device: warpgroup registers and wgmma
// ---------------------------------------------------------------------------

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Ties accumulator registers to this point, so the compiler moves no read
// of them above a wgmma_wait.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor for the 128 B swizzle (layout type 1 in
// bits 62-63). Byte offsets are encoded in 16 B units. In the B128 layout:
//  - K-major (K contiguous): rows of 128 B hold 64 K elements; sbo is the
//    stride between groups of 8 M/N rows (1024 B in a dense box); lbo is
//    unused. A k-step of 16 elements moves the start address by 32 B.
//  - MN-major (M or N contiguous): rows of 128 B hold 64 M/N elements, one
//    row per K; sbo is the stride between groups of 8 K rows (1024 B), lbo
//    the stride between 64-element M/N blocks (the next TMA box). A k-step
//    of 16 moves the start address by 16 rows, 2048 B.
__device__ __forceinline__ uint64_t desc_b128(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = cvta_smem(smem);
  uint64_t d = (uint64_t)((a & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// Accumulator operand lists of the m64nNk16 wgmma: R = N / 2 fp32
// registers a thread. Thread t of the warpgroup holds, for each 8-column
// block j, d[4j..4j+3] at rows 16 (t / 32) + (t % 32) / 4 (+8 for the
// last two) and columns 8j + 2 (t % 4) (+1): mma.sync's m16n8 fragment,
// tiled over the warps by rows and over N by columns.
#define FFPA_ACC8(i)                                                                      \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define FFPA_ACC32(i) FFPA_ACC8(i), FFPA_ACC8((i) + 8), FFPA_ACC8((i) + 16), FFPA_ACC8((i) + 24)
#define FFPA_REG8_0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define FFPA_REG16_0 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define FFPA_REG32_0                                                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define FFPA_REG32_1                                                                      \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, " \
  "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define FFPA_REG32_2                                                                      \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, " \
  "%81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define FFPA_REG32_3                                                                          \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "   \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, " \
  "%126, %127"
// TAIL names the operands after the accumulators: a, b, scale-d, trans-a,
// trans-b at R, R+1, R+2, R+3, R+4.
#define FFPA_WGMMA(N, TY, REGS, SCALE, TAIL, ...)                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" SCALE ", 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" REGS \
               "}, " TAIL ";\n}\n"                                                   \
               : __VA_ARGS__                                                         \
               : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB))
#define FFPA_WGMMA_BOTH(N, REGS, SCALE, TAIL, ...)        \
  if constexpr (F16)                                      \
    FFPA_WGMMA(N, "f16", REGS, SCALE, TAIL, __VA_ARGS__); \
  else                                                    \
    FFPA_WGMMA(N, "bf16", REGS, SCALE, TAIL, __VA_ARGS__);

// d (64 x N, fp32) += A (64 x 16) * B (16 x N), both from shared memory
// through descriptors a and b; TA / TB set when A is M-major / B is
// N-major (the transposes wgmma allows for 16-bit types). T is
// __nv_bfloat16 or __half. scale_d 0 gives d = A * B: an accumulation
// starts that way rather than from zeros written by ordinary instructions,
// which ptxas would order against the wgmma pipeline (serializing it).
template <typename T, int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int scale_d = 1) {
  constexpr bool F16 = std::is_same<T, __half>::value;
  static_assert(N == 16 || N == 32 || N == 64 || N == 128 || N == 192 || N == 256,
                "N is 16, 32, 64, 128, 192 or 256");
  if constexpr (N == 16) {
    FFPA_WGMMA_BOTH(16, FFPA_REG8_0, "10", "%8, %9, p, 1, 1, %11, %12", FFPA_ACC8(0))
  } else if constexpr (N == 32) {
    FFPA_WGMMA_BOTH(32, FFPA_REG16_0, "18", "%16, %17, p, 1, 1, %19, %20", FFPA_ACC8(0),
                    FFPA_ACC8(8))
  } else if constexpr (N == 64) {
    FFPA_WGMMA_BOTH(64, FFPA_REG32_0, "34", "%32, %33, p, 1, 1, %35, %36", FFPA_ACC32(0))
  } else if constexpr (N == 128) {
    FFPA_WGMMA_BOTH(128, FFPA_REG32_0 ", " FFPA_REG32_1, "66", "%64, %65, p, 1, 1, %67, %68",
                    FFPA_ACC32(0), FFPA_ACC32(32))
  } else if constexpr (N == 192) {
    FFPA_WGMMA_BOTH(192, FFPA_REG32_0 ", " FFPA_REG32_1 ", " FFPA_REG32_2, "98",
                    "%96, %97, p, 1, 1, %99, %100", FFPA_ACC32(0), FFPA_ACC32(32),
                    FFPA_ACC32(64))
  } else {
    FFPA_WGMMA_BOTH(256, FFPA_REG32_0 ", " FFPA_REG32_1 ", " FFPA_REG32_2 ", " FFPA_REG32_3,
                    "130", "%128, %129, p, 1, 1, %131, %132", FFPA_ACC32(0), FFPA_ACC32(32),
                    FFPA_ACC32(64), FFPA_ACC32(96))
  }
}

#undef FFPA_WGMMA_BOTH
#undef FFPA_WGMMA
#undef FFPA_REG32_3
#undef FFPA_REG32_2
#undef FFPA_REG32_1
#undef FFPA_REG32_0
#undef FFPA_REG16_0
#undef FFPA_REG8_0
#undef FFPA_ACC32
#undef FFPA_ACC8

// Four 8 x 8 matrices of 16-bit elements to shared memory, transposed:
// lane l gives the address of row l % 8 of matrix l / 8; thread t's r[m]
// holds elements (t / 4, 2 (t % 4)) and (t / 4, 2 (t % 4) + 1) of matrix m
// before the transpose (an accumulator fragment), which land in rows
// 2 (t % 4) and 2 (t % 4) + 1 at column t / 4. ldmatrix.trans's inverse.
__device__ __forceinline__ void stsm_x4_trans(void* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   cvta_smem(p)),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// 2^x by the special-function unit's approximation, without the range
// handling of exp2f: the softmax's exponents are <= 0, and results below
// 2^-126 flush to 0, where a row sum cannot see them.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A 64 x 64 box of 16-bit elements (128 B rows): the unit TMA loads and a
// wgmma k16 step reads, 8 KB on a 1024 B boundary.
constexpr int BOX_BYTES = 64 * 64 * 2;

// Column block cb of nb over `chunks` 64-column boxes, in columns: as even
// as possible, the first chunks % nb blocks one box wider. The split of
// every wgmma kernel's column blocks and passes (ops/config.py
// _even_blocks mirrors it).
struct Cols {
  int c0, nc;
};
__host__ __device__ inline Cols col_block(int chunks, int nb, int cb) {
  const int base = chunks / nb, extra = chunks % nb;
  return {(cb * base + (cb < extra ? cb : extra)) * 64, base + (cb < extra ? 1 : 0)};
}

// Byte offset of element (r, c) of a box in the 128 B swizzle: TMA's
// layout and wgmma's B128.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

// One box's product of a warpgroup: 4 wgmma k16 steps, 64 rows. A (64
// rows, K-major) from a, B from b: K-major (TB 0: a k16 step is 32 B along
// the row) or N-major (TB 1: 16 rows of 128 B, lbo between boxes). A step
// adds its offset to the start-address field (16 B units) of the box's
// descriptor, which shared memory's 18-bit addresses never carry out of.
// With fresh set, the first step overwrites acc (scale-d 0).
template <typename T, int N, int TB, int R>
__device__ __forceinline__ void box_mma(float (&acc)[R], const unsigned char* a,
                                        const unsigned char* b, bool fresh = false) {
  constexpr uint32_t b_step = TB ? 2048 : 32, lbo = TB ? BOX_BYTES : 16;
  const uint64_t da = desc_b128(a, 16, 1024), db = desc_b128(b, lbo, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<T, N, 0, TB>(acc, da + kk * (32 >> 4), db + kk * (b_step >> 4),
                          kk > 0 || !fresh);
}

}  // namespace sm90
}  // namespace ffpa
