// Paged decode attention for Hopper (sm_90a): the counterpart of the Pallas
// _paged_decode_kernel (ffpa_attn_tpu/ops/paged.py). ops/paged.py calls the C
// entry point ffpa_paged_decode through ctypes.
//
// K/V live in a global pool of pages [P, Hkv, page, D] (bf16/f16, or int8
// with per-row fp32 scales [P, Hkv, page]); sequence b's cache position pos
// is row pos % page of pool page table[b * max_pages + pos / page], and
// lens[b] rows are valid. Packed row r (query head hkv * group + r / nq at
// position r % nq, PackGQA: K/V stream once per KV head) attends cached
// positions < lens - (nq - 1) + r % nq (all nq new tokens already appended),
// and with a window those >= that limit - 1 - window_left. int8 pools: the K
// scale multiplies S (before softcap, so the cap sees the true logit) and the
// V scale multiplies P after the row sum, so no page is dequantized.
//
// Bound on an H100: bytes. At R = 2 packed rows the kernel does 2
// multiply-adds per K element it loads, against the card's balance point of
// 295 flop per byte (utils/profiling.py paged_decode_counts): the time is the
// cache's bytes over 3.35 TB/s plus whatever latency is not hidden. The TPU
// grid (B, Hkv, max_pages) walks one sequence's pages in order; at the
// serving shape that is 16 blocks for 132 SMs. So the walk is split, and
// launch 2 merges the splits by LSE (split_merge.cuh, the dense decode's):
//   launch 1, grid (splits, Hkv * row_blocks, B), writes fp32 partials
//   normalised by their own l with lse_s = m + log l (-inf where a split
//   attended nothing), [B, Hkv, splits, R, Dv] and [B, Hkv, splits, R].
//
// Launch 1 is one TMA + wgmma block (namespace tma) for every shape the
// TPU kernel takes: D, Dv <= 1024 in 64-column multiples, pages of any
// size, bf16/f16 or int8 pools. make_plan sizes it (ffpa_paged_plan hands
// the plan out, ops/config.py paged_plan mirrors it).
//
// * The split. Each block cuts its split from its own sequence's length on
//   the device: the live range [first, lens[b]) (first: the window's first
//   position rounded down to a 64-row tile, else 0) is cut into `splits`
//   near-equal runs of whole tiles, so every block of a live sequence streams
//   about the same bytes and none streams positions past lens[b].
// * The stream. The producer warp keeps a ring of 8 KiB stages full (up to
//   12, about 90 KiB in flight a block): each stage is 64 cache rows x 128 B
//   of K or V (64 bf16/f16 or 128 int8 columns), landed by TMA through a 3-D
//   map (D, page, P * Hkv) with the 128 B swizzle as boxes of box_rows rows,
//   box_rows the largest power of two dividing both the page and 64, so a box
//   never crosses a page. TMA swizzles by the shared address, so a stage of
//   boxes of 1..64 rows reads as one 64-row box; at 64 / box_rows boxes a
//   stage (up to 64, pages of an odd size) the warp's lanes share the issues,
//   each reading the page table once for each of its boxes a tile.
// * The math. One consumer warpgroup (D, Dv <= 512) does it with wgmma, roles
//   swapped so the 64 cache rows are M and the packed rows N = 16:
//   S^T = K Q^T (Q resident in 16-row boxes) and O^T += V^T P^T (V read
//   M-major, P^T through one swizzled 16 x 64 box); S and the fp32 O^T (64
//   registers a thread at Dv 512) stay in registers, the row maxima cross the
//   four warps through shared memory, and only two 128-thread named barriers
//   a tile stand between the stages. int8 stages are widened to the query
//   type into two swizzled 64 x 64 boxes by the consumers before their
//   products. Two blocks fit an SM.
// * Above 512 (SPLIT): O^T at Dv 1024 would take 128 registers a thread, so
//   two consumer warpgroups split Dv's stages (col_block), each holding the
//   D512 block's 64 registers of O^T. Both form the same S^T from every K
//   stage (bit-identical, so the same softmax, with no barrier between them:
//   a decode's S products are a few percent of its time) and keep their own
//   P^T box, exchange slots and int8 staging; each waits on and frees every
//   stage of the stream, its partner's V stages unread, so a stage's phases
//   stay in step. One block an SM, 288 threads.
#include <string.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"
#include "split_merge.cuh"

namespace {

using namespace ffpa;

constexpr int KV_TILE = 64;   // K/V rows per tile (ops/config.py KV_TILE)
constexpr int D_CHUNK = 64;   // head-dim columns per box (ops/config.py D_CHUNK)
constexpr int MAX_D = 1024;   // head dims the block takes

namespace tma {

using namespace ffpa::sm90;

constexpr int ROWS = 16;                       // packed rows of a block: wgmma's N
constexpr int TILE = KV_TILE;                  // cache rows of a tile: wgmma's M
constexpr int STAGE_BYTES = TILE * 128;        // 64 rows x 128 B of K or V
constexpr int MAX_BOXES = 8;                   // 64-column boxes of O^T a warpgroup holds
constexpr int MAX_STAGES = 12;
constexpr int CONSUMERS = 128;                 // a warpgroup: the math
constexpr int CONSUMER_WARPS = CONSUMERS / 32; // a warpgroup's arrivals that free a stage
constexpr int Q_BOX_BYTES = ROWS * 128;        // 16 rows x 64 columns of Q, or of P^T
constexpr int STAGING_BYTES = 2 * BOX_BYTES;   // an int8 stage widened: two 64 x 64 boxes
constexpr int XCH_FLOATS = 2 * CONSUMER_WARPS * ROWS;  // per-warp row maxima, two tiles
// D, Dv <= 512: two blocks an SM, 228 KiB of shared memory, 1 KiB of it
// reserved a block. Above: one block an SM, all a block may opt into.
constexpr size_t BLOCK_SMEM = 115712;
constexpr size_t SPLIT_BLOCK_SMEM = 232448;

// Consumer warpgroups of the instance, and its threads (and one producer
// warp).
__host__ __device__ constexpr int warpgroups(bool split) { return split ? 2 : 1; }
__host__ __device__ constexpr int threads(bool split) {
  return warpgroups(split) * CONSUMERS + 32;
}

// Shared memory of a block besides its ring (a stage is STAGE_COST with its
// two barriers): the 1024 B alignment, Q's boxes and, per warpgroup, int8's
// two staging buffers, the P^T box and the exchange.
constexpr size_t fixed_bytes(int nd, bool q8, bool split) {
  return 1024 + (size_t)nd * Q_BOX_BYTES +
         warpgroups(split) * ((q8 ? 2 * (size_t)STAGING_BYTES : 0) + Q_BOX_BYTES +
                              XCH_FLOATS * sizeof(float));
}
constexpr size_t STAGE_COST = STAGE_BYTES + 2 * sizeof(uint64_t);
static_assert(fixed_bytes(MAX_BOXES, true, false) + 2 * STAGE_COST <= BLOCK_SMEM,
              "int8 at D512 keeps a ring of two stages or more");
static_assert(fixed_bytes(MAX_D / 64, true, true) + 2 * STAGE_COST <= SPLIT_BLOCK_SMEM,
              "int8 at D1024 keeps a ring of two stages or more");

// Shared memory of a block, from a 1024 B boundary.
struct Smem {
  unsigned char* ring;     // stages x 8 KiB
  unsigned char* staging;  // int8: per warpgroup two buffers of two widened boxes
  unsigned char* q;        // nd boxes of 16 x 64
  unsigned char* p;        // per warpgroup P^T: 16 packed rows x 64 cache rows
  float* xch;              // per warpgroup [2][CONSUMER_WARPS][ROWS]
  uint64_t* full;
  uint64_t* empty;
};
__device__ __forceinline__ Smem carve(unsigned char* base, int nd, int stages, bool q8, int wgs) {
  Smem sm;
  sm.ring = base;
  sm.staging = sm.ring + (size_t)stages * STAGE_BYTES;
  sm.q = sm.staging + (q8 ? wgs * 2 * STAGING_BYTES : 0);
  sm.p = sm.q + nd * Q_BOX_BYTES;
  sm.xch = reinterpret_cast<float*>(sm.p + wgs * Q_BOX_BYTES);
  sm.full = reinterpret_cast<uint64_t*>(sm.xch + wgs * XCH_FLOATS);
  sm.empty = sm.full + stages;
  return sm;
}

// The kernel's tensor maps, a __grid_constant__ parameter of their own (TMA
// reads them by address); the scalars stay an ordinary parameter.
struct Maps {
  CUtensorMap k_map;  // (D, page, P * Hkv); box (128 B, box_rows, 1)
  CUtensorMap v_map;  // (Dv, page, P * Hkv)
};

struct Params {
  const void* q;          // packed [B, Hkv, R, D]
  const float* k_scales;  // [P, Hkv, page] (int8 pools), else null
  const float* v_scales;
  const int* table;       // [B * max_pages]
  const int* lens;        // [B]
  float* o_part;          // [B, Hkv, splits, R, Dv]
  float* lse_part;        // [B, Hkv, splits, R]
  int Hkv, nrows, nq, D, Dv, page, max_pages, box_rows, stages, num_splits, row_blocks;
  float scale, softcap;
  int window_left;
};

// A pool map: 3-D (columns, row in page, page * Hkv + kv head) of one pool,
// 128 B boxes of box_rows rows, 128 B swizzle. int8 pools move as bytes.
inline cudaError_t encode_pool(CUtensorMap* map, int esize, bool f16, const void* base, int cols,
                               int page, uint64_t slabs, int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const CUtensorMapDataType dt = esize == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                 : f16      ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)page, slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * esize, (cuuint64_t)page * cols * esize};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / esize), (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || strides[0] % 16 != 0)
    return cudaErrorInvalidValue;
  const CUresult r = fn(map, dt, 3, const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A block's packed rows and cache rows: its split of the live range
// [first, n), cut on the device from lens[b] into num_splits near-equal runs
// of whole tiles (ops/paged.py paged_split_ranges is the same rule). The
// same in every thread.
struct Range {
  int b, kvh, row0, n, kv_lo, kv_hi, ntiles;
};
__device__ __forceinline__ Range range_of(const Params& p) {
  Range r;
  r.b = blockIdx.z;
  r.kvh = blockIdx.y / p.row_blocks;
  r.row0 = (blockIdx.y % p.row_blocks) * ROWS;
  r.n = min(p.lens[r.b], p.max_pages * p.page);
  int first = 0;
  if (p.window_left >= 0) first = (max(0, r.n - p.nq - p.window_left) / TILE) * TILE;
  const int live = r.n > first ? (r.n - first + TILE - 1) / TILE : 0;
  const int t0 = (int)((long long)blockIdx.x * live / p.num_splits);
  const int t1 = (int)((long long)(blockIdx.x + 1) * live / p.num_splits);
  r.kv_lo = first + t0 * TILE;
  r.kv_hi = min(first + t1 * TILE, r.n);
  r.ntiles = t1 - t0;
  return r;
}

// The producer warp: per tile, lane l takes boxes l and l + 32 of every
// stage (64 / box_rows boxes a stage), each box's page read once from the
// table (past the table's end, the null page: such rows are masked); then
// the K stages and the V stages, each all the boxes of 64 rows of one 128 B
// column slab. Lane 0 arms the stage's barrier before any lane issues.
__device__ __forceinline__ void produce(const Maps& maps, const Params& p, const Smem& sm,
                                        const Range& r, int nks, int nvs, int slab_cols) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    prefetch_map(&maps.k_map);
    prefetch_map(&maps.v_map);
  }
  const int* trow = p.table + (long long)r.b * p.max_pages;
  const int nb = TILE / p.box_rows;
  int it = 0;
  for (int t = 0; t < r.ntiles; ++t) {
    const int kv0 = r.kv_lo + t * TILE;
    int slab[2], off[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int bx = lane + 32 * i;
      slab[i] = 0;
      off[i] = 0;
      if (bx < nb) {
        const int pos = kv0 + bx * p.box_rows, pi = pos / p.page;
        const int pid = pi < p.max_pages ? __ldg(trow + pi) : 0;
        slab[i] = pid * p.Hkv + r.kvh;
        off[i] = pos - pi * p.page;
      }
    }
#pragma unroll 1
    for (int kv = 0; kv < 2; ++kv) {
      const CUtensorMap* map = kv ? &maps.v_map : &maps.k_map;
      const int ns = kv ? nvs : nks;
      for (int j = 0; j < ns; ++j, ++it) {
        const int st = it % p.stages;
        if (it >= p.stages) mbar_wait(&sm.empty[st], ((it / p.stages) - 1) & 1);
        if (lane == 0) mbar_arrive_expect_tx(&sm.full[st], STAGE_BYTES);
        __syncwarp();
        unsigned char* dst = sm.ring + (size_t)st * STAGE_BYTES;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int bx = lane + 32 * i;
          if (bx < nb)
            tma_load_3d(dst + bx * p.box_rows * 128, map, &sm.full[st], j * slab_cols, off[i],
                        slab[i]);
        }
      }
    }
  }
}

// Four int8 values (one 32-bit word) as two pairs of the query type; exact
// (|x| <= 128 fits both types' significands).
template <typename T>
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi);
template <>
__device__ __forceinline__ void widen4<__half>(uint32_t w, uint32_t& lo, uint32_t& hi) {
  // 0x64uu is 1024 + u in f16; u = x + 128.
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t a = __byte_perm(u, 0x64646464u, 0x4140), b = __byte_perm(u, 0x64646464u, 0x4342);
  const __half2 bias = __halves2half2(__ushort_as_half(0x6480), __ushort_as_half(0x6480));
  const __half2 x = __hsub2(*reinterpret_cast<const __half2*>(&a), bias);
  const __half2 y = __hsub2(*reinterpret_cast<const __half2*>(&b), bias);
  lo = *reinterpret_cast<const uint32_t*>(&x);
  hi = *reinterpret_cast<const uint32_t*>(&y);
}
template <>
__device__ __forceinline__ void widen4<__nv_bfloat16>(uint32_t w, uint32_t& lo, uint32_t& hi) {
  // 0x4B0000uu is 2^23 + u in fp32; the integer result's top half is its bf16.
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// An int8 stage (64 rows x 128 columns, swizzled) widened to two swizzled
// 64 x 64 boxes of T: thread tid takes half a row, 4 chunks of 16 values
// (the second half in rotated order, so no two threads of a quarter warp
// meet in a bank).
template <typename T>
__device__ __forceinline__ void widen_stage(const unsigned char* src, unsigned char* dst,
                                            int tid) {
  const int row = tid >> 1, half = tid & 1, sw = row & 7;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cc = half ? 4 + ((k + 2) & 3) : k;  // 16-column chunk of the int8 row
    const uint4 x = *reinterpret_cast<const uint4*>(src + row * 128 + ((cc ^ sw) << 4));
    uint32_t w[8];
    widen4<T>(x.x, w[0], w[1]);
    widen4<T>(x.y, w[2], w[3]);
    widen4<T>(x.z, w[4], w[5]);
    widen4<T>(x.w, w[6], w[7]);
    unsigned char* box = dst + (cc >> 2) * BOX_BYTES + row * 128;
    const int c0 = 2 * (cc & 3);  // its two 8-column chunks in the box
    *reinterpret_cast<uint4*>(box + ((c0 ^ sw) << 4)) = make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(box + (((c0 + 1) ^ sw) << 4)) = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// O^T (64 rows of Dv x 16 packed rows) += V^T P^T for one 64-column V box: A
// is the box read M-major (a k16 step is 16 rows, 2048 B), B the P^T box
// (K-major, 32 B a step).
template <typename T>
__device__ __forceinline__ void pv_mma(float (&acc)[8], const unsigned char* vbox,
                                       const unsigned char* pbox) {
  const uint64_t da = desc_b128(vbox, BOX_BYTES, 1024), db = desc_b128(pbox, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<T, ROWS, 1, 0>(acc, da + kk * (2048 >> 4), db + kk * (32 >> 4), 1);
}

// A consumer warpgroup. Accumulator element 4 j + 2 hh + e of thread (warp,
// g = lane / 4, t4 = lane % 4) is M row 16 warp + g + 8 hh and packed row
// (N column) 8 j + 2 t4 + e: for S^T the cache row kv0 + 16 warp + g + 8 hh,
// for O^T box i's column 64 i + 16 warp + g + 8 hh. Element 4 j + 2 hh + e
// belongs to this thread's packed-row slot jj = 2 j + e. With SPLIT,
// warpgroup wg owns V stages [vs0, vs0 + vsn) of each tile (col_block over
// the tile's nvs), Dv boxes from vb0 on.
template <typename T, bool Q8, bool SPLIT>
__device__ __forceinline__ void consume(const Params& p, const Smem& sm, const Range& r, int nd,
                                        int nv, int nks, int nvs) {
  constexpr int WGS = warpgroups(SPLIT);
  constexpr int MAX_VS = Q8 ? MAX_BOXES / 2 : MAX_BOXES;  // V stages of a warpgroup, at most
  constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;
  const int tid = threadIdx.x & (CONSUMERS - 1), warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // The warpgroup's index through a shuffle, so the compiler sees it uniform
  // across the warp and the branches on it around wgmma as not divergent.
  const int wg = SPLIT ? __shfl_sync(0xffffffffu, (int)(threadIdx.x / CONSUMERS), 0) : 0;
  const int bar = SPLIT ? 2 + wg : 1;  // this warpgroup's named barrier
  int vs0 = 0, vsn = nvs;
  if constexpr (SPLIT) {
    const Cols c = col_block(nvs, WGS, wg);
    vs0 = c.c0 / 64;
    vsn = c.nc;
  }
  const int vb0 = Q8 ? 2 * vs0 : vs0;  // this warpgroup's first Dv box
  unsigned char* const pbox = sm.p + wg * Q_BOX_BYTES;
  float* const xch0 = sm.xch + wg * XCH_FLOATS;

  // Q: the block's 16 packed rows (zeros past R) into nd swizzled boxes, by
  // every consumer thread.
  const T* qb = static_cast<const T*>(p.q) + (long long)(r.b * p.Hkv + r.kvh) * p.nrows * p.D;
  for (int i = threadIdx.x; i < ROWS * nd * 8; i += WGS * CONSUMERS) {
    const int row = i / (nd * 8), c = i - row * (nd * 8);  // 8-column chunk c of the row
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r.row0 + row < p.nrows)
      x = *reinterpret_cast<const uint4*>(qb + (long long)(r.row0 + row) * p.D + 8 * c);
    *reinterpret_cast<uint4*>(sm.q + (c >> 3) * Q_BOX_BYTES + swz(row, 8 * (c & 7))) = x;
  }

  int col[4], lim[4];
  bool live[4];
  float m[4], l[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    col[jj] = 8 * (jj >> 1) + 2 * t4 + (jj & 1);
    const int row = r.row0 + col[jj];
    live[jj] = row < p.nrows;
    lim[jj] = r.n - (p.nq - 1) + row % p.nq;
    m[jj] = -INFINITY;
    l[jj] = 0.f;
  }
  float o[MAX_BOXES * 8];
#pragma unroll
  for (int i = 0; i < MAX_BOXES * 8; ++i) o[i] = 0.f;
  fence_operands(o);
  fence_proxy_async();
  named_barrier_sync(1, WGS * CONSUMERS);  // Q is in

  // it: the stream's stage index; held: a stage whose products may still
  // run (one group stays in flight); sg: int8 staging buffers used.
  int it = 0, held = -1, sg = 0;
  auto release = [&](int st, bool pred) { mbar_arrive_if(&sm.empty[st], pred && lane == 0); };
  auto done_with = [&](int st) {
    wgmma_commit();
    wgmma_wait<1>();
    release(held >= 0 ? held : 0, held >= 0);
    held = st;
  };
  auto drain = [&]() {
    wgmma_wait<0>();
    release(held >= 0 ? held : 0, held >= 0);
    held = -1;
  };
  // int8: stage st widened into this warpgroup's next staging buffer, then
  // freed; the buffer's products of two stages before completed at the
  // last wait.
  auto widen = [&](int st) -> const unsigned char* {
    unsigned char* stg = sm.staging + (wg * 2 + (sg++ & 1)) * STAGING_BYTES;
    widen_stage<T>(sm.ring + (size_t)st * STAGE_BYTES, stg, tid);
    __syncwarp();
    release(st, true);
    fence_proxy_async();
    named_barrier_sync(bar, CONSUMERS);
    return stg;
  };
  // SPLIT: the partner's V stages, waited on and freed unread, so this
  // warpgroup sees every phase of every stage.
  auto pass_over = [&](int count) {
    for (int j = 0; j < count; ++j, ++it) {
      const int st = it % p.stages;
      mbar_wait(&sm.full[st], (it / p.stages) & 1);
      release(st, true);
    }
  };
  const int* trow = p.table + (long long)r.b * p.max_pages;

  for (int t = 0; t < r.ntiles; ++t) {
    const int kv0 = r.kv_lo + t * TILE;
    int pos[2];
    float ksc[2] = {1.f, 1.f}, vsc[2] = {1.f, 1.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      pos[hh] = kv0 + 16 * warp + g + 8 * hh;
      if constexpr (Q8) {
        // The row scales, once a tile; read before the stream's wait.
        if (pos[hh] < r.kv_hi) {
          const long long pg = __ldg(trow + pos[hh] / p.page);
          const long long pr = (pg * p.Hkv + r.kvh) * p.page + pos[hh] % p.page;
          ksc[hh] = __ldg(p.k_scales + pr);
          vsc[hh] = __ldg(p.v_scales + pr);
        }
      }
    }

    // S^T = K Q^T over D: stage j holds the 128 B column slab j.
    float s[8];
    for (int j = 0; j < nks; ++j, ++it) {
      const int st = it % p.stages;
      mbar_wait(&sm.full[st], (it / p.stages) & 1);
      if constexpr (Q8) {
        const unsigned char* stg = widen(st);
        wgmma_fence();
        box_mma<T, ROWS, 0>(s, stg, sm.q + 2 * j * Q_BOX_BYTES, j == 0);
        if (2 * j + 1 < nd)
          box_mma<T, ROWS, 0>(s, stg + BOX_BYTES, sm.q + (2 * j + 1) * Q_BOX_BYTES);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_fence();
        box_mma<T, ROWS, 0>(s, sm.ring + (size_t)st * STAGE_BYTES, sm.q + j * Q_BOX_BYTES, j == 0);
        done_with(st);
      }
    }
    drain();  // also completes the tile before's P V products
    fence_operands(s);
    fence_operands(o);  // no rescale of O moves above the wait

    // Scores in log2 units; masked ones MASK_VALUE (finite, so m is).
    float sv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int hh = (i >> 1) & 1, jj = 2 * (i >> 2) + (i & 1);
      const int ps = pos[hh];
      bool keep = live[jj] && ps < r.kv_hi && ps < lim[jj];
      if (p.window_left >= 0) keep = keep && ps >= lim[jj] - 1 - p.window_left;
      float x = s[i] * p.scale * ksc[hh];
      if (p.softcap > 0.f) x = p.softcap * tanhf(__fdividef(x, p.softcap));
      sv[i] = keep ? x * LOG2E : MASK_VALUE;
    }

    // Column (packed-row) maxima: this thread's two cache rows, the warp's
    // 16 (lanes of one t4), then the four warps through the exchange.
    float* xch = xch0 + (t & 1) * (CONSUMER_WARPS * ROWS);
    float mx[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int i0 = 4 * (jj >> 1) + (jj & 1);
      mx[jj] = fmaxf(sv[i0], sv[i0 + 2]);
      mx[jj] = fmaxf(mx[jj], __shfl_xor_sync(0xffffffffu, mx[jj], 4));
      mx[jj] = fmaxf(mx[jj], __shfl_xor_sync(0xffffffffu, mx[jj], 8));
      mx[jj] = fmaxf(mx[jj], __shfl_xor_sync(0xffffffffu, mx[jj], 16));
      if (g == 0) xch[warp * ROWS + col[jj]] = mx[jj];
    }
    named_barrier_sync(bar, CONSUMERS);
    float alpha[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float mt = xch[col[jj]];
#pragma unroll
      for (int w = 1; w < CONSUMER_WARPS; ++w) mt = fmaxf(mt, xch[w * ROWS + col[jj]]);
      const float mn = fmaxf(m[jj], mt);
      alpha[jj] = ex2(m[jj] - mn);  // 0 on the first tile (m = -inf)
      m[jj] = mn;
    }

    // P = 2^(s - m); l sums it before the V scale; P^T into its box.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int hh = (i >> 1) & 1, jj = 2 * (i >> 2) + (i & 1);
      const float pv = sv[i] == MASK_VALUE ? 0.f : ex2(sv[i] - m[jj]);
      if ((i & 2) == 0) l[jj] *= alpha[jj];
      l[jj] += pv;
      *reinterpret_cast<T*>(pbox + swz(col[jj], 16 * warp + g + 8 * hh)) =
          from_float<T>(pv * vsc[hh]);
    }
#pragma unroll
    for (int i = 0; i < MAX_BOXES * 8; ++i) o[i] *= alpha[2 * ((i & 7) >> 2) + (i & 1)];
    fence_operands(o);
    fence_proxy_async();
    named_barrier_sync(bar, CONSUMERS);  // P^T is in; every warp has read the maxima

    // O^T += V^T P^T: V stage vs0 + j is the 128 B column slab vs0 + j (Dv
    // box vb0 + j, or boxes vb0 + 2 j and vb0 + 2 j + 1 of an int8 pool).
    if constexpr (SPLIT) pass_over(vs0);
#pragma unroll
    for (int j = 0; j < MAX_VS; ++j) {
      if (j < vsn) {
        const int st = it % p.stages;
        mbar_wait(&sm.full[st], (it / p.stages) & 1);
        if constexpr (Q8) {
          const unsigned char* stg = widen(st);
          wgmma_fence();
          pv_mma<T>(*reinterpret_cast<float(*)[8]>(o + 16 * j), stg, pbox);
          if (vb0 + 2 * j + 1 < nv)
            pv_mma<T>(*reinterpret_cast<float(*)[8]>(o + 16 * j + 8), stg + BOX_BYTES, pbox);
          wgmma_commit();
          wgmma_wait<1>();
        } else {
          wgmma_fence();
          pv_mma<T>(*reinterpret_cast<float(*)[8]>(o + 8 * j), sm.ring + (size_t)st * STAGE_BYTES,
                    pbox);
          done_with(st);
        }
        ++it;
      }
    }
    if constexpr (SPLIT) pass_over(nvs - vs0 - vsn);
  }
  drain();
  fence_operands(o);

  // Epilogue: l over the warp's lanes and the four warps; o_s = O / l and
  // lse_s = m + log l on rows below R (l == 0: o_s = 0, lse_s = -inf). A
  // warpgroup writes its own Dv boxes; warpgroup 0 writes lse_s.
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    l[jj] += __shfl_xor_sync(0xffffffffu, l[jj], 4);
    l[jj] += __shfl_xor_sync(0xffffffffu, l[jj], 8);
    l[jj] += __shfl_xor_sync(0xffffffffu, l[jj], 16);
    if (g == 0) xch0[warp * ROWS + col[jj]] = l[jj];  // read by all before the last barrier
  }
  named_barrier_sync(bar, CONSUMERS);
  const int nvb = SPLIT ? min(nv - vb0, (Q8 ? 2 : 1) * vsn) : nv;  // this warpgroup's boxes
  const long long base = ((long long)(r.b * p.Hkv + r.kvh) * p.num_splits + blockIdx.x) * p.nrows;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    if (!live[jj]) continue;
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < CONSUMER_WARPS; ++w) lt += xch0[w * ROWS + col[jj]];
    const float inv = lt == 0.f ? 0.f : __fdividef(1.f, lt);
    const long long row = base + r.row0 + col[jj];
    float* dst = p.o_part + row * p.Dv + 64 * vb0 + 16 * warp + g;
#pragma unroll
    for (int i = 0; i < MAX_BOXES; ++i) {
      if (i < nvb) {
        dst[64 * i] = o[8 * i + 4 * (jj >> 1) + (jj & 1)] * inv;
        dst[64 * i + 8] = o[8 * i + 4 * (jj >> 1) + 2 + (jj & 1)] * inv;
      }
    }
    if (wg == 0 && warp == 0 && g == 0)
      p.lse_part[row] = lt == 0.f ? -INFINITY : m[jj] * LN2 + logf(lt);
  }
}

template <typename T, bool Q8, bool SPLIT>
__global__ void __launch_bounds__(threads(SPLIT), SPLIT ? 1 : 2)
    paged_tma_kernel(const __grid_constant__ Maps maps, const Params p) {
  constexpr int WGS = warpgroups(SPLIT);
  extern __shared__ unsigned char smem_raw[];
  // Boxes on 1024 B boundaries: the 128 B swizzle's atom.
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int nd = p.D / 64, nv = p.Dv / 64;
  constexpr int SLAB_COLS = Q8 ? 128 : 64;  // columns of a 128 B slab
  const int nks = (p.D + SLAB_COLS - 1) / SLAB_COLS, nvs = (p.Dv + SLAB_COLS - 1) / SLAB_COLS;
  const Range r = range_of(p);
  if (r.ntiles == 0) {
    // A split with no tile: o_s = 0, lse_s = -inf, which the merge weighs 0.
    const long long base_row =
        ((long long)(r.b * p.Hkv + r.kvh) * p.num_splits + blockIdx.x) * p.nrows + r.row0;
    const int rows = min(ROWS, p.nrows - r.row0);
    for (int i = threadIdx.x; i < rows * p.Dv; i += threads(SPLIT))
      p.o_part[base_row * p.Dv + i] = 0.f;
    if (threadIdx.x < rows) p.lse_part[base_row + threadIdx.x] = -INFINITY;
    return;
  }
  const Smem sm = carve(base, nd, p.stages, Q8, WGS);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], WGS * CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x < WGS * CONSUMERS)
    consume<T, Q8, SPLIT>(p, sm, r, nd, nv, nks, nvs);
  else
    produce(maps, p, sm, r, nks, nvs, SLAB_COLS);
}

template <typename T, bool Q8, bool SPLIT>
cudaError_t launch(const Params& p, size_t smem, const void* k_pages, const void* v_pages,
                   int num_pages, int B, cudaStream_t st) {
  const bool f16 = std::is_same<T, __half>::value;
  const int esize = Q8 ? 1 : 2;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const uint64_t slabs = (uint64_t)num_pages * p.Hkv;
  cudaError_t e = encode_pool(&maps.k_map, esize, f16, k_pages, p.D, p.page, slabs, p.box_rows);
  if (e == cudaSuccess)
    e = encode_pool(&maps.v_map, esize, f16, v_pages, p.Dv, p.page, slabs, p.box_rows);
  if (e != cudaSuccess) return e;
  auto kern = paged_tma_kernel<T, Q8, SPLIT>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.num_splits, p.Hkv * p.row_blocks, B);
  kern<<<grid, threads(SPLIT), smem, st>>>(maps, p);
  return cudaGetLastError();
}

// The launch's registers a thread and local (spill) bytes a thread.
template <typename T, bool Q8>
cudaError_t attributes(bool split, cudaFuncAttributes* a) {
  return split ? cudaFuncGetAttributes(a, paged_tma_kernel<T, Q8, true>)
               : cudaFuncGetAttributes(a, paged_tma_kernel<T, Q8, false>);
}

}  // namespace tma

// The tiling of a launch at head dims (D, Dv), multiples of 64 up to 1024,
// over pages of `page` rows: 16 packed rows a block (a taller packing takes
// row blocks); box_rows the largest power of two dividing the page and 64;
// D, Dv <= 512 one consumer warpgroup in a block's share of two an SM,
// wider heads two (SPLIT) in one block an SM; as many 8 KiB stages, at most
// 12, as fit beside the fixed bytes. ffpa_paged_plan hands it out;
// ops/config.py paged_plan mirrors it and the card test holds the two
// equal.
struct Plan {
  int rows, box_rows, stages, consumers, blocks_per_sm;
  size_t smem;
};
inline Plan make_plan(int D, int Dv, int page, bool q8) {
  Plan pl = {};
  const bool split = D > 512 || Dv > 512;
  pl.rows = tma::ROWS;
  pl.box_rows = KV_TILE;
  while (page % pl.box_rows != 0) pl.box_rows /= 2;
  pl.consumers = tma::warpgroups(split);
  pl.blocks_per_sm = split ? 1 : 2;
  const size_t fixed = tma::fixed_bytes(D / 64, q8, split);
  const size_t budget = split ? tma::SPLIT_BLOCK_SMEM : tma::BLOCK_SMEM;
  pl.stages = (int)std::min((size_t)tma::MAX_STAGES, (budget - fixed) / tma::STAGE_COST);
  pl.smem = fixed + pl.stages * tma::STAGE_COST;
  return pl;
}

inline bool valid_dims(int D, int Dv, int page) {
  return D > 0 && Dv > 0 && D <= MAX_D && Dv <= MAX_D && D % D_CHUNK == 0 && Dv % D_CHUNK == 0 &&
         page >= 1;
}

template <typename T>
cudaError_t launch_paged(const tma::Params& p, const Plan& pl, bool q8, const void* k_pages,
                         const void* v_pages, int num_pages, void* o, float* lse, int B,
                         cudaStream_t st) {
  const bool split = pl.consumers == 2;
  cudaError_t e;
  if (q8)
    e = split ? tma::launch<T, true, true>(p, pl.smem, k_pages, v_pages, num_pages, B, st)
              : tma::launch<T, true, false>(p, pl.smem, k_pages, v_pages, num_pages, B, st);
  else
    e = split ? tma::launch<T, false, true>(p, pl.smem, k_pages, v_pages, num_pages, B, st)
              : tma::launch<T, false, false>(p, pl.smem, k_pages, v_pages, num_pages, B, st);
  if (e != cudaSuccess) return e;
  return launch_split_merge<T>(p.o_part, p.lse_part, o, lse, p.nrows, p.num_splits, p.Dv,
                               B * p.Hkv, st);
}

}  // namespace

extern "C" int ffpa_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                 const float* k_scales, const float* v_scales, const int* table,
                                 const int* lens, void* o, float* lse, float* o_part,
                                 float* lse_part, int is_fp16, int quantized, int B, int Hkv,
                                 int R, int nq, int D, int Dv, int page, int max_pages,
                                 int num_pages, float scale, float softcap, int window_left,
                                 int num_splits, void* stream) {
  if (!valid_dims(D, Dv, page) || max_pages < 1 || num_pages < 1 || nq < 1 || R < 1 ||
      num_splits < 1 || (quantized && (k_scales == nullptr || v_scales == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(D, Dv, page, quantized != 0);
  tma::Params p = {};
  p.q = q;
  p.k_scales = k_scales;
  p.v_scales = v_scales;
  p.table = table;
  p.lens = lens;
  p.o_part = o_part;
  p.lse_part = lse_part;
  p.Hkv = Hkv;
  p.nrows = R;
  p.nq = nq;
  p.D = D;
  p.Dv = Dv;
  p.page = page;
  p.max_pages = max_pages;
  p.box_rows = pl.box_rows;
  p.stages = pl.stages;
  p.num_splits = num_splits;
  p.row_blocks = (R + pl.rows - 1) / pl.rows;
  p.scale = scale;
  p.softcap = softcap;
  p.window_left = window_left;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_fp16 ? launch_paged<__half>(p, pl, quantized, k_pages, v_pages, num_pages, o,
                                              lse, B, st)
                       : launch_paged<__nv_bfloat16>(p, pl, quantized, k_pages, v_pages,
                                                     num_pages, o, lse, B, st));
}

// The tiling ffpa_paged_decode takes at head dims (D, Dv), multiples of 64
// up to 1024, over pages of `page` rows: out[0..6] are the route (1, TMA:
// the only one), the packed rows of a block, the rows of a TMA box, the
// ring's stages, the dynamic shared-memory bytes of a block, its consumer
// warpgroups and the blocks an SM holds; cap is out's length.
extern "C" int ffpa_paged_plan(int D, int Dv, int page, int quantized, int* out, int cap) {
  if (!valid_dims(D, Dv, page) || cap < 7) return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(D, Dv, page, quantized != 0);
  out[0] = 1;
  out[1] = pl.rows;
  out[2] = pl.box_rows;
  out[3] = pl.stages;
  out[4] = (int)pl.smem;
  out[5] = pl.consumers;
  out[6] = pl.blocks_per_sm;
  return 0;
}

// Registers a thread and local (spill) bytes a thread of the launch-1
// kernel with `consumers` warpgroups (1: D, Dv <= 512; 2: wider), in f16
// or bf16, over an int8 pool or not.
extern "C" int ffpa_paged_attrs(int consumers, int is_fp16, int quantized, int* regs,
                                int* local_bytes) {
  if (consumers != 1 && consumers != 2) return (int)cudaErrorInvalidValue;
  const bool split = consumers == 2;
  cudaFuncAttributes a;
  cudaError_t e;
  if (is_fp16)
    e = quantized ? tma::attributes<__half, true>(split, &a)
                  : tma::attributes<__half, false>(split, &a);
  else
    e = quantized ? tma::attributes<__nv_bfloat16, true>(split, &a)
                  : tma::attributes<__nv_bfloat16, false>(split, &a);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
